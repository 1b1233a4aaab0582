"""Host FM-index: build, container, j-mer seed table."""
