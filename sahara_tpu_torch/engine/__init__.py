"""Device index and the seed-and-verify search path."""
