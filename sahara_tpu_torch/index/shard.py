"""Index-file dispatch by container kind.

``sahara_tpu`` also writes an interval-sharded container (``kind`` =
``"sharded"``) for texts beyond the single-device limit; the port does not
read it yet (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

from sahara_tpu_torch.index.fmindex import FMIndex, load_index, read_meta

SHARDED_NOT_PORTED = "interval-sharded indexes are not ported; see ROADMAP.md queue 1 item 13"


def peek_index_kind(path) -> str:
    """An index file's container kind ('bi', 'uni' or 'sharded'), from its
    metadata member alone."""
    return read_meta(path).get("kind", "plain")


def load_any_index(path) -> FMIndex:
    """Load a plain index file; a sharded container raises."""
    if peek_index_kind(path) == "sharded":
        raise NotImplementedError(SHARDED_NOT_PORTED)
    return load_index(path)
