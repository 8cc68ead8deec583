"""Checkpoint / resume for solver state.

The reference has no checkpointing (SURVEY.md §5 — solves are minutes-scale
and the drivers rebuild everything per cycle); for production-scale runs this
module provides simple, dependency-free save/restore of solution vectors and
solver metadata as compressed .npz.  A copy of
``portable_multigrid_tpu/utils/checkpoint.py`` (NumPy only); torch tensors
are saved through ``np.asarray``, so pass them on the CPU.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(path: str, arrays: dict, metadata: dict | None = None):
    """Save named arrays + a JSON metadata blob atomically."""
    tmp = path + ".tmp"
    meta = json.dumps(metadata or {})
    np.savez_compressed(
        tmp, __metadata__=np.frombuffer(meta.encode(), dtype=np.uint8),
        **{k: np.asarray(v) for k, v in arrays.items()},
    )
    # np.savez appends .npz to the filename it's given
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Returns (arrays, metadata)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "__metadata__"}
        meta = {}
        if "__metadata__" in data.files:
            meta = json.loads(bytes(data["__metadata__"]).decode())
    return arrays, meta
