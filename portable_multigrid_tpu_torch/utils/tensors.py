"""Host arrays to tensors."""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, dtype, device) -> torch.Tensor:
    """``a`` (host values, anything ``np.array`` takes) through float64
    into a new tensor of ``dtype`` on ``device``.  The copy is taken in
    every case: a float64 tensor on the CPU shares no memory with ``a``."""
    return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                           device=device)
