"""numpy -> tensor on an explicit device, with a cache for constant tables.

The constant tables (transform and quant matrices, Hadamard, neighbour
offsets) are the "weights" the codec computes with; `const` uploads
each once per (content, dtype, device) and hands back the same read-only
tensor.  video_codecs_tpu/utils/devconst.py has no counterpart: it
rebuilds `jnp` constants from numpy inside each JAX trace, and eager
PyTorch has no traces.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_CONST_CACHE: dict = {}


def to_device(arr, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Copy a numpy array (or array-like) to `device`, optionally cast."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def const(arr, device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Cached device tensor of a numpy constant table (never mutate it)."""
    a = np.ascontiguousarray(arr)
    key = (a.shape, a.dtype.name,
           hashlib.blake2b(a.tobytes(), digest_size=16).digest(),
           dtype, str(torch.device(device)))
    hit = _CONST_CACHE.get(key)
    if hit is None:
        _CONST_CACHE[key] = hit = to_device(a, device, dtype)
    return hit
