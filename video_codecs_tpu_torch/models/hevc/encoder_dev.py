"""Reference-sample gather and block helpers of the device intra encoders.

Counterpart of the part of video_codecs_tpu/models/hevc/encoder_jax.py
that the quadtree encoder (models/hevc/encoder_qt_dev.py) uses.  The
static tables `_ref_offsets` and `_wavefront_schedule` are the port's
copies of the originals (each keeps its name and a comment gives the
original's line); `gather_refs` and `_extract_blocks` take tensors on any
device.  The flat 16x16 device encoder of that module is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.utils.device import const


# video_codecs_tpu/models/hevc/encoder_jax.py:44
@functools.lru_cache(maxsize=None)
def _ref_offsets(n: int):
    """Static (dy, dx) offsets of the 4N+1 reference samples."""
    r = 4 * n + 1
    dy = np.zeros(r, np.int32)
    dx = np.zeros(r, np.int32)
    for k in range(2 * n):
        dy[k] = 2 * n - 1 - k
        dx[k] = -1
    dy[2 * n] = -1
    dx[2 * n] = -1
    for i in range(2 * n):
        dy[2 * n + 1 + i] = -1
        dx[2 * n + 1 + i] = i
    return dy, dx  # numpy: lru_cache must never hold traced jnp values


# video_codecs_tpu/models/hevc/encoder_jax.py:61
def gather_refs(plane: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                n: int) -> torch.Tensor:
    """Substituted reference arrays [B, 4N+1] for blocks at (x0, y0).

    Availability = raster block decode order: left (j < N), corner, top and
    top-right (clipped at the picture edge); below-left never available.
    """
    h, w = plane.shape
    dev = plane.device
    dy, dx = (const(t, dev, torch.int32) for t in _ref_offsets(n))
    rows = y0[:, None] + dy[None, :]
    cols = x0[:, None] + dx[None, :]
    k = torch.arange(4 * n + 1, dtype=torch.int32, device=dev)[None, :]
    is_left = k < 2 * n
    avail = torch.where(
        is_left,
        (x0[:, None] > 0) & (k >= n),                 # left part only
        torch.where(k == 2 * n,
                    (x0[:, None] > 0) & (y0[:, None] > 0),
                    (y0[:, None] > 0) & (cols < w)))
    samples = plane[rows.clamp(0, h - 1).long(), cols.clamp(0, w - 1).long()]
    return intra_ops.substitute_unavailable(samples.int(), avail)


# video_codecs_tpu/models/hevc/encoder_jax.py:124
def _extract_blocks(plane: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    n: int) -> torch.Tensor:
    ar = torch.arange(n, dtype=torch.int64, device=plane.device)
    rows = y0.long()[:, None, None] + ar[None, :, None]
    cols = x0.long()[:, None, None] + ar[None, None, :]
    return plane[rows, cols]


# video_codecs_tpu/models/hevc/encoder_jax.py:135
@functools.lru_cache(maxsize=None)
def _wavefront_schedule(bw: int, bh: int):
    """Static schedule: for each diagonal d = bx + 2*by, the (padded) list
    of block coords; plus per-step valid mask."""
    steps = bw + 2 * (bh - 1)
    per_step: list[list[tuple[int, int]]] = [[] for _ in range(steps)]
    for by in range(bh):
        for bx in range(bw):
            per_step[bx + 2 * by].append((bx, by))
    max_len = max(len(s) for s in per_step)
    coords = np.zeros((steps, max_len, 2), np.int32)
    valid = np.zeros((steps, max_len), bool)
    for d, blocks in enumerate(per_step):
        for i, (bx, by) in enumerate(blocks):
            coords[d, i] = (bx, by)
            valid[d, i] = True
    return coords, valid, steps, max_len  # numpy constants
