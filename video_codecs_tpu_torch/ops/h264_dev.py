"""H.264 pixel ops on batched blocks: quarter-pel 6-tap/bilinear MC, 4x4
integer transform, quant/dequant, chroma 2x2 DC.

Counterpart of ops/h264_jax.py (same functions, same integers).  Tables
come from the port's numpy module ops/h264_transform.py.  The reference's
forward transform is an int32 einsum; CUDA has no int32 matmul, so
`fwd4x4_dev` is the Cf butterfly in adds and shifts.  `>>` and `&` on
int32 tensors are arithmetic shift and two's-complement and, as in jnp.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.ops import h264_transform as ht
from video_codecs_tpu_torch.ops.interp import gather_window
from video_codecs_tpu_torch.utils.device import const

_TAPS6 = (1, -5, 20, 20, -5, 1)


def _gather(ref: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, w: int,
            h: int) -> torch.Tensor:
    """[B, h, w] clamped int32 windows at integer (x0, y0) per block."""
    return gather_window(ref, x0, y0, w, h).int()


def _hfilt(a: torch.Tensor, n: int) -> torch.Tensor:
    return sum(t * a[..., :, k:n + k] for k, t in enumerate(_TAPS6))


def _vfilt(a: torch.Tensor, n: int) -> torch.Tensor:
    return sum(t * a[..., k:n + k, :] for k, t in enumerate(_TAPS6))


def mc_luma_dev(ref, x0, y0, mvx, mvy, n: int) -> torch.Tensor:
    """Batched quarter-pel luma MC: [B] block origins/MVs -> [B, n, n]
    (spec 8.4.2.2.1 G..r grid, j from unrounded intermediates)."""
    xi = x0 + (mvx >> 2)
    yi = y0 + (mvy >> 2)
    dx = mvx & 3
    dy = mvy & 3
    pat = _gather(ref, xi - 2, yi - 2, n + 6, n + 6)

    G = pat[:, 2:2 + n, 2:2 + n]
    b1 = _hfilt(pat, n + 1)                       # [B, n+6, n+1]
    b_all = ((b1 + 16) >> 5).clamp(0, 255)
    b = b_all[:, 2:2 + n, 0:n]
    s = b_all[:, 3:3 + n, 0:n]
    h1 = _vfilt(pat, n + 1)                       # [B, n+1, n+6]
    h_all = ((h1 + 16) >> 5).clamp(0, 255)
    h_ = h_all[:, 0:n, 2:2 + n]
    m = h_all[:, 0:n, 3:3 + n]
    j1 = _vfilt(b1, n + 1)                        # [B, n+1, n+1]
    j = ((j1[:, 0:n, 0:n] + 512) >> 10).clamp(0, 255)
    Hn = pat[:, 2:2 + n, 3:3 + n]
    Mn = pat[:, 3:3 + n, 2:2 + n]

    def avg(a, c):
        return (a + c + 1) >> 1

    # select per block by (dx, dy); 16 variants, masked
    out = G
    for (fx, fy), v in (
            ((1, 0), avg(G, b)), ((2, 0), b), ((3, 0), avg(b, Hn)),
            ((0, 1), avg(G, h_)), ((0, 2), h_), ((0, 3), avg(h_, Mn)),
            ((2, 2), j), ((2, 1), avg(b, j)), ((2, 3), avg(j, s)),
            ((1, 2), avg(h_, j)), ((3, 2), avg(j, m)),
            ((1, 1), avg(b, h_)), ((3, 1), avg(b, m)),
            ((1, 3), avg(h_, s)), ((3, 3), avg(m, s))):
        sel = ((dx == fx) & (dy == fy))[:, None, None]
        out = torch.where(sel, v, out)
    return out


def mc_chroma_dev(ref, x0, y0, mvx, mvy, n: int) -> torch.Tensor:
    """Batched eighth-pel bilinear chroma MC (mv in quarter-LUMA units)."""
    xi = x0 + (mvx >> 3)
    yi = y0 + (mvy >> 3)
    dx = (mvx & 7)[:, None, None]
    dy = (mvy & 7)[:, None, None]
    pat = _gather(ref, xi, yi, n + 1, n + 1)
    A = pat[:, 0:n, 0:n]
    B = pat[:, 0:n, 1:1 + n]
    C = pat[:, 1:1 + n, 0:n]
    D = pat[:, 1:1 + n, 1:1 + n]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B +
            (8 - dx) * dy * C + dx * dy * D + 32) >> 6


def _cf_1d(x0, x1, x2, x3):
    """One Cf pass on four rows/columns: Cf = [[1,1,1,1], [2,1,-1,-2],
    [1,-1,-1,1], [1,-2,2,-1]] (ht._CF)."""
    s03, d03 = x0 + x3, x0 - x3
    s12, d12 = x1 + x2, x1 - x2
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def fwd4x4_dev(res: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> transformed W = Cf X Cf^T (exact int32 butterfly)."""
    x = res.int()
    y = torch.stack(_cf_1d(*x.unbind(-2)), dim=-2)      # Cf X
    return torch.stack(_cf_1d(*y.unbind(-1)), dim=-1)   # (Cf X) Cf^T


def inv4x4_dev(d: torch.Tensor) -> torch.Tensor:
    """Spec 8.5.12.2 butterfly inverse with final (x+32)>>6 — exact
    twin of ht.inverse4x4 (same butterfly order; >>1 makes it matter)."""
    x = d.int()
    e0 = x[..., 0, :] + x[..., 2, :]
    e1 = x[..., 0, :] - x[..., 2, :]
    e2 = (x[..., 1, :] >> 1) - x[..., 3, :]
    e3 = x[..., 1, :] + (x[..., 3, :] >> 1)
    g = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-2)
    f0 = g[..., :, 0] + g[..., :, 2]
    f1 = g[..., :, 0] - g[..., :, 2]
    f2 = (g[..., :, 1] >> 1) - g[..., :, 3]
    f3 = g[..., :, 1] + (g[..., :, 3] >> 1)
    h = torch.stack([f0 + f3, f1 + f2, f1 - f2, f0 - f3], dim=-1)
    return (h + 32) >> 6


def quant_ac_dev(w: torch.Tensor, qp: int,
                 intra: bool = False) -> torch.Tensor:
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    m = const(np.asarray(ht._MF[qp % 6], np.int32)[ht._POS_CLASS], w.device)
    lv = (w.abs() * m + f) >> qbits
    return torch.sign(w) * lv


def dequant_ac_dev(levels: torch.Tensor, qp: int) -> torch.Tensor:
    v = const(np.asarray(ht._V[qp % 6], np.int32)[ht._POS_CLASS],
              levels.device)
    return (levels * v) << (qp // 6)


def hadamard2x2_dev(x: torch.Tensor) -> torch.Tensor:
    a = x[..., 0, 0]
    b = x[..., 0, 1]
    c = x[..., 1, 0]
    d = x[..., 1, 1]
    return torch.stack([
        torch.stack([a + b + c + d, a - b + c - d], dim=-1),
        torch.stack([a + b - c - d, a - b - c + d], dim=-1)], dim=-2)


def quant_chroma_dc_dev(dc_h: torch.Tensor, qp: int,
                        intra: bool = False) -> torch.Tensor:
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    m0 = int(ht._MF[qp % 6][0])
    lv = (dc_h.abs() * m0 + 2 * f) >> (qbits + 1)
    return torch.sign(dc_h) * lv


def dequant_chroma_dc_dev(levels: torch.Tensor, qp: int) -> torch.Tensor:
    f = hadamard2x2_dev(levels)
    ls = int(ht._V[qp % 6][0]) << 4
    return ((f * ls) << (qp // 6)) >> 5
