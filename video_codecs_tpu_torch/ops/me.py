"""Motion estimation: integer search and quarter-pel refinement.

Counterpart of video_codecs_tpu/ops/me.py: `integer_search` (:23-45),
HM's TZSearch `tz_search` (:82-157) with its candidate rings
`_tz_points`, the hierarchical `pyramid_search` (:210-250) with `_pool4`
and `_sad_best_around`, `_sad_at_points` (the plain gather path), the
SATD refinement `_refine` (:253-269) and `motion_search` (:271), which
runs "full" (HM's FastSearch 0), "tz" (FastSearch 1) or "auto" (full up
to search range 12, TZ beyond) and then the refinement's two rounds as
one entry, `inter_pred.refine_qpel` (one launch of the Hopper kernel on
CUDA tensors; `_refine`, one round, is its plain version).

Every SAD comes from `sad_surface` (the Hopper kernel on CUDA tensors,
which takes the 8-bit samples as they are; 4x4-pooled planes are rounded
means, so they stay within 0..255 too): one surface over the whole
window, then the cost, then `torch.argmin`, which returns the first
minimum -- the row-major (dy outer, dx inner) order in which the
reference's chunked loops keep the first minimum (argmin within a chunk,
strict `<` across chunks and windows).  So the winner is the reference's
exactly.  TZSearch reads each of its stages' candidates out of one
+-search_range surface instead of gathering [B, P, n, n] patches: every
SAD is an integer sum, so the value read is the one the reference's
gather sums.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import inter_pred, interp
from video_codecs_tpu_torch.ops.interp import gather_window
from video_codecs_tpu_torch.ops.sad_surface import sad_surface
from video_codecs_tpu_torch.utils.device import const

# The 8-neighbour refinement pattern (ops/me.py:249), as (dx, dy).
_OFFS8 = np.array([(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                   (-1, 1), (0, 1), (1, 1)], np.int32)


def _u8(a: torch.Tensor) -> torch.Tensor:
    """8-bit samples (0..255) as contiguous uint8, the kernel's input."""
    return a.to(torch.uint8).contiguous()


def _span_offsets(r: int) -> np.ndarray:
    """|d| for d = -r..r (the displacement along one axis of a surface)."""
    return np.abs(np.arange(2 * r + 1) - r).astype(np.int32)


# video_codecs_tpu/ops/me.py:23
def integer_search(ref: torch.Tensor, cur: torch.Tensor, x0: torch.Tensor,
                   y0: torch.Tensor, n: int,
                   search_range: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full integer-pel search around (0, 0) for every block.

    ref: [H, W], cur: [B, n, n], 8-bit samples in any integer dtype;
    returns (mvx, mvy) int-pel [B]."""
    r = search_range
    span = 2 * r + 1
    win = gather_window(_u8(ref), x0 - r, y0 - r, n + 2 * r, n + 2 * r)
    sad = sad_surface(_u8(cur), win, n, r)
    # small centre bias like HM's mv-cost: prefer shorter MVs on ties
    d = _span_offsets(r)
    mv_cost = const((d[:, None] + d[None, :]).reshape(-1), ref.device)
    best = torch.argmin(sad.reshape(-1, span * span) + mv_cost[None, :],
                        dim=1).int()
    return best % span - r, best // span - r


# video_codecs_tpu/ops/me.py:48
def _sad_at_points(win: torch.Tensor, cur: torch.Tensor, pts: np.ndarray,
                   r: int, n: int) -> torch.Tensor:
    """SAD of `cur` [B,n,n] vs window patches at integer offsets pts [P,2]
    (mvx, mvy in [-r, r]).  win: [B, n+2r, n+2r].  Returns [B, P].
    (The plain gather; the search stages take their grids from
    `sad_surface`.)"""
    dev = win.device
    dx = pts[:, 0] + r
    dy = pts[:, 1] + r
    rows = const(dy[:, None, None] + np.arange(n)[None, :, None], dev,
                 torch.int64)
    cols = const(dx[:, None, None] + np.arange(n)[None, None, :], dev,
                 torch.int64)
    patches = win.int()[:, rows, cols]                       # [B, P, n, n]
    return (patches - cur.int()[:, None]).abs().sum((-2, -1),
                                                    dtype=torch.int32)


# video_codecs_tpu/ops/me.py:61
def _tz_points(search_range: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed TZSearch candidate set: 8-point diamond rings at power-of-two
    distances (TEncSearch xTZ8PointDiamondSearch :332-656) plus the center.
    Returns (points [P,2], ring_distance [P])."""
    pts = [(0, 0)]
    dist = [0]
    d = 1
    while d <= search_range:
        if d == 1:
            ring = [(0, -1), (-1, 0), (1, 0), (0, 1)]
        else:
            h = d // 2
            ring = [(0, -d), (-h, -h), (h, -h), (-d, 0), (d, 0),
                    (-h, h), (h, h), (0, d)]
        for p in ring:
            pts.append(p)
            dist.append(d)
        d *= 2
    return np.array(pts, np.int32), np.array(dist, np.int32)


def _pick(cost: torch.Tensor, *vals: torch.Tensor):
    """First minimum of cost [B, P] per block: (its cost, and each of
    vals [B, P] or [P] at it)."""
    k = torch.argmin(cost, dim=1, keepdim=True)
    out = [torch.gather(cost, 1, k)[:, 0]]
    for v in vals:
        out.append(torch.gather(v, 1, k)[:, 0] if v.ndim == 2
                   else v[k[:, 0]])
    return out


# video_codecs_tpu/ops/me.py:82
def tz_search(ref: torch.Tensor, cur: torch.Tensor, x0, y0, n: int,
              search_range: int,
              raster_stride: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """TZSearch as fixed-shape stages over one SAD surface (the
    reference's TEncSearch::xTZSearch :3881 twin).

    The +-search_range window of every block goes through `sad_surface`
    once; each stage reads its candidates' SADs out of that surface at
    (mvy + r, mvx + r) and adds the |mvx| + |mvy| cost:
      1. star: the 8-point diamond rings at distances 1, 2, 4 .. r around
         (0, 0) (`_tz_points(r)`), one argmin;
      2. raster: the stride-5 grid arange(-r, r + 1, 5) squared, taken
         where its best cost is strictly lower than stage 1's;
      3. three star-refinement rounds (the reference's docstring says
         two; its code, `for _ in range(3)`, runs three): the rings of
         `_tz_points(8)` around the running best, clipped to [-r, r]
         (a clipped candidate can repeat; the first in ring order wins),
         each round taken where strictly lower.
    ref: [H, W], cur: [B, n, n], 8-bit samples in any integer dtype.
    Returns integer-pel (mvx, mvy) [B] int32."""
    r = search_range
    span = 2 * r + 1
    dev = ref.device
    win = gather_window(_u8(ref), x0 - r, y0 - r, n + 2 * r, n + 2 * r)
    sad = sad_surface(_u8(cur), win, n, r).reshape(-1, span * span)
    del win

    def fixed(pts):
        """(cost [B, P], mvx [P], mvy [P]) of fixed candidates."""
        idx = const((pts[:, 1] + r) * span + pts[:, 0] + r, dev,
                    torch.int64)
        mv_cost = const(np.abs(pts[:, 0]) + np.abs(pts[:, 1]), dev)
        return (sad[:, idx] + mv_cost[None, :], const(pts[:, 0], dev),
                const(pts[:, 1], dev))

    # --- stage 1: diamond rings around the zero MV ---
    pts1, _ = _tz_points(r)
    bcost, bx, by = _pick(*fixed(pts1))

    # --- stage 2: raster (taken where strictly better) ---
    grid = np.arange(-r, r + 1, raster_stride, dtype=np.int32)
    gx, gy = np.meshgrid(grid, grid, indexing="xy")
    pts2 = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    cost2, x2, y2 = _pick(*fixed(pts2))
    use_raster = cost2 < bcost
    bx = torch.where(use_raster, x2, bx)
    by = torch.where(use_raster, y2, by)
    bcost = torch.where(use_raster, cost2, bcost)

    # --- stage 3: star refinement around the running best ---
    pts3, _ = _tz_points(8)
    p3x, p3y = const(pts3[:, 0], dev), const(pts3[:, 1], dev)
    for _ in range(3):
        cand_x = (bx[:, None] + p3x[None, :]).clamp(-r, r)
        cand_y = (by[:, None] + p3y[None, :]).clamp(-r, r)
        idx = ((cand_y + r) * span + cand_x + r).long()
        cost = torch.gather(sad, 1, idx) + cand_x.abs() + cand_y.abs()
        c, kx, ky = _pick(cost, cand_x, cand_y)
        better = c < bcost
        bx = torch.where(better, kx, bx)
        by = torch.where(better, ky, by)
        bcost = torch.where(better, c, bcost)
    return bx.int(), by.int()


# video_codecs_tpu/ops/me.py:175
def _sad_best_around(ref: torch.Tensor, cur: torch.Tensor, x0, y0,
                     cx: torch.Tensor, cy: torch.Tensor, n: int, rad: int,
                     best_sad, best_x, best_y, bias: int = 0):
    """Refine (best_x, best_y) over the (2rad+1)^2 window around per-block
    centers (cx, cy); SAD + |mv| bias argmin folded into the running best.

    One SAD surface for the whole window; its first minimum in raster
    order is the reference's chunk-of-32 winner, and the fold into the
    running best keeps the reference's strict `<`."""
    span = 2 * rad + 1
    dev = ref.device
    win = gather_window(ref, x0 + cx - rad, y0 + cy - rad, n + 2 * rad,
                        n + 2 * rad)
    sad = sad_surface(_u8(cur), _u8(win), n, rad).reshape(-1, span * span)
    off = np.arange(-rad, rad + 1, dtype=np.int32)
    pdx = const(np.tile(off, span), dev)                     # dx inner
    pdy = const(np.repeat(off, span), dev)                   # dy outer
    mvx = cx[:, None] + pdx[None, :]
    mvy = cy[:, None] + pdy[None, :]
    cost = sad + mvx.abs() + mvy.abs() + bias
    k = torch.argmin(cost, dim=1, keepdim=True)
    c = torch.gather(cost, 1, k)[:, 0]
    better = c < best_sad
    best_sad = torch.where(better, c, best_sad)
    best_x = torch.where(better, torch.gather(mvx, 1, k)[:, 0], best_x)
    best_y = torch.where(better, torch.gather(mvy, 1, k)[:, 0], best_y)
    return best_sad, best_x, best_y


# video_codecs_tpu/ops/me.py:203
def _pool4(a: torch.Tensor) -> torch.Tensor:
    """4x4 mean pool (rounded) over the trailing two dims."""
    sh = a.shape
    a = a.reshape(sh[:-2] + (sh[-2] // 4, 4, sh[-1] // 4, 4))
    return (a.sum((-3, -1), dtype=torch.int32) + 8) >> 4


# video_codecs_tpu/ops/me.py:210
def pyramid_search(ref: torch.Tensor, cur: torch.Tensor, x0, y0, n: int,
                   search_range: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical integer search: a quarter-resolution exhaustive search
    over the whole +-search_range window (SADs on 4x4-pooled blocks),
    then a +-3 full-resolution window around the zero MV and one around
    the upscaled winner.  Three SAD surfaces, all blocks at once."""
    rq = max(1, (search_range + 3) // 4)
    span = 2 * rq + 1
    dev = ref.device
    ref_q = _pool4(ref.int())
    cur_q = _pool4(cur.int())
    nq = n // 4
    win_q = gather_window(ref_q, x0 // 4 - rq, y0 // 4 - rq, nq + 2 * rq,
                          nq + 2 * rq)
    sad_q = sad_surface(_u8(cur_q), _u8(win_q), nq, rq).reshape(
        -1, span * span)
    # scale pooled SADs to full-res magnitude for the |mv| bias to matter
    d = _span_offsets(rq)
    bias = const(4 * (d[:, None] + d[None, :]).reshape(-1), dev)
    cost_q = sad_q * 16 + bias[None, :]
    kq = torch.argmin(cost_q, dim=1).int()
    cx = (kq % span - rq) * 4
    cy = (kq // span - rq) * 4

    big = torch.full((cur.shape[0],), 1 << 30, dtype=torch.int32,
                     device=dev)
    zero = torch.zeros(cur.shape[0], dtype=torch.int32, device=dev)
    best_sad, best_x, best_y = _sad_best_around(
        ref, cur, x0, y0, zero, zero, n, 3, big, zero, zero)
    best_sad, best_x, best_y = _sad_best_around(
        ref, cur, x0, y0, cx, cy, n, 3, best_sad, best_x, best_y)
    r = search_range
    return best_x.clamp(-r, r).int(), best_y.clamp(-r, r).int()


# video_codecs_tpu/ops/me.py:253
def _refine(ref, cur, x0, y0, mvx, mvy, n, step):
    """One diamond refinement round at quarter-pel `step` using SATD."""
    offs8 = const(_OFFS8, ref.device)
    cand_x = mvx[:, None] + offs8[None, :, 0] * step   # [B, 8]
    cand_y = mvy[:, None] + offs8[None, :, 1] * step
    best = cost_ops.hadamard_satd_8x8(
        cur, interp.mc_luma(ref, x0, y0, mvx, mvy, n))  # [B]
    for k in range(8):
        pred = interp.mc_luma(ref, x0, y0, cand_x[:, k], cand_y[:, k], n)
        satd = cost_ops.hadamard_satd_8x8(cur, pred)
        better = satd < best
        best = torch.where(better, satd, best)
        mvx = torch.where(better, cand_x[:, k], mvx)
        mvy = torch.where(better, cand_y[:, k], mvy)
    return mvx, mvy, best


# video_codecs_tpu/ops/me.py:271
def motion_search(ref: torch.Tensor, cur: torch.Tensor, x0, y0, n: int,
                  search_range: int = 8, method: str = "auto"):
    """Integer + half + quarter search; returns (mvx, mvy) quarter-pel [B]
    and the final SATD.

    method: "full" = exhaustive window (HM FastSearch:0), "tz" = TZSearch
    stages (FastSearch:1), "auto" = full for small ranges where the whole
    window is cheaper than the TZ stages, TZ beyond.  As in the
    reference, any method but "tz" after "auto" runs the full search."""
    if method == "auto":
        method = "full" if search_range <= 12 else "tz"
    if method == "tz":
        imx, imy = tz_search(ref, cur, x0, y0, n, search_range)
    else:
        imx, imy = integer_search(ref, cur, x0, y0, n, search_range)
    return inter_pred.refine_qpel(ref, cur, x0, y0, imx * 4, imy * 4, n)
