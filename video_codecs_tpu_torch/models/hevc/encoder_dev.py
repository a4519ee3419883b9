"""The flat CTB16 all-intra device encoder and the device helpers the
quadtree and inter encoders share: reference-sample gather, 16x16 intra
mode decision, batched TB coding.

Counterpart of video_codecs_tpu/models/hevc/encoder_jax.py.  The static
tables `_ref_offsets` and `_wavefront_schedule` are the port's copies of
the originals (each keeps its name and a comment gives the original's
line); the device functions take tensors on any device.  `encode_frame`
is `encode_frame_jit`: the mode decision, the reconstruction wavefront
over the anti-diagonals d = bx + 2 * by (`encode_frame_device`, one
batch of 16x16 luma and 8x8 chroma blocks per diagonal, only the
diagonal's own blocks: the reference's padded lanes write nothing) and
the uniform-grid deblock.  `decide_modes_device` and
`encode_frame_device` also take stacks of tile columns [T, H, W]
(`parallel/tiles.py`): one sweep and one wavefront for all the tiles.
`_code_blocks` and `_code_blocks_rate` take the device full RDOQ, hard
quantization and RDOQ-lite, as the reference does; without the full
RDOQ, `_code_blocks_rate`'s rate is the reference's proxy.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from video_codecs_tpu_torch.models.hevc.intra_codec import chroma_qp
from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import intra_wavefront
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops import rdoq_dev
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.utils.device import const

DC = 1


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
                n: int, t: torch.Tensor | None = None) -> torch.Tensor:
    """Substituted reference arrays [B, 4N+1] for blocks at (x0, y0).

    Availability = raster block decode order: left (j < N), corner, top and
    top-right (clipped at the picture edge); below-left never available.
    With `t`, `plane` is a stack [T, H, W] of independent pictures (tile
    columns) and block i reads picture t[i]; each is its own picture
    edge.
    """
    h, w = plane.shape[-2:]
    dev = plane.device
    dy, dx = (const(a, dev, torch.int32) for a in _ref_offsets(n))
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
    rows, cols = rows.clamp(0, h - 1).long(), cols.clamp(0, w - 1).long()
    samples = (plane[rows, cols] if t is None
               else plane[t.long()[:, None], rows, cols])
    return intra_ops.substitute_unavailable(samples.int(), avail)


# video_codecs_tpu/models/hevc/encoder_jax.py:88
def decide_modes_device(y: torch.Tensor, qp: int, bw: int,
                        bh: int) -> torch.Tensor:
    """[bh, bw] best intra mode per 16x16 block (orig-neighbor sweep).

    The 35-mode SATDs of every block at once, then the MPM-biased argmin
    left to right along each row (the reference's `lax.scan`), all rows
    together.  A stack y [T, H, W] of tile columns (`parallel/tiles.py`)
    gives [T, bh, bw]: every tile's blocks in the one sweep, and the
    rows of all tiles in the one scan."""
    dev = y.device
    nt = y.shape[0] if y.dim() == 3 else 0
    ys = torch.arange(bh, dtype=torch.int32, device=dev) * 16
    xs = torch.arange(bw, dtype=torch.int32, device=dev) * 16
    x0 = xs.repeat(bh)
    y0 = ys.repeat_interleave(bw)
    t = None
    if nt:
        x0, y0 = x0.repeat(nt), y0.repeat(nt)
        t = torch.arange(nt, device=dev).repeat_interleave(bw * bh)
    refs = gather_refs(y.int(), x0, y0, 16, t)
    modes = torch.arange(35, dtype=torch.int32,
                         device=dev).expand(x0.shape[0], 35)
    preds = intra_ops.predict_intra(refs, modes, 4)
    blocks = _extract_blocks(y.int(), x0, y0, 16, t)
    satd = cost_ops.hadamard_satd_8x8(blocks[:, None], preds)  # [B, 35]
    satd = satd.reshape(max(nt, 1) * bh, bw, 35)
    bh_all = satd.shape[0]

    sl = math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))
    c_mpm0 = int(round(sl * 2.0))
    c_mpm1 = int(round(sl * 3.0))
    c_rem = int(round(sl * 6.0))

    rows = torch.arange(bh_all, device=dev)
    left_mode = torch.full((bh_all,), DC, dtype=torch.int32, device=dev)
    out = []
    for bx in range(bw):
        m0 = torch.where(left_mode < 2, 0, left_mode).long()
        m2 = torch.where(left_mode < 2, 26, 0).long()
        bits = torch.full((bh_all, 35), c_rem, dtype=torch.int32, device=dev)
        bits[rows, m0] = c_mpm0
        bits[:, 1] = c_mpm1
        bits[rows, m2] = c_mpm1
        # careful: order matters if m0/m2 collide with DC=1; mpm0 wins
        bits[rows, m0] = c_mpm0
        left_mode = torch.argmin(satd[:, bx] + bits, dim=1).int()
        out.append(left_mode)
    out = torch.stack(out, dim=1)
    return out.reshape(nt, bh, bw) if nt else out


# video_codecs_tpu/models/hevc/encoder_jax.py:124
def _extract_blocks(plane: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    n: int, t: torch.Tensor | None = None) -> torch.Tensor:
    ar = torch.arange(n, dtype=torch.int64, device=plane.device)
    rows = y0.long()[:, None, None] + ar[None, :, None]
    cols = x0.long()[:, None, None] + ar[None, None, :]
    if t is not None:                   # plane [T, H, W], block i in t[i]
        return plane[t.long()[:, None, None], rows, cols]
    return plane[rows, cols]


def _put_blocks(plane: torch.Tensor, vals: torch.Tensor, x0: torch.Tensor,
                y0: torch.Tensor, n: int,
                t: torch.Tensor | None = None) -> None:
    """Write the [B, n, n] blocks `vals` into `plane` at (x0, y0), in
    place (the blocks do not overlap); with `t`, block i into picture
    t[i] of the stack `plane` [T, H, W]."""
    ar = torch.arange(n, dtype=torch.int64, device=plane.device)
    rows = y0.long()[:, None, None] + ar[None, :, None]
    cols = x0.long()[:, None, None] + ar[None, None, :]
    if t is None:
        plane[rows, cols] = vals.to(plane.dtype)
    else:
        plane[t.long()[:, None, None], rows, cols] = vals.to(plane.dtype)


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


# video_codecs_tpu/models/hevc/encoder_jax.py:154
def _code_blocks(orig, pred, qp, log2, intra_slice=True, sbh=False,
                 rdoq=False, is_luma=True, lam=None):
    """Batched TB coding: returns (levels, recon, cbf).

    rdoq: False = hard quant, True/"lite" = elementwise RDOQ-lite,
    "full" = the scan-based device full RDOQ (ops/rdoq_dev.py).
    """
    res = orig - pred
    coeff = tr_ops.forward_transform(res, log2)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq == "full":
        levels = rdoq_dev.rdoq_dev(
            coeff, qp, log2, lam=lam, is_luma=is_luma,
            slice_type=2 if intra_slice else 0)
    elif rdoq:
        levels = quant_ops.rdoq_lite(coeff, qp, log2, lam=lam)
    else:
        levels = quant_ops.quantize(coeff, qp, log2)
    if sbh:
        levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
    cbf = (levels != 0).any(-1).any(-1)
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = (pred + r).clamp(0, 255)
    rec = torch.where(cbf[:, None, None], rec, pred)
    return levels, rec, cbf


# video_codecs_tpu/models/hevc/encoder_jax.py:187
def _code_blocks_rate(orig, pred, qp, log2, sbh=False, is_luma=True,
                      rdoq="full", lam=None):
    """Batched TB coding that also returns the estimated CABAC rate.

    Returns (levels, recon, cbf, bits[f32 per block]).  With rdoq="full"
    the bits come from the RDOQ's own fractional-bit bookkeeping (HM
    CABAC-counter parity); otherwise a cheap proxy is used: 2 bits per
    nonzero level plus 2 log2(1 + |level|) summed over the block, in the
    order of the reference's function run op by op (`_proxy_sum`; under
    jit XLA fuses the log2 into the reduce in an order that depends on
    the surrounding program, which the port does not follow: its
    encoders take the full RDOQ)."""
    res = orig - pred
    coeff = tr_ops.forward_transform(res, log2)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq == "full":
        levels, bits = rdoq_dev.rdoq_dev(
            coeff, qp, log2, lam=lam, is_luma=is_luma, slice_type=0,
            return_rate=True)
    else:
        if rdoq:
            levels = quant_ops.rdoq_lite(coeff, qp, log2, lam=lam)
        else:
            levels = quant_ops.quantize(coeff, qp, log2,
                                        intra_slice=False)
        a = levels.abs()
        bits = (2.0 * (a > 0).sum((-2, -1)).float() +
                2.0 * _proxy_sum(quant_ops.log2_xla(1.0 + a.float())))
    if sbh:
        levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
    cbf = (levels != 0).any(-1).any(-1)
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = (pred + r).clamp(0, 255)
    rec = torch.where(cbf[:, None, None], rec, pred)
    return levels, rec, cbf, bits


def _proxy_sum(x: torch.Tensor) -> torch.Tensor:
    """[B, N, N] float32 -> [B] in the order of XLA CPU's reduce over the
    two minor axes (its object code): up to N = 8, each row's sum left to
    right in a vector lane, then the lanes halved pairwise (lane i with
    lane i + N/2); above, one sum left to right in raster order."""
    n = x.shape[-1]
    if n > 8:
        return rdoq_dev._seq_sum(x.reshape(x.shape[0], n * n))
    v = rdoq_dev._seq_sum(x)
    while v.shape[-1] > 1:
        v = v[..., :v.shape[-1] // 2] + v[..., v.shape[-1] // 2:]
    return v[..., 0]


# video_codecs_tpu/models/hevc/encoder_jax.py:224
def _predict_single_mode(refs: torch.Tensor, modes: torch.Tensor, log2: int,
                         is_luma: bool) -> torch.Tensor:
    """[L, 4N+1] refs + [L] modes -> [L, N, N] predictions."""
    return intra_ops.predict_intra(refs, modes[:, None], log2,
                                   is_luma=is_luma)[:, 0]


# video_codecs_tpu/models/hevc/encoder_jax.py:231
def encode_frame_device(y, u, v, modes, qp: int, qp_c: int, bw: int, bh: int,
                        sbh: bool = False, rdoq: bool = False):
    """Wavefront recon of a whole frame on the planes' device.

    Inputs: int32 planes, modes [bh, bw].
    Returns: levels_y [B,16,16], levels_cb/cr [B,8,8], cbf [3, B] and
    rec_y, rec_u, rec_v (int32).  Each diagonal's blocks depend only on
    earlier diagonals, so each is one batch; its prediction reads the
    planes before the diagonal writes them.

    Stacks of T tile columns (planes [T, H, W], modes [T, bh, bw]; bw
    the tile's width in CTBs) are coded as T independent pictures in the
    one wavefront: each diagonal's batch holds that diagonal's blocks of
    every tile, block (t, bx, by) at index t * bw * bh + by * bw + bx of
    the level arrays (the reference's shard_map layout,
    parallel/tiles.py:80), and the rec planes stay stacked.

    CUDA tensors go through the hand-written kernel
    (`intra_wavefront.flat_wavefront`: one persistent launch); CPU
    tensors through the plain version `encode_frame_device_ref`.  The
    kernel takes hard quantisation and RDOQ-lite (rdoq "full" raises
    ValueError on the card)."""
    if y.device.type == "cpu":
        return encode_frame_device_ref(y, u, v, modes, qp, qp_c, bw, bh,
                                       sbh, rdoq)
    dev = y.device
    nt = y.shape[0] if y.dim() == 3 else 0
    h, w = y.shape[-2:]
    b = bw * bh * max(nt, 1)
    lead = (nt,) if nt else ()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    st = dict(rec_y=zeros(*lead, h, w), rec_u=zeros(*lead, h // 2, w // 2),
              rec_v=zeros(*lead, h // 2, w // 2),
              levels_y=zeros(b, 16, 16), levels_cb=zeros(b, 8, 8),
              levels_cr=zeros(b, 8, 8),
              cbf=torch.zeros((3, b), dtype=torch.bool, device=dev))
    intra_wavefront.flat_wavefront(
        y.int().contiguous(), u.int().contiguous(), v.int().contiguous(),
        modes.int().contiguous(), (st["rec_y"], st["rec_u"], st["rec_v"]),
        (st["levels_y"], st["levels_cb"], st["levels_cr"]), tuple(st["cbf"]),
        qp, qp_c, bw, bh, sbh, rdoq, flat_lambdas(qp, qp_c),
        LITE_LAM_SCALE)
    return st


def flat_lambdas(qp: int, qp_c: int) -> tuple[float, float]:
    """`_code_blocks`' default lambda (lam=None) at the luma and the
    chroma QP."""
    return tuple(0.57 * 2.0 ** ((q - 12) / 3.0) for q in (qp, qp_c))


# RDOQ-lite's rate scale where `_code_blocks` leaves it at the default.
LITE_LAM_SCALE = quant_ops.rdoq_lite.__kwdefaults__["lam_scale"]


def encode_frame_device_ref(y, u, v, modes, qp: int, qp_c: int, bw: int,
                            bh: int, sbh: bool = False, rdoq: bool = False):
    """The plain version of `encode_frame_device`: the reference's
    wavefront as eager torch ops, one batch per diagonal."""
    coords, valid, steps, _ = _wavefront_schedule(bw, bh)
    dev = y.device
    nt = y.shape[0] if y.dim() == 3 else 0
    cdev = const(coords if not nt else _tile_schedule(bw, bh, nt), dev)
    lens = valid.sum(1) * max(nt, 1)
    h, w = y.shape[-2:]
    b = bw * bh * max(nt, 1)
    lead = (nt,) if nt else ()
    st = dict(
        rec_y=torch.zeros(lead + (h, w), dtype=torch.int32, device=dev),
        rec_u=torch.zeros(lead + (h // 2, w // 2), dtype=torch.int32,
                          device=dev),
        rec_v=torch.zeros(lead + (h // 2, w // 2), dtype=torch.int32,
                          device=dev),
        levels_y=torch.zeros((b, 16, 16), dtype=torch.int32, device=dev),
        levels_cb=torch.zeros((b, 8, 8), dtype=torch.int32, device=dev),
        levels_cr=torch.zeros((b, 8, 8), dtype=torch.int32, device=dev),
        cbf=torch.zeros((3, b), dtype=torch.bool, device=dev),
    )
    modes_flat = modes.reshape(-1)

    def plane_step(plane, orig, x0, y0, n, blk_modes, is_luma, qpp, t):
        log2 = 4 if n == 16 else 3
        refs = gather_refs(plane, x0, y0, n, t)
        pred = _predict_single_mode(refs, blk_modes, log2, is_luma)
        oblk = _extract_blocks(orig, x0, y0, n, t)
        levels, rec, cbf = _code_blocks(oblk, pred, qpp, log2, sbh=sbh,
                                        rdoq=rdoq)
        _put_blocks(plane, rec, x0, y0, n, t)
        return levels, cbf

    planes = (("rec_y", "levels_y", y, 16, qp),
              ("rec_u", "levels_cb", u, 8, qp_c),
              ("rec_v", "levels_cr", v, 8, qp_c))
    t = None
    for d in range(steps):
        c = cdev[d, :int(lens[d])]
        bx, by = c[:, 0], c[:, 1]
        bidx = (by * bw + bx).long()
        if nt:
            t = c[:, 2]
            bidx = bidx + t.long() * (bw * bh)
        blk_modes = modes_flat[bidx]
        for comp, (rec_key, lv_key, orig, n, qpp) in enumerate(planes):
            lv, cbf = plane_step(st[rec_key], orig, bx * n, by * n, n,
                                 blk_modes, comp == 0, qpp, t)
            st[lv_key][bidx] = lv
            st["cbf"][comp, bidx] = cbf
    return st


@functools.lru_cache(maxsize=None)
def _tile_schedule(bw: int, bh: int, nt: int) -> np.ndarray:
    """`_wavefront_schedule`'s coordinates for nt tiles of bw x bh CTBs:
    [steps, nt * max_len, 3] (bx, by, tile), each diagonal's blocks of
    tile 0, then of tile 1, ..., in the first nt * len lanes."""
    coords, valid, steps, max_len = _wavefront_schedule(bw, bh)
    out = np.zeros((steps, nt * max_len, 3), np.int32)
    for d in range(steps):
        n = int(valid[d].sum())
        for t in range(nt):
            out[d, t * n:(t + 1) * n, :2] = coords[d, :n]
            out[d, t * n:(t + 1) * n, 2] = t
    return out


# video_codecs_tpu/models/hevc/encoder_jax.py:299
def encode_frame(y, u, v, qp: int, bw: int, bh: int, deblock: bool = True,
                 sbh: bool = False, rdoq: bool = False):
    """Full device pipeline: mode decision + wavefront recon + deblock,
    on the planes' device.  Returns the reference's dict: rec planes
    uint8, levels int16, cbf [3, B] bool and modes int8."""
    yi = y.int()
    ui = u.int()
    vi = v.int()
    modes = decide_modes_device(yi, qp, bw, bh)
    st = encode_frame_device(yi, ui, vi, modes, qp, chroma_qp(qp), bw, bh,
                             sbh=sbh, rdoq=rdoq)
    if deblock:
        st["rec_y"], st["rec_u"], st["rec_v"] = deblock_ops.deblock_420(
            st["rec_y"], st["rec_u"], st["rec_v"], qp)
    st["modes"] = modes
    st["rec_y"] = st["rec_y"].to(torch.uint8)
    st["rec_u"] = st["rec_u"].to(torch.uint8)
    st["rec_v"] = st["rec_v"].to(torch.uint8)
    for k in ("levels_y", "levels_cb", "levels_cr"):
        st[k] = st[k].clamp(-32768, 32767).to(torch.int16)
    st["modes"] = st["modes"].to(torch.int8)
    return st
