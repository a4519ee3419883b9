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
the uniform-grid deblock.  `_code_blocks` and `_code_blocks_rate` take
the device full RDOQ and `_code_blocks` also hard quantization and
RDOQ-lite, as the reference does; the rate proxy of `_code_blocks_rate`
without the full RDOQ raises NotImplementedError (the inter encoders
always run the full RDOQ).
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


# video_codecs_tpu/models/hevc/encoder_jax.py:88
def decide_modes_device(y: torch.Tensor, qp: int, bw: int,
                        bh: int) -> torch.Tensor:
    """[bh, bw] best intra mode per 16x16 block (orig-neighbor sweep).

    The 35-mode SATDs of every block at once, then the MPM-biased argmin
    left to right along each row (the reference's `lax.scan`), all rows
    together."""
    dev = y.device
    ys = torch.arange(bh, dtype=torch.int32, device=dev) * 16
    xs = torch.arange(bw, dtype=torch.int32, device=dev) * 16
    x0 = xs.repeat(bh)
    y0 = ys.repeat_interleave(bw)
    refs = gather_refs(y.int(), x0, y0, 16)
    modes = torch.arange(35, dtype=torch.int32,
                         device=dev).expand(bw * bh, 35)
    preds = intra_ops.predict_intra(refs, modes, 4)
    blocks = _extract_blocks(y.int(), x0, y0, 16)
    satd = cost_ops.hadamard_satd_8x8(blocks[:, None], preds)  # [B, 35]
    satd = satd.reshape(bh, bw, 35)

    sl = math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))
    c_mpm0 = int(round(sl * 2.0))
    c_mpm1 = int(round(sl * 3.0))
    c_rem = int(round(sl * 6.0))

    rows = torch.arange(bh, device=dev)
    left_mode = torch.full((bh,), DC, dtype=torch.int32, device=dev)
    out = []
    for bx in range(bw):
        m0 = torch.where(left_mode < 2, 0, left_mode).long()
        m2 = torch.where(left_mode < 2, 26, 0).long()
        bits = torch.full((bh, 35), c_rem, dtype=torch.int32, device=dev)
        bits[rows, m0] = c_mpm0
        bits[:, 1] = c_mpm1
        bits[rows, m2] = c_mpm1
        # careful: order matters if m0/m2 collide with DC=1; mpm0 wins
        bits[rows, m0] = c_mpm0
        left_mode = torch.argmin(satd[:, bx] + bits, dim=1).int()
        out.append(left_mode)
    return torch.stack(out, dim=1)


# video_codecs_tpu/models/hevc/encoder_jax.py:124
def _extract_blocks(plane: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    n: int) -> torch.Tensor:
    ar = torch.arange(n, dtype=torch.int64, device=plane.device)
    rows = y0.long()[:, None, None] + ar[None, :, None]
    cols = x0.long()[:, None, None] + ar[None, None, :]
    return plane[rows, cols]


def _put_blocks(plane: torch.Tensor, vals: torch.Tensor, x0: torch.Tensor,
                y0: torch.Tensor, n: int) -> None:
    """Write the [B, n, n] blocks `vals` into `plane` at (x0, y0), in
    place (the blocks do not overlap)."""
    ar = torch.arange(n, dtype=torch.int64, device=plane.device)
    plane[y0.long()[:, None, None] + ar[None, :, None],
          x0.long()[:, None, None] + ar[None, None, :]] = vals.to(plane.dtype)


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

    Returns (levels, recon, cbf, bits[f32 per block]); the bits come from
    the full RDOQ's own fractional-bit bookkeeping (HM CABAC-counter
    parity).  The reference's cheap proxy for the other quantizers is
    not ported."""
    res = orig - pred
    coeff = tr_ops.forward_transform(res, log2)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq != "full":
        raise NotImplementedError(
            "_code_blocks_rate: only the full RDOQ's rate is ported")
    levels, bits = rdoq_dev.rdoq_dev(
        coeff, qp, log2, lam=lam, is_luma=is_luma, slice_type=0,
        return_rate=True)
    if sbh:
        levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
    cbf = (levels != 0).any(-1).any(-1)
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = (pred + r).clamp(0, 255)
    rec = torch.where(cbf[:, None, None], rec, pred)
    return levels, rec, cbf, bits


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
    planes before the diagonal writes them."""
    coords, valid, steps, _ = _wavefront_schedule(bw, bh)
    dev = y.device
    cdev = const(coords, dev)
    lens = valid.sum(1)
    h, w = y.shape
    b = bw * bh
    st = dict(
        rec_y=torch.zeros((h, w), dtype=torch.int32, device=dev),
        rec_u=torch.zeros((h // 2, w // 2), dtype=torch.int32, device=dev),
        rec_v=torch.zeros((h // 2, w // 2), dtype=torch.int32, device=dev),
        levels_y=torch.zeros((b, 16, 16), dtype=torch.int32, device=dev),
        levels_cb=torch.zeros((b, 8, 8), dtype=torch.int32, device=dev),
        levels_cr=torch.zeros((b, 8, 8), dtype=torch.int32, device=dev),
        cbf=torch.zeros((3, b), dtype=torch.bool, device=dev),
    )
    modes_flat = modes.reshape(-1)

    def plane_step(plane, orig, x0, y0, n, blk_modes, is_luma, qpp):
        log2 = 4 if n == 16 else 3
        refs = gather_refs(plane, x0, y0, n)
        pred = _predict_single_mode(refs, blk_modes, log2, is_luma)
        oblk = _extract_blocks(orig, x0, y0, n)
        levels, rec, cbf = _code_blocks(oblk, pred, qpp, log2, sbh=sbh,
                                        rdoq=rdoq)
        _put_blocks(plane, rec, x0, y0, n)
        return levels, cbf

    planes = (("rec_y", "levels_y", y, 16, qp),
              ("rec_u", "levels_cb", u, 8, qp_c),
              ("rec_v", "levels_cr", v, 8, qp_c))
    for d in range(steps):
        c = cdev[d, :int(lens[d])]
        bx, by = c[:, 0], c[:, 1]
        bidx = (by * bw + bx).long()
        blk_modes = modes_flat[bidx]
        for comp, (rec_key, lv_key, orig, n, qpp) in enumerate(planes):
            lv, cbf = plane_step(st[rec_key], orig, bx * n, by * n, n,
                                 blk_modes, comp == 0, qpp)
            st[lv_key][bidx] = lv
            st["cbf"][comp, bidx] = cbf
    return st


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
