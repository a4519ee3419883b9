"""Device all-intra CU-quadtree encoder (CTB 32, CUs 32/16/8).

Counterpart of video_codecs_tpu/models/hevc/encoder_jax_qt.py, function
by function under the same names, on tensors of an explicit device (the
caller's), without autograd.

Pass 1, decision: for every CU candidate of every size (8/16/32), all 35
intra modes from original-neighbour references as one matmul, 8x8
Hadamard SATD and a left-MPM-aware row scan pick a mode; the chosen mode
is trial-coded (transform -> full RDOQ with CABAC-table rates -> recon)
for J = SSE + lambda * R; a bottom-up tree DP (four children against
the parent) resolves the quadtree.  Boundary CUs that do not fit the
picture are split (spec 7.4.9.4).

Pass 2, reconstruction: CTBs on an anti-diagonal d = cx + 2*cy are
independent; inside each CTB the Z-order micro-steps (one 32, four 16,
sixteen 8) code the CUs whose origin and decided depth match, with
reference samples under the exact spec 6.4.1 Z-scan availability.  The
reference computes every candidate at every step and drops the
unselected ones in its scatter; the port reads the decided depth map on
the host once and codes only the selected CUs of each step (skipping
empty steps), which writes the same planes.

Float32 decisions follow the reference's operations in its order (see
ops/rdoq_dev.py and ops/quant.py): the trial cost is the fused
multiply-add d + lambda * R of the reference's XLA loop, the 2x2 child
sums are (a + b) + (c + d) over each pair of rows, and no float32
reduction goes through torch.sum.

Outputs: depth map, per-size mode maps, coefficient planes (each CU's
levels at its position, int16) and the deblocked recon planes, for the
CABAC serializer (models/hevc/quadtree_codec.py, entropy/native.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from video_codecs_tpu_torch.models.hevc import encoder_dev
from video_codecs_tpu_torch.models.hevc.intra_codec import chroma_qp
from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import intra_wavefront
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops import rdoq_dev
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.ops.quant import fma32
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const

DC = 1
LOG2_CTB = 5
CTB = 32

# Per-CU syntax-overhead bit estimates for the tree decision (part mode,
# prev_intra flag, mpm/rem bins, chroma mode, cbf flags).
_CU_OVERHEAD_BITS = {8: 10.0, 16: 9.0, 32: 9.0}

# RDOQ-lite rate-model lambda calibration of the quadtree path (the
# reference's default; it reads an override from its environment, the
# port does not).
RDOQ_LAM_SCALE = 1.0


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:62
def _ceil_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


# ---------------------------------------------------------------------------
# Z-scan availability (device twin of quadtree_codec.z_index/build_ref_z)
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/encoder_jax_qt.py:70
def z_index_dev(x: torch.Tensor, y: torch.Tensor, log2_ctb: int,
                ctbs_per_row: int) -> torch.Tensor:
    """Global Z-scan order of the 4x4 block containing (x, y) (spec 6.4.1)."""
    nbits = log2_ctb - 2
    mask = (1 << nbits) - 1
    ix = (x >> 2) & mask
    iy = (y >> 2) & mask
    m = torch.zeros_like(x)
    for b in range(nbits):
        m = m | (((ix >> b) & 1) << (2 * b)) | (((iy >> b) & 1) << (2 * b + 1))
    ctb = (y >> log2_ctb) * ctbs_per_row + (x >> log2_ctb)
    return (ctb << (2 * nbits)) + m


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:84
def gather_refs_z(plane: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                  n: int, log2_ctb: int, w: int, h: int) -> torch.Tensor:
    """Substituted reference arrays [B, 4N+1] with exact Z-scan
    availability against the true picture dims (w, h); `plane` may be
    padded larger."""
    ph, pw = plane.shape
    dev = plane.device
    ctbs_per_row = (w + (1 << log2_ctb) - 1) >> log2_ctb
    dy, dx = (const(t, dev, torch.int32)
              for t in encoder_dev._ref_offsets(n))
    rows = y0[:, None] + dy[None, :]
    cols = x0[:, None] + dx[None, :]
    inb = (rows >= 0) & (cols >= 0) & (rows < h) & (cols < w)
    rc = rows.clamp(0, ph - 1)
    cc = cols.clamp(0, pw - 1)
    cur = z_index_dev(x0, y0, log2_ctb, ctbs_per_row)[:, None]
    avail = inb & (z_index_dev(cc, rc, log2_ctb, ctbs_per_row) < cur)
    samples = plane[rc.long(), cc.long()]
    return intra_ops.substitute_unavailable(samples.int(), avail)


# ---------------------------------------------------------------------------
# Pass 1: per-size mode sweep + trial-coded cost, then tree-DP
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/encoder_jax_qt.py:107
def _grid(n: int, pw: int, ph: int, device):
    bw, bh = pw // n, ph // n
    ar_x = torch.arange(bw, dtype=torch.int32, device=device) * n
    ar_y = torch.arange(bh, dtype=torch.int32, device=device) * n
    xs = ar_x.repeat(bh)
    ys = ar_y.repeat_interleave(bw)
    return xs, ys, bw, bh


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:114
def _mode_sweep(y: torch.Tensor, qp: int, n: int,
                lam_scale: float = 1.0) -> torch.Tensor:
    """[bh, bw] best intra mode per n-block (original-neighbour SATD sweep
    with a left-MPM-aware scan along each row of blocks)."""
    ph, pw = y.shape
    dev = y.device
    xs, ys, bw, bh = _grid(n, pw, ph, dev)
    log2 = n.bit_length() - 1
    refs = encoder_dev.gather_refs(y, xs, ys, n)
    modes = torch.arange(35, dtype=torch.int32, device=dev).expand(bw * bh, 35)
    preds = intra_ops.predict_intra(refs, modes, log2)
    blocks = encoder_dev._extract_blocks(y, xs, ys, n)
    satd = cost_ops.hadamard_satd_8x8(blocks[:, None], preds)
    del preds
    satd = satd.reshape(bh, bw, 35)

    sl = math.sqrt(lam_scale * 0.57 * 2.0 ** ((qp - 12) / 3.0))
    c_mpm0 = int(round(sl * 2.0))
    c_mpm1 = int(round(sl * 3.0))
    c_rem = int(round(sl * 6.0))

    # bits[m0] = c_mpm0 wins over bits[1] = bits[m2] = c_mpm1 (the
    # reference's order of .at[].set); torch.argmin takes the first
    # minimum, as jnp.argmin does.
    ar = torch.arange(35, dtype=torch.int32, device=dev)[None, :]
    left = torch.full((bh,), DC, dtype=torch.int32, device=dev)
    bests = []
    for bx in range(bw):
        m0 = torch.where(left < 2, 0, left)[:, None]
        m2 = torch.where(left < 2, 26, 0)[:, None]
        bits = torch.where(ar == m0, c_mpm0,
                           torch.where((ar == m2) | (ar == 1), c_mpm1, c_rem))
        left = torch.argmin(satd[:, bx] + bits, dim=1).int()
        bests.append(left)
    return torch.stack(bests, dim=1)


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:148
def _level_rate_bits(levels: torch.Tensor) -> torch.Tensor:
    """Crude coefficient-rate model over [..., N, N] levels (bits), summed
    row-major left to right; 2 + log2(1 + a) is XLA's log and one FMA
    (quant_ops.log_1p_tables)."""
    a = levels.abs()
    rate = const(quant_ops.log_1p_tables()[1], levels.device,
                 torch.float32)
    bits = torch.where(a == 0, 0.0, rate[a.long()])
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    acc = flat[..., 0]
    for i in range(1, flat.shape[-1]):
        acc = acc + flat[..., i]
    return acc


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:155
def _trial_cost(y: torch.Tensor, qp: int, n: int, modes: torch.Tensor,
                lam: float, rdoq: bool) -> torch.Tensor:
    """True-RD trial of the chosen mode per block: J = SSE + lam*R, with
    the device full RDOQ's CABAC-table rate when rdoq is on."""
    ph, pw = y.shape
    dev = y.device
    xs, ys, bw, bh = _grid(n, pw, ph, dev)
    log2 = n.bit_length() - 1
    refs = encoder_dev.gather_refs(y, xs, ys, n)
    pred = intra_ops.predict_intra(refs, modes.reshape(-1, 1), log2)[:, 0]
    oblk = encoder_dev._extract_blocks(y, xs, ys, n)
    res = oblk - pred
    coeff = tr_ops.forward_transform(res, log2)
    if rdoq:
        levels, bits = rdoq_dev.rdoq_dev(coeff, qp, log2, lam=lam,
                                         slice_type=2, return_rate=True)
        rate = bits + _CU_OVERHEAD_BITS[n]
    else:
        levels = quant_ops.quantize(coeff, qp, log2)
        rate = _level_rate_bits(levels) + _CU_OVERHEAD_BITS[n]
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = (pred + r).clamp(0, 255)
    d = cost_ops.sse(oblk, rec).float()
    lam_f = torch.tensor(lam, dtype=torch.float32, device=dev)
    return fma32(lam_f, rate, d).reshape(bh, bw)      # d + lam * rate


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:186
def _sum2x2(a: torch.Tensor) -> torch.Tensor:
    """Sum of each 2x2 cell, as (top pair) + (bottom pair)."""
    return (a[0::2, 0::2] + a[0::2, 1::2]) + (a[1::2, 0::2] + a[1::2, 1::2])


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:191
def decide_qt_device(y: torch.Tensor, qp: int, w: int, h: int, rdoq: bool,
                     lam_scale: float = 1.0):
    """Quadtree decision on the padded original luma plane (int32).

    Returns depth8 [ph/8, pw/8] int32 (0: in a 32-CU, 1: 16, 2: 8) plus
    per-size mode maps.  Boundary CUs that do not fit the true picture are
    forced split (spec implicit split)."""
    ph, pw = y.shape
    dev = y.device
    lam = lam_scale * 0.57 * 2.0 ** ((qp - 12) / 3.0)

    m8 = _mode_sweep(y, qp, 8, lam_scale)
    m16 = _mode_sweep(y, qp, 16, lam_scale)
    m32 = _mode_sweep(y, qp, 32, lam_scale)
    j8 = _trial_cost(y, qp, 8, m8, lam, rdoq)
    j16 = _trial_cost(y, qp, 16, m16, lam, rdoq)
    j32 = _trial_cost(y, qp, 32, m32, lam, rdoq)

    def fit_mask(n, bw, bh):
        xs = torch.arange(bw, dtype=torch.int32, device=dev) * n
        ys = torch.arange(bh, dtype=torch.int32, device=dev) * n
        return (ys[:, None] + n <= h) & (xs[None, :] + n <= w)

    in8 = fit_mask(8, pw // 8, ph // 8)          # inside == fits for 8
    fit16 = fit_mask(16, pw // 16, ph // 16)
    fit32 = fit_mask(32, pw // 32, ph // 32)

    j8 = torch.where(in8, j8, 0.0)               # absent blocks cost nothing
    sum8 = _sum2x2(j8)
    split16 = (~fit16) | (sum8 < j16)
    j16t = torch.where(split16, sum8, j16)
    sum16 = _sum2x2(j16t)
    split32 = (~fit32) | (sum16 < j32)

    def up(a, k):
        return a.repeat_interleave(k, 0).repeat_interleave(k, 1)

    chosen32 = ~split32                                          # 32-grid
    chosen16 = up(split32, 2) & ~split16
    up32 = up(chosen32, 4)                                       # 8-grid
    up16 = up(chosen16, 2)
    depth8 = 2 - 2 * up32.int() - up16.int()
    return depth8, m8, m16, m32


# ---------------------------------------------------------------------------
# Pass 2: wavefront reconstruction honoring the decided tree
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/encoder_jax_qt.py:238
def _scatter(plane: torch.Tensor, vals: torch.Tensor, xs: torch.Tensor,
             ys: torch.Tensor, n: int) -> torch.Tensor:
    """Write the [B, n, n] blocks at (xs, ys) into `plane` in place.  The
    reference scatters every candidate and drops the unselected ones
    (mode="drop"); the port passes only the selected blocks."""
    ar = torch.arange(n, dtype=torch.int64, device=plane.device)
    rows = ys.long()[:, None, None] + ar[None, :, None]
    cols = xs.long()[:, None, None] + ar[None, None, :]
    plane[rows, cols] = vals.to(plane.dtype)
    return plane


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:246
def _scan_type_dev(modes: torch.Tensor) -> torch.Tensor:
    """Mode-dependent scan for 4x4/8x8 TBs (rom.intra_scan_type twin)."""
    ver = (modes >= 6) & (modes <= 14)
    hor = (modes >= 22) & (modes <= 30)
    return torch.where(ver, rom.SCAN_VER,
                       torch.where(hor, rom.SCAN_HOR, rom.SCAN_DIAG)).int()


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:254
def _code_tb_batch(oblk, pred, qp: int, log2: int, sbh: bool, rdoq: bool,
                   scan_t: torch.Tensor | None, lam_scale: float = 1.0):
    """Batched TB coding; returns (levels, recon)."""
    res = oblk - pred
    coeff = tr_ops.forward_transform(res, log2)
    if rdoq:
        lam = lam_scale * 0.57 * 2.0 ** ((qp - 12) / 3.0)
        levels = quant_ops.rdoq_lite(coeff, qp, log2, lam=lam,
                                     lam_scale=RDOQ_LAM_SCALE)
    else:
        levels = quant_ops.quantize(coeff, qp, log2)
    if sbh:
        if scan_t is None:
            levels = quant_ops.apply_sbh(levels, log2, coeff, qp)
        else:
            levels = quant_ops.apply_sbh_scan(levels, log2, scan_t, coeff, qp)
    dq = quant_ops.dequantize(levels, qp, log2)
    r = tr_ops.inverse_transform(dq, log2)
    rec = (pred + r).clamp(0, 255)
    return levels, rec


# video_codecs_tpu/models/hevc/encoder_jax_qt.py:276
def encode_frame_qt_device(y, u, v, depth8, m8, m16, m32, qp: int, qp_c: int,
                           w: int, h: int, sbh: bool, rdoq: bool,
                           lam_scale: float = 1.0):
    """Wavefront recon of the decided quadtree; returns recon planes and
    coefficient planes (padded dims; caller crops).

    CUDA tensors go through the hand-written kernel
    (`intra_wavefront.qt_wavefront`: one persistent launch, the decided
    tree read on the card, no host sync); CPU tensors through the
    plain version `encode_frame_qt_device_ref`."""
    if y.device.type == "cpu":
        return encode_frame_qt_device_ref(y, u, v, depth8, m8, m16, m32, qp,
                                          qp_c, w, h, sbh, rdoq, lam_scale)
    lam = tuple(lam_scale * 0.57 * 2.0 ** ((q - 12) / 3.0)
                for q in (qp, qp_c))
    return intra_wavefront.qt_wavefront(y, u, v, depth8, m8, m16, m32, qp,
                                        qp_c, w, h, sbh, rdoq, lam,
                                        RDOQ_LAM_SCALE)


def encode_frame_qt_device_ref(y, u, v, depth8, m8, m16, m32, qp: int,
                               qp_c: int, w: int, h: int, sbh: bool,
                               rdoq: bool, lam_scale: float = 1.0):
    """The plain version of `encode_frame_qt_device`: the reference's
    wavefront as eager torch ops, one batch per micro-step of a diagonal."""
    ph, pw = y.shape
    dev = y.device
    cw, ch = pw // CTB, ph // CTB
    coords, valid, steps, _ = encoder_dev._wavefront_schedule(cw, ch)
    depth_h = depth8.cpu().numpy()        # the decided tree, read once

    def zeros(hh, ww):
        return torch.zeros((hh, ww), dtype=torch.int32, device=dev)

    st = dict(rec_y=zeros(ph, pw), rec_u=zeros(ph // 2, pw // 2),
              rec_v=zeros(ph // 2, pw // 2), coef_y=zeros(ph, pw),
              coef_u=zeros(ph // 2, pw // 2), coef_v=zeros(ph // 2, pw // 2))

    def code_cu(xs_h, ys_h, n, mode_map, want_depth):
        sel = ((xs_h < w) & (ys_h < h) &
               (depth_h[np.minimum(ys_h, ph - 1) // 8,
                        np.minimum(xs_h, pw - 1) // 8] == want_depth))
        if not sel.any():
            return
        xs = torch.from_numpy(xs_h[sel].astype(np.int32)).to(dev)
        ys = torch.from_numpy(ys_h[sel].astype(np.int32)).to(dev)
        log2 = n.bit_length() - 1
        modes = mode_map[(ys // n).long(), (xs // n).long()].int()
        # luma
        refs = gather_refs_z(st["rec_y"], xs, ys, n, LOG2_CTB, w, h)
        pred = intra_ops.predict_intra(refs, modes[:, None], log2)[:, 0]
        oblk = encoder_dev._extract_blocks(y, xs, ys, n)
        scan_t = _scan_type_dev(modes) if log2 == 3 else None
        lv, rec = _code_tb_batch(oblk, pred, qp, log2, sbh, rdoq, scan_t,
                                 lam_scale)
        _scatter(st["rec_y"], rec, xs, ys, n)
        _scatter(st["coef_y"], lv, xs, ys, n)
        # chroma (DM mode, TB at half size, min 4)
        cs = max(n // 2, 4)
        clog2 = cs.bit_length() - 1
        cxs, cys = xs // 2, ys // 2
        cscan_t = _scan_type_dev(modes) if clog2 == 2 else None
        for orig_c, rk, ck in ((u, "rec_u", "coef_u"), (v, "rec_v", "coef_v")):
            refc = gather_refs_z(st[rk], cxs, cys, cs, LOG2_CTB - 1,
                                 w // 2, h // 2)
            predc = intra_ops.predict_intra(refc, modes[:, None], clog2,
                                            is_luma=False)[:, 0]
            oc = encoder_dev._extract_blocks(orig_c, cxs, cys, cs)
            lvc, recc = _code_tb_batch(oc, predc, qp_c, clog2, sbh, rdoq,
                                       cscan_t, lam_scale)
            _scatter(st[rk], recc, cxs, cys, cs)
            _scatter(st[ck], lvc, cxs, cys, cs)

    for d in range(steps):
        c = coords[d][valid[d]]
        cx = c[:, 0] * CTB
        cy = c[:, 1] * CTB
        # Z-order micro-steps: the 32-CU, then per 16-quadrant the 16-CU
        # and its four 8-CUs
        code_cu(cx, cy, 32, m32, 0)
        for q in range(4):
            qx = cx + (q & 1) * 16
            qy = cy + (q >> 1) * 16
            code_cu(qx, qy, 16, m16, 1)
            for s in range(4):
                code_cu(qx + (s & 1) * 8, qy + (s >> 1) * 8, 8, m8, 2)
    return st


# ---------------------------------------------------------------------------
# Deblocking BS maps from the depth map (CU boundaries on the 8 grid)
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/encoder_jax_qt.py:361
def bs_maps_from_depth(depth8: torch.Tensor, w: int, h: int):
    """BS=2 on 8-grid edges between different CUs (all-intra picture):
    two 8-cells belong to the same CU iff they share a CU origin."""
    w8, h8 = w // 8, h // 8
    d = depth8[:h8, :w8]
    gx = torch.arange(w8, dtype=torch.int32, device=d.device)[None, :]
    gy = torch.arange(h8, dtype=torch.int32, device=d.device)[:, None]
    size8 = (4 >> d).int()                      # CU size in 8-cells: 4/2/1
    ox = gx - (gx % size8)
    oy = gy - (gy % size8)
    cu_id = oy * w8 + ox
    bs_ver = 2 * (cu_id[:, :-1] != cu_id[:, 1:]).int().T
    bs_hor = 2 * (cu_id[:-1, :] != cu_id[1:, :]).int()
    return bs_ver.contiguous(), bs_hor


# ---------------------------------------------------------------------------
# The whole picture (counterpart of encode_frame_qt_jit)
# ---------------------------------------------------------------------------

def _pad_edge(p: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Edge-replicate an int32 plane to hh x ww (jnp.pad mode "edge")."""
    rows = torch.arange(hh, device=p.device).clamp(max=p.shape[0] - 1)
    cols = torch.arange(ww, device=p.device).clamp(max=p.shape[1] - 1)
    return p.int()[rows][:, cols]


def encode_frame_qt(y, u, v, qp: int, w: int, h: int,
                    deblock: bool = True, sbh: bool = True,
                    rdoq: bool = True, lam_scale: float = 1.0) -> dict:
    """Decision + wavefront recon + deblock of one picture: y, u, v are
    8-bit planes (any integer dtype) on the device the work runs on.
    The counterpart of the reference's encode_frame_qt_jit
    (encoder_jax_qt.py:384), eager instead of one compiled graph."""
    with torch.inference_mode():
        pw, ph = _ceil_to(w, CTB), _ceil_to(h, CTB)
        yi = _pad_edge(y, ph, pw)
        ui = _pad_edge(u, ph // 2, pw // 2)
        vi = _pad_edge(v, ph // 2, pw // 2)

        qp_c = chroma_qp(qp)
        depth8, m8, m16, m32 = decide_qt_device(yi, qp, w, h, rdoq,
                                                lam_scale)
        st = encode_frame_qt_device(yi, ui, vi, depth8, m8, m16, m32, qp,
                                    qp_c, w, h, sbh, rdoq, lam_scale)

        rec_y = st["rec_y"][:h, :w]
        rec_u = st["rec_u"][:h // 2, :w // 2]
        rec_v = st["rec_v"][:h // 2, :w // 2]
        if deblock:
            bs_ver, bs_hor = bs_maps_from_depth(depth8, w, h)
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs(
                rec_y, rec_u, rec_v, qp, bs_ver, bs_hor, block=8)

        def i16(p):
            # int16 is exact: levels are spec-clipped to 16 bits (7.4.9.11)
            return p.clamp(-32768, 32767).to(torch.int16)

        return dict(
            rec_y=rec_y.to(torch.uint8),
            rec_u=rec_u.to(torch.uint8),
            rec_v=rec_v.to(torch.uint8),
            coef_y=i16(st["coef_y"][:h, :w]),
            coef_u=i16(st["coef_u"][:h // 2, :w // 2]),
            coef_v=i16(st["coef_v"][:h // 2, :w // 2]),
            depth8=depth8.to(torch.int8),
            m8=m8.to(torch.int8),
            m16=m16.to(torch.int8),
            m32=m32.to(torch.int8),
        )
