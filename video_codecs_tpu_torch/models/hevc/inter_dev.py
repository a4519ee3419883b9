"""The device phases of the HEVC inter encoders and the low-delay P,
hierarchical-B and random-access encoders on the flat CTB16 toolset.

Counterpart of video_codecs_tpu/models/hevc/inter_jax.py: the MV helpers
(`scale_mv_dev`, `mvd_bits_dev`, `_shift_grid`, `_scatter_blocks`), the
intra wavefront of inter pictures `_intra_wavefront`, the P-picture
pipeline `encode_p_frame_dev` and the LD-P encoder
`DeviceLowDelayEncoder` (device phase, spec merge/AMVP reconciliation
`_reconcile`, HM's LD-P QP/lambda ladder), the per-list motion search
`b_me_one` and the per-16 B/anchor-P decision `encode_b_frame_dev` with
the options of the flat path (`merge_eval="first"`, the intra candidate,
deblocking with `bs_maps_b_dev`) and of the CTB32 quadtree encoder
(models/hevc/inter_qt.py: `merge_eval="best4"`, the RQT, the CU8 tree,
the device TMVP candidate, `no_backward` and `[R, H, W]` multi-reference
stacks, without intra blocks), and the flat B engines
`DeviceHierarchicalBEncoder` and `DeviceRandomAccessEncoder` (device
phase `_b_device_phase`, spec merge/AMVP reconciliation `_reconcile_b`,
`_device_b_frame`).  `hm_lambda` and `_gop_lambda` are the port's copies
of the host lambda ladder.

The integer motion search is the pyramid or, through
`ops/me.motion_search`, HM's full search, TZSearch or "auto" (the
reference's dispatch, inter_jax.py:225-236 and :462-476).
With `cfg.sao` the three flat engines code the IDR through
`IntraEncoder.encode_frame` (the reference's host CTB loop, computed on
the device with the same bytes) and decide SAO in every picture with
`IntraEncoder._sao_decide_apply` (statistics from the SAO kernel, luma
CTB 16, chroma CTB 8).  `encode_b_frame_dev` takes the multichip dry
run's tile-sharded inputs (`me_fields`, `gx_blk0`, `pic_bw`;
parallel/sharded.py).  The options the encoders refuse raise ValueError:
tiles, WPP, weighted prediction, cu_qp_delta and, on the flat B engines,
what the reference writes wrongly (TMVP, MaxNumMergeCand > 1 in the RA
header, timing SEI and the long-term IDR, which its B loop does not
write).

Float32 in the reference's order.  The decisions compare float32 costs
J = D + lambda * R, so each is the reference's float32 expression as
XLA's CPU backend computes it: `round(sl * (7 + b))` is a float32
product rounded half to even, a multiply feeding an add in one fused
loop is one fused multiply-add (`ops/quant.fma32`), a 4-entry sum
(`_persum`, `_sum2x2`) runs left to right, and `log2` is XLA's
(`ops/quant.log2_xla`).  Sums of squared integer differences are
integers below 2^24, exact in any order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from video_codecs_tpu_torch.models.hevc import bframe_codec as bc
from video_codecs_tpu_torch.models.hevc import encoder_dev
from video_codecs_tpu_torch.models.hevc import inter_codec as pc
from video_codecs_tpu_torch.models.hevc import motion
from video_codecs_tpu_torch.models.hevc import ra_codec as ra
from video_codecs_tpu_torch.models.hevc.intra_codec import chroma_qp
from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import me as me_ops
from video_codecs_tpu_torch.ops.quant import fma32, log2_xla
from video_codecs_tpu_torch.utils.device import to_device

MODE_INTER, MODE_INTRA = 0, 1
INF = 1 << 30
#: integer motion searches: the pyramid, HM's full search (FastSearch 0),
#: TZSearch (FastSearch 1) and "auto" (full up to search range 12, TZ
#: beyond), as in ops/me.motion_search
ME_METHODS = ("pyr", "full", "tz", "auto")


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def _round_cost(sl: float, units: torch.Tensor) -> torch.Tensor:
    """round(sl * units) as the reference computes it: the float32 product
    of float32(sl) and the int32 units, rounded half to even, as int32."""
    s = torch.tensor(sl, dtype=torch.float32, device=units.device)
    return torch.round(s * units.float()).int()


def _round_const(v: float) -> int:
    """jnp.round of a Python float: float32(v) rounded half to even."""
    return int(np.round(np.float32(v)))


def _persum(a: torch.Tensor) -> torch.Tensor:
    """sum(a.reshape(-1, 4), axis=1), left to right (XLA's CPU order)."""
    g = a.reshape(-1, 4)
    return ((g[:, 0] + g[:, 1]) + g[:, 2]) + g[:, 3]


def _sum2x2(g: torch.Tensor) -> torch.Tensor:
    """sum over axes (1, 3) of [h, 2, w, 2], left to right in (dy, dx)
    order (XLA's CPU order)."""
    return (((g[:, 0, :, 0] + g[:, 0, :, 1]) + g[:, 1, :, 0])
            + g[:, 1, :, 1])


# ---------------------------------------------------------------------------
# Device twins of the shared MV helpers
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/inter_jax.py:67
def scale_mv_dev(mvx, mvy, tb, td):
    """Vectorized spec 8.5.3.2.8 MV scaling (twin of motion.scale_mv).

    tb, td: int32 tensors or scalars (POC deltas, clipped to [-128, 127]).
    """
    dev = mvx.device
    tb = _i32(tb, dev).clamp(-128, 127)
    td = _i32(td, dev).clamp(-128, 127)
    same = (td == tb) | (td == 0)
    td_safe = torch.where(td == 0, 1, td)
    num = 16384 + td_safe.abs() // 2
    tx = torch.where(td_safe < 0, -(num // td_safe.abs()),
                     num // td_safe.abs())
    dsf = ((tb * tx + 32) >> 6).clamp(-4096, 4095)

    def one(v):
        s = dsf * v
        val = (s.abs() + 127) >> 8
        return torch.where(s >= 0, val, -val).clamp(-32768, 32767)

    return (torch.where(same, mvx, one(mvx)).int(),
            torch.where(same, mvy, one(mvy)).int())


# video_codecs_tpu/models/hevc/inter_jax.py:90
def mvd_bits_dev(dx, dy):
    """Closed-form MVD rate estimate (twin of inter_codec
    mvd_bits_estimate): 2 + per-component [a>0] + 2*max(floor(log2 a), 1)
    for a > 1."""
    def comp(d):
        a = d.int().abs()
        lg = torch.floor(log2_xla(a.clamp(min=1).float())).clamp(
            min=1.0).int()
        return (a > 0).int() + torch.where(a > 1, 2 * lg,
                                           torch.zeros_like(lg))

    return 2 + comp(dx) + comp(dy)


# video_codecs_tpu/models/hevc/inter_jax.py:104
def _shift_grid(field: torch.Tensor, dx: int, dy: int, fill):
    """Neighbor gather on a [bh, bw, ...] grid: value of the block at
    (bx + dx, by + dy), `fill` outside."""
    out = torch.roll(field, shifts=(-dy, -dx), dims=(0, 1))
    bh, bw = field.shape[:2]
    dev = field.device
    ys = torch.arange(bh, device=dev)[:, None] + dy
    xs = torch.arange(bw, device=dev)[None, :] + dx
    inb = (ys >= 0) & (ys < bh) & (xs >= 0) & (xs < bw)
    while inb.ndim < out.ndim:
        inb = inb[..., None]
    return torch.where(inb, out, torch.as_tensor(fill, dtype=out.dtype,
                                                 device=dev))


# video_codecs_tpu/models/hevc/inter_jax.py:117
def _scatter_blocks(plane, vals, xs, ys, n, sel):
    """Masked batched block scatter: the selected blocks' values written
    into a copy of `plane` (the reference drops the unselected lanes out
    of bounds)."""
    out = plane.clone()
    idx = torch.nonzero(sel, as_tuple=True)[0]
    if idx.numel():
        encoder_dev._put_blocks(out, vals[idx], xs[idx], ys[idx], n)
    return out


# video_codecs_tpu/models/hevc/inter_jax.py:125
def _intra_wavefront(yi, ui, vi, intra_grid, intra_modes, planes, cbfs,
                     qp: int, qp_c: int, sbh: bool, rdoq: bool,
                     bw: int, bh: int):
    """Reconstruct the (rare) intra blocks of an inter picture on an
    anti-diagonal wavefront: rec planes already hold the inter recon, so
    each intra block reads decode-order-correct neighbors.

    planes: (rec_y, rec_u, rec_v, coef_y, coef_u, coef_v);
    cbfs: (cbf_y, cbf_u, cbf_v) flat [B] bool with inter blocks filled.
    Returns the updated (planes, cbfs), new tensors.  The intra map is
    read back once; each diagonal d = bx + 2 * by codes only its intra
    blocks, in one batch, and a diagonal without one is skipped (the
    reference's masked lanes write nothing)."""
    grid = intra_grid.cpu().numpy()
    if not grid.any():
        return planes, cbfs
    dev = yi.device
    coords, valid, steps, _ = encoder_dev._wavefront_schedule(bw, bh)
    per_d = [coords[d][valid[d]] for d in range(steps)]
    per_d = [c[grid[c[:, 1], c[:, 0]]] for c in per_d]
    ends = np.cumsum([len(c) for c in per_d])
    sel = torch.from_numpy(np.concatenate(per_d)).to(dev)
    rec_y, rec_u, rec_v, cf_y, cf_u, cf_v = (p.clone() for p in planes)
    cb_y, cb_u, cb_v = (c.clone() for c in cbfs)
    put = encoder_dev._put_blocks
    for d in range(steps):
        if not len(per_d[d]):
            continue
        c = sel[ends[d] - len(per_d[d]):ends[d]]
        bxs, bys = c[:, 0], c[:, 1]
        xs, ys = bxs * 16, bys * 16
        modes = intra_modes[bys.long(), bxs.long()]
        refs_l = encoder_dev.gather_refs(rec_y, xs, ys, 16)
        pr = intra_ops.predict_intra(refs_l, modes[:, None], 4)[:, 0]
        ob = encoder_dev._extract_blocks(yi, xs, ys, 16)
        lv, rec, cb = encoder_dev._code_blocks(ob, pr, qp, 4,
                                               intra_slice=True, sbh=sbh,
                                               rdoq=rdoq)
        put(rec_y, rec, xs, ys, 16)
        put(cf_y, lv, xs, ys, 16)
        tgt = (bys * bw + bxs).long()
        cb_y[tgt] = cb
        cxs, cys = xs // 2, ys // 2
        for orig_p, rec_p, cf_p, cb_p in ((ui, rec_u, cf_u, cb_u),
                                          (vi, rec_v, cf_v, cb_v)):
            refs_c = encoder_dev.gather_refs(rec_p, cxs, cys, 8)
            prc = intra_ops.predict_intra(refs_c, modes[:, None], 3,
                                          is_luma=False)[:, 0]
            oc = encoder_dev._extract_blocks(orig_p, cxs, cys, 8)
            lvc, recc, cbc = encoder_dev._code_blocks(
                oc, prc, qp_c, 3, intra_slice=True, sbh=sbh, rdoq=rdoq)
            put(rec_p, recc, cxs, cys, 8)
            put(cf_p, lvc, cxs, cys, 8)
            cb_p[tgt] = cbc
    return (rec_y, rec_u, rec_v, cf_y, cf_u, cf_v), (cb_y, cb_u, cb_v)


# ---------------------------------------------------------------------------
# The P-frame pipeline (low-delay P toolset)
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/inter_jax.py:192
def encode_p_frame_dev(y, u, v, refs_y, refs_u, refs_v,
                       col_inter, col_mvx, col_mvy, col_refpoc,
                       ref_pocs, poc, col_poc,
                       qp: int, w: int, h: int, n_refs: int,
                       search_range: int, sbh: bool, rdoq: bool,
                       tmvp: bool, me_method: str = "pyr",
                       deblock: bool = True, lam: float | None = None):
    """One P picture, all pixel math on the tensors' device.

    refs_y: [R, H, W] stacked L0 references (newest first, 8-bit samples
    in any integer dtype); col_*: collocated picture motion field (TMVP
    source), [bh, bw]; ref_pocs: [R] int32; poc, col_poc: ints.  Returns
    the reference's dict of field maps + coef/recon planes."""
    dev = y.device
    bw, bh = w // 16, h // 16
    nb = bw * bh
    qp_c = chroma_qp(qp)
    x0 = (torch.arange(bw, dtype=torch.int32, device=dev) * 16).repeat(bh)
    y0 = (torch.arange(bh, dtype=torch.int32, device=dev) *
          16).repeat_interleave(bw)
    yi = y.int()
    refs_y = refs_y.int()
    cur = encoder_dev._extract_blocks(yi, x0, y0, 16)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    sl = math.sqrt(lam)

    # ---- 1. motion search per reference ----
    mvx_r, mvy_r, satd_r = [], [], []
    for r in range(n_refs):
        if me_method == "pyr":
            imx, imy = me_ops.pyramid_search(refs_y[r], cur, x0, y0, 16,
                                             search_range)
            mvx, mvy = imx * 4, imy * 4
            mvx, mvy, _ = me_ops._refine(refs_y[r], cur, x0, y0, mvx, mvy,
                                         16, 2)
            mvx, mvy, satd = me_ops._refine(refs_y[r], cur, x0, y0, mvx,
                                            mvy, 16, 1)
        else:
            mvx, mvy, satd = me_ops.motion_search(
                refs_y[r], cur, x0, y0, 16, search_range, me_method)
        mvx_r.append(mvx)
        mvy_r.append(mvy)
        satd_r.append(satd)
    me_mvx = torch.stack(mvx_r)          # [R, B]
    me_mvy = torch.stack(mvy_r)
    me_satd = torch.stack(satd_r)

    # ---- 2a. explicit-MV candidates: rate vs the left-neighbor predictor
    # (approximation of AMVP; the host recomputes the real predictor) ----
    gx = me_mvx.reshape(n_refs, bh, bw)
    gy = me_mvy.reshape(n_refs, bh, bw)
    zcol = torch.zeros((n_refs, bh, 1), dtype=torch.int32, device=dev)
    pred_x = torch.cat([zcol, gx[:, :, :-1]], dim=2).reshape(n_refs, nb)
    pred_y = torch.cat([zcol, gy[:, :, :-1]], dim=2).reshape(n_refs, nb)
    bits_me = mvd_bits_dev(me_mvx - pred_x, me_mvy - pred_y)
    ref_bias = torch.arange(n_refs, dtype=torch.int32, device=dev)[:, None]
    cost_me_r = me_satd + _round_cost(sl, 4 + ref_bias + bits_me)
    best_r = torch.argmin(cost_me_r, dim=0).int()       # first minimum
    cost_me = cost_me_r.min(dim=0).values
    me_best_mvx = torch.gather(me_mvx, 0, best_r.long()[None])[0]
    me_best_mvy = torch.gather(me_mvy, 0, best_r.long()[None])[0]

    # ---- 2b. merge candidate approximations from the phase-1 field ----
    f_mvx = me_best_mvx.reshape(bh, bw)
    f_mvy = me_best_mvy.reshape(bh, bw)
    f_ref = best_r.reshape(bh, bw)
    by_i = torch.arange(bh, device=dev).repeat_interleave(bw)
    bx_i = torch.arange(bw, device=dev).repeat(bh)
    cands = []                                        # (mvx, mvy, ref, ok)
    for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)):
        cx = _shift_grid(f_mvx, dx, dy, 0).reshape(nb)
        cy = _shift_grid(f_mvy, dx, dy, 0).reshape(nb)
        cr = _shift_grid(f_ref, dx, dy, 0).reshape(nb)
        ys_ = by_i + dy
        xs_ = bx_i + dx
        ok = (ys_ >= 0) & (ys_ < bh) & (xs_ >= 0) & (xs_ < bw) & \
            ((dy < 0) | (dx < 0))
        cands.append((cx, cy, cr, ok))
    if tmvp:
        td = col_poc - col_refpoc.reshape(nb).int()
        tb = poc - int(ref_pocs[0])
        tx_, ty_ = scale_mv_dev(col_mvx.reshape(nb).int(),
                                col_mvy.reshape(nb).int(), tb, td)
        cands.append((tx_, ty_, torch.zeros(nb, dtype=torch.int32,
                                            device=dev),
                      col_inter.reshape(nb).bool()))
    zeros = torch.zeros(nb, dtype=torch.int32, device=dev)
    cands.append((zeros, zeros, zeros,
                  torch.ones(nb, dtype=torch.bool, device=dev)))

    cost_mrg = torch.full((nb,), INF, dtype=torch.int32, device=dev)
    mrg_mvx = mrg_mvy = mrg_ref = zeros
    for idx, (cx, cy, cr, ok) in enumerate(cands):
        pred = interp.mc_luma_multi(refs_y, cr, x0, y0, cx, cy, 16)
        satd = cost_ops.hadamard_satd_8x8(cur, pred)
        c = satd + _round_const(sl * (2 + idx))
        c = torch.where(ok, c, INF)
        better = c < cost_mrg
        cost_mrg = torch.where(better, c, cost_mrg)
        mrg_mvx = torch.where(better, cx, mrg_mvx)
        mrg_mvy = torch.where(better, cy, mrg_mvy)
        mrg_ref = torch.where(better, cr, mrg_ref)

    # ---- 2c. intra candidate (orig-neighbor sweep, like the host path) --
    intra_modes = encoder_dev.decide_modes_device(yi, qp, bw, bh)  # [bh,bw]
    refs_o = encoder_dev.gather_refs(yi, x0, y0, 16)
    pred_i = intra_ops.predict_intra(
        refs_o, intra_modes.reshape(nb)[:, None], 4)[:, 0]
    cost_intra = cost_ops.hadamard_satd_8x8(cur, pred_i) + \
        _round_const(sl * 9)

    # ---- 2d. decision ----
    use_intra = cost_intra <= torch.minimum(cost_mrg, cost_me)
    use_mrg = (~use_intra) & (cost_mrg <= cost_me)
    fin_mvx = torch.where(use_mrg, mrg_mvx, me_best_mvx)
    fin_mvy = torch.where(use_mrg, mrg_mvy, me_best_mvy)
    fin_ref = torch.where(use_mrg, mrg_ref, best_r).int()
    pred_mode = torch.where(use_intra, MODE_INTRA, MODE_INTER).int()

    # ---- 3. final MC + residual coding for inter blocks ----
    pred_y_fin = interp.mc_luma_multi(refs_y, fin_ref, x0, y0,
                                      fin_mvx, fin_mvy, 16)
    rd = "full" if rdoq else False
    lv_y, rec_blk, cbf_y = encoder_dev._code_blocks(
        cur, pred_y_fin, qp, 4, intra_slice=False, sbh=sbh, rdoq=rd,
        lam=lam)

    cx0, cy0 = x0 // 2, y0 // 2
    ui = u.int()
    vi = v.int()
    cur_u = encoder_dev._extract_blocks(ui, cx0, cy0, 8)
    cur_v = encoder_dev._extract_blocks(vi, cx0, cy0, 8)
    pred_u = interp.mc_chroma_multi(refs_u.int(), fin_ref, cx0, cy0,
                                    fin_mvx, fin_mvy, 8)
    pred_v = interp.mc_chroma_multi(refs_v.int(), fin_ref, cx0, cy0,
                                    fin_mvx, fin_mvy, 8)
    lv_u, rec_u_blk, cbf_u = encoder_dev._code_blocks(
        cur_u, pred_u, qp_c, 3, intra_slice=False, sbh=sbh, rdoq=rd,
        is_luma=False, lam=lam)
    lv_v, rec_v_blk, cbf_v = encoder_dev._code_blocks(
        cur_v, pred_v, qp_c, 3, intra_slice=False, sbh=sbh, rdoq=rd,
        is_luma=False, lam=lam)

    # scatter inter recon + coefficients into planes
    is_inter = pred_mode == MODE_INTER

    def plane0(hh, ww):
        return torch.zeros((hh, ww), dtype=torch.int32, device=dev)

    rec_y_pl = _scatter_blocks(plane0(h, w), rec_blk, x0, y0, 16, is_inter)
    rec_u_pl = _scatter_blocks(plane0(h // 2, w // 2), rec_u_blk, cx0, cy0,
                               8, is_inter)
    rec_v_pl = _scatter_blocks(plane0(h // 2, w // 2), rec_v_blk, cx0, cy0,
                               8, is_inter)
    coef_y = _scatter_blocks(plane0(h, w), lv_y, x0, y0, 16, is_inter)
    coef_u = _scatter_blocks(plane0(h // 2, w // 2), lv_u, cx0, cy0, 8,
                             is_inter)
    coef_v = _scatter_blocks(plane0(h // 2, w // 2), lv_v, cx0, cy0, 8,
                             is_inter)

    # ---- 4. intra blocks: wavefront recon (neighbor-dependent); the
    # reference inlines _intra_wavefront's body here ----
    planes, cbfs = _intra_wavefront(
        yi, ui, vi, use_intra.reshape(bh, bw), intra_modes,
        (rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v),
        (cbf_y & is_inter, cbf_u & is_inter, cbf_v & is_inter),
        qp, qp_c, sbh, rdoq, bw, bh)
    rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v = planes
    cbf_y, cbf_u, cbf_v = cbfs

    # ---- 5. deblock with BS maps (twin of inter_codec.compute_bs_maps) --
    pm = pred_mode.reshape(bh, bw)
    cby = cbf_y.reshape(bh, bw)
    mx = fin_mvx.reshape(bh, bw)
    my = fin_mvy.reshape(bh, bw)
    rpoc = ref_pocs.to(dev).int()[fin_ref.long()].reshape(bh, bw)

    def bs_pair(a_intra, b_intra, a_cbf, b_cbf, amx, bmx, amy, bmy,
                arp, brp):
        intra2 = a_intra | b_intra
        one = a_cbf | b_cbf | (arp != brp) | ((amx - bmx).abs() >= 4) | \
            ((amy - bmy).abs() >= 4)
        return torch.where(intra2, 2, torch.where(one, 1, 0)).int()

    ii = pm == MODE_INTRA
    bs_ver = bs_pair(ii[:, :-1], ii[:, 1:], cby[:, :-1], cby[:, 1:],
                     mx[:, :-1], mx[:, 1:], my[:, :-1], my[:, 1:],
                     rpoc[:, :-1], rpoc[:, 1:]).T
    bs_hor = bs_pair(ii[:-1, :], ii[1:, :], cby[:-1, :], cby[1:, :],
                     mx[:-1, :], mx[1:, :], my[:-1, :], my[1:, :],
                     rpoc[:-1, :], rpoc[1:, :])
    if deblock:
        rec_y_pl, rec_u_pl, rec_v_pl = deblock_ops.deblock_420_bs(
            rec_y_pl, rec_u_pl, rec_v_pl, qp, bs_ver, bs_hor, block=16)

    def i16(c):
        return c.clamp(-32768, 32767).to(torch.int16)

    return dict(
        pred_mode=pred_mode.reshape(bh, bw).to(torch.int8),
        intra_mode=intra_modes.to(torch.int8),
        mvx=fin_mvx.reshape(bh, bw),
        mvy=fin_mvy.reshape(bh, bw),
        ref_idx=fin_ref.reshape(bh, bw).to(torch.int8),
        cbf_y=cbf_y.reshape(bh, bw),
        cbf_cb=cbf_u.reshape(bh, bw),
        cbf_cr=cbf_v.reshape(bh, bw),
        coef_y=i16(coef_y),
        coef_u=i16(coef_u),
        coef_v=i16(coef_v),
        rec_y=rec_y_pl.to(torch.uint8),
        rec_u=rec_u_pl.to(torch.uint8),
        rec_v=rec_v_pl.to(torch.uint8),
    )


# ---------------------------------------------------------------------------
# The B-frame pipeline (hierarchical-B / RA toolset)
# ---------------------------------------------------------------------------

def bs_maps_b_dev(pm, cby, dirg, m0x, m0y, m1x, m1y):
    """Deblocking BS maps of the flat B path from the final per-16
    fields ([bh, bw] each): the reference's inline twin of
    bframe_codec._bs_maps_b (inter_jax.py:1127-1151).  Returns (bs_ver
    [bw - 1, bh], bs_hor [bh - 1, bw]) as int32 tensors."""
    intra = pm == MODE_INTRA

    def bs_pair(sl_a, sl_b):
        intra2 = intra[sl_a] | intra[sl_b]
        da = dirg[sl_a]
        diff_dir = da != dirg[sl_b]
        d0 = ((m0x[sl_a] - m0x[sl_b]).abs() >= 4) | \
            ((m0y[sl_a] - m0y[sl_b]).abs() >= 4)
        d1 = ((m1x[sl_a] - m1x[sl_b]).abs() >= 4) | \
            ((m1y[sl_a] - m1y[sl_b]).abs() >= 4)
        use0 = (da & 1) > 0
        mv_diff = torch.where(da == 3, d0 | d1, torch.where(use0, d0, d1))
        one = cby[sl_a] | cby[sl_b] | diff_dir | mv_diff
        return torch.where(intra2, 2, torch.where(one, 1, 0)).int()

    bs_ver = bs_pair(np.s_[:, :-1], np.s_[:, 1:]).T
    bs_hor = bs_pair(np.s_[:-1, :], np.s_[1:, :])
    return bs_ver, bs_hor


# video_codecs_tpu/models/hevc/inter_jax.py:462
def b_me_one(ref_y, cur, x0, y0, search_range: int, me_method: str,
             n: int = 16):
    """Per-list ME of one B picture against one reference: integer search
    (the pyramid, or `me_ops.motion_search`'s full / TZ / auto) +
    half/quarter SATD refinement.

    Returns quarter-pel (mvx, mvy, satd), each [B]."""
    if me_method == "pyr":
        imx, imy = me_ops.pyramid_search(ref_y, cur, x0, y0, n,
                                         search_range)
        mvx, mvy = imx * 4, imy * 4
        mvx, mvy, _ = me_ops._refine(ref_y, cur, x0, y0, mvx, mvy, n, 2)
        return me_ops._refine(ref_y, cur, x0, y0, mvx, mvy, n, 1)
    return me_ops.motion_search(ref_y, cur, x0, y0, n, search_range,
                                me_method)


def _to4(a, n):
    """[G, 2n, 2n] -> [4G, n, n] quadrants in z order."""
    g = a.shape[0]
    return (a.reshape(g, 2, n, 2, n).permute(0, 1, 3, 2, 4)
            .reshape(g * 4, n, n))


def _from4(a, n):
    """[4G, n, n] quadrants in z order -> [G, 2n, 2n]."""
    g = a.shape[0] // 4
    return (a.reshape(g, 2, 2, n, n).permute(0, 1, 3, 2, 4)
            .reshape(g, 2 * n, 2 * n))


def _ssef(a, b):
    """Float32 SSE over the trailing two dims (integer-valued, exact)."""
    d = (a - b).int()
    return (d * d).sum((-2, -1), dtype=torch.int32).float()


# video_codecs_tpu/models/hevc/inter_jax.py:479
def encode_b_frame_dev(y, u, v, ref0_y, ref0_u, ref0_v,
                       ref1_y, ref1_u, ref1_v,
                       qp: int, w: int, h: int, has_l1: bool,
                       search_range: int, sbh: bool, rdoq: bool,
                       me_method: str = "pyr", deblock: bool = True,
                       me_fields=None, allow_intra: bool = True,
                       merge_eval: str = "first",
                       lam: float | None = None, rqt: bool = False,
                       cu8: bool = False,
                       gx_blk0=None, pic_bw=None, tmvp_fields=None,
                       no_backward: bool = False):
    """One B (or anchor P) picture of the RA toolset, all pixel math on
    the tensors' device.  Reference planes are [R, H, W] stacks (ME per
    list and reference; the cheapest reference wins per block) or 2-D
    planes (one reference per list).  Returns the reference's dict of
    per-16 decisions, per-8 CU8 fields, levels and reconstruction.

    merge_eval "first" is the flat path's single merge candidate (the
    first available neighbour A1/B1, else zero MVs), "best4" the CTB32
    path's merge-5 approximation; allow_intra adds the intra candidate
    (its blocks coded on the wavefront); deblock filters the recon with
    the BS maps of the final motion field at block 16.

    For a halo-padded tile of a larger picture (parallel/sharded.py):
    me_fields, [(mvx, mvy, satd)] per list, replaces reference 0's ME;
    gx_blk0 is the picture's 16-block column of local column 0 and pic_bw
    the picture's width in 16-blocks, so the left MV predictors (per 16
    and per 8) and the merge neighbours follow the picture's edges, not
    the tile's."""
    if merge_eval not in ("first", "best4"):
        raise ValueError(
            f"encode_b_frame_dev: merge_eval={merge_eval!r} is not one of "
            "'first', 'best4'")
    dev = y.device
    bw, bh = w // 16, h // 16
    nb = bw * bh
    qp_c = chroma_qp(qp)
    x0 = (torch.arange(bw, dtype=torch.int32, device=dev) * 16).repeat(bh)
    y0 = (torch.arange(bh, dtype=torch.int32, device=dev) *
          16).repeat_interleave(bw)
    yi = y.int()
    ui = u.int()
    vi = v.int()
    cur = encoder_dev._extract_blocks(yi, x0, y0, 16)
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    sl = math.sqrt(lam)
    lamf = torch.tensor(lam, dtype=torch.float32, device=dev)
    n_lists = 2 if has_l1 else 1

    def stack3(p):
        p = p.int()
        return p[None] if p.ndim == 2 else p

    refs_y = [stack3(ref0_y), stack3(ref1_y)]
    refs_u = [stack3(ref0_u), stack3(ref1_u)]
    refs_v = [stack3(ref0_v), stack3(ref1_v)]
    nrefs = [refs_y[0].shape[0], refs_y[1].shape[0]]
    zcol = torch.zeros((bh, 1), dtype=torch.int32, device=dev)
    by_i = torch.arange(bh, device=dev).repeat_interleave(bw)
    bx_i = torch.arange(bw, device=dev).repeat(bh)

    # ---- ME per (list, ref); per-block best ref by cost ----
    mvs, satds, bits, ridxs = [], [], [], []
    for lx in range(n_lists):
        cand = []
        for r in range(nrefs[lx]):
            if me_fields is not None and r == 0:
                mvx, mvy, satd = me_fields[lx]
            else:
                mvx, mvy, satd = b_me_one(refs_y[lx][r], cur, x0, y0,
                                          search_range, me_method)
            gx = mvx.reshape(bh, bw)
            gy = mvy.reshape(bh, bw)
            px = torch.cat([zcol, gx[:, :-1]], dim=1).reshape(nb)
            py = torch.cat([zcol, gy[:, :-1]], dim=1).reshape(nb)
            if gx_blk0 is not None:
                gcol = int(gx_blk0) + bx_i
                px = torch.where(gcol == 0, 0, px)
                py = torch.where(gcol == 0, 0, py)
            b = mvd_bits_dev(mvx - px, mvy - py) + (r + 1 if
                                                   nrefs[lx] > 1 else 0)
            cand.append((mvx, mvy, satd, b,
                         satd + _round_cost(sl, 7 + b)))
        best = cand[0]
        ridx = torch.zeros(nb, dtype=torch.int32, device=dev)
        for r in range(1, nrefs[lx]):
            better = cand[r][4] < best[4]
            best = tuple(torch.where(better, n_, o_)
                         for n_, o_ in zip(cand[r], best))
            ridx = torch.where(better, r, ridx)
        mvs.append((best[0], best[1]))
        satds.append(best[2])
        bits.append(best[3])
        ridxs.append(ridx)

    cost_uni = [satds[lx] + _round_cost(sl, 7 + bits[lx])
                for lx in range(n_lists)]

    # bi hypothesis from the two best-uni MVs, then ONE alternating
    # refinement round per list (TEncSearch.cpp:3567, one pass)
    if has_l1:
        p0_14 = interp.mc_luma14_multi(refs_y[0], ridxs[0],
                                       x0, y0, mvs[0][0], mvs[0][1], 16)

        def bi_refine(fix14, refs_l, ridx_l, mvx, mvy):
            best = cost_ops.hadamard_satd_8x8(
                cur, interp.bi_average(
                    fix14, interp.mc_luma14_multi(
                        refs_l, ridx_l, x0, y0, mvx, mvy, 16)))
            for k in range(8):
                cx_ = mvx + int(me_ops._OFFS8[k][0])
                cy_ = mvy + int(me_ops._OFFS8[k][1])
                satd = cost_ops.hadamard_satd_8x8(
                    cur, interp.bi_average(
                        fix14, interp.mc_luma14_multi(
                            refs_l, ridx_l, x0, y0, cx_, cy_, 16)))
                better = satd < best
                best = torch.where(better, satd, best)
                mvx = torch.where(better, cx_, mvx)
                mvy = torch.where(better, cy_, mvy)
            return mvx, mvy, best

        b1x, b1y, _ = bi_refine(p0_14, refs_y[1], ridxs[1],
                                mvs[1][0], mvs[1][1])
        p1r_14 = interp.mc_luma14_multi(refs_y[1], ridxs[1], x0, y0,
                                        b1x, b1y, 16)
        b0x, b0y, satd_bi = bi_refine(p1r_14, refs_y[0], ridxs[0],
                                      mvs[0][0], mvs[0][1])
        cost_bi = satd_bi + _round_cost(sl, 8 + bits[0] + bits[1])
        mvs_bi = ((b0x, b0y), (b1x, b1y))
    else:
        cost_bi = torch.full((nb,), INF, dtype=torch.int32, device=dev)
        mvs_bi = None

    # provisional field = best explicit hypothesis (for merge approx)
    zr = torch.zeros(nb, dtype=torch.int32, device=dev)
    if has_l1:
        best_uni_is0 = cost_uni[0] <= cost_uni[1]
        cost_uni_min = torch.minimum(cost_uni[0], cost_uni[1])
        prov_dir = torch.where(cost_bi < cost_uni_min, 3,
                               torch.where(best_uni_is0, 1, 2)).int()
        cost_expl = torch.minimum(cost_bi, cost_uni_min)
        is_bi = prov_dir == 3
        prov_mv0x = torch.where(is_bi, mvs_bi[0][0], mvs[0][0])
        prov_mv0y = torch.where(is_bi, mvs_bi[0][1], mvs[0][1])
        prov_mv1x = torch.where(is_bi, mvs_bi[1][0], mvs[1][0])
        prov_mv1y = torch.where(is_bi, mvs_bi[1][1], mvs[1][1])
        prov_r0 = ridxs[0]
        prov_r1 = ridxs[1]
    else:
        prov_dir = torch.ones(nb, dtype=torch.int32, device=dev)
        cost_expl = cost_uni[0]
        prov_mv0x, prov_mv0y = mvs[0]
        prov_r0 = ridxs[0]
        prov_mv1x = prov_mv1y = zr
        prov_r1 = zr

    # ---- merge approximation: twin of derive_merge ("first", flat path:
    # the host codes a single candidate, so only the first available
    # neighbour A1/B1 is codeable) or of the merge-5 list ("best4", qt
    # path: A1/B1/B0/B2 [+ TMVP] + zero with their merge_idx rates; the
    # host re-derives the spec list per PU and codes the real index) ----
    def grid(a):
        return a.reshape(bh, bw)

    fb_dir = 3 if has_l1 else 1

    def uni(q):
        return ((q + 32) >> 6).clamp(0, 255)

    def mrg_pred(dirs, m0x, m0y, m1x, m1y, r0, r1):
        p0 = interp.mc_luma14_multi(refs_y[0], r0, x0, y0, m0x, m0y, 16)
        if not has_l1:
            return uni(p0).int()
        p1 = interp.mc_luma14_multi(refs_y[1], r1, x0, y0, m1x, m1y, 16)
        return torch.where(
            (dirs == 3)[:, None, None], interp.bi_average(p0, p1),
            torch.where((dirs == 1)[:, None, None], uni(p0),
                        uni(p1))).int()

    if merge_eval == "best4":
        mcands = []
        for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)):
            ys_ = by_i + dy
            xs_ = bx_i + dx
            if gx_blk0 is not None:
                gxs = int(gx_blk0) + xs_
                ok = (ys_ >= 0) & (ys_ < bh) & (gxs >= 0) & \
                    (gxs < int(pic_bw)) & ((dy < 0) | (dx < 0))
            else:
                ok = (ys_ >= 0) & (ys_ < bh) & (xs_ >= 0) & (xs_ < bw) & \
                    ((dy < 0) | (dx < 0))
            mcands.append(tuple(
                _shift_grid(grid(f), dx, dy, fill).reshape(nb)
                for f, fill in ((prov_dir, fb_dir), (prov_mv0x, 0),
                                (prov_mv0y, 0), (prov_mv1x, 0),
                                (prov_mv1y, 0), (prov_r0, 0),
                                (prov_r1, 0))) + (ok,))
        if tmvp_fields is not None:
            # temporal candidate approximation (spec 8.5.3.2.8-9 via the
            # compressed 16x16 collocated field): bottom-right col block
            # when inside the picture and the same CTB row, else center; MV
            # from the selected col list scaled to refIdx 0
            (cinter, c0x_, c0y_, c1x_, c1y_, cpf0, cpf1, crp0, crp1,
             cpoc, curpoc, tp0, tp1) = tmvp_fields
            cinter = cinter.reshape(nb)
            c0x_, c0y_ = c0x_.reshape(nb), c0y_.reshape(nb)
            c1x_, c1y_ = c1x_.reshape(nb), c1y_.reshape(nb)
            cpf0, cpf1 = cpf0.reshape(nb), cpf1.reshape(nb)
            crp0, crp1 = crp0.reshape(nb), crp1.reshape(nb)
            use_br = ((bx_i + 1 < bw) & (by_i + 1 < bh) & ((by_i % 2) == 0) &
                      _shift_grid(grid(cinter), 1, 1, False).reshape(nb))

            def pick(f, fill=0):
                shifted = _shift_grid(grid(f), 1, 1, fill).reshape(nb)
                return torch.where(use_br, shifted, f)

            a_int = pick(cinter, False)
            a0x, a0y = pick(c0x_), pick(c0y_)
            a1x, a1y = pick(c1x_), pick(c1y_)
            a_pf0, a_pf1 = pick(cpf0, False), pick(cpf1, False)
            a_rp0, a_rp1 = pick(crp0), pick(crp1)
            # listCol: L1 if col has no L0, L0 if no L1; else the
            # no-backward/collocated_from_l0 rule (col list 1 here)
            tmv = []
            for lx, tpoc in ((0, tp0), (1, tp1)):
                fixed_col = lx if no_backward else 0  # col_from_l0=0
                lcol = torch.where(~a_pf0, 1, torch.where(~a_pf1, 0,
                                                          fixed_col))
                cmx = torch.where(lcol == 0, a0x, a1x)
                cmy = torch.where(lcol == 0, a0y, a1y)
                crp = torch.where(lcol == 0, a_rp0, a_rp1)
                sx, sy = scale_mv_dev(cmx, cmy, _i32(curpoc, dev) -
                                      _i32(tpoc, dev), _i32(cpoc, dev) - crp)
                tmv.append((sx, sy))
            t_dir = torch.where(a_int, fb_dir, 0).int()
            mcands.append((t_dir, tmv[0][0], tmv[0][1],
                           tmv[1][0], tmv[1][1], zr, zr,
                           a_int & (t_dir > 0)))
        mcands.append((torch.full((nb,), fb_dir, dtype=torch.int32,
                                  device=dev), zr, zr, zr, zr, zr, zr,
                       torch.ones(nb, dtype=torch.bool, device=dev)))
        cost_mrg = torch.full((nb,), INF, dtype=torch.int32, device=dev)
        mrg_dir = torch.full((nb,), fb_dir, dtype=torch.int32, device=dev)
        mrg_mv0x = mrg_mv0y = mrg_mv1x = mrg_mv1y = zr
        mrg_r0 = mrg_r1 = zr
        for idx, (cd, c0x, c0y, c1x, c1y, cr0, cr1, ok) in \
                enumerate(mcands):
            pred = mrg_pred(cd, c0x, c0y, c1x, c1y, cr0, cr1)
            c = cost_ops.hadamard_satd_8x8(cur, pred) + _round_const(
                sl * (2 + idx))
            c = torch.where(ok, c, INF)
            better = c < cost_mrg
            cost_mrg = torch.where(better, c, cost_mrg)
            mrg_dir = torch.where(better, cd, mrg_dir)
            mrg_mv0x = torch.where(better, c0x, mrg_mv0x)
            mrg_mv0y = torch.where(better, c0y, mrg_mv0y)
            mrg_mv1x = torch.where(better, c1x, mrg_mv1x)
            mrg_mv1y = torch.where(better, c1y, mrg_mv1y)
            mrg_r0 = torch.where(better, cr0, mrg_r0)
            mrg_r1 = torch.where(better, cr1, mrg_r1)
    else:
        def pick(field, fallback):
            left = _shift_grid(grid(field), -1, 0, 0)
            above = _shift_grid(grid(field), 0, -1, 0)
            out = torch.where(grid(bx_i) > 0, left,
                              torch.where(grid(by_i) > 0, above, fallback))
            return out.reshape(nb)

        # fallback blocks carry zero MVs
        is_fb = (bx_i == 0) & (by_i == 0)

        def pick0(field):
            return torch.where(is_fb, 0, pick(field, 0))

        mrg_dir = torch.where(is_fb, fb_dir, pick(prov_dir, fb_dir)).int()
        mrg_mv0x = pick0(prov_mv0x)
        mrg_mv0y = pick0(prov_mv0y)
        mrg_mv1x = pick0(prov_mv1x)
        mrg_mv1y = pick0(prov_mv1y)
        mrg_r0 = pick0(prov_r0)
        mrg_r1 = pick0(prov_r1)
        pred_mrg = mrg_pred(mrg_dir, mrg_mv0x, mrg_mv0y, mrg_mv1x,
                            mrg_mv1y, mrg_r0, mrg_r1)
        cost_mrg = cost_ops.hadamard_satd_8x8(cur, pred_mrg) + \
            _round_const(sl * 2)

    # ---- intra candidate (orig-neighbour sweep); without allow_intra
    # (the CTB32 qt path: z-scan intra availability) the modes are only
    # an output and the candidate never wins ----
    intra_modes = encoder_dev.decide_modes_device(yi, qp, bw, bh)
    if allow_intra:
        refs_o = encoder_dev.gather_refs(yi, x0, y0, 16)
        pred_i = intra_ops.predict_intra(
            refs_o, intra_modes.reshape(nb)[:, None], 4)[:, 0]
        cost_intra = cost_ops.hadamard_satd_8x8(cur, pred_i) + \
            _round_const(sl * 9)
    else:
        cost_intra = torch.full((nb,), INF, dtype=torch.int32, device=dev)

    # ---- decision (host tie-break order) ----
    use_intra = cost_intra <= torch.minimum(cost_mrg, cost_expl)
    use_mrg = (~use_intra) & (cost_mrg <= cost_expl)
    fin_dir = torch.where(use_mrg, mrg_dir, prov_dir)
    fin_mv0x = torch.where(use_mrg, mrg_mv0x, prov_mv0x)
    fin_mv0y = torch.where(use_mrg, mrg_mv0y, prov_mv0y)
    fin_mv1x = torch.where(use_mrg, mrg_mv1x, prov_mv1x)
    fin_mv1y = torch.where(use_mrg, mrg_mv1y, prov_mv1y)
    fin_r0 = torch.where(use_mrg, mrg_r0, prov_r0)
    fin_r1 = torch.where(use_mrg, mrg_r1, prov_r1)
    pred_mode = torch.where(use_intra, MODE_INTRA, MODE_INTER).int()

    # ---- final MC + residual ----
    def final_pred(refs0, refs1, xs, ys, n, mv0, mv1, mc14):
        q0 = mc14(refs0, fin_r0, xs, ys, mv0[0], mv0[1], n)
        if has_l1:
            q1 = mc14(refs1, fin_r1, xs, ys, mv1[0], mv1[1], n)
            return torch.where(
                (fin_dir == 3)[:, None, None], interp.bi_average(q0, q1),
                torch.where((fin_dir == 1)[:, None, None], uni(q0),
                            uni(q1))).int()
        return uni(q0).int()

    pred_y_fin = final_pred(refs_y[0], refs_y[1] if has_l1 else refs_y[0],
                            x0, y0, 16, (fin_mv0x, fin_mv0y),
                            (fin_mv1x, fin_mv1y), interp.mc_luma14_multi)
    rd = "full" if rdoq else rdoq
    lv_y, rec_blk, cbf_y, bits_y = encoder_dev._code_blocks_rate(
        cur, pred_y_fin, qp, 4, sbh=sbh, rdoq=rd, lam=lam)

    cx0, cy0 = x0 // 2, y0 // 2
    cur_u = encoder_dev._extract_blocks(ui, cx0, cy0, 8)
    cur_v = encoder_dev._extract_blocks(vi, cx0, cy0, 8)
    r0u, r0v = refs_u[0], refs_v[0]
    r1u, r1v = refs_u[1], refs_v[1]
    pred_u = final_pred(r0u, r1u, cx0, cy0, 8, (fin_mv0x, fin_mv0y),
                        (fin_mv1x, fin_mv1y), interp.mc_chroma14_multi)
    pred_v = final_pred(r0v, r1v, cx0, cy0, 8, (fin_mv0x, fin_mv0y),
                        (fin_mv1x, fin_mv1y), interp.mc_chroma14_multi)
    lv_u, rec_u_blk, cbf_u, bits_u = encoder_dev._code_blocks_rate(
        cur_u, pred_u, qp_c, 3, sbh=sbh, rdoq=rd, is_luma=False, lam=lam)
    lv_v, rec_v_blk, cbf_v, bits_v = encoder_dev._code_blocks_rate(
        cur_v, pred_v, qp_c, 3, sbh=sbh, rdoq=rd, is_luma=False, lam=lam)
    bits_yuv = (bits_y + bits_u) + bits_v
    coef_bits = bits_yuv.reshape(bh, bw)
    tusplit = torch.zeros(nb, dtype=torch.bool, device=dev)
    zb8 = torch.zeros((2 * bh, 2 * bw), dtype=torch.bool, device=dev)
    cbf_y8 = cbf_cb4 = cbf_cr4 = zb8

    def submap(c4):
        """[nb*4] z-order sub-block flags -> the raster 8 grid."""
        return (c4.reshape(bh, bw, 2, 2).permute(0, 2, 1, 3)
                .reshape(2 * bh, 2 * bw))

    if rqt:
        # ---- encoder-side RQT depth 1: TU16 -> 4x TU8 (luma) with 4x4
        # chroma, the RD-cheaper transform tree per block
        # (TEncSearch xEstimateInterResidualQT) ----
        lv8, rec8, cbf8, b8 = encoder_dev._code_blocks_rate(
            _to4(cur, 8), _to4(pred_y_fin, 8), qp, 3, sbh=sbh, rdoq=rd,
            lam=lam)
        lv4u, rec4u, cbf4u, b4u = encoder_dev._code_blocks_rate(
            _to4(cur_u, 4), _to4(pred_u, 4), qp_c, 2, sbh=sbh, rdoq=rd,
            is_luma=False, lam=lam)
        lv4v, rec4v, cbf4v, b4v = encoder_dev._code_blocks_rate(
            _to4(cur_v, 4), _to4(pred_v, 4), qp_c, 2, sbh=sbh, rdoq=rd,
            is_luma=False, lam=lam)

        d16 = (_ssef(cur, rec_blk) + _ssef(cur_u, rec_u_blk)) + \
            _ssef(cur_v, rec_v_blk)
        d8 = _persum((_ssef(_to4(cur, 8), rec8) +
                      _ssef(_to4(cur_u, 4), rec4u)) +
                     _ssef(_to4(cur_v, 4), rec4v))
        # split overhead: ~6 extra cbf/split bins vs the unsplit tree
        j16 = fma32(bits_yuv + 1.0, lamf, d16)
        split_bits = (_persum(b8) + _persum(b4u)) + _persum(b4v)
        j8 = fma32(split_bits + 7.0, lamf, d8)
        tusplit = (j8 < j16) & (pred_mode == MODE_INTER)

        sel = tusplit[:, None, None]
        lv_y = torch.where(sel, _from4(lv8, 8), lv_y)
        rec_blk = torch.where(sel, _from4(rec8, 8), rec_blk)
        lv_u = torch.where(sel, _from4(lv4u, 4), lv_u)
        rec_u_blk = torch.where(sel, _from4(rec4u, 4), rec_u_blk)
        lv_v = torch.where(sel, _from4(lv4v, 4), lv_v)
        rec_v_blk = torch.where(sel, _from4(rec4v, 4), rec_v_blk)
        cbf_y = torch.where(tusplit, cbf8.reshape(-1, 4).any(1), cbf_y)
        cbf_u = torch.where(tusplit, cbf4u.reshape(-1, 4).any(1), cbf_u)
        cbf_v = torch.where(tusplit, cbf4v.reshape(-1, 4).any(1), cbf_v)
        coef_bits = torch.where(tusplit, split_bits,
                                bits_yuv).reshape(bh, bw)
        cbf_y8 = submap(cbf8)
        cbf_cb4 = submap(cbf4u)
        cbf_cr4 = submap(cbf4v)

    # ---- CU8 split: each 16x16 may split into 4 CU8s with their own
    # motion (TEncCu xCompressCU depth recursion to 8x8): per-8 ME/bi
    # hypothesis, TU8 + 4x4-chroma residual with exact RDOQ rates, then
    # J(4 children + split overhead) vs J(single 16 PU) ----
    split8 = torch.zeros(nb, dtype=torch.bool, device=dev)
    bw8, bh8 = 2 * bw, 2 * bh
    nb8 = bw8 * bh8
    z8 = torch.zeros((bh8, bw8), dtype=torch.int32, device=dev)
    dir8_m = mv0x8_m = mv0y8_m = mv1x8_m = mv1y8_m = r0_8m = r1_8m = z8
    if cu8:
        x8 = (torch.arange(bw8, dtype=torch.int32, device=dev) *
              8).repeat(bh8)
        y8 = (torch.arange(bh8, dtype=torch.int32, device=dev) *
              8).repeat_interleave(bw8)
        cur8 = encoder_dev._extract_blocks(yi, x8, y8, 8)
        zcol8 = torch.zeros((bh8, 1), dtype=torch.int32, device=dev)
        mvs8, bits8, ridxs8 = [], [], []
        cost_uni8 = []
        for lx in range(n_lists):
            cand8 = []
            for r in range(nrefs[lx]):
                m8x, m8y, s8 = b_me_one(refs_y[lx][r], cur8, x8, y8,
                                        search_range, me_method, n=8)
                g8x = m8x.reshape(bh8, bw8)
                g8y = m8y.reshape(bh8, bw8)
                p8x = torch.cat([zcol8, g8x[:, :-1]], dim=1).reshape(nb8)
                p8y = torch.cat([zcol8, g8y[:, :-1]], dim=1).reshape(nb8)
                if gx_blk0 is not None:
                    gcol8 = 2 * int(gx_blk0) + torch.arange(
                        bw8, device=dev).repeat(bh8)
                    p8x = torch.where(gcol8 == 0, 0, p8x)
                    p8y = torch.where(gcol8 == 0, 0, p8y)
                b8_ = mvd_bits_dev(m8x - p8x, m8y - p8y) + \
                    (r + 1 if nrefs[lx] > 1 else 0)
                cand8.append((m8x, m8y, s8, b8_,
                              s8 + _round_cost(sl, 5 + b8_)))
            best8 = cand8[0]
            ridx8 = torch.zeros(nb8, dtype=torch.int32, device=dev)
            for r in range(1, nrefs[lx]):
                better = cand8[r][4] < best8[4]
                best8 = tuple(torch.where(better, n_, o_)
                              for n_, o_ in zip(cand8[r], best8))
                ridx8 = torch.where(better, r, ridx8)
            mvs8.append((best8[0], best8[1]))
            bits8.append(best8[3])
            ridxs8.append(ridx8)
            cost_uni8.append(best8[4])
        zr8 = torch.zeros(nb8, dtype=torch.int32, device=dev)
        if has_l1:
            q0 = interp.mc_luma14_multi(refs_y[0], ridxs8[0], x8, y8,
                                        mvs8[0][0], mvs8[0][1], 8)
            q1 = interp.mc_luma14_multi(refs_y[1], ridxs8[1], x8, y8,
                                        mvs8[1][0], mvs8[1][1], 8)
            cost_bi8 = cost_ops.hadamard_satd_8x8(
                cur8, interp.bi_average(q0, q1)) + _round_cost(
                sl, 6 + bits8[0] + bits8[1])
            uni0 = cost_uni8[0] <= cost_uni8[1]
            uni_min = torch.minimum(cost_uni8[0], cost_uni8[1])
            dir8 = torch.where(cost_bi8 < uni_min, 3,
                               torch.where(uni0, 1, 2)).int()
            mvr8 = torch.where(dir8 == 3, bits8[0] + bits8[1] + 6,
                               torch.where(dir8 == 1, bits8[0],
                                           bits8[1]) + 5)
            m1x8, m1y8 = mvs8[1]
        else:
            dir8 = torch.ones(nb8, dtype=torch.int32, device=dev)
            mvr8 = bits8[0] + 5
            m1x8 = m1y8 = zr8
        m0x8, m0y8 = mvs8[0]

        r0_8 = ridxs8[0]
        r1_8 = ridxs8[1] if has_l1 else zr8

        def pred8(refs, xs, ys, n, mv0, mv1, mc14):
            q0 = mc14(refs[0], r0_8, xs, ys, mv0[0], mv0[1], n)
            if not has_l1:
                return uni(q0).int()
            q1 = mc14(refs[1], r1_8, xs, ys, mv1[0], mv1[1], n)
            return torch.where(
                (dir8 == 3)[:, None, None], interp.bi_average(q0, q1),
                torch.where((dir8 == 1)[:, None, None], uni(q0),
                            uni(q1))).int()

        pred8_y = pred8(refs_y, x8, y8, 8, (m0x8, m0y8), (m1x8, m1y8),
                        interp.mc_luma14_multi)
        cx8, cy8 = x8 // 2, y8 // 2
        cur4u = encoder_dev._extract_blocks(ui, cx8, cy8, 4)
        cur4v = encoder_dev._extract_blocks(vi, cx8, cy8, 4)
        pred4u = pred8((r0u, r1u), cx8, cy8, 4, (m0x8, m0y8),
                       (m1x8, m1y8), interp.mc_chroma14_multi)
        pred4v = pred8((r0v, r1v), cx8, cy8, 4, (m0x8, m0y8),
                       (m1x8, m1y8), interp.mc_chroma14_multi)
        lv8y, rec8y, cbf8y, rb8y = encoder_dev._code_blocks_rate(
            cur8, pred8_y, qp, 3, sbh=sbh, rdoq=rd, lam=lam)
        lv4u8, rec4u8, cbf4u8, rb4u = encoder_dev._code_blocks_rate(
            cur4u, pred4u, qp_c, 2, sbh=sbh, rdoq=rd, is_luma=False,
            lam=lam)
        lv4v8, rec4v8, cbf4v8, rb4v = encoder_dev._code_blocks_rate(
            cur4v, pred4v, qp_c, 2, sbh=sbh, rdoq=rd, is_luma=False,
            lam=lam)

        d8 = (_ssef(cur8, rec8y) + _ssef(cur4u, rec4u8)) + \
            _ssef(cur4v, rec4v8)
        # per-CU8 syntax: skip/pred/part/merge + cbf bins ~ 7
        rb8 = (rb8y + rb4u) + rb4v
        j8 = fma32((rb8 + mvr8.float()) + 7.0, lamf, d8)

        def sum16(a8):
            """[bh8*bw8] child values -> per-16 sums [nb]."""
            return _sum2x2(a8.reshape(bh, 2, bw, 2)).reshape(nb)

        # J of the single-PU 16 alternative: coded distortion + coef
        # rate + its mv/mode rate
        d16f = (_ssef(cur, rec_blk) + _ssef(cur_u, rec_u_blk)) + \
            _ssef(cur_v, rec_v_blk)
        if has_l1:
            rate16 = torch.where(
                fin_dir == 3, (bits[0] + bits[1] + 8).float(),
                (torch.where(fin_dir == 1, bits[0], bits[1]) + 7).float())
        else:
            rate16 = (bits[0] + 7).float()
        rate16 = torch.where(use_mrg, 4.0, rate16)
        j16 = fma32((coef_bits.reshape(nb) + rate16) + 5.0, lamf, d16f)
        j8sum = sum16(j8) + lamf            # split_cu_flag
        split8 = (j8sum < j16) & (pred_mode == MODE_INTER)

        # update per-16 outputs for split blocks
        s8g = split8.reshape(bh, bw)
        sel8 = s8g[(y8 // 16).long(), (x8 // 16).long()]   # child mask

        def any16(c8):
            return c8.reshape(bh, 2, bw, 2).any(3).any(1).reshape(nb)

        cbf_y = torch.where(split8, any16(cbf8y), cbf_y)
        cbf_u = torch.where(split8, any16(cbf4u8), cbf_u)
        cbf_v = torch.where(split8, any16(cbf4v8), cbf_v)
        coef_bits = torch.where(s8g, sum16(rb8).reshape(bh, bw), coef_bits)
        tusplit = tusplit & ~split8
        # per-8 cbf/motion maps (plain raster 8 grid)
        s8_8 = s8g.repeat_interleave(2, 0).repeat_interleave(2, 1)
        cbf_y8 = torch.where(s8_8, cbf8y.reshape(bh8, bw8), cbf_y8)
        cbf_cb4 = torch.where(s8_8, cbf4u8.reshape(bh8, bw8), cbf_cb4)
        cbf_cr4 = torch.where(s8_8, cbf4v8.reshape(bh8, bw8), cbf_cr4)
        dir8_m = dir8.reshape(bh8, bw8)
        mv0x8_m = m0x8.reshape(bh8, bw8)
        mv0y8_m = m0y8.reshape(bh8, bw8)
        mv1x8_m = m1x8.reshape(bh8, bw8)
        mv1y8_m = m1y8.reshape(bh8, bw8)
        r0_8m = r0_8.reshape(bh8, bw8)
        r1_8m = r1_8.reshape(bh8, bw8)

    is_inter = pred_mode == MODE_INTER

    def zeros(hh, ww):
        return torch.zeros((hh, ww), dtype=torch.int32, device=dev)

    rec_y_pl = _scatter_blocks(zeros(h, w), rec_blk, x0, y0, 16, is_inter)
    rec_u_pl = _scatter_blocks(zeros(h // 2, w // 2), rec_u_blk, cx0, cy0,
                               8, is_inter)
    rec_v_pl = _scatter_blocks(zeros(h // 2, w // 2), rec_v_blk, cx0, cy0,
                               8, is_inter)
    coef_y = _scatter_blocks(zeros(h, w), lv_y, x0, y0, 16, is_inter)
    coef_u = _scatter_blocks(zeros(h // 2, w // 2), lv_u, cx0, cy0, 8,
                             is_inter)
    coef_v = _scatter_blocks(zeros(h // 2, w // 2), lv_v, cx0, cy0, 8,
                             is_inter)
    if cu8:
        # overwrite split-CU8 regions with the per-8 coded result
        rec_y_pl = _scatter_blocks(rec_y_pl, rec8y, x8, y8, 8, sel8)
        rec_u_pl = _scatter_blocks(rec_u_pl, rec4u8, cx8, cy8, 4, sel8)
        rec_v_pl = _scatter_blocks(rec_v_pl, rec4v8, cx8, cy8, 4, sel8)
        coef_y = _scatter_blocks(coef_y, lv8y, x8, y8, 8, sel8)
        coef_u = _scatter_blocks(coef_u, lv4u8, cx8, cy8, 4, sel8)
        coef_v = _scatter_blocks(coef_v, lv4v8, cx8, cy8, 4, sel8)

    planes, cbfs = _intra_wavefront(
        yi, ui, vi, use_intra.reshape(bh, bw), intra_modes,
        (rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v),
        (cbf_y & is_inter, cbf_u & is_inter, cbf_v & is_inter),
        qp, qp_c, sbh, rdoq, bw, bh)
    rec_y_pl, rec_u_pl, rec_v_pl, coef_y, coef_u, coef_v = planes
    cbf_y, cbf_u, cbf_v = cbfs

    # ---- BS maps (twin of bframe_codec._bs_maps_b) + deblock ----
    if deblock:
        bs_ver, bs_hor = bs_maps_b_dev(
            pred_mode.reshape(bh, bw), cbf_y.reshape(bh, bw),
            fin_dir.reshape(bh, bw), fin_mv0x.reshape(bh, bw),
            fin_mv0y.reshape(bh, bw), fin_mv1x.reshape(bh, bw),
            fin_mv1y.reshape(bh, bw))
        rec_y_pl, rec_u_pl, rec_v_pl = deblock_ops.deblock_420_bs(
            rec_y_pl, rec_u_pl, rec_v_pl, qp, bs_ver, bs_hor, block=16)

    def i16(c):
        return c.clamp(-32768, 32767).to(torch.int16)

    return dict(
        pred_mode=pred_mode.reshape(bh, bw).to(torch.int8),
        intra_mode=intra_modes.to(torch.int8),
        inter_dir=fin_dir.reshape(bh, bw).to(torch.int8),
        mv0x=fin_mv0x.reshape(bh, bw), mv0y=fin_mv0y.reshape(bh, bw),
        mv1x=fin_mv1x.reshape(bh, bw), mv1y=fin_mv1y.reshape(bh, bw),
        cbf_y=cbf_y.reshape(bh, bw), cbf_cb=cbf_u.reshape(bh, bw),
        cbf_cr=cbf_v.reshape(bh, bw),
        coef_bits=coef_bits,
        tusplit=tusplit.reshape(bh, bw),
        split8=split8.reshape(bh, bw),
        dir8=dir8_m.to(torch.int8),
        mv0x8=mv0x8_m, mv0y8=mv0y8_m, mv1x8=mv1x8_m, mv1y8=mv1y8_m,
        r0_8=r0_8m.to(torch.int8), r1_8=r1_8m.to(torch.int8),
        ref0_idx=fin_r0.reshape(bh, bw).to(torch.int8),
        ref1_idx=fin_r1.reshape(bh, bw).to(torch.int8),
        cbf_y8=cbf_y8, cbf_cb4=cbf_cb4, cbf_cr4=cbf_cr4,
        coef_y=i16(coef_y), coef_u=i16(coef_u), coef_v=i16(coef_v),
        rec_y=rec_y_pl.to(torch.uint8),
        rec_u=rec_u_pl.to(torch.uint8),
        rec_v=rec_v_pl.to(torch.uint8),
    )


# ---------------------------------------------------------------------------
# Slice lambda of the RA GOP (host)
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/inter_jax.py:1475
def hm_lambda(qp: int, qp_factor: float, depth: int) -> float:
    """HM's RD lambda ladder (TEncSlice::setUpLambda TEncSlice.cpp:320-350):
    lambda = QPFactor * 2^((qp-12)/3), scaled by Clip3(2, 4, (qp-12)/6)
    for pictures above the base temporal layer."""
    lam = qp_factor * 2.0 ** ((qp - 12) / 3.0)
    if depth > 0:
        lam *= min(4.0, max(2.0, (qp - 12) / 6.0))
    return lam


# video_codecs_tpu/models/hevc/inter_jax.py:1485
def _gop_lambda(enc, poc):
    """Slice lambda for the current picture from the encoder's GOPEntry
    table (RA path); None -> legacy 0.57 constant elsewhere."""
    gop = getattr(enc, "gop", None)
    if not gop:
        return None
    gs = getattr(enc, "gop_size", 0)
    e = next((e for e in gop if gs and (poc - e.poc) % gs == 0), None)
    if e is None:
        return None
    return hm_lambda(enc.cfg.qp, e.qp_factor, e.temporal_id)


# ---------------------------------------------------------------------------
# The low-delay P encoder: device phase + host reconciliation and CABAC
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/inter_jax.py:1188
class DeviceLowDelayEncoder(pc.LowDelayEncoder):
    """LD-P encoder whose per-picture pixel pipeline runs on a torch
    device (the card unless the caller passes device="cpu").

    Same bitstream toolset as LowDelayEncoder (CTB=CU=PU=16, multi-ref,
    merge, TMVP, SAO, HRD timing SEI, the long-term IDR reference); the
    IDR is the flat CTB16 device intra encoder, each P picture
    `encode_p_frame_dev`, then the host reconciles the merge/AMVP syntax
    and writes the slice and the picture-hash SEI.  With SAO the IDR
    goes through `IntraEncoder.encode_frame` (the reference's host CTB
    loop, computed on the device with the same bytes) and every picture
    through `_sao_decide_apply` (statistics on the device).  Tiles, WPP,
    weighted prediction and cu_qp_delta raise ValueError here."""

    #: HM encoder_lowdelay_P_main.cfg GOP-4 ladder: (QPoffset, QPfactor)
    LD_GOP = ((5, 0.4624), (4, 0.4624), (5, 0.4624), (1, 0.578))

    # video_codecs_tpu/models/hevc/inter_jax.py:1199
    def __init__(self, cfg, search_range: int = 64,
                 me_method: str = "pyr", ld_ladder: bool = True, *,
                 device="cuda") -> None:
        for opt in ("wpp", "weighted_pred", "cu_qp_delta"):
            if getattr(cfg, opt):
                raise ValueError(f"DeviceLowDelayEncoder: {opt} is not "
                                 "ported")
        if cfg.tile_columns != 1:
            raise ValueError("DeviceLowDelayEncoder: tiles are not ported")
        if me_method not in ME_METHODS:
            raise ValueError(f"DeviceLowDelayEncoder: me_method "
                             f"{me_method!r} is not one of {ME_METHODS}")
        super().__init__(cfg, search_range, me_method)
        self.ld_ladder = ld_ladder
        self.device = torch.device(device)

    # video_codecs_tpu/models/hevc/inter_jax.py:1206
    def encode_sequence_ldp(self, frames, rate_control=None):
        """Apply HM's LD-P QP/lambda ladder (QPoffset cycle 5,4,5,1 with
        per-entry QPFactor, TEncSlice setUpLambda) unless a rate
        controller drives QP."""
        if rate_control is not None or not self.ld_ladder:
            return super().encode_sequence_ldp(frames, rate_control)
        base = self.cfg.qp
        gop = self.LD_GOP

        def sched(poc):
            if poc == 0:
                return base
            return base + gop[(poc - 1) % len(gop)][0]

        self.qp_schedule = sched
        try:
            return super().encode_sequence_ldp(frames, rate_control)
        finally:
            self.qp_schedule = None
            self.cfg.qp = base

    # video_codecs_tpu/models/hevc/inter_jax.py:1227
    def _ld_lambda(self, poc):
        if getattr(self, "qp_schedule", None) is None:
            return None
        off, fac = self.LD_GOP[(poc - 1) % len(self.LD_GOP)]
        return hm_lambda(self.cfg.qp, fac, 1 if off > 1 else 0)

    # video_codecs_tpu/models/hevc/inter_jax.py:1233
    def encode_p_frame(self, y, u, v, dpb, poc):
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        refs = dpb[:cfg.num_refs]
        n_refs = len(refs)
        ref_pocs = [p for (p, _, _) in refs]
        col = refs[0][2] if cfg.temporal_mvp else None
        if col is None:
            col_inter = np.zeros((bh, bw), bool)
            col_mv = np.zeros((bh, bw, 2), np.int32)
            col_refpoc = np.zeros((bh, bw), np.int32)
            col_poc = 0
        else:
            col_inter, col_mv, col_refpoc, col_poc = (
                col.inter, col.mv, col.ref_poc, col.poc)

        st = self._device_phase(y, u, v, refs, col_inter, col_mv,
                                col_refpoc, ref_pocs, poc, col_poc)

        info = self._reconcile(st, bw, bh, ref_pocs, poc,
                               col if cfg.temporal_mvp else None)

        rec_y = st["rec_y"].astype(np.int32)
        rec_u = st["rec_u"].astype(np.int32)
        rec_v = st["rec_v"].astype(np.int32)

        sao_params = None
        if cfg.sao:
            yv, uv, vv = (p.astype(np.int32) for p in (y, u, v))
            sao_params, (rec_y, rec_u, rec_v) = self._sao_decide_apply(
                (yv, uv, vv), (rec_y, rec_u, rec_v))

        mf = motion.MotionField.empty(bw, bh, poc)
        inter_m = st["pred_mode"] == MODE_INTER
        mf.inter[:] = inter_m
        mf.mv[..., 0] = np.where(inter_m, st["mvx"], 0)
        mf.mv[..., 1] = np.where(inter_m, st["mvy"], 0)
        ref_poc_map = np.array(ref_pocs, np.int32)[st["ref_idx"]]
        mf.ref_poc[:] = np.where(inter_m, ref_poc_map, 0)

        slice_nal = self._encode_p_slice(info, poc, None, n_refs,
                                         sao_params)
        sei_nal = self._hash_sei(rec_y, rec_u, rec_v)
        return [slice_nal, sei_nal], (rec_y, rec_u, rec_v), mf

    def _device_phase(self, y, u, v, refs, col_inter, col_mv, col_refpoc,
                      ref_pocs, poc, col_poc) -> dict:
        """Upload the picture, its references and the collocated field,
        run `encode_p_frame_dev` on the encoder's device and copy the
        dict back as numpy (the copy synchronises)."""
        cfg = self.cfg
        dev = self.device
        with torch.inference_mode():
            def up(a):
                return to_device(np.asarray(a), dev)

            def stack(c):
                return up(np.stack([np.asarray(pl[c], np.uint8)
                                    for (_, pl, _) in refs]))

            st = encode_p_frame_dev(
                *(up(np.asarray(p, np.uint8)) for p in (y, u, v)),
                stack(0), stack(1), stack(2),
                up(col_inter), up(col_mv[..., 0]), up(col_mv[..., 1]),
                up(col_refpoc), torch.tensor(ref_pocs, dtype=torch.int32),
                poc, col_poc,
                qp=cfg.qp, w=cfg.width, h=cfg.height, n_refs=len(refs),
                search_range=self.search_range, sbh=cfg.sign_data_hiding,
                rdoq=True, tmvp=cfg.temporal_mvp, me_method=self.me_method,
                deblock=not cfg.deblocking_disabled,
                lam=self._ld_lambda(poc))
            return {k: t.cpu().numpy() for k, t in st.items()}

    # video_codecs_tpu/models/hevc/inter_jax.py:1294
    def encode_frame(self, y, u, v, *args, **kwargs):
        """IDR pictures via the flat CTB16 device intra encoder; with SAO
        through `IntraEncoder.encode_frame` (the reference's host CTB
        loop, here computed on the device with the same bytes)."""
        if self.cfg.sao:
            return super().encode_frame(y, u, v, *args, **kwargs)
        return self.encode_frame_fast(y, u, v)

    # video_codecs_tpu/models/hevc/inter_jax.py:1302
    def _reconcile(self, st, bw, bh, ref_pocs, poc, col):
        """Build the BlockInfo grid: spec-exact merge/AMVP syntax for the
        device-decided final motion field (motion.py derivation, shared
        with the decoder)."""
        cfg = self.cfg
        info: list[list[pc.BlockInfo | None]] = [
            [None] * bw for _ in range(bh)]
        grid = motion.NeighborGrid(info, bw, bh)
        pmod = st["pred_mode"]
        mvx, mvy = st["mvx"], st["mvy"]
        ridx = st["ref_idx"]
        cbf_y, cbf_cb, cbf_cr = st["cbf_y"], st["cbf_cb"], st["cbf_cr"]
        coef_y, coef_u, coef_v = st["coef_y"], st["coef_u"], st["coef_v"]
        imodes = st["intra_mode"]

        for by in range(bh):
            for bx in range(bw):
                b = pc.BlockInfo()
                b.qp = cfg.qp
                xx, yy = bx * 16, by * 16
                b.cbf_y = bool(cbf_y[by, bx])
                b.cbf_cb = bool(cbf_cb[by, bx])
                b.cbf_cr = bool(cbf_cr[by, bx])
                if b.cbf_y:
                    b.levels_y = coef_y[yy:yy + 16, xx:xx + 16] \
                        .astype(np.int32)
                if b.cbf_cb:
                    b.levels_cb = coef_u[yy // 2:yy // 2 + 8,
                                         xx // 2:xx // 2 + 8] \
                        .astype(np.int32)
                if b.cbf_cr:
                    b.levels_cr = coef_v[yy // 2:yy // 2 + 8,
                                         xx // 2:xx // 2 + 8] \
                        .astype(np.int32)
                if pmod[by, bx] == MODE_INTRA:
                    b.pred_mode = pc.MODE_INTRA
                    b.intra_mode = int(imodes[by, bx])
                    info[by][bx] = b
                    continue
                b.pred_mode = pc.MODE_INTER
                mv = (int(mvx[by, bx]), int(mvy[by, bx]))
                r = int(ridx[by, bx])
                b.mv = mv
                b.ref_idx = r
                b.ref_poc = ref_pocs[r]
                merge_list = motion.merge_candidates(
                    grid, bx, by, ref_pocs, poc, col, cfg.merge_cands,
                    cfg.temporal_mvp)
                try:
                    m_idx = merge_list.index((mv, r))
                except ValueError:
                    m_idx = -1
                no_resid = not (b.cbf_y or b.cbf_cb or b.cbf_cr)
                if m_idx >= 0:
                    b.merge = True
                    b.merge_idx = m_idx
                    if no_resid:
                        b.skip = True
                else:
                    b.merge = False
                    amvp = motion.amvp_candidates(
                        grid, bx, by, r, ref_pocs, poc, col,
                        cfg.temporal_mvp)
                    mvds = [(mv[0] - p[0], mv[1] - p[1]) for p in amvp]
                    bits = [pc.mvd_bits_estimate(d) for d in mvds]
                    b.mvp_idx = 0 if bits[0] <= bits[1] else 1
                    b.mvd = mvds[b.mvp_idx]
                info[by][bx] = b
        return info


# ---------------------------------------------------------------------------
# The flat CTB16 hierarchical-B / random-access encoders: device phase +
# host reconciliation (bframe_codec / ra_codec syntax) and CABAC
# ---------------------------------------------------------------------------

L0, L1 = bc.L0, bc.L1


# video_codecs_tpu/models/hevc/inter_jax.py:1381
def _reconcile_b(st, bw, bh, ref_poc, poc, is_anchor):
    """Build the BBlock grid for a device-encoded B/anchor picture:
    spec-exact merge/AMVP syntax reproducing the device-decided final
    motion field (bframe_codec.derive_merge / derive_amvp_b, shared with
    the decoder).  Where the device's approximate merge differs from the
    real single merge candidate, the MV is coded explicitly — always
    conformant, approximation only ever costs bits."""
    info: list[list[bc.BBlock | None]] = [[None] * bw for _ in range(bh)]
    pmod = st["pred_mode"]
    idir = st["inter_dir"]
    m0x, m0y = st["mv0x"], st["mv0y"]
    m1x, m1y = st["mv1x"], st["mv1y"]
    cbf_y, cbf_cb, cbf_cr = st["cbf_y"], st["cbf_cb"], st["cbf_cr"]
    coef_y, coef_u, coef_v = st["coef_y"], st["coef_u"], st["coef_v"]
    imodes = st["intra_mode"]

    for by in range(bh):
        for bx in range(bw):
            b = bc.BBlock()
            xx, yy = bx * 16, by * 16
            b.cbf_y = bool(cbf_y[by, bx])
            b.cbf_cb = bool(cbf_cb[by, bx])
            b.cbf_cr = bool(cbf_cr[by, bx])
            if b.cbf_y:
                b.levels_y = coef_y[yy:yy + 16, xx:xx + 16].astype(np.int32)
            if b.cbf_cb:
                b.levels_cb = coef_u[yy // 2:yy // 2 + 8,
                                     xx // 2:xx // 2 + 8].astype(np.int32)
            if b.cbf_cr:
                b.levels_cr = coef_v[yy // 2:yy // 2 + 8,
                                     xx // 2:xx // 2 + 8].astype(np.int32)
            if pmod[by, bx] == MODE_INTRA:
                b.pred_mode = bc.MODE_INTRA
                b.intra_mode = int(imodes[by, bx])
                info[by][bx] = b
                continue
            b.pred_mode = bc.MODE_INTER
            d = int(idir[by, bx])
            mv = {}
            if d & 1:
                mv[L0] = (int(m0x[by, bx]), int(m0y[by, bx]))
            if d & 2:
                mv[L1] = (int(m1x[by, bx]), int(m1y[by, bx]))
            b.inter_dir = d
            b.mv = mv
            mdir, mmv = bc.derive_merge(info, bx, by, bw, bh,
                                        is_b_slice=not is_anchor)
            no_res = not (b.cbf_y or b.cbf_cb or b.cbf_cr)
            if mdir == d and all(tuple(mmv[lx]) == mv[lx] for lx in mv):
                b.merge = True
                if no_res:
                    b.skip = True
            else:
                b.merge = False
                if d == 3:
                    b.mvp_idx = {}
                    b.mvd = {}
                    for lx in (L0, L1):
                        amvp = bc.derive_amvp_b(info, bx, by, bw, bh, lx,
                                                poc, ref_poc)
                        mvds = [(mv[lx][0] - p[0], mv[lx][1] - p[1])
                                for p in amvp]
                        bits = [pc.mvd_bits_estimate(x) for x in mvds]
                        mi = 0 if bits[0] <= bits[1] else 1
                        b.mvp_idx[lx] = mi
                        b.mvd[lx] = mvds[mi]
                else:
                    lx = L0 if d & 1 else L1
                    amvp = bc.derive_amvp_b(info, bx, by, bw, bh, lx,
                                            poc, ref_poc)
                    mvds = [(mv[lx][0] - p[0], mv[lx][1] - p[1])
                            for p in amvp]
                    bits = [pc.mvd_bits_estimate(x) for x in mvds]
                    b.mvp_idx = 0 if bits[0] <= bits[1] else 1
                    b.mvd = mvds[b.mvp_idx]
            info[by][bx] = b
    return info


def _check_flat_b(name, cfg, me_method):
    """The device engines take the device motion searches only; the
    configurations the flat B syntax writes wrongly raise in
    `HierarchicalBEncoder.__init__` (`bframe_codec.check_flat_b`), the RA
    header's MaxNumMergeCand other than 1 in
    `RandomAccessEncoder.__init__`."""
    if me_method not in ME_METHODS:
        raise ValueError(f"{name}: me_method {me_method!r} is not one of "
                         f"{ME_METHODS}")


def _b_device_phase(enc, y, u, v, r0, r1, has_l1, lam) -> dict:
    """Upload the picture and its list references (one per list; the L0
    planes stand in for L1 in anchors), run `encode_b_frame_dev` with
    the flat path's options on the encoder's device and copy the dict
    back as numpy (the copy synchronises)."""
    cfg = enc.cfg
    with torch.inference_mode():
        def up(a):
            return to_device(np.asarray(a, np.uint8), enc.device)

        st = encode_b_frame_dev(
            *(up(p) for p in (y, u, v)), *(up(p) for p in r0),
            *(up(p) for p in r1),
            qp=cfg.qp, w=cfg.width, h=cfg.height, has_l1=has_l1,
            search_range=enc.search_range, sbh=cfg.sign_data_hiding,
            rdoq=True, me_method=enc.me_method,
            deblock=not cfg.deblocking_disabled, lam=lam)
        return {k: t.cpu().numpy() for k, t in st.items()}


# video_codecs_tpu/models/hevc/inter_jax.py:1498
def _device_b_frame(enc, frame, poc, refs, is_anchor):
    """Shared device B/anchor picture path: run encode_b_frame_dev, then
    host reconciliation + CABAC with the encoder's own serializer."""
    cfg = enc.cfg
    y, u, v = frame
    bw, bh = cfg.width // 16, cfg.height // 16
    ref_poc = {lx: rp for lx, (rp, _) in refs.items()}
    has_l1 = L1 in refs
    r0 = refs[L0][1]
    r1 = refs[L1][1] if has_l1 else r0

    st = _b_device_phase(enc, y, u, v, r0, r1, has_l1,
                         _gop_lambda(enc, poc))

    info = _reconcile_b(st, bw, bh, ref_poc, poc, is_anchor)
    rec_y = st["rec_y"].astype(np.int32)
    rec_u = st["rec_u"].astype(np.int32)
    rec_v = st["rec_v"].astype(np.int32)
    sao_params = None
    if cfg.sao:
        yv, uv, vv = (np.asarray(p).astype(np.int32) for p in (y, u, v))
        sao_params, (rec_y, rec_u, rec_v) = enc._sao_decide_apply(
            (yv, uv, vv), (rec_y, rec_u, rec_v))
    slice_nal = enc._encode_b_slice(info, poc, is_anchor, ref_poc,
                                    poc - ref_poc[L0], sao_params)
    sei_nal = enc._hash_sei(rec_y, rec_u, rec_v)
    return [slice_nal, sei_nal], (rec_y, rec_u, rec_v)


# video_codecs_tpu/models/hevc/inter_jax.py:1538
class DeviceHierarchicalBEncoder(bc.HierarchicalBEncoder):
    """2-level hierarchical-B encoder (I0, anchor P pictures two apart,
    one non-reference B between) with the per-picture pixel pipeline on
    a torch device (the card unless the caller passes device="cpu"): the
    IDR through the flat CTB16 device intra encoder, each B / anchor P
    picture through `encode_b_frame_dev` with the flat path's options
    (single merge candidate, intra candidate, deblock at block 16), then
    the host reconciliation, slice writer and picture-hash SEI.  What
    the reference diverts to its host path or mis-codes raises
    ValueError here (`_check_flat_b`)."""

    # video_codecs_tpu/models/hevc/inter_jax.py:1542
    def __init__(self, cfg, search_range: int = 64,
                 me_method: str = "pyr", *, device="cuda") -> None:
        _check_flat_b("DeviceHierarchicalBEncoder", cfg, me_method)
        super().__init__(cfg, search_range, me_method)
        self.device = torch.device(device)

    # video_codecs_tpu/models/hevc/inter_jax.py:1546
    def encode_frame(self, y, u, v, *args, **kwargs):
        """IDR pictures via the flat CTB16 device intra encoder; with SAO
        through `IntraEncoder.encode_frame` (the reference's host CTB
        loop, here computed on the device with the same bytes)."""
        if self.cfg.sao:
            return super().encode_frame(y, u, v, *args, **kwargs)
        return self.encode_frame_fast(y, u, v)

    # video_codecs_tpu/models/hevc/inter_jax.py:1552
    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        return _device_b_frame(self, frame, poc, refs, is_anchor)


# video_codecs_tpu/models/hevc/inter_jax.py:1556
class DeviceRandomAccessEncoder(ra.RandomAccessEncoder):
    """GOP-driven RA encoder (GOPEntry tables, BASELINE config 3
    structure) on the flat CTB16 toolset, with the per-picture pixel
    pipeline on a torch device (the card unless the caller passes
    device="cpu"), as `DeviceHierarchicalBEncoder`; each picture's slice
    carries the GOP entry's RPS and QP, and its lambda is HM's ladder
    (`_gop_lambda`).  `cfg.merge_cands` must be 1: the flat CU writer
    codes no merge_idx, while the RA slice header signals
    MaxNumMergeCand from the configuration."""

    # video_codecs_tpu/models/hevc/inter_jax.py:1560
    def __init__(self, cfg, gop: tuple = ra.GOP8_RA,
                 search_range: int = 64, me_method: str = "pyr", *,
                 device="cuda") -> None:
        _check_flat_b("DeviceRandomAccessEncoder", cfg, me_method)
        super().__init__(cfg, gop, search_range, me_method)
        self.device = torch.device(device)

    # video_codecs_tpu/models/hevc/inter_jax.py:1564
    def encode_frame(self, y, u, v, *args, **kwargs):
        """IDR pictures via the flat CTB16 device intra encoder; with SAO
        through `IntraEncoder.encode_frame` (the reference's host CTB
        loop, here computed on the device with the same bytes)."""
        if self.cfg.sao:
            return super().encode_frame(y, u, v, *args, **kwargs)
        return self.encode_frame_fast(y, u, v)

    # video_codecs_tpu/models/hevc/inter_jax.py:1570
    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        # tag reference-ness for the NAL type (RandomAccessEncoder logic)
        e = next((e for e in self.gop
                  if (poc - e.poc) % self.gop_size == 0), None)
        self._cur_is_ref = e is None or e.temporal_id < 3
        return _device_b_frame(self, frame, poc, refs, is_anchor)
