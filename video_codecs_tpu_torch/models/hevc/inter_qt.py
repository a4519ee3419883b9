"""Random-access encoder on the CTB32 device quadtree: the device tree
pass `qt_merge_dev` and `QtDeviceRandomAccessEncoder`.

Counterpart of video_codecs_tpu/models/hevc/inter_qt.py.  The device half
(`_sse_blocks`, `_coef_bits_blocks`, `_pred_cand`, `qt_merge_dev`) is the
reference's computation on tensors of any device; the host half (the
encoder's GOP loop, TMVP motion store, spec-exact merge/AMVP
reconciliation and CABAC serializer, `_QtSliceState`) is the port's copy
of the original, function by function, each with a comment giving the
original's line.

`QtDeviceRandomAccessEncoder(cfg, ..., device="cuda")` runs every picture
on the card unless the caller passes device="cpu": the IDR through the
port's `QuadtreeFastEncoder`, each B/P picture through
`inter_dev.encode_b_frame_dev` + `qt_merge_dev` (`_device_phase`, which
returns numpy), then, with `cfg.sao`, the SAO decision (`_sao_decide_qt`:
per-CTB statistics on the device through the CUDA kernel of
`ops/sao.sao_stats`, three launches a picture, and the reference's
offset search on the host) and its apply to the recon, then the host
serializer and the picture-hash SEI.  `me_method` is "pyr" (the
pyramid), "full", "tz" (HM's TZSearch) or "auto", at n = 16 and, in the
CU8 tree, n = 8.  The intra candidate of B pictures is off on this path,
as in the reference (`allow_intra=False`, inter_qt.py:657).

Float32: the tree decision compares `d + round(lam * r)` in float32 and
the residual CU32 cost `(d + lam * (20 + bits)).astype(int32)`, the
latter one fused multiply-add as XLA's CPU backend computes it
(`ops/quant.fma32`); the 4-entry rate sum runs left to right.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, residual
from video_codecs_tpu_torch.models.hevc import encoder_dev
from video_codecs_tpu_torch.models.hevc import inter_codec as pc
from video_codecs_tpu_torch.models.hevc import inter_dev
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.models.hevc import motion_hm
from video_codecs_tpu_torch.models.hevc import quadtree_codec
from video_codecs_tpu_torch.models.hevc import ra_codec as ra
from video_codecs_tpu_torch.models.hevc.intra_codec import chroma_qp
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops import sao as sao_ops
from video_codecs_tpu_torch.ops.quant import fma32
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const, to_device

L0, L1 = 0, 1
DC = 1
MODE_INTER, MODE_INTRA = 0, 1
NAL_TRAIL_N, NAL_TRAIL_R = 0, 1

# ceil(log2(1 + a)) for every level magnitude a = 0..32768: the
# reference takes it in float32 with XLA's log2, which is exact at the
# powers of two, so the table is the integer ceiling
# (tests/test_torch_hevc_inter_ops.py holds it against the JAX expression).
CEIL_LOG2_1P = np.array([0] + [(a).bit_length() for a in range(1, 32769)],
                        np.int32)


# ---------------------------------------------------------------------------
# Device phase: 32x32 merge/skip tree decision + final recon
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/inter_qt.py:66
def _sse_blocks(a_plane, b_blocks, xs, ys, n):
    a = encoder_dev._extract_blocks(a_plane, xs, ys, n)
    d = (a - b_blocks).int()
    return (d * d).sum((-2, -1), dtype=torch.int32)


# video_codecs_tpu/models/hevc/inter_qt.py:72
def _coef_bits_blocks(coef_plane, xs, ys, n):
    """Cheap device-side coefficient-rate proxy per block: 2 bits per
    nonzero + 2 bits per magnitude doubling (Exp-Golomb-ish)."""
    lv = encoder_dev._extract_blocks(coef_plane, xs, ys, n)
    a = lv.int().abs()
    nnz = (a > 0).sum((-2, -1), dtype=torch.int32)
    mag = const(CEIL_LOG2_1P, a.device)[a.long()].sum((-2, -1),
                                                       dtype=torch.int32)
    return 2 * nnz + 2 * mag


# video_codecs_tpu/models/hevc/inter_qt.py:83
def _pred_cand(refs_y_pair, r0, r1, xs, ys, n, dirs, mv0x, mv0y,
               mv1x, mv1y, has_l1, mc14):
    """Uni/bi prediction for per-block candidate motion (8-bit clipped);
    refs are [R, H, W] stacks with per-block ref indices r0/r1."""
    q0 = mc14(refs_y_pair[0], r0, xs, ys, mv0x, mv0y, n)
    if not has_l1:
        return ((q0 + 32) >> 6).clamp(0, 255).int()
    q1 = mc14(refs_y_pair[1], r1, xs, ys, mv1x, mv1y, n)
    return torch.where(
        (dirs == 3)[:, None, None], interp.bi_average(q0, q1),
        torch.where((dirs == 1)[:, None, None],
                    ((q0 + 32) >> 6).clamp(0, 255),
                    ((q1 + 32) >> 6).clamp(0, 255))).int()


# video_codecs_tpu/models/hevc/inter_qt.py:380 (qt_merge_dev's deblock)
def deblock_maps(rec_y, rec_u, rec_v, qp: int, *, pred_mode, dir8, mv0x8,
                 mv0y8, mv1x8, mv1y8, r0_8, r1_8, tusplit, split8, cbf_y8,
                 cbf_y):
    """`qt_merge_dev`'s deblock as a function of its final maps (the
    qt dict's keys of the same names): BS at 8-sample granularity (spec
    8.7.2.4) -- TU8-split and CU8-split CUs create internal edges, and
    CU-boundary edges use the cbf of the ADJACENT TU -- then
    `deblock_420_bs`.  The tiled engines (parallel/sharded.py) deblock
    the assembled picture with it."""
    def up8(f):
        return f.repeat_interleave(2, 0).repeat_interleave(2, 1)

    pm8 = up8(pred_mode)
    dir8 = dir8.int()
    r0_8, r1_8 = r0_8.int(), r1_8.int()
    eff8 = torch.where(up8(tusplit | split8), cbf_y8, up8(cbf_y))

    def bs_pair8(sl_a, sl_b):
        a_i = (pm8 == MODE_INTRA)[sl_a]
        b_i = (pm8 == MODE_INTRA)[sl_b]
        intra2 = a_i | b_i
        diff_dir = dir8[sl_a] != dir8[sl_b]
        d0 = ((mv0x8[sl_a] - mv0x8[sl_b]).abs() >= 4) | \
            ((mv0y8[sl_a] - mv0y8[sl_b]).abs() >= 4) | \
            (r0_8[sl_a] != r0_8[sl_b])
        d1 = ((mv1x8[sl_a] - mv1x8[sl_b]).abs() >= 4) | \
            ((mv1y8[sl_a] - mv1y8[sl_b]).abs() >= 4) | \
            (r1_8[sl_a] != r1_8[sl_b])
        use0 = (dir8[sl_a] & 1) > 0
        mv_diff = torch.where(dir8[sl_a] == 3, d0 | d1,
                              torch.where(use0, d0, d1))
        one = eff8[sl_a] | eff8[sl_b] | diff_dir | mv_diff
        return torch.where(intra2, 2, torch.where(one, 1, 0)).int()

    ver8 = bs_pair8(np.s_[:, :-1], np.s_[:, 1:]).T.contiguous()
    hor8 = bs_pair8(np.s_[:-1, :], np.s_[1:, :]).contiguous()
    # only TU/PU boundaries are filtered (spec 8.7.2.2): odd 8-grid
    # edges exist only inside TU8-split or CU8-split CUs
    inner = tusplit | split8
    odd_ok_v = inner.T.repeat_interleave(2, 1)          # [bw, bh8]
    ver8[0::2] = torch.where(odd_ok_v, ver8[0::2], 0)
    odd_ok_h = inner.repeat_interleave(2, 1)            # [bh, bw8]
    hor8[0::2] = torch.where(odd_ok_h, hor8[0::2], 0)
    return deblock_ops.deblock_420_bs(rec_y.int(), rec_u.int(), rec_v.int(),
                                      qp, ver8, hor8, block=8)


# video_codecs_tpu/models/hevc/inter_qt.py:98
def qt_merge_dev(y, u, v, ref0_y, ref0_u, ref0_v, ref1_y, ref1_u, ref1_v,
                 st16, qp: int, w: int, h: int, has_l1: bool, sbh: bool,
                 rdoq: bool, deblock: bool = True,
                 lam: float | None = None):
    """Tree pass over the per-16 decision `st16` (encode_b_frame_dev
    output with deblock=False): decide skip-CU32 regions, substitute
    their prediction, keep the (absent) intra blocks, and deblock.
    Returns the final state + tree maps, tensors on the input's device."""
    dev = y.device
    bw, bh = w // 16, h // 16
    g32w, g32h = bw // 2, bh // 2
    ng = g32h * g32w
    qp_c = chroma_qp(qp)
    yi = y.int()
    ui = u.int()
    vi = v.int()

    def stack3(p):
        p = p.int()
        return p[None] if p.ndim == 2 else p

    refs_y = [stack3(ref0_y), stack3(ref1_y)]
    refs_u = [stack3(ref0_u), stack3(ref1_u)]
    refs_v = [stack3(ref0_v), stack3(ref1_v)]
    if lam is None:
        lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    lamf = torch.tensor(lam, dtype=torch.float32, device=dev)

    x0 = (torch.arange(bw, dtype=torch.int32, device=dev) * 16).repeat(bh)
    y0 = (torch.arange(bh, dtype=torch.int32, device=dev) *
          16).repeat_interleave(bw)
    cx0, cy0 = x0 // 2, y0 // 2

    rec_y = st16["rec_y"].int()
    rec_u = st16["rec_u"].int()
    rec_v = st16["rec_v"].int()
    coef_y = st16["coef_y"].int()
    coef_u = st16["coef_u"].int()
    coef_v = st16["coef_v"].int()

    # ---- per-16 cost: true SSE of the coded result + the RDOQ's own
    # CABAC-rate estimate (~8 bits of mode/merge/cbf syntax per CU) ----
    rec_blk = encoder_dev._extract_blocks(rec_y, x0, y0, 16)
    d16 = _sse_blocks(yi, rec_blk, x0, y0, 16)
    d16 = d16 + _sse_blocks(
        ui, encoder_dev._extract_blocks(rec_u, cx0, cy0, 8), cx0, cy0, 8)
    d16 = d16 + _sse_blocks(
        vi, encoder_dev._extract_blocks(rec_v, cx0, cy0, 8), cx0, cy0, 8)
    if "coef_bits" in st16:
        r16 = 8.0 + st16["coef_bits"].reshape(-1)
    else:
        r16 = (8 + _coef_bits_blocks(coef_y, x0, y0, 16) +
               _coef_bits_blocks(coef_u, cx0, cy0, 8) +
               _coef_bits_blocks(coef_v, cx0, cy0, 8)).float()
    cost16 = (d16 + torch.round(lamf * r16).int()).reshape(bh, bw)

    # ---- candidate motion per aligned 32x32 region ----
    pred_mode = st16["pred_mode"].int()
    fb_dir = 3 if has_l1 else 1
    is_inter = pred_mode == MODE_INTER
    dir_m = torch.where(is_inter, st16["inter_dir"].int(), 0)
    mv = {k: st16[k] for k in ("mv0x", "mv0y", "mv1x", "mv1y")}
    zg16 = torch.zeros((bh, bw), dtype=torch.int32, device=dev)
    rf = {"r0": st16.get("ref0_idx", zg16).int(),
          "r1": st16.get("ref1_idx", zg16).int()}

    def child(f, dy, dx):
        return f[dy::2, dx::2][:g32h, :g32w]

    cands = []
    for dy in (0, 1):
        for dx in (0, 1):
            d = child(dir_m, dy, dx)
            ok = d > 0
            cands.append(tuple(
                torch.where(ok, child(mv[k], dy, dx), 0).reshape(-1)
                for k in ("mv0x", "mv0y", "mv1x", "mv1y")) +
                (torch.where(ok, d, fb_dir).reshape(-1),) + tuple(
                torch.where(ok, child(rf[k], dy, dx), 0).reshape(-1)
                for k in ("r0", "r1")))
    zg = torch.zeros(ng, dtype=torch.int32, device=dev)
    fbv = torch.full((ng,), fb_dir, dtype=torch.int32, device=dev)
    cands.append((zg, zg, zg, zg, fbv, zg, zg))

    x32 = (torch.arange(g32w, dtype=torch.int32, device=dev) *
           32).repeat(g32h)
    y32 = (torch.arange(g32h, dtype=torch.int32, device=dev) *
           32).repeat_interleave(g32w)
    cur32 = encoder_dev._extract_blocks(yi, x32, y32, 32)
    cur32u = encoder_dev._extract_blocks(ui, x32 // 2, y32 // 2, 16)
    cur32v = encoder_dev._extract_blocks(vi, x32 // 2, y32 // 2, 16)

    INF = 1 << 30
    skip_rate = inter_dev._round_const(lam * 14)
    best_cost = torch.full((ng,), INF, dtype=torch.int32, device=dev)
    best = [zg, zg, zg, zg, fbv, zg, zg]
    best_planes = None
    for c in cands:
        m0x, m0y, m1x, m1y, dirs, cr0, cr1 = c
        py32 = _pred_cand(refs_y, cr0, cr1, x32, y32, 32, dirs, m0x, m0y,
                          m1x, m1y, has_l1, interp.mc_luma14_multi)
        pu32 = _pred_cand(refs_u, cr0, cr1, x32 // 2, y32 // 2, 16, dirs,
                          m0x, m0y, m1x, m1y, has_l1,
                          interp.mc_chroma14_multi)
        pv32 = _pred_cand(refs_v, cr0, cr1, x32 // 2, y32 // 2, 16, dirs,
                          m0x, m0y, m1x, m1y, has_l1,
                          interp.mc_chroma14_multi)

        def ssd(a, b):
            d = a - b
            return (d * d).sum((-2, -1), dtype=torch.int32)

        d = ssd(cur32, py32) + ssd(cur32u, pu32) + ssd(cur32v, pv32)
        cost = d + skip_rate
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best = [torch.where(better, a, b) for a, b in zip(c, best)]
        sel = better[:, None, None]
        if best_planes is None:
            best_planes = (py32, pu32, pv32)
        else:
            best_planes = tuple(torch.where(sel, n_, o_) for n_, o_ in
                                zip((py32, pu32, pv32), best_planes))

    # ---- residual-coded CU32 candidate: the best whole-region
    # prediction's residual as an RQT split to 4 TU16 (TEncSearch
    # xEstimateInterResidualQT at depth 1), with the RDOQ's exact-rate
    # estimate; regions may merge with cbf != 0 ----
    rd = "full" if rdoq else rdoq
    cur16m = inter_dev._to4(cur32, 16)
    pred16m = inter_dev._to4(best_planes[0], 16)
    lv16y, rec16y, cbf16y, rbits_y = encoder_dev._code_blocks_rate(
        cur16m, pred16m, qp, 4, sbh=sbh, rdoq=rd, lam=lam)
    cur8u = inter_dev._to4(cur32u, 8)
    pred8u = inter_dev._to4(best_planes[1], 8)
    lv8u, rec8u, cbf8u, rbits_u = encoder_dev._code_blocks_rate(
        cur8u, pred8u, qp_c, 3, sbh=sbh, rdoq=rd, is_luma=False, lam=lam)
    cur8v = inter_dev._to4(cur32v, 8)
    pred8v = inter_dev._to4(best_planes[2], 8)
    lv8v, rec8v, cbf8v, rbits_v = encoder_dev._code_blocks_rate(
        cur8v, pred8v, qp_c, 3, sbh=sbh, rdoq=rd, is_luma=False, lam=lam)

    def per_region(a):
        return a.reshape(-1, 4).sum(1, dtype=a.dtype)

    def ssd2(a, b):
        d = a - b
        return (d * d).sum((-2, -1), dtype=torch.int32)

    d_res = per_region(ssd2(cur16m, rec16y) + ssd2(cur8u, rec8u) +
                       ssd2(cur8v, rec8v))
    bits_res = inter_dev._persum((rbits_y + rbits_u) + rbits_v)
    any_cbf32 = per_region((cbf16y | cbf8u | cbf8v).int()) > 0
    # syntax overhead: ~20 bits (merge + split + cbf flags) vs ~7 for skip
    j_res = fma32(20.0 + bits_res, lamf, d_res.float()).int()
    j_skip = best_cost       # SSE + lam*14 from the candidate loop
    j_res = torch.where(any_cbf32, j_res, INF)

    child_sum = (child(cost16, 0, 0) + child(cost16, 0, 1) +
                 child(cost16, 1, 0) + child(cost16, 1, 1)).reshape(-1)
    j_best32 = torch.minimum(j_skip, j_res)
    merged = j_best32 <= child_sum                        # [G]
    res32 = merged & (j_res < j_skip)
    merged_g = merged.reshape(g32h, g32w)

    # ---- substitute merged regions into the final state ----
    def up2(f32):
        """[G] region values -> [bh, bw], 0 outside the regions."""
        g = f32.reshape(g32h, g32w)
        f = torch.zeros((bh, bw), dtype=g.dtype, device=dev)
        f[:2 * g32h, :2 * g32w] = g.repeat_interleave(2, 0) \
            .repeat_interleave(2, 1)
        return f

    def up2vals(v4):
        """[G*4] child-order values -> [bh, bw] map over covered blocks."""
        g = v4.reshape(g32h, g32w, 2, 2).permute(0, 2, 1, 3)
        f = torch.zeros((bh, bw), dtype=v4.dtype, device=dev)
        f[:2 * g32h, :2 * g32w] = g.reshape(2 * g32h, 2 * g32w)
        return f

    m2 = up2(merged)
    fin_pred_mode = torch.where(m2, MODE_INTER, pred_mode)
    fin_dir = torch.where(m2, up2(best[4]), dir_m)
    fin_mv = {}
    for i, k in enumerate(("mv0x", "mv0y", "mv1x", "mv1y")):
        fin_mv[k] = torch.where(m2, up2(best[i]), mv[k])
    fin_r0 = torch.where(m2, up2(best[5]), rf["r0"])
    fin_r1 = torch.where(m2, up2(best[6]), rf["r1"])

    res2 = up2(res32)
    cbf_y = torch.where(m2, res2 & up2vals(cbf16y), st16["cbf_y"])
    cbf_cb = torch.where(m2, res2 & up2vals(cbf8u), st16["cbf_cb"])
    cbf_cr = torch.where(m2, res2 & up2vals(cbf8v), st16["cbf_cr"])

    sel32 = merged
    use_res = res32[:, None, None]
    rec_y = inter_dev._scatter_blocks(
        rec_y, torch.where(use_res, inter_dev._from4(rec16y, 16),
                           best_planes[0]), x32, y32, 32, sel32)
    rec_u = inter_dev._scatter_blocks(
        rec_u, torch.where(use_res, inter_dev._from4(rec8u, 8),
                           best_planes[1]), x32 // 2, y32 // 2, 16, sel32)
    rec_v = inter_dev._scatter_blocks(
        rec_v, torch.where(use_res, inter_dev._from4(rec8v, 8),
                           best_planes[2]), x32 // 2, y32 // 2, 16, sel32)
    coef_y = inter_dev._scatter_blocks(
        coef_y, torch.where(use_res, inter_dev._from4(lv16y, 16), 0),
        x32, y32, 32, sel32)
    coef_u = inter_dev._scatter_blocks(
        coef_u, torch.where(use_res, inter_dev._from4(lv8u, 8), 0),
        x32 // 2, y32 // 2, 16, sel32)
    coef_v = inter_dev._scatter_blocks(
        coef_v, torch.where(use_res, inter_dev._from4(lv8v, 8), 0),
        x32 // 2, y32 // 2, 16, sel32)

    # ---- intra blocks would be re-run on the final recon here; this
    # path makes none (inter_dev._intra_wavefront raises on one) ----
    intra_grid = fin_pred_mode == MODE_INTRA
    intra_modes = st16["intra_mode"].int()
    planes, cbfs = inter_dev._intra_wavefront(
        yi, ui, vi, intra_grid, intra_modes,
        (rec_y, rec_u, rec_v, coef_y, coef_u, coef_v),
        (cbf_y, cbf_cb, cbf_cr), qp, qp_c, sbh, rdoq, bw, bh)
    rec_y, rec_u, rec_v, coef_y, coef_u, coef_v = planes
    cbf_y, cbf_cb, cbf_cr = cbfs

    # ---- BS maps on the final fields ----
    pm = fin_pred_mode
    dirg = fin_dir
    m0x, m0y = fin_mv["mv0x"], fin_mv["mv0y"]
    m1x, m1y = fin_mv["mv1x"], fin_mv["mv1y"]
    zb = torch.zeros((bh, bw), dtype=torch.bool, device=dev)
    zb8 = torch.zeros((2 * bh, 2 * bw), dtype=torch.bool, device=dev)
    z8 = torch.zeros((2 * bh, 2 * bw), dtype=torch.int32, device=dev)
    tusplit = st16.get("tusplit", zb) & ~m2
    split8m = st16.get("split8", zb) & ~m2
    cbf_y8m = st16.get("cbf_y8", zb8)

    def up8(f):
        return f.repeat_interleave(2, 0).repeat_interleave(2, 1)

    # final per-8 motion: CU8-split blocks carry their own PU motion,
    # everything else repeats the CU16/CU32 field onto the 8 grid
    use8 = up8(split8m)
    dir8f = torch.where(use8, st16.get("dir8", z8).int(), up8(dirg))
    m0x8f = torch.where(use8, st16.get("mv0x8", z8), up8(m0x))
    m0y8f = torch.where(use8, st16.get("mv0y8", z8), up8(m0y))
    m1x8f = torch.where(use8, st16.get("mv1x8", z8), up8(m1x))
    m1y8f = torch.where(use8, st16.get("mv1y8", z8), up8(m1y))
    r0_8f = torch.where(use8, st16.get("r0_8", z8).int(), up8(fin_r0))
    r1_8f = torch.where(use8, st16.get("r1_8", z8).int(), up8(fin_r1))
    if deblock:
        rec_y, rec_u, rec_v = deblock_maps(
            rec_y, rec_u, rec_v, qp, pred_mode=pm, dir8=dir8f,
            mv0x8=m0x8f, mv0y8=m0y8f, mv1x8=m1x8f, mv1y8=m1y8f,
            r0_8=r0_8f, r1_8=r1_8f, tusplit=tusplit, split8=split8m,
            cbf_y8=cbf_y8m, cbf_y=cbf_y)

    def i16(c):
        return c.clamp(-32768, 32767).to(torch.int16)

    return dict(
        merged32=merged_g,
        res32=res32.reshape(g32h, g32w),
        tusplit=tusplit,
        split8=split8m,
        dir8=dir8f.to(torch.int8),
        mv0x8=m0x8f, mv0y8=m0y8f, mv1x8=m1x8f, mv1y8=m1y8f,
        r0_8=r0_8f.to(torch.int8), r1_8=r1_8f.to(torch.int8),
        ref0_idx=fin_r0.to(torch.int8),
        ref1_idx=fin_r1.to(torch.int8),
        cbf_y8=st16.get("cbf_y8", zb8),
        cbf_cb4=st16.get("cbf_cb4", zb8),
        cbf_cr4=st16.get("cbf_cr4", zb8),
        pred_mode=fin_pred_mode.to(torch.int8),
        intra_mode=intra_modes.to(torch.int8),
        inter_dir=fin_dir.to(torch.int8),
        mv0x=fin_mv["mv0x"], mv0y=fin_mv["mv0y"],
        mv1x=fin_mv["mv1x"], mv1y=fin_mv["mv1y"],
        cbf_y=cbf_y, cbf_cb=cbf_cb, cbf_cr=cbf_cr,
        coef_y=i16(coef_y), coef_u=i16(coef_u), coef_v=i16(coef_v),
        rec_y=rec_y.to(torch.uint8),
        rec_u=rec_u.to(torch.uint8),
        rec_v=rec_v.to(torch.uint8),
    )


# video_codecs_tpu/models/hevc/inter_qt.py:454 (_sao_stats_jit)
def _sao_stats(orig, rec, ctb: int):
    """Device SAO statistics of one (padded, CTB-multiple) plane."""
    return sao_ops.sao_stats(orig, rec, ctb)


# video_codecs_tpu/models/hevc/inter_qt.py:460
def _pad_to(a, m):
    h, w = a.shape
    ph, pw = -h % m, -w % m
    if ph or pw:
        a = np.pad(a, ((0, ph), (0, pw)), mode="edge")
    return a


# video_codecs_tpu/models/hevc/inter_qt.py:472
class QtDeviceRandomAccessEncoder(ra.RandomAccessEncoder):
    """GOP-driven RA encoder emitting CTB32 streams: device intra
    quadtree for IDR, device per-16 inter decision + 32x32 skip-merge
    tree for B/P pictures, merge-5 syntax via motion_hm."""

    #: writes its own CTB32 slices (`_serialize_qt_slice`), not the flat
    #: 16x16 syntax whose refusals `bframe_codec.check_flat_b` holds
    flat_syntax = False

    # video_codecs_tpu/models/hevc/inter_qt.py:477
    def __init__(self, cfg, gop: tuple = ra.GOP8_RA,
                 search_range: int = 64, me_method: str = "pyr",
                 cu8: bool = True, num_refs_active: int = 1, *,
                 device="cuda") -> None:
        assert cfg.log2_ctb == 5 and cfg.log2_min_cb == 3 and \
            cfg.log2_max_tb == 5, "qt inter build is CTB32 (quadtree SPS)"
        assert cfg.width % 16 == 0 and cfg.height % 16 == 0
        if me_method not in inter_dev.ME_METHODS:
            raise ValueError(f"QtDeviceRandomAccessEncoder: me_method "
                             f"{me_method!r} is not one of "
                             f"{inter_dev.ME_METHODS}")
        cfg.tt_depth_inter = 1     # CU32 residuals code an RQT split
        self.cu8 = cu8
        #: active refs per list (HM GOPEntry num_ref_pics_active uses 2;
        #: 1 is the reference's default, the 2-ref machinery is
        #: conformant and tested)
        self.num_refs_active = num_refs_active
        super().__init__(cfg, gop, search_range, me_method)
        self.device = torch.device(device)
        self._qt_intra = quadtree_codec.QuadtreeFastEncoder(
            cfg, device=device)
        # HM I-slice lambda scale: 0.57*(1 - 0.05*NumberBFrames)
        # (TEncSlice.cpp:323) -> stronger pyramid base
        nbf = self.gop_size - 1
        self._qt_intra.lam_scale = 1.0 - min(0.5, 0.05 * nbf)

    # video_codecs_tpu/models/hevc/inter_qt.py:498
    def encode_frame(self, y, u, v, *args, **kwargs):
        """IDR via the device intra CU-quadtree (CTB32 geometry)."""
        return self._qt_intra.encode_frame_fast(y, u, v)

    # video_codecs_tpu/models/hevc/inter_qt.py:502
    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        e = next((e for e in self.gop
                  if (poc - e.poc) % self.gop_size == 0), None)
        self._cur_is_ref = e is None or e.temporal_id < 3
        cfg = self.cfg
        y, u, v = frame
        l0, l1 = getattr(self, "_cur_ref_lists", None) or (
            [(refs[L0][0], refs[L0][1])],
            [(refs[L1][0], refs[L1][1])] if L1 in refs else [])
        has_l1 = bool(l1)
        ref_pocs = [[p for p, _ in l0], [p for p, _ in l1]]

        def stack(lst, c):
            return to_device(np.stack(
                [np.asarray(planes[c], np.uint8) for _, planes in lst]),
                self.device)

        args = [stack(l0, 0), stack(l0, 1), stack(l0, 2)]
        args += [stack(l1 or l0, 0), stack(l1 or l0, 1),
                 stack(l1 or l0, 2)]
        lam = inter_dev._gop_lambda(self, poc)
        no_backward = all(p < poc for lst in ref_pocs for p in lst)
        if cfg.temporal_mvp:
            col_poc = (ref_pocs[1][0] if has_l1 else ref_pocs[0][0])
            tf = self._tmvp_fields(col_poc, poc, ref_pocs)
            qt = self._device_phase(y, u, v, args, has_l1, lam,
                                    tmvp_fields=tf,
                                    no_backward=no_backward)
        else:
            qt = self._device_phase(y, u, v, args, has_l1, lam)
        sao_params = None
        if cfg.sao:
            sao_params = self._sao_decide_qt(
                (np.asarray(y), np.asarray(u), np.asarray(v)), qt, lam)
        qt = {k: np.asarray(val) for k, val in qt.items()}
        if sao_params is not None:
            qt["rec_y"] = sao_ops.apply_frame(
                qt["rec_y"], sao_params, 32, 0).astype(np.uint8)
            qt["rec_u"] = sao_ops.apply_frame(
                qt["rec_u"], sao_params, 16, 1).astype(np.uint8)
            qt["rec_v"] = sao_ops.apply_frame(
                qt["rec_v"], sao_params, 16, 2).astype(np.uint8)

        slice_nal = self._serialize_qt_slice(qt, poc, is_anchor,
                                             ref_pocs, sao_params)
        if cfg.temporal_mvp:
            self._store_motion(qt, poc, ref_pocs)
        rec = tuple(qt[k].astype(np.int32)
                    for k in ("rec_y", "rec_u", "rec_v"))
        sei_nal = self._hash_sei(*rec)
        return [slice_nal, sei_nal], rec

    # video_codecs_tpu/models/hevc/inter_qt.py:556
    def _store_motion(self, qt, poc, ref_pocs):
        """Retain the picture's final 8-grid motion as the collocated
        source (spec-identical to what any decoder reconstructs from
        the stream; 8-grid repeat == the 4x4 field since every PU is
        >= 8 samples)."""
        mots = getattr(self, "_motion", None)
        if mots is None:
            mots = self._motion = {}
        d8 = qt["dir8"].astype(np.int32)
        intra8 = np.repeat(np.repeat(
            qt["pred_mode"].astype(np.int32) == MODE_INTRA, 2, 0), 2, 1)
        rp = [np.asarray(ref_pocs[0], np.int32),
              np.asarray(ref_pocs[1] or [0], np.int32)]
        r0 = qt.get("r0_8", np.zeros_like(d8)).astype(np.int32)
        r1 = qt.get("r1_8", np.zeros_like(d8)).astype(np.int32)
        mots[poc] = dict(
            poc=poc,
            inter=(~intra8) & (d8 > 0),
            pf0=(~intra8) & ((d8 & 1) > 0),
            pf1=(~intra8) & ((d8 & 2) > 0),
            mv0x=qt["mv0x8"].astype(np.int32),
            mv0y=qt["mv0y8"].astype(np.int32),
            mv1x=qt["mv1x8"].astype(np.int32),
            mv1y=qt["mv1y8"].astype(np.int32),
            r0=r0, r1=r1,
            rp0=rp[0][np.clip(r0, 0, len(rp[0]) - 1)],
            rp1=rp[1][np.clip(r1, 0, len(rp[1]) - 1)])
        if len(mots) > 20:
            for k in sorted(mots)[:-20]:
                del mots[k]

    # video_codecs_tpu/models/hevc/inter_qt.py:587
    def _tmvp_fields(self, col_poc, poc, ref_pocs):
        """Device TMVP candidate inputs from the stored collocated
        motion, compressed to the 16 grid (top-left 4x4 per 16x16 --
        spec 8.5.3.2.8 / TComCUMvField::compress), as tensors on the
        encoder's device; the POCs stay Python ints."""
        m = getattr(self, "_motion", {}).get(col_poc)
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        tp1 = ref_pocs[1][0] if ref_pocs[1] else ref_pocs[0][0]
        if m is None:
            z = torch.zeros((bh, bw), dtype=torch.int32, device=self.device)
            zb = torch.zeros((bh, bw), dtype=torch.bool, device=self.device)
            return (zb, z, z, z, z, zb, zb, z, z, 0, poc,
                    ref_pocs[0][0], tp1)

        def c16(a):
            return to_device(np.ascontiguousarray(a[::2, ::2]), self.device)

        return (c16(m["inter"]), c16(m["mv0x"]), c16(m["mv0y"]),
                c16(m["mv1x"]), c16(m["mv1y"]), c16(m["pf0"]),
                c16(m["pf1"]), c16(m["rp0"]), c16(m["rp1"]),
                int(m["poc"]), poc, ref_pocs[0][0], tp1)

    # video_codecs_tpu/models/hevc/inter_qt.py:614
    def _col_picmotion(self, col_poc):
        """motion_hm.PicMotion view of the stored collocated picture
        (serializer + decoder-parity TMVP derivation).  An unknown POC
        (the IDR) maps to an all-intra field — exactly the decoder's
        view, so candidate lists stay in lockstep."""
        cfg = self.cfg
        m = getattr(self, "_motion", {}).get(col_poc)
        if m is None:
            pm = motion_hm.PicMotion(cfg.width, cfg.height, col_poc)
            pm.intra[:] = True
            pm.decoded[:] = True
            return pm
        pm = motion_hm.PicMotion(cfg.width, cfg.height, m["poc"])

        def up(a):
            return np.repeat(np.repeat(a, 2, 0), 2, 1)

        pm.pf[0] = up(m["pf0"])
        pm.pf[1] = up(m["pf1"])
        pm.mv[0, :, :, 0] = up(m["mv0x"])
        pm.mv[0, :, :, 1] = up(m["mv0y"])
        pm.mv[1, :, :, 0] = up(m["mv1x"])
        pm.mv[1, :, :, 1] = up(m["mv1y"])
        pm.ref_idx[0] = np.where(pm.pf[0], up(m["r0"]), -1)
        pm.ref_idx[1] = np.where(pm.pf[1], up(m["r1"]), -1)
        pm.ref_poc[0] = up(m["rp0"])
        pm.ref_poc[1] = up(m["rp1"])
        pm.intra[:] = up(~m["inter"])
        pm.decoded[:] = True
        return pm

    # video_codecs_tpu/models/hevc/inter_qt.py:645
    def _device_phase(self, y, u, v, args, has_l1, lam,
                      tmvp_fields=None, no_backward=False):
        """Full device pipeline of one B picture: per-16 decision +
        CU8 tree + 32 merge tree + deblock, on the encoder's device.
        Returns the qt dict as numpy arrays (the copy back synchronises)."""
        cfg = self.cfg
        with torch.inference_mode():
            y, u, v = (to_device(np.asarray(p, np.uint8), self.device)
                       for p in (y, u, v))
            st16 = inter_dev.encode_b_frame_dev(
                y, u, v, *args,
                qp=cfg.qp, w=cfg.width, h=cfg.height, has_l1=has_l1,
                search_range=self.search_range, sbh=cfg.sign_data_hiding,
                rdoq=True, me_method=self.me_method, deblock=False,
                allow_intra=False, merge_eval="best4", lam=lam, rqt=True,
                cu8=self.cu8, tmvp_fields=tmvp_fields,
                no_backward=no_backward)
            qt = qt_merge_dev(
                y, u, v, *args, st16,
                qp=cfg.qp, w=cfg.width, h=cfg.height, has_l1=has_l1,
                sbh=cfg.sign_data_hiding, rdoq=True,
                deblock=not cfg.deblocking_disabled, lam=lam)
            return {k: t.cpu().numpy() for k, t in qt.items()}

    # video_codecs_tpu/models/hevc/inter_qt.py:666
    def _sao_decide_qt(self, origs, qt, lam):
        """Per-CTB32 SAO decision for the qt B path: classification +
        stats batched on the encoder's device (`_sao_stats`: the CUDA
        kernel on the card, one launch per plane), tiny per-CTU offset
        search on host (TEncSampleAdaptiveOffset::decideBlkParams
        analog; chroma shares type/EO-class per the sao() syntax)."""
        cfg = self.cfg
        if not lam:
            lam = 0.85 * 2.0 ** ((cfg.qp - 12) / 3.0)
        n_ctb = cfg.ctbs_x * cfg.ctbs_y
        stats = []
        with torch.inference_mode():
            for comp, ctb in ((0, 32), (1, 16), (2, 16)):
                o = _pad_to(np.asarray(origs[comp], np.uint8), ctb)
                r = _pad_to(np.asarray(qt["rec_y" if comp == 0 else
                                          ("rec_u" if comp == 1 else
                                           "rec_v")], np.uint8), ctb)
                stats.append([a.cpu().numpy() for a in _sao_stats(
                    to_device(o, self.device), to_device(r, self.device),
                    ctb)])
        params = [[None] * 3 for _ in range(n_ctb)]
        for by in range(cfg.ctbs_y):
            for bx in range(cfg.ctbs_x):
                i = by * cfg.ctbs_x + bx
                ec, es, bc, bsum = stats[0]
                params[i][0] = sao_ops.decide_from_stats(
                    ec[:, :, by, bx], es[:, :, by, bx], bc[:, by, bx],
                    bsum[:, by, bx], lam)
                ec, es, bc, bsum = stats[1]
                cb = sao_ops.decide_from_stats(
                    ec[:, :, by, bx], es[:, :, by, bx], bc[:, by, bx],
                    bsum[:, by, bx], lam)
                ec, es, bc, bsum = stats[2]
                if cb.type_idx == sao_ops.SAO_EO:
                    cr = sao_ops.decide_eo_from_stats(
                        ec[:, :, by, bx], es[:, :, by, bx],
                        cb.eo_class, lam)
                elif cb.type_idx == sao_ops.SAO_BO:
                    cr = sao_ops.decide_bo_from_stats(
                        bc[:, by, bx], bsum[:, by, bx], lam)
                else:
                    cr = sao_ops.SaoParam()
                params[i][1], params[i][2] = cb, cr
        return params

    # video_codecs_tpu/models/hevc/inter_qt.py:713
    def _serialize_qt_slice(self, qt, poc, is_anchor, ref_pocs,
                            sao_params=None) -> bytes:
        cfg = self.cfg
        rps = getattr(self, "_cur_rps", None)
        if rps is None:
            neg = [(p - poc, True) for p in ref_pocs[0] if p < poc]
            pos = [(p - poc, True) for p in ref_pocs[1] if p > poc]
            rps = (neg, pos)
        n0 = len(ref_pocs[0])
        n1 = max(1, len(ref_pocs[1]))
        w = ra.write_ra_slice_header(cfg, poc, 1 if is_anchor else 0,
                                     cfg.qp, *rps, n0=n0, n1=n1)
        enc = cabac.CabacEncoder(
            w, ctx.init_states(ctx.P if is_anchor else ctx.B, cfg.qp))

        col = None
        if cfg.temporal_mvp:
            col = self._col_picmotion(
                ref_pocs[1][0] if ref_pocs[1] else ref_pocs[0][0])
        st = _QtSliceState(cfg, qt, poc, is_anchor, ref_pocs, col)
        n_ctbs = cfg.ctbs_x * cfg.ctbs_y
        i = 0
        for cy in range(0, cfg.height, 32):
            for cx in range(0, cfg.width, 32):
                if sao_params is not None:
                    ic.encode_sao_ctu(enc, sao_params, i, cx // 32,
                                      cy // 32, cfg.ctbs_x, 0)
                self._code_qt_node(enc, st, cx, cy, 5)
                i += 1
                enc.encode_terminate(1 if i == n_ctbs else 0)
        enc.finish_slice()
        nal_type = NAL_TRAIL_R if getattr(self, "_cur_is_ref", True) \
            else NAL_TRAIL_N
        return bs.nal_unit(nal_type, w.data())

    # video_codecs_tpu/models/hevc/inter_qt.py:748
    def _code_qt_node(self, enc, st, x, y, log2):
        cfg = self.cfg
        size = 1 << log2
        inside = x + size <= cfg.width and y + size <= cfg.height
        if inside and log2 == 5:
            split = not bool(st.qt["merged32"][y // 32, x // 32])
            enc.encode_bin(ctx.off("split_cu_flag", st.split_ctx(x, y, 0)),
                           1 if split else 0)
            if not split:
                self._code_cu(enc, st, x, y, 32)
                return
        elif not inside:
            # implicit split (boundary CTB); recurse into valid children
            pass
        if log2 == 4:
            if inside:
                # min CB is 8: an explicit split flag at 16 (CU8 tree)
                sp8 = bool(st.qt.get("split8") is not None and
                           st.qt["split8"][y // 16, x // 16])
                enc.encode_bin(
                    ctx.off("split_cu_flag", st.split_ctx(x, y, 1)),
                    1 if sp8 else 0)
                if sp8:
                    for q in range(4):
                        self._code_cu8(enc, st, x + (q & 1) * 8,
                                       y + (q >> 1) * 8)
                else:
                    self._code_cu(enc, st, x, y, 16)
            return
        half = size // 2
        for q in range(4):
            nx, ny = x + (q & 1) * half, y + (q >> 1) * half
            if nx >= cfg.width or ny >= cfg.height:
                continue
            self._code_qt_node(enc, st, nx, ny, log2 - 1)

    # video_codecs_tpu/models/hevc/inter_qt.py:784
    def _code_cu(self, enc, st, x, y, size):
        cfg = self.cfg
        qt = st.qt
        bx, by = x // 16, y // 16
        nblk = size // 16
        depth = 5 - size.bit_length() + 1       # 0 at 32, 1 at 16
        st.set_depth(x, y, size, 0 if size == 32 else 1)
        if qt["pred_mode"][by, bx] == MODE_INTRA:
            self._code_intra_cu(enc, st, x, y)
            return
        d = int(qt["inter_dir"][by, bx])
        r0i = int(qt["ref0_idx"][by, bx]) if "ref0_idx" in qt else 0
        r1i = int(qt["ref1_idx"][by, bx]) if "ref1_idx" in qt else 0
        m = motion_hm.Motion(
            [bool(d & 1), bool(d & 2)],
            [(int(qt["mv0x"][by, bx]), int(qt["mv0y"][by, bx])),
             (int(qt["mv1x"][by, bx]), int(qt["mv1y"][by, bx]))],
            [r0i if d & 1 else -1, r1i if d & 2 else -1],
            [st.ref_pocs[L0][r0i] if d & 1 else 0,
             st.ref_pocs[L1][r1i] if d & 2 else 0])
        cands = motion_hm.merge_candidates_pu(
            st.pm, st.mctx, x, y, size, size, "2Nx2N", 0, cfg.log2_ctb)
        midx = next((i for i, c in enumerate(cands)
                     if c.same_motion(m)), -1)
        cbfs = [bool(qt[k][by:by + nblk, bx:bx + nblk].any())
                for k in ("cbf_y", "cbf_cb", "cbf_cr")]
        no_res = not any(cbfs)

        skip = midx >= 0 and no_res
        enc.encode_bin(ctx.off("skip_flag", st.skip_ctx(x, y)),
                       1 if skip else 0)
        if skip:
            self._code_merge_idx(enc, midx)
            st.set_inter(x, y, size, m, skip=True)
            return
        enc.encode_bin(ctx.off("pred_mode"), 0)
        enc.encode_bin(ctx.off("part_size"), 1)     # PART_2Nx2N
        enc.encode_bin(ctx.off("merge_flag"), 1 if midx >= 0 else 0)
        if midx >= 0:
            self._code_merge_idx(enc, midx)
            # 2Nx2N merge non-skip: rqt_root_cbf inferred 1
            assert not no_res, "no-residual merge must be skip"
        else:
            if not st.is_anchor:
                # inter_pred_idc, ctx = CU depth (sizes >= 16 -> 2 forms)
                if d == 3:
                    enc.encode_bin(ctx.off("inter_dir", depth), 1)
                else:
                    enc.encode_bin(ctx.off("inter_dir", depth), 0)
                    enc.encode_bin(ctx.off("inter_dir", 4),
                                   0 if d == 1 else 1)
            for lx in (L0, L1):
                if not m.pf[lx]:
                    continue
                self._code_ref_idx(enc, m.ref_idx[lx],
                                   len(st.ref_pocs[lx]))
                amvp = motion_hm.amvp_candidates_pu(
                    st.pm, st.mctx, x, y, size, size, lx, m.ref_idx[lx],
                    cfg.log2_ctb)
                mvds = [(m.mv[lx][0] - p[0], m.mv[lx][1] - p[1])
                        for p in amvp]
                bits = [pc.mvd_bits_estimate(dd) for dd in mvds]
                mi = 0 if bits[0] <= bits[1] else 1
                self._encode_mvd(enc, mvds[mi])
                enc.encode_bin(ctx.off("mvp_idx"), mi)
            enc.encode_bin(ctx.off("qt_root_cbf"), 0 if no_res else 1)
            if no_res:
                st.set_inter(x, y, size, m, skip=False)
                return
        # transform tree (spec 7.3.8.8, mirrored by GeneralDecoder
        # _decode_tt_inter): CU32 splits to 4 TU16; CU16 is TU == CU
        if size == 32:
            self._write_tt32(enc, st, x, y)
        elif bool(qt.get("tusplit") is not None and
                  qt["tusplit"][by, bx]):
            self._write_tt16_split(enc, st, x, y)
        else:
            if self.cfg.tt_depth_inter > 0:
                # trafoDepth 0 < MaxDepth: explicit non-split at 16
                enc.encode_bin(ctx.off("trans_subdiv", 1), 0)
            cbf_y, cbf_cb, cbf_cr = cbfs
            enc.encode_bin(ctx.off("cbf_chroma"), 1 if cbf_cb else 0)
            enc.encode_bin(ctx.off("cbf_chroma"), 1 if cbf_cr else 0)
            if cbf_cb or cbf_cr:
                enc.encode_bin(ctx.off("cbf_luma", 1), 1 if cbf_y else 0)
            else:
                assert cbf_y
            self._write_tu16(enc, st, x, y, cbf_y, cbf_cb, cbf_cr)
        st.set_inter(x, y, size, m, skip=False)

    # video_codecs_tpu/models/hevc/inter_qt.py:874
    def _code_cu8(self, enc, st, x, y):
        """One 8x8 CU of a split 16 (min CB): 2Nx2N PU with its own
        motion, TU8 luma + 4x4 chroma (spec 7.3.8.5; GeneralDecoder
        _decode_cu/_decode_inter_cu/_decode_tt_inter at log2 3)."""
        cfg = self.cfg
        qt = st.qt
        gy, gx = y // 8, x // 8
        st.set_depth(x, y, 8, 2)
        d = int(qt["dir8"][gy, gx])
        r0i = int(qt["r0_8"][gy, gx]) if "r0_8" in qt else 0
        r1i = int(qt["r1_8"][gy, gx]) if "r1_8" in qt else 0
        m = motion_hm.Motion(
            [bool(d & 1), bool(d & 2)],
            [(int(qt["mv0x8"][gy, gx]), int(qt["mv0y8"][gy, gx])),
             (int(qt["mv1x8"][gy, gx]), int(qt["mv1y8"][gy, gx]))],
            [r0i if d & 1 else -1, r1i if d & 2 else -1],
            [st.ref_pocs[L0][r0i] if d & 1 else 0,
             st.ref_pocs[L1][r1i] if d & 2 else 0])
        cands = motion_hm.merge_candidates_pu(
            st.pm, st.mctx, x, y, 8, 8, "2Nx2N", 0, cfg.log2_ctb)
        midx = next((i for i, c in enumerate(cands)
                     if c.same_motion(m)), -1)
        cbf_y = bool(qt["cbf_y8"][gy, gx])
        cbf_cb = bool(qt["cbf_cb4"][gy, gx])
        cbf_cr = bool(qt["cbf_cr4"][gy, gx])
        no_res = not (cbf_y or cbf_cb or cbf_cr)

        skip = midx >= 0 and no_res
        enc.encode_bin(ctx.off("skip_flag", st.skip_ctx(x, y)),
                       1 if skip else 0)
        if skip:
            self._code_merge_idx(enc, midx)
            st.set_inter(x, y, 8, m, skip=True)
            return
        enc.encode_bin(ctx.off("pred_mode"), 0)
        enc.encode_bin(ctx.off("part_size"), 1)     # PART_2Nx2N
        enc.encode_bin(ctx.off("merge_flag"), 1 if midx >= 0 else 0)
        if midx >= 0:
            self._code_merge_idx(enc, midx)
            assert not no_res, "no-residual merge must be skip"
        else:
            if not st.is_anchor:
                if d == 3:
                    enc.encode_bin(ctx.off("inter_dir", 2), 1)
                else:
                    enc.encode_bin(ctx.off("inter_dir", 2), 0)
                    enc.encode_bin(ctx.off("inter_dir", 4),
                                   0 if d == 1 else 1)
            for lx in (L0, L1):
                if not m.pf[lx]:
                    continue
                self._code_ref_idx(enc, m.ref_idx[lx],
                                   len(st.ref_pocs[lx]))
                amvp = motion_hm.amvp_candidates_pu(
                    st.pm, st.mctx, x, y, 8, 8, lx, m.ref_idx[lx],
                    cfg.log2_ctb)
                mvds = [(m.mv[lx][0] - p[0], m.mv[lx][1] - p[1])
                        for p in amvp]
                bits = [pc.mvd_bits_estimate(dd) for dd in mvds]
                mi = 0 if bits[0] <= bits[1] else 1
                self._encode_mvd(enc, mvds[mi])
                enc.encode_bin(ctx.off("mvp_idx"), mi)
            enc.encode_bin(ctx.off("qt_root_cbf"), 0 if no_res else 1)
            if no_res:
                st.set_inter(x, y, 8, m, skip=False)
                return
        # transform tree: TU8 (explicit non-split), chroma 4x4
        enc.encode_bin(ctx.off("trans_subdiv", 2), 0)
        enc.encode_bin(ctx.off("cbf_chroma", 0), 1 if cbf_cb else 0)
        enc.encode_bin(ctx.off("cbf_chroma", 0), 1 if cbf_cr else 0)
        if cbf_cb or cbf_cr:
            enc.encode_bin(ctx.off("cbf_luma", 1), 1 if cbf_y else 0)
        else:
            assert cbf_y
        sbh = cfg.sign_data_hiding
        if cbf_y:
            residual.encode_residual(
                enc, qt["coef_y"][y:y + 8, x:x + 8].astype(np.int32),
                3, rom.SCAN_DIAG, True, sign_hiding=sbh)
        cx, cy = x // 2, y // 2
        if cbf_cb:
            residual.encode_residual(
                enc, qt["coef_u"][cy:cy + 4, cx:cx + 4].astype(np.int32),
                2, rom.SCAN_DIAG, False, sign_hiding=sbh)
        if cbf_cr:
            residual.encode_residual(
                enc, qt["coef_v"][cy:cy + 4, cx:cx + 4].astype(np.int32),
                2, rom.SCAN_DIAG, False, sign_hiding=sbh)
        st.set_inter(x, y, 8, m, skip=False)

    # video_codecs_tpu/models/hevc/inter_qt.py:964
    def _write_tt16_split(self, enc, st, x, y):
        """CU16 transform tree split to 4 TU8 luma + 4x4 chroma per
        child (encoder RQT depth 1; GeneralDecoder _decode_tt_inter)."""
        qt = st.qt
        sbh = self.cfg.sign_data_hiding
        bx, by = x // 16, y // 16
        enc.encode_bin(ctx.off("trans_subdiv", 1), 1)
        cb_p = bool(qt["cbf_cb"][by, bx])
        cr_p = bool(qt["cbf_cr"][by, bx])
        enc.encode_bin(ctx.off("cbf_chroma", 0), 1 if cb_p else 0)
        enc.encode_bin(ctx.off("cbf_chroma", 0), 1 if cr_p else 0)
        for q in range(4):
            sx, sy = x + (q & 1) * 8, y + (q >> 1) * 8
            gy, gx = sy // 8, sx // 8
            cb = bool(qt["cbf_cb4"][gy, gx])
            cr = bool(qt["cbf_cr4"][gy, gx])
            if cb_p:
                enc.encode_bin(ctx.off("cbf_chroma", 1), 1 if cb else 0)
            else:
                assert not cb
            if cr_p:
                enc.encode_bin(ctx.off("cbf_chroma", 1), 1 if cr else 0)
            else:
                assert not cr
            cy_ = bool(qt["cbf_y8"][gy, gx])
            enc.encode_bin(ctx.off("cbf_luma", 0), 1 if cy_ else 0)
            if cy_:
                residual.encode_residual(
                    enc, qt["coef_y"][sy:sy + 8, sx:sx + 8]
                    .astype(np.int32), 3, rom.SCAN_DIAG, True,
                    sign_hiding=sbh)
            ccx, ccy = sx // 2, sy // 2
            if cb:
                residual.encode_residual(
                    enc, qt["coef_u"][ccy:ccy + 4, ccx:ccx + 4]
                    .astype(np.int32), 2, rom.SCAN_DIAG, False,
                    sign_hiding=sbh)
            if cr:
                residual.encode_residual(
                    enc, qt["coef_v"][ccy:ccy + 4, ccx:ccx + 4]
                    .astype(np.int32), 2, rom.SCAN_DIAG, False,
                    sign_hiding=sbh)

    # video_codecs_tpu/models/hevc/inter_qt.py:1007
    def _write_tt32(self, enc, st, x, y):
        """CU32 transform tree: split_transform_flag=1 + 4 TU16 children
        (chroma 8x8 per child, parent-conditioned cbf flags)."""
        qt = st.qt
        bx, by = x // 16, y // 16
        enc.encode_bin(ctx.off("trans_subdiv", 0), 1)
        cb_p = bool(qt["cbf_cb"][by:by + 2, bx:bx + 2].any())
        cr_p = bool(qt["cbf_cr"][by:by + 2, bx:bx + 2].any())
        enc.encode_bin(ctx.off("cbf_chroma", 0), 1 if cb_p else 0)
        enc.encode_bin(ctx.off("cbf_chroma", 0), 1 if cr_p else 0)
        for q in range(4):
            sx, sy = x + (q & 1) * 16, y + (q >> 1) * 16
            sbx, sby = sx // 16, sy // 16
            cb = bool(qt["cbf_cb"][sby, sbx])
            cr = bool(qt["cbf_cr"][sby, sbx])
            if cb_p:
                enc.encode_bin(ctx.off("cbf_chroma", 1), 1 if cb else 0)
            else:
                assert not cb
            if cr_p:
                enc.encode_bin(ctx.off("cbf_chroma", 1), 1 if cr else 0)
            else:
                assert not cr
            cy_ = bool(qt["cbf_y"][sby, sbx])
            enc.encode_bin(ctx.off("cbf_luma", 0), 1 if cy_ else 0)
            self._write_tu16(enc, st, sx, sy, cy_, cb, cr)

    # video_codecs_tpu/models/hevc/inter_qt.py:1034
    def _code_intra_cu(self, enc, st, x, y):
        cfg = self.cfg
        qt = st.qt
        bx, by = x // 16, y // 16
        enc.encode_bin(ctx.off("skip_flag", st.skip_ctx(x, y)), 0)
        enc.encode_bin(ctx.off("pred_mode"), 1)
        # intra CU at 16 is NOT min CB (8): no part_size bin
        mode = int(qt["intra_mode"][by, bx])
        mpm = st.mpm(x, y)
        if mode in mpm:
            enc.encode_bin(ctx.off("prev_intra_luma_pred"), 1)
            idx = mpm.index(mode)
            enc.encode_bypass(0 if idx == 0 else 1)
            if idx:
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(ctx.off("prev_intra_luma_pred"), 0)
            rem = mode
            for c in sorted(mpm, reverse=True):
                if mode > c:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
        enc.encode_bin(ctx.off("chroma_pred_mode"), 0)   # DM
        cbf_y = bool(qt["cbf_y"][by, bx])
        cbf_cb = bool(qt["cbf_cb"][by, bx])
        cbf_cr = bool(qt["cbf_cr"][by, bx])
        enc.encode_bin(ctx.off("cbf_chroma"), 1 if cbf_cb else 0)
        enc.encode_bin(ctx.off("cbf_chroma"), 1 if cbf_cr else 0)
        enc.encode_bin(ctx.off("cbf_luma", 1), 1 if cbf_y else 0)
        self._write_tu16(enc, st, x, y, cbf_y, cbf_cb, cbf_cr)
        st.set_intra(x, y, 16, mode)

    # video_codecs_tpu/models/hevc/inter_qt.py:1066
    def _write_tu16(self, enc, st, x, y, cbf_y, cbf_cb, cbf_cr):
        sbh = self.cfg.sign_data_hiding
        qt = st.qt
        if cbf_y:
            residual.encode_residual(
                enc, qt["coef_y"][y:y + 16, x:x + 16].astype(np.int32),
                4, rom.SCAN_DIAG, True, sign_hiding=sbh)
        cx, cy = x // 2, y // 2
        if cbf_cb:
            residual.encode_residual(
                enc, qt["coef_u"][cy:cy + 8, cx:cx + 8].astype(np.int32),
                3, rom.SCAN_DIAG, False, sign_hiding=sbh)
        if cbf_cr:
            residual.encode_residual(
                enc, qt["coef_v"][cy:cy + 8, cx:cx + 8].astype(np.int32),
                3, rom.SCAN_DIAG, False, sign_hiding=sbh)

    # video_codecs_tpu/models/hevc/inter_qt.py:1083
    def _code_ref_idx(self, enc, idx: int, nref: int) -> None:
        """TR ref_idx_lX: bins 0/1 ctx-coded, rest bypass (mirror of
        GeneralDecoder._parse_ref_idx / TDecSbac parseRefFrmIdx)."""
        if nref <= 1:
            return
        enc.encode_bin(ctx.off("ref_idx", 0), 1 if idx > 0 else 0)
        if idx == 0:
            return
        k = 1
        while k < nref - 1:
            b = 1 if idx > k else 0
            if k == 1:
                enc.encode_bin(ctx.off("ref_idx", 1), b)
            else:
                enc.encode_bypass(b)
            if not b:
                break
            k += 1

    # video_codecs_tpu/models/hevc/inter_qt.py:1102
    def _code_merge_idx(self, enc, idx: int) -> None:
        pc.LowDelayEncoder._encode_merge_idx(self, enc, idx)

    _encode_mvd = pc.LowDelayEncoder._encode_mvd


# video_codecs_tpu/models/hevc/inter_qt.py:1108
class _QtSliceState:
    """Per-slice serializer state: spec motion grid + depth/mode maps."""

    # video_codecs_tpu/models/hevc/inter_qt.py:1111
    def __init__(self, cfg, qt, poc, is_anchor, ref_pocs, col=None):
        self.cfg = cfg
        self.qt = qt
        self.is_anchor = is_anchor
        self.ref_pocs = ref_pocs
        self.pm = motion_hm.PicMotion(cfg.width, cfg.height, poc)
        no_backward = all(p <= poc for lst in ref_pocs for p in lst)
        self.mctx = motion_hm.SliceMotionCtx(
            poc, ref_pocs, not is_anchor,
            cfg.merge_cands, cfg.temporal_mvp and col is not None, col,
            False, no_backward)
        self.depth8 = np.zeros((cfg.height // 8, cfg.width // 8), np.int32)
        self.mode4 = np.full((cfg.height // 4, cfg.width // 4), DC,
                             np.int32)

    # video_codecs_tpu/models/hevc/inter_qt.py:1126
    def split_ctx(self, x, y, depth):
        c = 0
        if x > 0 and self.depth8[y // 8, (x - 1) // 8] > depth:
            c += 1
        if y > 0 and self.depth8[(y - 1) // 8, x // 8] > depth:
            c += 1
        return c

    # video_codecs_tpu/models/hevc/inter_qt.py:1134
    def set_depth(self, x, y, size, depth):
        s8 = size // 8
        self.depth8[y // 8:y // 8 + s8, x // 8:x // 8 + s8] = depth

    # video_codecs_tpu/models/hevc/inter_qt.py:1138
    def skip_ctx(self, x, y):
        pm = self.pm
        c = 0
        gx, gy = x // 4, y // 4
        if x > 0 and pm.decoded[gy, gx - 1] and pm.skip[gy, gx - 1]:
            c += 1
        if y > 0 and pm.decoded[gy - 1, gx] and pm.skip[gy - 1, gx]:
            c += 1
        return c

    # video_codecs_tpu/models/hevc/inter_qt.py:1148
    def set_inter(self, x, y, size, m, skip):
        self.pm.set_pu(x, y, size, size, m)
        if skip:
            self.pm.skip[y // 4:(y + size) // 4, x // 4:(x + size) // 4] \
                = True

    # video_codecs_tpu/models/hevc/inter_qt.py:1154
    def set_intra(self, x, y, size, mode):
        self.pm.set_intra(x, y, size)
        s4 = size // 4
        self.mode4[y // 4:y // 4 + s4, x // 4:x // 4 + s4] = mode

    # video_codecs_tpu/models/hevc/inter_qt.py:1159
    def mpm(self, x, y):
        """Spec MPM (twin of the general decoder's _PicState.mpm; CTB-row
        clamp for the above neighbor)."""
        pm = self.pm

        def mode_at(sx, sy, clamp_ctb):
            if sx < 0 or sy < 0 or sx >= self.cfg.width or \
                    sy >= self.cfg.height:
                return DC
            if clamp_ctb and (sy >> self.cfg.log2_ctb) != \
                    (y >> self.cfg.log2_ctb):
                return DC
            if not pm.decoded[sy // 4, sx // 4] or \
                    not pm.intra[sy // 4, sx // 4]:
                return DC
            return int(self.mode4[sy // 4, sx // 4])

        a = mode_at(x - 1, y, False)
        b = mode_at(x, y - 1, True)
        if a == b:
            if a < 2:
                return [0, 1, 26]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        out = [a, b]
        for third in (0, 1, 26):
            if third not in out:
                out.append(third)
                break
        return out
