"""Device H.264 P-slice engine in PyTorch (counterpart of
models/h264/inter_jax.py).

Two phases, as in the reference:

Phase 1 (device, `encode_p_dev`): full-search integer ME (SAD surfaces from
the Hopper kernel on CUDA) + half/quarter SATD refinement with the H.264
6-tap/bilinear filters for every 16x16 MB and every 8x8 sub-block,
P_16x16-vs-P_8x8 decision on coded cost, 4x4 transform + quant + recon,
chroma 2x2-DC + AC, all MBs at once.

Phase 2 (host, `DeviceH264Encoder._host_phase`): spec-exact median MV
prediction, P_Skip detection and CAVLC of exactly the device-decided
levels, with the port's own H.264 host stack (models/h264/inter_codec.py
and the modules under it).

The IDR is coded by the host intra encoder, as in the reference:
`DeviceH264Encoder` overrides only `_encode_p_frame`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import cavlc
from video_codecs_tpu_torch.entropy.bitstream import BitWriter
from video_codecs_tpu_torch.models.h264.inter_codec import (
    _BLK_X, _BLK_Y, H264Encoder, NcGrid, _code_residual_16,
    _NCBP_INTER_420, bs_maps_p, mv_pred_part, _commit_part, skip_mv,
    deblock_frame)
from video_codecs_tpu_torch.models.hevc.inter_dev import mvd_bits_dev
from video_codecs_tpu_torch.ops import h264_transform as ht
from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import h264_dev as hd
from video_codecs_tpu_torch.ops import me as me_ops
from video_codecs_tpu_torch.ops.quant import INV_LN2, fma32, log_1p_tables
from video_codecs_tpu_torch.utils.device import const, to_device



def _refine_h264(ref, cur, x0, y0, mvx, mvy, n, step):
    """One 8-neighbor refinement round at quarter-pel `step` with the
    H.264 interpolator + SATD."""
    best = cost_ops.hadamard_satd_8x8(
        cur, hd.mc_luma_dev(ref, x0, y0, mvx, mvy, n))
    for k in range(8):
        cx = mvx + int(me_ops._OFFS8[k][0]) * step
        cy = mvy + int(me_ops._OFFS8[k][1]) * step
        satd = cost_ops.hadamard_satd_8x8(
            cur, hd.mc_luma_dev(ref, x0, y0, cx, cy, n))
        better = satd < best
        best = torch.where(better, satd, best)
        mvx = torch.where(better, cx, mvx)
        mvy = torch.where(better, cy, mvy)
    return mvx, mvy, best


def _me_grid(ref, y_plane, ref8, n: int, sr: int, w: int, h: int):
    """Full ME for every aligned n-block: integer full search (on the
    uint8 reference ref8, as the SAD kernel takes it) + half + quarter
    refinement (on the int32 planes).  Returns (mvx, mvy, satd,
    bits-proxy) flat [B], the block origins and the int32 blocks."""
    bw, bh = w // n, h // n
    dev = ref.device
    x0 = (torch.arange(bw, dtype=torch.int32, device=dev) * n).repeat(bh)
    y0 = (torch.arange(bh, dtype=torch.int32, device=dev) * n
          ).repeat_interleave(bw)
    cur = hd._gather(y_plane, x0, y0, n, n)
    imx, imy = me_ops.integer_search(ref8, cur.to(torch.uint8), x0, y0, n,
                                     sr)
    mvx, mvy = imx * 4, imy * 4
    mvx, mvy, _ = _refine_h264(ref, cur, x0, y0, mvx, mvy, n, 2)
    mvx, mvy, satd = _refine_h264(ref, cur, x0, y0, mvx, mvy, n, 1)
    zero = torch.zeros((bh, 1), dtype=torch.int32, device=dev)
    px = torch.cat([zero, mvx.reshape(bh, bw)[:, :-1]], dim=1).reshape(-1)
    py = torch.cat([zero, mvy.reshape(bh, bw)[:, :-1]], dim=1).reshape(-1)
    bits = mvd_bits_dev(mvx - px, mvy - py)
    return mvx, mvy, satd, bits, x0, y0, cur


def _sum_in_order(a: torch.Tensor, dims: int) -> torch.Tensor:
    """float32 sum over the trailing `dims` dims, added one element at a
    time in row-major order, so the result is the same on every device."""
    flat = a.reshape(a.shape[:a.dim() - dims] + (-1,))
    s = flat[..., 0]
    for i in range(1, flat.shape[-1]):
        s = s + flat[..., i]
    return s


def _lv_bits(lv):
    """Coefficient-rate proxy per block batch [..., 4, 4] (bits):
    2 * (nonzero count + sum of log2(1 + |level|)) in the order XLA's CPU
    code computes it: the four rows as vector lanes, each summing its
    columns as a chain of FMAs of log(1 + a) and 1/ln 2, the lanes added
    as (row 0 + row 2) + (row 1 + row 3), then the count, then times 2."""
    a = lv.abs()
    ln = const(log_1p_tables()[0], lv.device, torch.float32)[a.long()]
    inv = torch.tensor(INV_LN2, device=lv.device)
    acc = ln[..., 0] * inv
    for j in range(1, 4):
        acc = fma32(ln[..., j], inv, acc)
    tot = (acc[..., 0] + acc[..., 2]) + (acc[..., 1] + acc[..., 3])
    return (tot + (a > 0).sum((-2, -1)).float()) * 2.0


def _blocks_to_plane(vals: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[bh*bw, n, n] blocks in raster order -> [bh*n, bw*n] plane."""
    n = vals.shape[-1]
    return vals.reshape(bh, bw, n, n).permute(0, 2, 1, 3).reshape(
        bh * n, bw * n)


def _up(grid: torch.Tensor, f: int) -> torch.Tensor:
    """Repeat each cell of a [gh, gw] grid f times along both axes."""
    return grid.repeat_interleave(f, 0).repeat_interleave(f, 1)


def _split_costs(d16, rb16, bits16, d8, rb8, bits8, lam: float, mbh: int,
                 mbw: int):
    """P_16x16 and P_8x8 costs per MB: j16 = d16 + lam * (rate + mv bits
    + 2), j8s = the four 8x8 children's d8 + lam * (rate + mv bits + 3),
    summed, + 4 lam; d8, rb8, bits8 on the raster 8 grid.  XLA's CPU
    code computes each `d + lam * r` as one fused multiply-add, so the
    port does too (`fma32`); the four children add left to right."""
    lamf = torch.tensor(lam, dtype=torch.float32, device=d16.device)
    j16 = fma32(rb16 + (bits16 + 2).float(), lamf, d16)
    g = fma32(rb8 + (bits8 + 3).float(), lamf, d8).reshape(mbh, 2, mbw, 2)
    j8s = (((g[:, 0, :, 0] + g[:, 0, :, 1]) + g[:, 1, :, 0])
           + g[:, 1, :, 1]).reshape(-1) + lamf * 4.0
    return j16, j8s


def encode_p_dev(y, u, v, ref_y, ref_u, ref_v, qp: int, w: int, h: int,
                 sr: int, lam: float) -> dict:
    """One P picture on the planes' device: ME (16 + 8), P16/P8x8
    decision on coded cost, residual transform/quant/recon, chroma
    DC+AC.  Returns maps + level planes + recon (pre-deblock), with the
    keys, shapes and dtypes of the reference's encode_p_dev."""
    if w % 16 or h % 16:
        raise ValueError(f"encode_p_dev needs MB-aligned planes, got {w}x{h}")
    qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
    mbw, mbh = w // 16, h // 16
    dev = y.device
    yi, ui, vi = y.int(), u.int(), v.int()
    ry, ru, rv = ref_y.int(), ref_u.int(), ref_v.int()
    ry8 = ref_y.to(torch.uint8)                  # samples are 0..255

    m16x, m16y, satd16, bits16, x16, y16, cur16 = _me_grid(
        ry, yi, ry8, 16, sr, w, h)
    m8x, m8y, satd8, bits8, x8, y8, cur8 = _me_grid(ry, yi, ry8, 8, sr, w, h)

    # ---- luma residual coding for both hypotheses ----
    def code_luma(pred, cur):
        res = cur - pred
        n = cur.shape[-1]
        b = cur.shape[0]
        k = n // 4
        blk = res.reshape(b, k, 4, k, 4).transpose(2, 3)
        lv = hd.quant_ac_dev(hd.fwd4x4_dev(blk), qp)
        r = hd.inv4x4_dev(hd.dequant_ac_dev(lv, qp))
        rec = (pred + r.transpose(2, 3).reshape(b, n, n)).clamp(0, 255)
        # integer squared error (< 2^24) is exact in float32
        d = ((cur - rec) ** 2).sum((-2, -1), dtype=torch.int32).float()
        bits = _sum_in_order(_lv_bits(lv), 2)
        return lv, rec, d, bits

    pred16 = hd.mc_luma_dev(ry, x16, y16, m16x, m16y, 16)
    lv16, rec16, d16, rb16 = code_luma(pred16, cur16)
    pred8 = hd.mc_luma_dev(ry, x8, y8, m8x, m8y, 8)
    lv8, rec8, d8, rb8 = code_luma(pred8, cur8)

    j16, j8s = _split_costs(d16, rb16, bits16, d8, rb8, bits8, lam, mbh,
                            mbw)
    split8 = j8s < j16                                   # [nmb]

    # ---- final luma recon/levels planes ----
    # Blocks are MB-aligned and tile the picture, so the reference's
    # masked scatters become a per-pixel select between two planes.
    s8g = split8.reshape(mbh, mbw)
    sel_pix = _up(s8g, 16)

    def lv_plane(lv, n):
        return lv.transpose(2, 3).reshape(lv.shape[0], n, n)

    rec_y = torch.where(sel_pix, _blocks_to_plane(rec8, 2 * mbh, 2 * mbw),
                        _blocks_to_plane(rec16, mbh, mbw))
    coef_y = torch.where(
        sel_pix, _blocks_to_plane(lv_plane(lv8, 8), 2 * mbh, 2 * mbw),
        _blocks_to_plane(lv_plane(lv16, 16), mbh, mbw))

    # ---- chroma: final assembled pred, 2x2 DC + AC ----
    cx16, cy16 = x16 // 2, y16 // 2
    sel8 = _up(s8g, 2).reshape(-1)
    fin8x = torch.where(sel8, m8x, _up(m16x.reshape(mbh, mbw), 2).reshape(-1))
    fin8y = torch.where(sel8, m8y, _up(m16y.reshape(mbh, mbw), 2).reshape(-1))
    predu4 = hd.mc_chroma_dev(ru, x8 // 2, y8 // 2, fin8x, fin8y, 4)
    predv4 = hd.mc_chroma_dev(rv, x8 // 2, y8 // 2, fin8x, fin8y, 4)
    # assemble per-MB 8x8 chroma pred from the four 4x4 sub-preds
    pu_pl = _blocks_to_plane(predu4, 2 * mbh, 2 * mbw)
    pv_pl = _blocks_to_plane(predv4, 2 * mbh, 2 * mbw)
    cur_u = hd._gather(ui, cx16, cy16, 8, 8)
    cur_v = hd._gather(vi, cx16, cy16, 8, 8)
    pu = hd._gather(pu_pl, cx16, cy16, 8, 8)
    pv = hd._gather(pv_pl, cx16, cy16, 8, 8)

    def code_chroma(co, cp):
        cres = co - cp
        cwt = hd.fwd4x4_dev(cres.reshape(-1, 2, 4, 2, 4).transpose(2, 3))
        cdc = cwt[:, :, :, 0, 0]
        dc_q = hd.quant_chroma_dc_dev(hd.hadamard2x2_dev(cdc), qpc)
        acq = hd.quant_ac_dev(cwt, qpc)
        acq[:, :, :, 0, 0] = 0
        dc_deq = hd.dequant_chroma_dc_dev(dc_q, qpc)
        d = hd.dequant_ac_dev(acq, qpc)
        d[:, :, :, 0, 0] = dc_deq
        rec = (cp + hd.inv4x4_dev(d).transpose(2, 3).reshape(-1, 8, 8)
               ).clamp(0, 255)
        return dc_q, acq, rec

    dcu, acu, rec_u_b = code_chroma(cur_u, pu)
    dcv, acv, rec_v_b = code_chroma(cur_v, pv)

    def ac_plane(acq):
        return _blocks_to_plane(acq.transpose(2, 3).reshape(-1, 8, 8),
                                mbh, mbw)

    return dict(
        split8=s8g,
        mv16x=m16x.reshape(mbh, mbw), mv16y=m16y.reshape(mbh, mbw),
        mv8x=m8x.reshape(2 * mbh, 2 * mbw),
        mv8y=m8y.reshape(2 * mbh, 2 * mbw),
        coef_y=coef_y.to(torch.int16),
        coef_u=ac_plane(acu).to(torch.int16),
        coef_v=ac_plane(acv).to(torch.int16),
        dc_u=dcu.to(torch.int16), dc_v=dcv.to(torch.int16),
        rec_y=rec_y.to(torch.uint8),
        rec_u=_blocks_to_plane(rec_u_b, mbh, mbw).to(torch.uint8),
        rec_v=_blocks_to_plane(rec_v_b, mbh, mbw).to(torch.uint8),
    )


class DeviceH264Encoder(H264Encoder):
    """H.264 baseline encoder with the P-slice pixel pipeline on `device`
    (ME + mode decision + transforms); host CAVLC phase 2.

    The work runs on the card unless the caller passes `device="cpu"`.
    The engine codes what the reference's does: one reference, full
    search, all partitions, hard quantization and CAVLC.  The options of
    `H264Encoder` beyond that raise NotImplementedError here; the
    reference asserts CAVLC and sends several references to its host
    coder (models/h264/inter_jax.py:236-252), which the port carries as
    `H264Encoder` itself.

    `p_times` collects (device-phase s, host-phase s) per P picture; the
    device phase includes the uploads and the copy of its result to the
    host, so it ends synchronised."""

    def __init__(self, width: int, height: int, qp: int = 28,
                 search_range: int = 16, *, device="cuda", **kw) -> None:
        engine = {"entropy": "cavlc", "perceptual": "", "n_refs": 1,
                  "quant": "normal", "me": "full", "weighted_pred": False,
                  "partitions": True, "transform8x8": False,
                  "long_term": False, "lt_period": 0, "reorder": "",
                  "intra_refresh": 0}
        bad = [k for k, v in kw.items() if engine.get(k, v) != v]
        if bad:
            raise NotImplementedError(
                f"DeviceH264Encoder: {', '.join(bad)} not on the device "
                "engine (one reference, full search, all partitions, hard "
                "quantization, CAVLC)")
        super().__init__(width, height, qp=qp,
                         search_range=search_range, device=device, **kw)
        self.p_times: list[tuple[float, float]] = []

    def _encode_p_frame(self, y, u, v, refs, frame_num, poc=None,
                        reorder_cmds=None, mmco=None):
        # the constructor refuses long-term references and reordering,
        # so `encode_sequence` hands no commands here
        t0 = time.perf_counter()
        st = self._device_phase(y, u, v, refs[0])
        t1 = time.perf_counter()
        out = self._host_phase(st, frame_num, poc)
        self.p_times.append((t1 - t0, time.perf_counter() - t1))
        return out

    def _device_phase(self, y, u, v, ref) -> dict:
        """Upload, run encode_p_dev, return its outputs as numpy."""
        qp = self.qp
        lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
        with torch.inference_mode():
            # the samples are 8-bit: the int32 reference planes go up as
            # uint8, a quarter of the bytes
            planes = [to_device(np.asarray(p, np.uint8), self.device)
                      for p in (y, u, v, *ref)]
            st = encode_p_dev(*planes, qp=qp, w=self.w, h=self.h,
                              sr=self.sr, lam=lam)
            return {k: t.cpu().numpy() for k, t in st.items()}

    # The host phase below is models/h264/inter_jax.py:267-419 as it is
    # (that module imports jax, so it cannot be imported here).
    def _host_phase(self, st, frame_num, poc):
        qp = self.qp
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
        mbw, mbh = self.w // 16, self.h // 16
        w4 = mbw * 4

        # ---- host phase: spec-exact median pred + CAVLC ----
        w = BitWriter()
        w.ue(0)                  # first_mb_in_slice
        w.ue(5)                  # slice_type = P
        w.ue(0)                  # pps_id
        w.write(frame_num & 0xFF, 8)
        if poc is not None:
            w.write(poc & 0xFFFF, 16)
        w.flag(0)                # num_ref_idx_active_override
        w.flag(0)                # ref_pic_list_modification
        w.flag(0)                # adaptive_ref_pic_marking
        w.se(qp - 26)
        w.ue(0)                  # disable_deblocking_filter_idc
        w.se(0)
        w.se(0)

        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        mvg = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg = np.full((mbh * 4, mbw * 4), -1, np.int32)
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)
        intra_mb = np.zeros((mbh, mbw), bool)
        zz = cavlc.ZIGZAG_4x4
        coef_y = st["coef_y"].astype(np.int32)
        coef_u = st["coef_u"].astype(np.int32)
        coef_v = st["coef_v"].astype(np.int32)
        skip_run = 0

        for mby in range(mbh):
            for mbx in range(mbw):
                x, yy = mbx * 16, mby * 16
                gx, gy = mbx * 4, mby * 4
                sp8 = bool(st["split8"][mby, mbx])
                # partitions in decode order with spec median pred
                if sp8:
                    parts = []
                    for b8 in range(4):
                        ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
                        mv = (int(st["mv8x"][2 * mby + (b8 >> 1),
                                             2 * mbx + (b8 & 1)]),
                              int(st["mv8y"][2 * mby + (b8 >> 1),
                                             2 * mbx + (b8 & 1)]))
                        pmv = mv_pred_part(mvg, refg, dec4,
                                           gx + ox // 4, gy + oy // 4,
                                           2, 2, 0, "")
                        _commit_part(mvg, refg, dec4, gx, gy, ox, oy,
                                     8, 8, 0, mv)
                        parts.append((ox, oy, 8, 8, 0, mv, pmv))
                    mb_type_sel, subs = 3, [0, 0, 0, 0]
                else:
                    mv = (int(st["mv16x"][mby, mbx]),
                          int(st["mv16y"][mby, mbx]))
                    smv = skip_mv(mvg, refg, gx, gy, w4)
                    pmv = mv_pred_part(mvg, refg, dec4, gx, gy, 4, 4,
                                       0, "")
                    _commit_part(mvg, refg, dec4, gx, gy, 0, 0, 16, 16,
                                 0, mv)
                    parts = [(0, 0, 16, 16, 0, mv, pmv)]
                    mb_type_sel, subs = 0, None

                # cbp from the level planes
                lv = np.zeros((4, 4, 4, 4), np.int32)
                for by4 in range(4):
                    for bx4 in range(4):
                        lv[by4, bx4] = coef_y[yy + by4 * 4:yy + by4 * 4
                                              + 4, x + bx4 * 4:x + bx4
                                              * 4 + 4]
                cbp_luma = 0
                for i8 in range(4):
                    ids = [4 * i8 + k for k in range(4)]
                    if any(lv[_BLK_Y[i], _BLK_X[i]].any() for i in ids):
                        cbp_luma |= 1 << i8
                cx8, cy8 = mbx * 8, mby * 8
                c_dc_q = [st["dc_u"][mby * mbw + mbx].astype(np.int32),
                          st["dc_v"][mby * mbw + mbx].astype(np.int32)]
                c_ac_q = []
                for cpl in (coef_u, coef_v):
                    acq = np.zeros((2, 2, 4, 4), np.int32)
                    for by2 in range(2):
                        for bx2 in range(2):
                            acq[by2, bx2] = cpl[
                                cy8 + by2 * 4:cy8 + by2 * 4 + 4,
                                cx8 + bx2 * 4:cx8 + bx2 * 4 + 4]
                    c_ac_q.append(acq)
                cbp_chroma = 2 if any(q.any() for q in c_ac_q) else (
                    1 if any(q.any() for q in c_dc_q) else 0)
                cbp = cbp_luma | (cbp_chroma << 4)

                if not sp8 and cbp == 0 and parts[0][5] == smv:
                    skip_run += 1
                    for bx4 in range(4):
                        for by4 in range(4):
                            nc_y.set(gx + bx4, gy + by4, 0)
                    for comp in (nc_u, nc_v):
                        for b2 in range(4):
                            comp.set(mbx * 2 + (b2 & 1),
                                     mby * 2 + (b2 >> 1), 0)
                    continue

                w.ue(skip_run)
                skip_run = 0
                w.ue(mb_type_sel)
                if mb_type_sel == 3:
                    for s in subs:
                        w.ue(s)
                for (_, _, _, _, _, mv_, pmv_) in parts:
                    w.se(mv_[0] - pmv_[0])
                    w.se(mv_[1] - pmv_[1])
                w.ue(_NCBP_INTER_420[cbp])
                if cbp:
                    w.se(0)      # mb_qp_delta
                for i8 in range(4):
                    for k in range(4):
                        idx = 4 * i8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        if cbp_luma & (1 << i8):
                            _code_residual_16(w, lv[y4, x4], nc_y,
                                              gx + x4, gy + y4)
                        else:
                            nc_y.set(gx + x4, gy + y4, 0)
                if cbp_chroma:
                    for comp in (0, 1):
                        dcs = c_dc_q[comp]
                        cavlc.encode_block(
                            w, [int(dcs[0, 0]), int(dcs[0, 1]),
                                int(dcs[1, 0]), int(dcs[1, 1])], -1, 4)
                for comp, grid in ((0, nc_u), (1, nc_v)):
                    for idx in range(4):
                        x4, y4 = idx & 1, idx >> 1
                        if cbp_chroma == 2:
                            coeffs = c_ac_q[comp][y4, x4].reshape(16)[zz][1:]
                            total = cavlc.encode_block(
                                w, [int(c) for c in coeffs],
                                grid.nc(mbx * 2 + x4, mby * 2 + y4), 15)
                        else:
                            total = 0
                        grid.set(mbx * 2 + x4, mby * 2 + y4, total)

        if skip_run:
            w.ue(skip_run)
        w.rbsp_trailing_bits()

        rec_y = st["rec_y"].astype(np.int32)
        rec_u = st["rec_u"].astype(np.int32)
        rec_v = st["rec_v"].astype(np.int32)
        bs_ver, bs_hor = bs_maps_p(intra_mb, nc_y.tc, mvg, refg)
        rec_y, rec_u, rec_v = deblock_frame(rec_y, rec_u, rec_v, qp, qpc,
                                            bs_ver, bs_hor)
        return w.data(), (rec_y, rec_u, rec_v)
