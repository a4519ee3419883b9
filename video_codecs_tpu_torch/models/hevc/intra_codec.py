"""HEVC intra host helpers: reference build, MPM, chroma QP, TB coding,
stream headers, the picture-hash SEI, the CTB16 IDR with SAO, and the
flat intra decoder.

The port's copy of video_codecs_tpu/models/hevc/intra_codec.py; each
function keeps its name and a comment gives the original's line.
`IntraEncoder.encode_frame` has two routes.  With `cfg.rdoq` set or
`modes` given it is the reference's host CTB loop: `decide_modes` (one
batched 35-mode `predict_intra` and one `hadamard_satd_8x8` on the
encoder's device, one copy back, then the MPM-aware choice in float64
numpy on the host), a raster recon with `code_tb_np` (float64
`rdoq_lite_np` or the host full RDOQ `ops/rdoq.rdoq_np`), the picture
deblock on the encoder's device, and with `cfg.sao` the SAO decision.
Otherwise it codes the picture on the flat CTB16 device encoder, whose
bytes the reference holds to its host loop at rdoq off
(tests/test_encoder_jax.py:9).  Both decide SAO from the device
statistics (`_sao_decide_apply`: luma CTB 16, chroma CTB 8) and write
the slice with the Python writer (the sao() syntax, and a zero
cu_qp_delta in coded CUs of cu_qp_delta pictures).  `IntraDecoder`
decodes those slices (`_decode_slice`, SAO applied with
`ops/sao.apply_ctus`).  Cut: WPP (the slice writer and decoder raise)
and tiles in the encoder.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, native, residual
from video_codecs_tpu_torch.models.hevc import headers
from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops import rdoq as rdoq_ops
from video_codecs_tpu_torch.ops import sao as sao_ops
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import to_device

DC = 1


# video_codecs_tpu/models/hevc/intra_codec.py:46
def build_ref_np(plane: np.ndarray, x: int, y: int, n: int,
                 tile_x0: int = 0, tile_x1: int | None = None) -> np.ndarray:
    """Substituted reference array (4N+1) for block at (x, y) from a
    partially reconstructed plane; availability follows tile-scan decode
    order and never crosses the [tile_x0, tile_x1) tile column."""
    h, w = plane.shape
    if tile_x1 is None:
        tile_x1 = w
    r = 4 * n + 1
    samples = np.zeros(r, np.int32)
    avail = np.zeros(r, bool)
    # left column k=0..2N-1: p[-1][2N-1-k]
    if x > tile_x0:
        for k in range(n, 2 * n):          # j = 2N-1-k in [0, N): left part
            j = 2 * n - 1 - k
            samples[k] = plane[y + j, x - 1]
            avail[k] = True
        # below-left j in [N, 2N): never decoded yet in raster block order
    if x > tile_x0 and y > 0:
        samples[2 * n] = plane[y - 1, x - 1]
        avail[2 * n] = True
    if y > 0:
        top_max = min(2 * n, tile_x1 - x)  # clipped at tile/picture edge
        for i in range(top_max):
            samples[2 * n + 1 + i] = plane[y - 1, x + i]
            avail[2 * n + 1 + i] = True
    # spec 8.4.4.2.2 substitution
    if not avail.any():
        return np.full(r, 128, np.int32)
    out = samples.copy()
    if not avail[0]:
        out[0] = samples[np.argmax(avail)]
    for k in range(1, r):
        if not avail[k]:
            out[k] = out[k - 1]
    return out


# video_codecs_tpu/models/hevc/intra_codec.py:84
def mpm_list(left_mode: int) -> list[int]:
    """MPM candidates; above candidate is always DC because every CU is a
    CTB top row (spec 8.4.2 line-buffer rule)."""
    cand_a, cand_b = left_mode, DC
    if cand_a == cand_b:
        if cand_a < 2:
            return [0, 1, 26]
        return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 2 + 1) % 32)]
    out = [cand_a, cand_b]
    for third in (0, 1, 26):
        if third not in out:
            out.append(third)
            break
    return out


# video_codecs_tpu/models/hevc/intra_codec.py:100
def chroma_qp(qp: int) -> int:
    return int(rom.CHROMA_QP_TABLE_420[max(0, min(57, qp))])


# video_codecs_tpu/models/hevc/intra_codec.py:104
def code_tb_np(orig: np.ndarray, pred: np.ndarray, qp: int, log2: int,
               dst: bool, sbh: bool = False, rdoq: bool | str = False,
               is_luma: bool = True,
               scan_type: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Transform+quant one TB; returns (levels, recon).

    rdoq: False = hard quantization, True/"lite" = soft-decision RDOQ-lite,
    "full" = full CG/last-pos RDOQ (ops/rdoq.py, HM xRateDistOptQuant twin).
    scan_type: coefficient scan of the TB (needed so SBH parity is fixed
    over the CGs of the scan the residual is actually coded with).
    """
    res = orig.astype(np.int32) - pred
    coeff = tr_ops.forward_transform_np(res, log2, dst=dst)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq == "full":
        levels = rdoq_ops.rdoq_np(coeff, qp, log2, lam=lam, is_luma=is_luma)
    elif rdoq:
        levels = quant_ops.rdoq_lite_np(coeff, qp, log2, lam=lam)
    else:
        levels = quant_ops.quantize_np(coeff, qp, log2)
    if sbh and levels.any():
        levels = quant_ops.apply_sbh_np(levels, log2, coeff, qp,
                                        scan_type=scan_type)
    if not levels.any():
        return levels, pred.astype(np.int32)
    dq = quant_ops.dequantize_np(levels, qp, log2)
    r = tr_ops.inverse_transform_np(dq, log2, dst=dst)
    return levels, np.clip(pred + r, 0, 255).astype(np.int32)


# video_codecs_tpu/models/hevc/intra_codec.py:135
@dataclasses.dataclass
class CtuData:
    mode: int
    levels_y: np.ndarray | None
    levels_cb: np.ndarray | None
    levels_cr: np.ndarray | None


# video_codecs_tpu/models/hevc/intra_codec.py:143
def encode_sao_ctu(enc, params, i, bx, by, bw, tx0):
    """sao() syntax for one CTU (spec 7.3.8.3)."""
    left_same = (bx > tx0 and
                 all(params[i - 1][c].key() == params[i][c].key()
                     for c in range(3)))
    if bx > tx0:
        enc.encode_bin(ctx.off("sao_merge"), 1 if left_same else 0)
        if left_same:
            return
    up_same = (by > 0 and
               all(params[i - bw][c].key() == params[i][c].key()
                   for c in range(3)))
    if by > 0:
        enc.encode_bin(ctx.off("sao_merge"), 1 if up_same else 0)
        if up_same:
            return
    for c in range(3):
        p = params[i][c]
        if c < 2:  # type coded for luma (c==0) and chroma (c==1)
            enc.encode_bin(ctx.off("sao_type"),
                           0 if p.type_idx == sao_ops.SAO_OFF else 1)
            if p.type_idx != sao_ops.SAO_OFF:
                enc.encode_bypass(
                    1 if p.type_idx == sao_ops.SAO_EO else 0)
        if p.type_idx == sao_ops.SAO_OFF:
            continue
        for k in range(4):
            mag = abs(p.offsets[k])
            for _ in range(mag):
                enc.encode_bypass(1)
            if mag < 7:
                enc.encode_bypass(0)
        if p.type_idx == sao_ops.SAO_BO:
            for k in range(4):
                if p.offsets[k]:
                    enc.encode_bypass(1 if p.offsets[k] < 0 else 0)
            enc.encode_bypass_bins(p.band_position, 5)
        elif c < 2:
            enc.encode_bypass_bins(p.eo_class, 2)


# video_codecs_tpu/models/hevc/intra_codec.py:183
def decode_sao_ctu(dec, params, i, bx, by, bw, tx0):
    if bx > tx0 and dec.decode_bin(ctx.off("sao_merge")):
        params[i] = [params[i - 1][c] for c in range(3)]
        return
    if by > 0 and dec.decode_bin(ctx.off("sao_merge")):
        params[i] = [params[i - bw][c] for c in range(3)]
        return
    out = []
    for c in range(3):
        if c < 2:
            if dec.decode_bin(ctx.off("sao_type")):
                type_idx = (sao_ops.SAO_EO if dec.decode_bypass()
                            else sao_ops.SAO_BO)
            else:
                type_idx = sao_ops.SAO_OFF
        else:
            type_idx = out[1].type_idx
        if type_idx == sao_ops.SAO_OFF:
            out.append(sao_ops.SaoParam())
            continue
        mags = []
        for k in range(4):
            m = 0
            while m < 7 and dec.decode_bypass():
                m += 1
            mags.append(m)
        if type_idx == sao_ops.SAO_BO:
            offs = []
            for k in range(4):
                if mags[k]:
                    neg = dec.decode_bypass()
                    offs.append(-mags[k] if neg else mags[k])
                else:
                    offs.append(0)
            pos = dec.decode_bypass_bins(5)
            out.append(sao_ops.SaoParam(type_idx, 0, pos, tuple(offs)))
        else:
            ec = (dec.decode_bypass_bins(2) if c < 2
                  else out[1].eo_class)
            out.append(sao_ops.SaoParam(type_idx, ec, 0, tuple(mags)))
    params[i] = out


# video_codecs_tpu/models/hevc/intra_codec.py:230
class IntraEncoder:
    # video_codecs_tpu/models/hevc/intra_codec.py:231
    def __init__(self, cfg: headers.HevcConfig, *, device="cuda") -> None:
        assert cfg.width % 16 == 0 and cfg.height % 16 == 0, \
            "pad input or use conformance window (not yet emitted)"
        self.cfg = cfg
        self._wrote_headers = False
        self.device = torch.device(device)

    # video_codecs_tpu/models/hevc/intra_codec.py:237
    def stream_headers(self) -> list[bytes]:
        return [
            bs.nal_unit(bs.NAL_VPS, headers.write_vps(self.cfg)),
            bs.nal_unit(bs.NAL_SPS, headers.write_sps(self.cfg)),
            bs.nal_unit(bs.NAL_PPS, headers.write_pps(self.cfg)),
        ]

    # video_codecs_tpu/models/hevc/intra_codec.py:244
    def decide_modes(self, y: np.ndarray) -> np.ndarray:
        """Batched 35-mode SATD sweep from original neighbors + sequential
        MPM-aware bit cost (SURVEY.md §7.1).  The sweep (`predict_intra`
        of every block at all 35 modes, `hadamard_satd_8x8` against the
        originals) runs on the encoder's device, one copy back; the MPM
        raster is the reference's float64 numpy on the host."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        bounds = cfg.tile_col_bounds()
        tile_of = np.zeros(bw, np.int32)
        for t, (tx0, tx1) in enumerate(bounds):
            tile_of[tx0:tx1] = t
        nb = bw * bh
        refs = np.zeros((nb, 65), np.int32)
        origs = np.zeros((nb, 16, 16), np.int32)
        yv = y.astype(np.int32)
        for by in range(bh):
            for bx in range(bw):
                i = by * bw + bx
                tx0, tx1 = bounds[tile_of[bx]]
                refs[i] = build_ref_np(yv, bx * 16, by * 16, 16,
                                       tx0 * 16, tx1 * 16)
                origs[i] = yv[by * 16:(by + 1) * 16, bx * 16:(bx + 1) * 16]
        with torch.inference_mode():
            modes = torch.arange(35, dtype=torch.int32,
                                 device=self.device).expand(nb, 35)
            preds = intra_ops.predict_intra(to_device(refs, self.device),
                                            modes, 4)
            satd = cost_ops.hadamard_satd_8x8(
                to_device(origs, self.device)[:, None],
                preds).cpu().numpy()                      # [nb, 35]

        sqrt_lambda = math.sqrt(0.57 * 2.0 ** ((cfg.qp - 12) / 3.0))
        best = np.zeros(nb, np.int32)
        for by in range(bh):
            for bx in range(bw):
                i = by * bw + bx
                at_tile_edge = bx == bounds[tile_of[bx]][0]
                left = DC if at_tile_edge else int(best[i - 1])
                mpm = mpm_list(left)
                bits = np.full(35, 5.0 + 1.0)
                bits[mpm[0]] = 2.0
                bits[mpm[1]] = 3.0
                bits[mpm[2]] = 3.0
                cost = satd[i] + np.round(sqrt_lambda * bits)
                best[i] = int(np.argmin(cost))
        return best.reshape(bh, bw)

    # video_codecs_tpu/models/hevc/intra_codec.py:289
    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     modes: np.ndarray | None = None):
        """Encode one frame; returns (list of NALs, recon (y, u, v)).

        With `cfg.rdoq` set or `modes` given, the reference's host CTB
        loop (`_encode_frame_host`); otherwise the flat CTB16 device
        encoder (`_dispatch`), which gives the host loop's bytes at rdoq
        off (tests/test_encoder_jax.py:9).  Then, with `cfg.sao`, the SAO
        decision and apply (`_sao_decide_apply`), and `_encode_slice`,
        the Python writer that carries the sao() syntax.  WPP and tiles
        raise ValueError."""
        cfg = self.cfg
        if cfg.wpp:
            raise ValueError("IntraEncoder.encode_frame: WPP is not ported")
        if cfg.tile_columns != 1:
            raise ValueError("tiles are not ported (parallel.tiles)")
        if cfg.rdoq or modes is not None:
            ctus, (rec_y, rec_u, rec_v) = self._encode_frame_host(
                y, u, v, modes)
        else:
            bw, bh = cfg.width // 16, cfg.height // 16
            st = {k: t.cpu().numpy()
                  for k, t in self._dispatch(y, u, v).items()}
            modes = st["modes"].reshape(-1)
            lv_y, lv_cb, lv_cr = (st["levels_y"], st["levels_cb"],
                                  st["levels_cr"])
            cbf = st["cbf"]
            rec_y, rec_u, rec_v = (st[k].astype(np.int32)
                                   for k in ("rec_y", "rec_u", "rec_v"))
            ctus = [CtuData(mode=int(modes[i]),
                            levels_y=lv_y[i] if cbf[0, i] else None,
                            levels_cb=lv_cb[i] if cbf[1, i] else None,
                            levels_cr=lv_cr[i] if cbf[2, i] else None)
                    for i in range(bw * bh)]

        sao_params = None
        if cfg.sao:
            yv, uv, vv = (np.asarray(p).astype(np.int32) for p in (y, u, v))
            sao_params, (rec_y, rec_u, rec_v) = self._sao_decide_apply(
                (yv, uv, vv), (rec_y, rec_u, rec_v))

        slice_nal = self._encode_slice(ctus, sao_params)
        sei_nal = self._hash_sei(rec_y, rec_u, rec_v)
        return [slice_nal, sei_nal], (rec_y, rec_u, rec_v)

    def _encode_frame_host(self, y, u, v, modes=None):
        """The reference's host CTB loop (intra_codec.py:292-336): the
        modes from `decide_modes` unless given, then per CTB in raster
        order the intra prediction from the reconstruction and
        `code_tb_np` (with `cfg.rdoq`'s host RDOQ) for luma and both
        chroma TBs, then the picture deblock (`deblock_420` on the
        encoder's device, one copy each way).  Returns (CtuData list,
        deblocked recon)."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        if modes is None:
            modes = self.decide_modes(y)
        qp_c = chroma_qp(cfg.qp)

        rec_y = np.zeros((cfg.height, cfg.width), np.int32)
        rec_u = np.zeros((cfg.height // 2, cfg.width // 2), np.int32)
        rec_v = np.zeros_like(rec_u)
        yv, uv, vv = (np.asarray(p).astype(np.int32) for p in (y, u, v))

        ctus: list[CtuData] = [None] * (bw * bh)  # type: ignore
        tile_iter = [(bx, by, tx0, tx1)
                     for (tx0, tx1) in cfg.tile_col_bounds()
                     for by in range(bh) for bx in range(tx0, tx1)]
        for bx, by, tx0, tx1 in tile_iter:
            mode = int(modes[by, bx])
            x, yy = bx * 16, by * 16
            ref = build_ref_np(rec_y, x, yy, 16, tx0 * 16, tx1 * 16)
            pred = intra_ops.predict_intra_np(ref, mode, 4)
            lv, rec = code_tb_np(yv[yy:yy + 16, x:x + 16], pred, cfg.qp, 4,
                                 dst=False, sbh=cfg.sign_data_hiding,
                                 rdoq=cfg.rdoq)
            rec_y[yy:yy + 16, x:x + 16] = rec
            cx, cy = x // 2, yy // 2
            out_c = []
            for plane_o, plane_r in ((uv, rec_u), (vv, rec_v)):
                refc = build_ref_np(plane_r, cx, cy, 8, tx0 * 8, tx1 * 8)
                predc = intra_ops.predict_intra_np(refc, mode, 3,
                                                   is_luma=False)
                lvc, recc = code_tb_np(plane_o[cy:cy + 8, cx:cx + 8],
                                       predc, qp_c, 3, dst=False,
                                       sbh=cfg.sign_data_hiding,
                                       rdoq=cfg.rdoq)
                plane_r[cy:cy + 8, cx:cx + 8] = recc
                out_c.append(lvc)
            ctus[by * bw + bx] = CtuData(
                mode=mode,
                levels_y=lv if lv.any() else None,
                levels_cb=out_c[0] if out_c[0].any() else None,
                levels_cr=out_c[1] if out_c[1].any() else None)

        if not cfg.deblocking_disabled:
            with torch.inference_mode():
                out = deblock_ops.deblock_420(
                    *(to_device(p, self.device)
                      for p in (rec_y, rec_u, rec_v)), cfg.qp)
                rec_y, rec_u, rec_v = (o.cpu().numpy() for o in out)
        return ctus, (rec_y, rec_u, rec_v)

    # video_codecs_tpu/models/hevc/intra_codec.py:347
    def _sao_decide_apply(self, origs, recs):
        """Per-CTU SAO decision (luma + jointly-typed chroma) and apply.

        The flat engines' CTBs: luma 16, chroma 8.  The reference decides
        each CTB on the host from the planes (`decide_ctu`, and for Cr at
        Cb's type `_sao_eo_for` / `_sao_bo_for`); the port takes each
        plane's per-CTB statistics from `ops/sao.sao_stats` (the CUDA
        kernel on the card: three launches a picture) and decides from
        them with the same float64 arithmetic (`decide_from_stats`,
        `decide_eo_from_stats`, `decide_bo_from_stats`: the band windows'
        costs, which `_sao_bo_for` sums in a loop, are numpy's 4-entry
        sums, left to right too; tests/test_torch_hevc_sao.py holds the
        two to each other), then applies each plane with `apply_ctus` (a
        loop of `apply_ctu`)."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        lam = 0.57 * 2.0 ** ((cfg.qp - 12) / 3.0)
        stats = []
        with torch.inference_mode():
            for comp, ctb in ((0, 16), (1, 8), (2, 8)):
                o, r = (to_device(np.asarray(p[comp], np.uint8), self.device)
                        for p in (origs, recs))
                stats.append([a.cpu().numpy()
                              for a in sao_ops.sao_stats(o, r, ctb)])
        params = [[None] * 3 for _ in range(bw * bh)]
        for by in range(bh):
            for bx in range(bw):
                i = by * bw + bx
                ec, es, bc, bsum = stats[0]
                params[i][0] = sao_ops.decide_from_stats(
                    ec[:, :, by, bx], es[:, :, by, bx], bc[:, by, bx],
                    bsum[:, by, bx], lam)
                ec, es, bc, bsum = stats[1]
                cb = sao_ops.decide_from_stats(
                    ec[:, :, by, bx], es[:, :, by, bx], bc[:, by, bx],
                    bsum[:, by, bx], lam)
                # chroma components share type and EO class (spec sao())
                ec, es, bc, bsum = stats[2]
                if cb.type_idx == sao_ops.SAO_EO:
                    cr = sao_ops.decide_eo_from_stats(
                        ec[:, :, by, bx], es[:, :, by, bx], cb.eo_class, lam)
                elif cb.type_idx == sao_ops.SAO_BO:
                    cr = sao_ops.decide_bo_from_stats(
                        bc[:, by, bx], bsum[:, by, bx], lam)
                else:
                    cr = sao_ops.SaoParam()
                params[i][1], params[i][2] = cb, cr
        outs = tuple(sao_ops.apply_ctus(recs[c], [p[c] for p in params],
                                        16 if c == 0 else 8, bw)
                     for c in range(3))
        return params, outs

    # video_codecs_tpu/models/hevc/intra_codec.py:413
    def _encode_slice(self, ctus: list[CtuData], sao_params=None) -> bytes:
        """Serialize the slice; with tiles, one CABAC substream per tile
        in tile-scan order with entry-point offsets in the header."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        bounds = cfg.tile_col_bounds()
        substreams = []
        for t, (tx0, tx1) in enumerate(bounds):
            w = bs.BitWriter()
            enc = cabac.CabacEncoder(w, ctx.init_states(ctx.I, cfg.qp))
            last_tile = t == len(bounds) - 1
            for by in range(bh):
                for bx in range(tx0, tx1):
                    ctu = ctus[by * bw + bx]
                    if sao_params is not None:
                        encode_sao_ctu(enc, sao_params, by * bw + bx,
                                       bx, by, bw, tx0)
                    left_mode = ctus[by * bw + bx - 1].mode if bx > tx0 else DC
                    self._encode_ctu(enc, ctu, left_mode)
                    last_ctu = (by == bh - 1 and bx == tx1 - 1)
                    enc.encode_terminate(1 if (last_ctu and last_tile) else 0)
                    if last_ctu and not last_tile:
                        enc.encode_terminate(1)  # end_of_subset_one_bit
            enc.finish_slice()
            substreams.append(w.data())
        hdr = headers.write_slice_header(
            cfg, bs.NAL_IDR_W_RADL,
            entry_points=[len(ss) for ss in substreams[:-1]])
        return bs.nal_unit(bs.NAL_IDR_W_RADL,
                           hdr.data() + b"".join(substreams))

    # video_codecs_tpu/models/hevc/intra_codec.py:448
    def _encode_ctu(self, enc: cabac.CabacEncoder, ctu: CtuData,
                    left_mode: int) -> None:
        enc.encode_bin(ctx.off("part_size"), 1)  # PART_2Nx2N
        mpm = mpm_list(left_mode)
        mode = ctu.mode
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
        enc.encode_bin(ctx.off("chroma_pred_mode"), 0)  # DM
        enc.encode_bin(ctx.off("cbf_chroma"), 0 if ctu.levels_cb is None else 1)
        enc.encode_bin(ctx.off("cbf_chroma"), 0 if ctu.levels_cr is None else 1)
        enc.encode_bin(ctx.off("cbf_luma", 1), 0 if ctu.levels_y is None else 1)
        if getattr(self.cfg, "cu_qp_delta", False) and (
                ctu.levels_y is not None or ctu.levels_cb is not None or
                ctu.levels_cr is not None):
            # PPS cu_qp_delta applies to I slices too; intra uses delta 0
            from video_codecs_tpu_torch.models.hevc.inter_codec import \
                encode_cu_qp_delta
            encode_cu_qp_delta(enc, 0)
        sbh = self.cfg.sign_data_hiding
        if ctu.levels_y is not None:
            residual.encode_residual(enc, ctu.levels_y, 4, rom.SCAN_DIAG, True,
                                     sign_hiding=sbh)
        if ctu.levels_cb is not None:
            residual.encode_residual(enc, ctu.levels_cb, 3, rom.SCAN_DIAG,
                                     False, sign_hiding=sbh)
        if ctu.levels_cr is not None:
            residual.encode_residual(enc, ctu.levels_cr, 3, rom.SCAN_DIAG,
                                     False, sign_hiding=sbh)

# video_codecs_tpu/models/hevc/intra_codec.py:522
    def _hash_sei(self, rec_y, rec_u, rec_v) -> bytes | None:
        if not getattr(self.cfg, "hash_sei", True):
            return None           # annexb() drops None entries
        w = bs.BitWriter()
        w.write(132, 8)           # payloadType = decoded_picture_hash
        w.write(1 + 48, 8)        # payloadSize
        w.write(0, 8)             # hash_type = MD5
        for plane in (rec_y, rec_u, rec_v):
            md5 = hashlib.md5(plane.astype(np.uint8).tobytes()).digest()
            for b in md5:
                w.write(b, 8)
        w.rbsp_trailing_bits()
        return bs.nal_unit(bs.NAL_SUFFIX_SEI, w.data())


    # video_codecs_tpu/models/hevc/intra_codec.py:536
    def encode_frame_fast(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Device path: the flat CTB16 encoder on the encoder's device,
        then the native C++ CABAC serializer."""
        return self.serialize_frame(self._dispatch(y, u, v))

    def _dispatch(self, y, u, v) -> dict:
        """Upload the 8-bit planes and run `encoder_dev.encode_frame`;
        returns its dict of tensors on the device (not synchronised)."""
        from video_codecs_tpu_torch.models.hevc import encoder_dev

        cfg = self.cfg
        if cfg.tile_columns != 1:
            raise ValueError("tiles are not ported (parallel.tiles)")
        bw, bh = cfg.width // 16, cfg.height // 16
        with torch.inference_mode():
            planes = [to_device(np.asarray(p, np.uint8), self.device)
                      for p in (y, u, v)]
            return encoder_dev.encode_frame(
                *planes, cfg.qp, bw, bh, deblock=not cfg.deblocking_disabled,
                sbh=cfg.sign_data_hiding, rdoq=bool(cfg.rdoq))

    # video_codecs_tpu/models/hevc/intra_codec.py:554
    def serialize_frame(self, st, use_native: bool = True):
        """Host tail: fetch device outputs once, CABAC-serialize, hash."""
        cfg = self.cfg
        if cfg.sao:
            raise ValueError("SAO uses encode_frame (the native writer has "
                             "no sao() syntax)")
        bw, bh = cfg.width // 16, cfg.height // 16
        st = {k: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a)) for k, a in st.items()}
        modes = st["modes"].reshape(-1)
        lv_y, lv_cb, lv_cr = st["levels_y"], st["levels_cb"], st["levels_cr"]
        cbf = st["cbf"]
        rec = (st["rec_y"], st["rec_u"], st["rec_v"])

        if use_native:
            header = headers.write_slice_header(cfg, bs.NAL_IDR_W_RADL).data()
            payload = native.encode_slice_native(
                bw, bh, cfg.qp, modes, cbf, lv_y, lv_cb, lv_cr, header,
                ctx.init_states(ctx.I, cfg.qp),
                sign_hiding=cfg.sign_data_hiding)
            h0 = bs.NAL_IDR_W_RADL << 1
            slice_nal = bytes([h0, 1]) + payload
        else:
            ctus = [CtuData(mode=int(modes[i]),
                            levels_y=lv_y[i] if cbf[0, i] else None,
                            levels_cb=lv_cb[i] if cbf[1, i] else None,
                            levels_cr=lv_cr[i] if cbf[2, i] else None)
                    for i in range(bw * bh)]
            slice_nal = self._encode_slice(ctus)
        sei_nal = self._hash_sei(*rec)
        return [slice_nal, sei_nal], rec

    # video_codecs_tpu/models/hevc/intra_codec.py:588
    def encode_sequence(self, frames, fast: bool = False) -> tuple[bytes, list]:
        """frames: iterable of (y, u, v); returns (annexb stream, recons).

        The fast path dispatches every picture to the device first, then
        copies each state back and serializes it."""
        nals = self.stream_headers()
        recons = []
        if fast:
            states = [self._dispatch(y, u, v) for (y, u, v) in frames]
            states = [{k: a.cpu() for k, a in st.items()} for st in states]
            for st in states:
                frame_nals, rec = self.serialize_frame(st)
                nals.extend(frame_nals)
                recons.append(rec)
        else:
            for (y, u, v) in frames:
                frame_nals, rec = self.encode_frame(y, u, v)
                nals.extend(frame_nals)
                recons.append(rec)
        return bs.annexb(nals), recons


# video_codecs_tpu/models/hevc/intra_codec.py:627
class IntraDecoder:
    # video_codecs_tpu/models/hevc/intra_codec.py:628
    def __init__(self) -> None:
        self.cfg: headers.HevcConfig | None = None
        self.pps: headers.PpsInfo | None = None
        self.hash_status: list[bool] = []

    # video_codecs_tpu/models/hevc/intra_codec.py:633
    def decode(self, stream: bytes) -> list[tuple[np.ndarray, ...]]:
        frames = []
        pending_hash: list[bytes] | None = None
        for nal in bs.split_annexb(stream):
            nal_type = (nal[0] >> 1) & 0x3F
            rbsp = bs.strip_emulation_prevention(nal[2:])
            if nal_type == bs.NAL_VPS:
                continue
            if nal_type == bs.NAL_SPS:
                self.cfg = headers.parse_sps(rbsp)
            elif nal_type == bs.NAL_PPS:
                self.pps = headers.parse_pps(rbsp)
            elif nal_type in (bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP, bs.NAL_CRA):
                frames.append(self._decode_slice(rbsp, nal_type))
            elif nal_type == bs.NAL_SUFFIX_SEI:
                md5s = self._parse_hash_sei(rbsp)
                if md5s and frames:
                    ok = all(
                        hashlib.md5(frames[-1][i].astype(np.uint8).tobytes())
                        .digest() == md5s[i] for i in range(3))
                    self.hash_status.append(ok)
        return frames

    # video_codecs_tpu/models/hevc/intra_codec.py:656
    def _decode_slice(self, rbsp: bytes, nal_type: int):
        cfg, pps = self.cfg, self.pps
        info = headers.parse_slice_header(rbsp, nal_type, pps,
                                          sps_sao=cfg.sao)
        qp = info.qp
        qp_c = chroma_qp(qp)
        bw, bh = cfg.width // 16, cfg.height // 16

        # CABAC payload starts at the (byte-aligned) slice data offset;
        # tiles split it into independent substreams at the entry points.
        data = rbsp[info.data_offset_bits // 8:]
        if pps.wpp:
            return self._decode_slice_wpp(data, info, qp, qp_c)
        n_tiles = pps.tile_columns
        edges = [(i * bw) // n_tiles for i in range(n_tiles + 1)]
        offs = [0]
        for e in info.entry_points:
            offs.append(offs[-1] + e)
        offs.append(len(data))
        assert len(offs) == n_tiles + 1, "entry points != tile count"

        rec_y = np.zeros((cfg.height, cfg.width), np.int32)
        rec_u = np.zeros((cfg.height // 2, cfg.width // 2), np.int32)
        rec_v = np.zeros_like(rec_u)
        sao_params = [[None] * 3 for _ in range(bw * bh)]

        for t in range(n_tiles):
            tx0, tx1 = edges[t], edges[t + 1]
            dec = cabac.CabacDecoder(bs.BitReader(data[offs[t]:offs[t + 1]]),
                                     ctx.init_states(ctx.I, qp))
            last_tile = t == n_tiles - 1
            for by in range(bh):
                left_mode = DC
                for bx in range(tx0, tx1):
                    if cfg.sao:
                        decode_sao_ctu(dec, sao_params, by * bw + bx,
                                       bx, by, bw, tx0)
                    mode, lv_y, lv_cb, lv_cr = self._decode_ctu(dec, left_mode)
                    left_mode = mode
                    x, yy = bx * 16, by * 16
                    ref = build_ref_np(rec_y, x, yy, 16, tx0 * 16, tx1 * 16)
                    pred = intra_ops.predict_intra_np(ref, mode, 4)
                    if lv_y is not None:
                        dq = quant_ops.dequantize_np(lv_y, qp, 4)
                        r = tr_ops.inverse_transform_np(dq, 4)
                        rec = np.clip(pred + r, 0, 255)
                    else:
                        rec = pred
                    rec_y[yy:yy + 16, x:x + 16] = rec
                    cx, cy = x // 2, yy // 2
                    for lv_c, plane in ((lv_cb, rec_u), (lv_cr, rec_v)):
                        refc = build_ref_np(plane, cx, cy, 8, tx0 * 8, tx1 * 8)
                        predc = intra_ops.predict_intra_np(refc, mode, 3,
                                                           is_luma=False)
                        if lv_c is not None:
                            dq = quant_ops.dequantize_np(lv_c, qp_c, 3)
                            r = tr_ops.inverse_transform_np(dq, 3)
                            recc = np.clip(predc + r, 0, 255)
                        else:
                            recc = predc
                        plane[cy:cy + 8, cx:cx + 8] = recc
                    end = dec.decode_terminate()
                    is_last = (by == bh - 1 and bx == tx1 - 1 and last_tile)
                    assert end == (1 if is_last else 0), \
                        f"end_of_slice mismatch at CTU ({bx},{by})"
        if not pps.deblocking_disabled:
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_np(
                rec_y, rec_u, rec_v, qp)
        if cfg.sao:
            # the reference's apply_ctu loop, with each EO class's map
            # computed once per plane instead of once per CTB
            rec_y, rec_u, rec_v = (
                sao_ops.apply_ctus(p, [p3[c] for p3 in sao_params],
                                   16 if c == 0 else 8, bw)
                for c, p in enumerate((rec_y, rec_u, rec_v)))
        return rec_y, rec_u, rec_v

    # video_codecs_tpu/models/hevc/intra_codec.py:737
    def _decode_slice_wpp(self, data, info, qp, qp_c):
        """WPP decode is not ported."""
        raise NotImplementedError("IntraDecoder: WPP is not ported")

    # video_codecs_tpu/models/hevc/intra_codec.py:805
    def _decode_ctu(self, dec: cabac.CabacDecoder, left_mode: int):
        part = dec.decode_bin(ctx.off("part_size"))
        assert part == 1, "NxN partition not supported in this build"
        mpm = mpm_list(left_mode)
        if dec.decode_bin(ctx.off("prev_intra_luma_pred")):
            idx = 0 if dec.decode_bypass() == 0 else 1 + dec.decode_bypass()
            mode = mpm[idx]
        else:
            rem = dec.decode_bypass_bins(5)
            for c in sorted(mpm):
                if rem >= c:
                    rem += 1
            mode = rem
        cm = dec.decode_bin(ctx.off("chroma_pred_mode"))
        assert cm == 0, "non-DM chroma mode not supported"
        cbf_cb = dec.decode_bin(ctx.off("cbf_chroma"))
        cbf_cr = dec.decode_bin(ctx.off("cbf_chroma"))
        cbf_y = dec.decode_bin(ctx.off("cbf_luma", 1))
        if self.pps.cu_qp_delta and (cbf_y or cbf_cb or cbf_cr):
            from video_codecs_tpu_torch.models.hevc.inter_codec import \
                decode_cu_qp_delta
            assert decode_cu_qp_delta(dec) == 0, \
                "I slices of this build code zero cu_qp_delta"
        sbh = self.pps.sign_data_hiding
        lv_y = residual.decode_residual(dec, 4, rom.SCAN_DIAG, True,
                                        sign_hiding=sbh) if cbf_y else None
        lv_cb = residual.decode_residual(dec, 3, rom.SCAN_DIAG, False,
                                         sign_hiding=sbh) if cbf_cb else None
        lv_cr = residual.decode_residual(dec, 3, rom.SCAN_DIAG, False,
                                         sign_hiding=sbh) if cbf_cr else None
        return mode, lv_y, lv_cb, lv_cr

    # video_codecs_tpu/models/hevc/intra_codec.py:837
    @staticmethod
    def _parse_hash_sei(rbsp: bytes) -> list[bytes] | None:
        r = bs.BitReader(rbsp)
        ptype = r.read(8)
        psize = r.read(8)
        if ptype != 132:
            return None
        assert r.read(8) == 0 and psize == 49
        return [bytes(r.read(8) for _ in range(16)) for _ in range(3)]
