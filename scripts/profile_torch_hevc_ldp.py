"""Where the time of one 832x480 low-delay P picture and of the IDR goes
in the port's HEVC LD-P encoder (models/hevc/inter_dev.py, encoder_dev.py)
on the GPU.

Encodes the first 4 pictures of bench_ldp_480 (chip_smoke.ldp_cfg:
bench.py's clip, QP 32 with HM's LD-P ladder, 4 references, merge 5,
TMVP, SBH, SR64 pyramid) with `DeviceLowDelayEncoder` on the card, then
profiles the device phase of POC 4 (QP 33, all 4 references, the real
reconstructions and collocated field) and of the flat IDR, and prints,
for the whole phase and for its stages run on their own -- the motion
search of the 4 references (pyramid SAD surfaces + two SATD
refinements each), the 16x16 intra mode decision, the TB coding with the
full RDOQ (TU16 luma, TU8 chroma), the intra wavefront over the
picture's own intra blocks, and for the IDR the mode decision, the
reconstruction wavefront and the deblock:
  - wall time of an unprofiled run (synchronised, after a warm-up run);
  - CUDA kernel launches and device busy time from a second run under
    torch.profiler (device activity only), and the idle share of the
    unprofiled wall (1 - busy / wall);
then the kernels with the most device time in the P picture.

--me-method tz (or full, auto) encodes and profiles the same pictures
with HM's TZSearch (or full search) in place of the pyramid.

Usage (needs a CUDA card):
    python scripts/profile_torch_hevc_ldp.py [--me-method pyr]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from profile_torch_hevc_ra import measure, report  # noqa: E402
from video_codecs_tpu_torch.models.hevc import encoder_dev  # noqa: E402
from video_codecs_tpu_torch.models.hevc import inter_dev  # noqa: E402
from video_codecs_tpu_torch.models.hevc.intra_codec import (  # noqa: E402
    chroma_qp)
from video_codecs_tpu_torch.ops import deblock as deblock_ops  # noqa: E402
from video_codecs_tpu_torch.ops import inter_pred  # noqa: E402
from video_codecs_tpu_torch.ops import me as me_ops  # noqa: E402
from video_codecs_tpu_torch.utils.device import to_device  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--me-method", default="pyr",
                    choices=inter_dev.ME_METHODS)
    me = ap.parse_args().me_method
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    w, h, sr = chip_smoke.LDP_W, chip_smoke.LDP_H, chip_smoke.LDP_SR
    frames = chip_smoke.bench_synth_clip(w, h, 5)
    enc = inter_dev.DeviceLowDelayEncoder(chip_smoke.ldp_cfg(w, h),
                                          search_range=sr, me_method=me,
                                          device="cuda")
    calls = {}
    phase = enc._device_phase

    def keep(*a):
        calls[a[8]] = a
        return phase(*a)

    enc._device_phase = keep
    torch.set_grad_enabled(False)
    enc.encode_sequence_ldp(frames)
    y, u, v, refs, col_inter, col_mv, col_refpoc, ref_pocs, poc, col_poc = \
        calls[4]
    off, fac = enc.LD_GOP[(poc - 1) % len(enc.LD_GOP)]
    qp = enc.cfg.qp + off
    lam = inter_dev.hm_lambda(qp, fac, 1 if off > 1 else 0)
    dev = torch.device("cuda")
    bw, bh = w // 16, h // 16

    def up(a):
        return to_device(np.ascontiguousarray(a), dev)

    args = [up(np.asarray(p, np.uint8)) for p in (y, u, v)]
    args += [up(np.stack([np.asarray(pl[c], np.uint8)
                          for (_, pl, _) in refs])) for c in range(3)]
    args += [up(col_inter), up(col_mv[..., 0]), up(col_mv[..., 1]),
             up(col_refpoc), torch.tensor(ref_pocs, dtype=torch.int32),
             poc, col_poc]
    kw = dict(qp=qp, w=w, h=h, n_refs=len(refs), search_range=sr, sbh=True,
              rdoq=True, tmvp=True, me_method=me, deblock=True, lam=lam)
    out = {}

    def p_phase():
        st = inter_dev.encode_p_frame_dev(*args, **kw)
        out.update({k: t.cpu() for k, t in st.items()})

    with torch.inference_mode():
        p_phase()                                         # warm-up
        wall, launches, busy, prof = measure(p_phase)
        intra = out["pred_mode"] == 1
        print(f"{torch.cuda.get_device_name(0)}; {w}x{h} P picture POC {poc}"
              f" (QP {qp}, lambda {lam:.3f}, {len(refs)} references, "
              f"me_method {me!r}, "
              f"{int(intra.sum())} intra blocks), device phase with the copy "
              "back (planes already on the card)")
        report("whole P device phase", wall, launches, busy)
        x0 = (torch.arange(bw, dtype=torch.int32, device=dev) *
              16).repeat(bh)
        y0 = (torch.arange(bh, dtype=torch.int32, device=dev) *
              16).repeat_interleave(bw)
        yi, ui, vi = (a.int() for a in args[:3])
        cur = encoder_dev._extract_blocks(yi, x0, y0, 16)
        refs_y = args[3].int()

        def me_all():
            for r in range(refs_y.shape[0]):
                if me != "pyr":
                    me_ops.motion_search(refs_y[r], cur, x0, y0, 16, sr, me)
                    continue
                imx, imy = me_ops.pyramid_search(refs_y[r], cur, x0, y0, 16,
                                                 sr)
                inter_pred.refine_qpel(refs_y[r], cur, x0, y0, imx * 4,
                                       imy * 4, 16)

        report("ME, 4 references", *measure(me_all)[:3])
        report("decide_modes_device", *measure(
            lambda: encoder_dev.decide_modes_device(yi, qp, bw, bh))[:3])
        rng = np.random.default_rng(1)
        qc = chroma_qp(qp)
        for log2, luma, what in ((4, True, "TU16 luma"),
                                 (3, False, "TU8 chroma")):
            n = 1 << log2
            o = up(rng.integers(0, 256, (bw * bh, n, n)).astype(np.int32))
            p = (o + up(rng.integers(-12, 13, (bw * bh, n, n)).astype(
                np.int32))).clamp(0, 255)
            report(f"_code_blocks full RDOQ {what}", *measure(
                lambda o=o, p=p, log2=log2, luma=luma:
                encoder_dev._code_blocks(
                    o, p, qp if luma else qc, log2, intra_slice=False,
                    sbh=True, rdoq="full", is_luma=luma, lam=lam))[:3])
        planes = tuple(out[k].to(dev).int() for k in (
            "rec_y", "rec_u", "rec_v", "coef_y", "coef_u", "coef_v"))
        cbfs = tuple(out[k].to(dev).reshape(-1)
                     for k in ("cbf_y", "cbf_cb", "cbf_cr"))
        modes = out["intra_mode"].to(dev).int()
        report("_intra_wavefront", *measure(
            lambda: inter_dev._intra_wavefront(
                yi, ui, vi, intra.to(dev), modes, planes, cbfs, qp, qc,
                True, True, bw, bh))[:3])

        idr = {}
        iy, iu, iv = (up(np.asarray(p, np.uint8)) for p in frames[0])

        def i_phase():
            st = encoder_dev.encode_frame(iy, iu, iv, 32, bw, bh,
                                          deblock=True, sbh=True,
                                          rdoq=False)
            idr.update({k: t.cpu() for k, t in st.items()})

        i_phase()
        report("whole IDR device phase", *measure(i_phase)[:3])
        iyi, iui, ivi = iy.int(), iu.int(), iv.int()
        imodes = encoder_dev.decide_modes_device(iyi, 32, bw, bh)
        report("IDR decide_modes_device", *measure(
            lambda: encoder_dev.decide_modes_device(iyi, 32, bw, bh))[:3])
        report("IDR encode_frame_device", *measure(
            lambda: encoder_dev.encode_frame_device(
                iyi, iui, ivi, imodes, 32, chroma_qp(32), bw, bh, sbh=True,
                rdoq=False))[:3])
        rec = [idr[k].to(dev).int() for k in ("rec_y", "rec_u", "rec_v")]
        report("IDR deblock_420", *measure(
            lambda: deblock_ops.deblock_420(*rec, 32))[:3])
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))


if __name__ == "__main__":
    main()
