"""Where the time of one 1920x1072 B picture goes in the port's HEVC
random-access encoder (models/hevc/inter_dev.py + inter_qt.py) on the GPU.

Runs the device phase of the headline's POC-4 B picture (two lists, one
reference each: POC 0 and POC 8 of chip_smoke's seeded clip, the source
pictures standing in for their reconstructions; chip_smoke.ra_cfg
settings: QP 32, SR64 pyramid ME, CU8 tree off, TMVP candidate with an
empty collocated field, full RDOQ, HM lambda of its GOP entry) and
prints, for the whole device phase (`encode_b_frame_dev` + `qt_merge_dev`
+ copy back) and for its stages run on their own -- the per-list motion
search (`b_me_one`: pyramid SAD surfaces + the two SATD refinement
rounds in one `refine_qpel` launch), the
16x16 intra mode decision, the TB coding with the full RDOQ at each size
the path codes (TU16 luma, TU8 chroma, the RQT's TU8 luma and TU4
chroma), and the CU32 tree pass:
  - wall time of an unprofiled run (synchronised, after a warm-up run);
  - CUDA kernel launches and device busy time from a second run under
    torch.profiler (device activity only), and the idle share of the
    unprofiled wall (1 - busy / wall);
then the kernels with the most device time in the whole picture.

--me-method tz (or full, auto) runs the same picture with HM's
TZSearch (or full search) in place of the pyramid.

Usage (needs a CUDA card):
    python scripts/profile_torch_hevc_ra.py [--width 1920 --height 1072]
        [--me-method pyr]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from video_codecs_tpu_torch.models.hevc import encoder_dev  # noqa: E402
from video_codecs_tpu_torch.models.hevc import inter_dev  # noqa: E402
from video_codecs_tpu_torch.models.hevc import inter_qt  # noqa: E402
from video_codecs_tpu_torch.models.hevc.intra_codec import (  # noqa: E402
    chroma_qp)
from video_codecs_tpu_torch.ops import rdoq_dev  # noqa: E402
from video_codecs_tpu_torch.ops import sad_surface as ss  # noqa: E402


def measure(fn):
    """(wall ms, launches, busy ms, profile) of fn(): the wall of an
    unprofiled synchronised run, then one run under the profiler, whose
    RDOQ-kernel launches `measure.rdoq` keeps for `report`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    r0 = rdoq_dev.rdoq_dev.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    measure.rdoq = rdoq_dev.rdoq_dev.launches - r0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    busy = sum(e.device_time for e in kern) / 1e3
    return wall, len(kern), busy, prof


def report(name, wall, launches, busy):
    print(f"  {name:<30} wall {wall:9.1f} ms, {launches:7d} kernels, "
          f"device busy {busy:8.2f} ms, idle share {1 - busy / wall:.3f}, "
          f"RDOQ launches {measure.rdoq}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=chip_smoke.HEVC_W)
    ap.add_argument("--height", type=int, default=chip_smoke.HEVC_H)
    ap.add_argument("--me-method", default="pyr",
                    choices=inter_dev.ME_METHODS)
    args = ap.parse_args()
    me = args.me_method
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    w, h = args.width, args.height
    sr = chip_smoke.RA_SR
    cfg = chip_smoke.ra_cfg(w, h)
    qp, poc = cfg.qp, 4
    frames = chip_smoke.synth_clip(w, h, 9, seed=5)
    enc = inter_qt.QtDeviceRandomAccessEncoder(
        cfg, search_range=sr, me_method=me, cu8=False, device="cuda")
    lam = inter_dev._gop_lambda(enc, poc)
    dev = torch.device("cuda")

    def up(p):
        return torch.from_numpy(np.ascontiguousarray(p)).to(dev)

    cur = [up(p) for p in frames[poc]]
    args6 = [up(np.stack([frames[r][c]])) for r in (0, 8) for c in range(3)]
    tf = enc._tmvp_fields(8, poc, [[0], [8]])
    kw = dict(qp=qp, w=w, h=h, has_l1=True, search_range=sr, sbh=True,
              rdoq=True, me_method=me, deblock=False, allow_intra=False,
              merge_eval="best4", lam=lam, rqt=True, cu8=False,
              tmvp_fields=tf, no_backward=False)
    qkw = dict(qp=qp, w=w, h=h, has_l1=True, sbh=True, rdoq=True,
               deblock=True, lam=lam)
    st16 = {}

    def whole():
        st16.update(inter_dev.encode_b_frame_dev(*cur, *args6, **kw))
        qt = inter_qt.qt_merge_dev(*cur, *args6, st16, **qkw)
        return {k: t.cpu() for k, t in qt.items()}

    torch.set_grad_enabled(False)
    with torch.inference_mode():
        whole()                                           # warm-up
        n0 = ss.sad_surface.launches
        wall, launches, busy, prof = measure(whole)
        print(f"{torch.cuda.get_device_name(0)}; {w}x{h} QP{qp} B picture "
              f"(POC {poc}, lambda {lam:.3f}, me_method {me!r}), device "
              "phase with the copy "
              f"back (planes already on the card); SAD-kernel launches per "
              f"picture: {(ss.sad_surface.launches - n0) // 2}")
        report("whole device phase", wall, launches, busy)
        report("encode_b_frame_dev", *measure(
            lambda: inter_dev.encode_b_frame_dev(*cur, *args6, **kw))[:3])
        report("qt_merge_dev", *measure(
            lambda: inter_qt.qt_merge_dev(*cur, *args6, st16, **qkw))[:3])
        bw, bh = w // 16, h // 16
        x0 = (torch.arange(bw, dtype=torch.int32, device=dev) *
              16).repeat(bh)
        y0 = (torch.arange(bh, dtype=torch.int32, device=dev) *
              16).repeat_interleave(bw)
        yi = cur[0].int()
        blk = encoder_dev._extract_blocks(yi, x0, y0, 16)
        for lx in (0, 1):
            ref = args6[3 * lx][0].int()
            report(f"b_me_one list {lx} (n=16)", *measure(
                lambda ref=ref: inter_dev.b_me_one(ref, blk, x0, y0, sr,
                                                   me))[:3])
        report("decide_modes_device", *measure(
            lambda: encoder_dev.decide_modes_device(yi, qp, bw, bh))[:3])
        rng = np.random.default_rng(1)
        qc = chroma_qp(qp)
        for log2, luma, what in ((4, True, "TU16 luma"),
                                 (3, False, "TU8 chroma"),
                                 (3, True, "RQT TU8 luma"),
                                 (2, False, "RQT TU4 chroma")):
            n = 1 << log2
            b = bw * bh * (1 if log2 == 4 or (log2 == 3 and not luma)
                           else 4)
            o = up(rng.integers(0, 256, (b, n, n)).astype(np.int32))
            p = (o + up(rng.integers(-12, 13, (b, n, n)).astype(
                np.int32))).clamp(0, 255)
            report(f"_code_blocks_rate {what}", *measure(
                lambda o=o, p=p, log2=log2, luma=luma:
                encoder_dev._code_blocks_rate(
                    o, p, qp if luma else qc, log2, sbh=True,
                    is_luma=luma, rdoq="full", lam=lam))[:3])
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))


if __name__ == "__main__":
    main()
