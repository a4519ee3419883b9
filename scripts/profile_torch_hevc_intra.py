"""Where the time of one 1920x1072 IDR goes in the port's HEVC all-intra
quadtree encoder (models/hevc/encoder_qt_dev.py) on the GPU.

Encodes the first picture of chip_smoke's seeded clip (chip_smoke.hevc_cfg:
QP 32, RDOQ-lite, SBH, deblocking) and prints, for the whole device phase
(`encode_frame_qt`) and for each stage run on its own -- the three mode
sweeps, the three trial costs (with the device full RDOQ), the wavefront
reconstruction and the deblocking:
  - wall time of an unprofiled run (synchronised, after a warm-up run);
  - CUDA kernel launches and device busy time from a second run under
    torch.profiler (device activity only: the host-side events of half a
    million launches would take minutes to collect), and the idle share
    of the unprofiled wall (1 - busy / wall);
then the kernels with the most device time in the whole picture.

Usage (needs a CUDA card):
    python scripts/profile_torch_hevc_intra.py [--width 1920 --height 1072]
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
from video_codecs_tpu_torch.models.hevc import encoder_qt_dev as eq  # noqa: E402
from video_codecs_tpu_torch.models.hevc.intra_codec import chroma_qp  # noqa: E402
from video_codecs_tpu_torch.ops import rdoq_dev  # noqa: E402
from video_codecs_tpu_torch.ops import deblock as deblock_ops  # noqa: E402


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
    print(f"  {name:<28} wall {wall:9.1f} ms, {launches:7d} kernels, "
          f"device busy {busy:8.2f} ms, idle share {1 - busy / wall:.3f}, "
          f"RDOQ launches {measure.rdoq}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=chip_smoke.HEVC_W)
    ap.add_argument("--height", type=int, default=chip_smoke.HEVC_H)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    w, h = args.width, args.height
    cfg = chip_smoke.hevc_cfg(w, h)
    qp = cfg.qp
    y, u, v = chip_smoke.synth_clip(w, h, 1, seed=5)[0]
    dev = torch.device("cuda")
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in (y, u, v)]
    pw, ph = eq._ceil_to(w, eq.CTB), eq._ceil_to(h, eq.CTB)

    def whole():
        st = eq.encode_frame_qt(*planes, qp, w, h, deblock=True, sbh=True,
                                rdoq=True)
        return {k: a.cpu() for k, a in st.items()}

    torch.set_grad_enabled(False)
    with torch.inference_mode():
        whole()                                           # warm-up
        wall, launches, busy, prof = measure(whole)
        print(f"{torch.cuda.get_device_name(0)}; {w}x{h} QP{qp} IDR, "
              f"encode_frame_qt and the copy back (planes already on the "
              f"card):")
        report("whole picture", wall, launches, busy)

        yi = eq._pad_edge(planes[0], ph, pw)
        ui = eq._pad_edge(planes[1], ph // 2, pw // 2)
        vi = eq._pad_edge(planes[2], ph // 2, pw // 2)
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        modes = {}
        for n in (8, 16, 32):
            def sweep(n=n):
                modes[n] = eq._mode_sweep(yi, qp, n)
            report(f"mode sweep n={n}", *measure(sweep)[:3])
        for n in (8, 16, 32):
            report(f"trial cost + rdoq_dev n={n}",
                   *measure(lambda n=n: eq._trial_cost(
                       yi, qp, n, modes[n], lam, True))[:3])
        depth8, m8, m16, m32 = eq.decide_qt_device(yi, qp, w, h, True)
        st = {}

        def wave():
            st.update(eq.encode_frame_qt_device(
                yi, ui, vi, depth8, m8, m16, m32, qp, chroma_qp(qp), w, h,
                True, True))
        report("wavefront recon", *measure(wave)[:3])

        def dbk():
            bs_v, bs_h = eq.bs_maps_from_depth(depth8, w, h)
            deblock_ops.deblock_420_bs(st["rec_y"][:h, :w],
                                       st["rec_u"][:h // 2, :w // 2],
                                       st["rec_v"][:h // 2, :w // 2], qp,
                                       bs_v, bs_h, block=8)
        report("deblock", *measure(dbk)[:3])
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))


if __name__ == "__main__":
    main()
