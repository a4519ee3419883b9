"""Split the RDOQ kernel's time into its passes, on the card.

    python scripts/profile_torch_rdoq.py [--out DIR]

Builds a copy of csrc/rdoq.cu with a clock64() stamp at the start of each
pass (walk, search, rate, epilogue) and at the end, written per CTA to a
device array, and runs it at chip_smoke's TU32, TU16, TU8 and TU4 shapes,
each at its full batch and at B = 32 (one warp's TUs, the chain's
latency floor).  Prints each pass's SM cycles per CTA and per position
(the mean over the CTAs) and the slowest CTA's total, what `-Xptxas -v`
says of the unmodified kernel, and writes its SASS (cuobjdump -sass)
under --out.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from video_codecs_tpu_torch.ops import rdoq_dev as rdoq_ops  # noqa: E402
from video_codecs_tpu_torch.ops import sad_surface as ss  # noqa: E402

PASSES = ("walk", "search", "rate", "epilogue")
# the comment that opens each pass in csrc/rdoq.cu, in order
MARKS = ("  // ---- the walk", "  // ---- last-position search",
         "  // ---- the final levels", "  // ---- epilogue")
SHAPES = ("1080p IDR TU32 trial", "1080p B TU16 luma", "1080p B RQT TU8 luma",
          "1080p B RQT TU4 chroma")


def stamped_source() -> str:
    """csrc/rdoq.cu with g_stamps[cta][k] = clock64() before pass k and at
    the kernel's end, and vct_stamps() to copy the array out."""
    src = rdoq_ops._SRC.read_text()
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long g_stamps[1 << 16];\n",
                      1)
    for k, mark in enumerate(MARKS + ("template <int LOG2>\nint launch(",)):
        stamp = (f"  if (blockIdx.x < 8192) g_stamps[blockIdx.x * 8 + {k}] = "
                 "clock64();\n")
        if k < len(MARKS):
            src = src.replace(mark, stamp + mark, 1)
        else:                    # before the kernel's closing brace
            at = src.rindex("}\n", 0, src.index(mark))
            src = src[:at] + stamp + src[at:]
    return src + ('\nextern "C" int vct_stamps(void* dst, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, "
                  "n * sizeof(long long));\n}\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/rdoq_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.set_grad_enabled(False)
    so, _, log = rdoq_ops.build()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    sass = subprocess.run([str(Path(ss._nvcc()).with_name("cuobjdump")),
                           "-sass", str(so)], capture_output=True, text=True,
                          timeout=300)
    (out / "rdoq_sass.txt").write_text(sass.stdout)
    src = out / "rdoq_stamped.cu"
    src.write_text(stamped_source())
    lib = ctypes.CDLL(str(ss.build_library(src, "vct_rdoq_stamped")[0]))
    fn = lib.vct_rdoq
    fn.restype = ctypes.c_int
    fn.argtypes = rdoq_ops._load().vct_rdoq.argtypes
    lib.vct_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    shapes = {s[0]: s[1:] for s in chip_smoke.rdoq_shapes()}
    for what in SHAPES:
        co_all, log2, luma, st, rate, qp = shapes[what]
        for co in (co_all, co_all[:32]):
            b, n = co.shape[0], 1 << log2
            tab, rl = rdoq_ops._kernel_tables(qp, log2, luma, st, 0,
                                              co.device)
            q_bits, scale, lam_bits, es, inv = rdoq_ops._kernel_scalars(
                qp, log2, chip_smoke.rdoq_lam(qp), 8)
            levels = torch.empty((b, n, n), dtype=torch.int32, device="cuda")
            bits = torch.empty(b, dtype=torch.float32, device="cuda")
            for _ in range(3):
                err = fn(co.data_ptr(), *co.stride(), levels.data_ptr(),
                         bits.data_ptr(), b, log2, tab.data_ptr(),
                         rl.data_ptr(), q_bits, scale, lam_bits, es, inv,
                         int(luma), 1, torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"launch failed: cudaError {err}")
            torch.cuda.synchronize()
            per_cta = 16 if log2 == 5 else 32   # csrc/rdoq.cu Layout::kTus
            ctas = min((b + per_cta - 1) // per_cta, 8192)
            stamps = torch.zeros(ctas * 8, dtype=torch.int64)
            if lib.vct_stamps(stamps.data_ptr(), ctas * 8):
                sys.exit("could not read the stamps")
            d = stamps.view(ctas, 8)[:, :len(PASSES) + 1].double().diff(dim=1)
            mean = d.mean(dim=0).tolist()
            cells = ", ".join(f"{p} {c:.0f} ({c / (n * n):.1f}/position)"
                              for p, c in zip(PASSES, mean))
            slowest = float(d.sum(dim=1).max())
            print(f"[passes] {what} B={b}: SM cycles per CTA {cells}; "
                  f"total {sum(mean):.0f} ({sum(mean) / (n * n):.0f}"
                  f"/position), the slowest CTA {slowest:.0f}")


if __name__ == "__main__":
    main()
