"""Time the SAD-surface kernel against an older one, and the instructions
it is made of, on the card.

    python scripts/bench_torch_sad.py [--parent DIR] [--out DIR] [--rounds K]

At the shapes of a 1280x720 P picture (n=16, B=3600 and n=8, B=14400 at
search range 16; n=16, B=3600 at 32) it
  - builds csrc/sad_surface.cu, prints what `-Xptxas -v` says, writes the
    SASS (cuobjdump -sass) to --out and prints each kernel's instruction
    mix;
  - holds the kernel against the plain version (max abs err must be 0)
    and times it with CUDA events (median of 9);
  - measures the issue rate of the instructions the kernel's inner loop
    is made of (VABSDIFF4 with accumulate and PRMT, and float32 FADD for
    comparison) with a register-only micro-kernel timed by clock64():
    lanes per SM per clock;
  - with --parent, builds the kernel of an older tree (its
    video_codecs_tpu_torch/csrc/sad_surface.cu, with the uint8 entry point
    vct_sad_surface_u8, or the first kernel's int32 one
    vct_sad_surface_i32 on int32 copies of the same inputs) and times it
    in turns with the current kernel (old, new, new, old; K rounds), both
    called through the same bare ctypes launcher;
and prints each time beside the bound (chip_smoke.sad_bound).  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from video_codecs_tpu_torch.ops import sad_surface as ss  # noqa: E402

SHAPES = ((16, 3600, 16), (8, 14400, 16), (16, 3600, 32))


def cuda_ms(fn, reps: int = 9) -> float:
    return chip_smoke.cuda_ms(fn, reps=reps, warm=2)


def sass_mix(so: Path, out_dir: Path, tag: str) -> None:
    """Write the SASS of `so` and print the opcode counts per kernel."""
    cuobjdump = Path(ss._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(so)],
                         capture_output=True, text=True, timeout=300)
    (out_dir / f"sad_sass_{tag}.txt").write_text(res.stdout + res.stderr)
    fn, mix = None, collections.OrderedDict()
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if fn and m:
            mix[fn][m.group(2).split(".")[0]] += 1
    for fn, c in mix.items():
        top = ", ".join(f"{k} {v}" for k, v in c.most_common(12))
        print(f"[sass {tag}] {fn}: {sum(c.values())} instructions; {top}")


# Each thread runs 8 independent chains of OP, ITERS times over; nothing
# touches memory but the final store, so the time is the issue rate.
MICRO_SRC = r"""
#include <stdint.h>
#define ITERS 4096
template <int OP>
__global__ void micro(uint32_t* out, long long* cycles, uint32_t seed) {
  uint32_t a[8], b = seed * 2654435761u + threadIdx.x;
  for (int i = 0; i < 8; ++i) a[i] = seed + i * 77u + threadIdx.x;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (OP == 0) asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
                                : "+r"(a[i]) : "r"(b), "r"(a[(i + 1) & 7]));
      if (OP == 1) asm volatile("prmt.b32 %0, %0, %1, 0x5432;"
                                : "+r"(a[i]) : "r"(b));
      if (OP == 2) { float f = __uint_as_float(a[i]);
                     asm volatile("add.f32 %0, %0, %1;" : "+f"(f)
                                  : "f"(__uint_as_float(b)));
                     a[i] = __float_as_uint(f); }
    }
  }
  __syncthreads();
  long long t1 = clock64();
  uint32_t x = 0;
  for (int i = 0; i < 8; ++i) x ^= a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int vct_micro(int op, void* out, void* cycles, int ctas,
                         int threads, void* stream) {
  void (*k[3])(uint32_t*, long long*, uint32_t) = {
      micro<0>, micro<1>, micro<2>};
  k[op]<<<ctas, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (long long*)cycles, 12345u);
  return (int)cudaGetLastError();
}
"""
MICRO_OPS = ("VABSDIFF4.ACC (vabsdiff4.add)", "PRMT (prmt.b32)",
             "FADD (add.f32)")


def micro_rates(out_dir: Path) -> None:
    """Lanes per SM per clock of each instruction in MICRO_OPS."""
    src = ss._BUILD_DIR / "vct_micro.cu"
    so = ss._BUILD_DIR / "libvct_micro.so"
    ss._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(MICRO_SRC)
    res = subprocess.run([ss._nvcc(), *ss.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        sys.exit(f"micro-kernel did not build:\n{res.stderr}")
    sass_mix(so, out_dir, "micro")
    fn = ctypes.CDLL(str(so)).vct_micro
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas, threads = 2 * sms, 1024          # 2048 threads on every SM
    out = torch.empty(ctas * threads, dtype=torch.int32, device="cuda")
    cyc = torch.empty(ctas, dtype=torch.int64, device="cuda")
    for op, name in enumerate(MICRO_OPS):
        for _ in range(2):                 # the first run warms up
            err = fn(op, out.data_ptr(), cyc.data_ptr(), ctas, threads,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"micro-kernel launch failed: {err}")
            torch.cuda.synchronize()
        lanes = 2 * threads * 4096 * 8       # per SM: 2 CTAs
        rate = lanes / float(cyc.double().mean())
        print(f"[micro] {name}: {rate:.1f} lanes per SM per clock")


def load_parent(parent: Path):
    src = parent / "video_codecs_tpu_torch" / "csrc" / "sad_surface.cu"
    so = ss._BUILD_DIR / "libvct_sad_surface_parent.so"
    ss._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([ss._nvcc(), *ss.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        sys.exit(f"parent kernel did not build:\n{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build parent] {line.strip()}")
    lib = ctypes.CDLL(str(so))
    # the first kernel took int32 samples, the later ones take uint8
    u8 = hasattr(lib, "vct_sad_surface_u8")
    return bare(lib.vct_sad_surface_u8 if u8 else lib.vct_sad_surface_i32,
                "parent"), u8


def bare(fn, who: str):
    """A launcher calling the C entry point directly (no wrapper checks),
    so that the old and the new kernel are timed through the same host
    code."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]

    def run(cur, win, n, r):
        b, span = cur.shape[0], 2 * r + 1
        out = torch.empty((b, span, span), dtype=torch.int32, device="cuda")
        err = fn(cur.data_ptr(), win.data_ptr(), out.data_ptr(), b, n, r,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"{who} kernel launch failed: {err}")
        return out
    return run


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--out", default="build/sad_bench")
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds of old, new, new, old with --parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    micro_rates(out_dir)
    rng = np.random.default_rng(2024)
    data = []
    for n, b, r in SHAPES:
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        data.append((n, b, r, cur, win, ss.sad_surface_ref(cur, win, n, r)))

    so, secs, log = ss.build()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    print(f"[build] nvcc {secs:.2f} s (0 = cached)")
    sass_mix(so, out_dir, "default")
    per_pic = 0.0
    for n, b, r, cur, win, want in data:
        def fn():
            return ss.sad_surface(cur, win, n, r)
        if int((fn() - want).abs().max()):
            sys.exit(f"kernel != plain at n={n} r={r}")
        ms = cuda_ms(fn)
        bound = chip_smoke.sad_bound(n, b, r)[0]
        print(f"[sad] n={n} B={b} r={r}: {ms:.4f} ms, "
              f"{bound / ms:.1%} of the {bound:.4f} ms bound")
        if r == 16:
            per_pic += ms
    print(f"[sad] per 720p P picture: {per_pic:.4f} ms")

    if args.parent:
        old, old_u8 = load_parent(Path(args.parent))
        new = bare(ss._load().vct_sad_surface_u8, "current")
        turns = collections.defaultdict(list)
        for who in ("old", "new", "new", "old") * args.rounds:
            per_pic = 0.0
            for n, b, r, cur, win, want in data:
                if r != 16:
                    continue
                if who == "old":
                    ci, wi = (cur, win) if old_u8 else (cur.int(), win.int())
                    err = int((old(ci, wi, n, r) - want).abs().max())
                    ms = cuda_ms(lambda: old(ci, wi, n, r))
                else:
                    err = int((new(cur, win, n, r) - want).abs().max())
                    ms = cuda_ms(lambda: new(cur, win, n, r))
                if err:
                    sys.exit(f"{who} kernel != plain at n={n}")
                print(f"[turn {who}] n={n} B={b} r={r}: {ms:.4f} ms")
                per_pic += ms
            turns[who].append(per_pic)
            print(f"[turn {who}] per 720p P picture: {per_pic:.4f} ms")
        bound = sum(chip_smoke.sad_bound(n, b, r)[0]
                    for n, b, r in SHAPES if r == 16)
        for who in ("old", "new"):
            t = sorted(turns[who])
            print(f"[turns] {who} per 720p P picture over {len(t)} turns: "
                  f"median {statistics.median(t):.4f} ms, min {t[0]:.4f}, "
                  f"max {t[-1]:.4f}; {bound / statistics.median(t):.1%} "
                  f"of the {bound:.4f} ms bound")


if __name__ == "__main__":
    main()
