"""Full-window SAD surface for integer motion search.

Counterpart of ops/pallas_sad.py (`sad_surface`, the reference's only Pallas
kernel).  On a CUDA tensor `sad_surface` launches the hand-written Hopper
kernel csrc/sad_surface.cu, which it builds with nvcc at first use; on a
CPU tensor it runs the plain PyTorch version `sad_surface_ref`.  There is
no other path: a CUDA tensor either goes through the kernel or raises.
The kernel takes uint8 blocks and windows (the planes are 8-bit) and
n = 16, 8, 4 or 2: the H.264 blocks, the HEVC pyramid's full-resolution
windows (16, and 8 for the CU8 tree) and its quarter-resolution stage
(n // 4 = 4 and 2); the plain version takes uint8 or int32 and any n.

The kernel is built into build/torch_kernels/ under the repository root,
as a shared library with a plain C interface loaded with ctypes, and is
rebuilt whenever the source's hash or the build flags change.  Windows
too large for one CTA's shared memory are refused by the kernel's launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "sad_surface.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Block sizes the kernel is instantiated for.
KERNEL_SIZES = (2, 4, 8, 16)
# sad_surface_ref materialises at most this many patch elements at once.
_CHUNK_ELEMS = 1 << 26

_LIB = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(src: Path, stem: str) -> tuple[Path, float, str]:
    """Compile one kernel source for sm_90a into build/torch_kernels/
    lib<stem>_<hash>.so unless a library of the same source and flags
    exists.  Returns (library, build seconds, compiler output); seconds
    is 0.0 when the library was already built."""
    tag = hashlib.blake2b(src.read_bytes() + " ".join(NVCC_FLAGS).encode(),
                          digest_size=8).hexdigest()
    so = _BUILD_DIR / f"lib{stem}_{tag}.so"
    if so.exists():
        return so, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, res.stdout + res.stderr


def launch_stream(dev: torch.device) -> int:
    """The raw handle of `dev`'s current CUDA stream, for a launch through
    ctypes.  The wrappers of csrc/rdoq.cu and csrc/sao_stats.cu call it
    once per launch, so it builds no torch.cuda.Stream object; a tensor on
    another card than the current one is refused (no wrapper switches
    cards)."""
    current = torch.cuda.current_device()
    if dev.index is not None and dev.index != current:
        raise ValueError(f"kernel launch: {dev} is not the current card "
                         f"(cuda:{current})")
    return torch._C._cuda_getCurrentRawStream(current)


def build() -> tuple[Path, float, str]:
    """Compile csrc/sad_surface.cu (`build_library`)."""
    return build_library(_SRC, "vct_sad_surface")


def _load() -> ctypes.CDLL:
    """The built library, with its entry point's C signature declared:
    vct_sad_surface_u8(cur, win, out, b, n, r, stream)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        fn = lib.vct_sad_surface_u8
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        _LIB = lib
    return _LIB


def sad_surface_ref(cur: torch.Tensor, win: torch.Tensor, n: int,
                    r: int) -> torch.Tensor:
    """Plain PyTorch SAD surface: cur [B, n, n], win [B, n+2r, n+2r]
    (uint8 or int32) -> [B, 2r+1, 2r+1] int32.  The [b, 2r+1, 2r+1, n, n]
    patch view of each chunk of blocks is materialised, so chunks keep it
    under `_CHUNK_ELEMS`."""
    b = cur.shape[0]
    span = 2 * r + 1
    chunk = max(1, _CHUNK_ELEMS // (span * span * n * n))
    out = torch.empty((b, span, span), dtype=torch.int32, device=cur.device)
    for s in range(0, b, chunk):
        c = cur[s:s + chunk].int()
        pw = win[s:s + chunk].int().unfold(1, n, 1).unfold(2, n, 1)
        out[s:s + chunk] = (pw - c[:, None, None]).abs().sum(
            (-2, -1), dtype=torch.int32)
    return out


def sad_surface(cur: torch.Tensor, win: torch.Tensor, n: int,
                r: int) -> torch.Tensor:
    """cur [B, n, n], win [B, n+2r, n+2r] -> SAD [B, 2r+1, 2r+1] (int32).

    CUDA tensors (uint8, contiguous, n in KERNEL_SIZES) go through the
    Hopper kernel, counted in `sad_surface.launches`; CPU tensors through
    `sad_surface_ref`."""
    b = cur.shape[0]
    wsz = n + 2 * r
    if tuple(cur.shape) != (b, n, n) or tuple(win.shape) != (b, wsz, wsz):
        raise ValueError(f"sad_surface: cur {tuple(cur.shape)} / win "
                         f"{tuple(win.shape)} do not match n={n}, r={r}")
    if cur.device != win.device:
        raise ValueError("sad_surface: cur and win on different devices")
    if cur.device.type == "cpu":
        return sad_surface_ref(cur, win, n, r)
    if cur.device.type != "cuda":
        raise ValueError(f"sad_surface: no kernel for {cur.device}")
    if cur.dtype != torch.uint8 or win.dtype != torch.uint8:
        raise TypeError("sad_surface kernel takes uint8 cur and win, got "
                        f"{cur.dtype} / {win.dtype}")
    if n not in KERNEL_SIZES:
        raise ValueError(f"sad_surface kernel takes n in {KERNEL_SIZES}, "
                         f"got {n}")
    if not (cur.is_contiguous() and win.is_contiguous()):
        raise ValueError("sad_surface kernel takes contiguous tensors")
    span = 2 * r + 1
    out = torch.empty((b, span, span), dtype=torch.int32, device=cur.device)
    if b == 0:
        return out
    lib = _load()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        err = lib.vct_sad_surface_u8(cur.data_ptr(), win.data_ptr(),
                                     out.data_ptr(), b, n, r, stream)
    if err != 0:
        raise RuntimeError(f"sad_surface kernel launch failed: cudaError "
                           f"{err} (1: the {wsz}x{wsz} window does not fit "
                           "one CTA's shared memory)")
    sad_surface.launches += 1
    return out


sad_surface.launches = 0
