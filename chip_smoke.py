#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through its hand-written CUDA kernels, the
SAD surface, the SAO statistics and the full RDOQ: the H.264 device
P-slice engine at
1280x720, the HEVC random-access GOP-8 headline at 1920x1072 (SAO off,
then on), the HEVC low-delay P row at 832x480, both HEVC rows with
HM's TZSearch, the LD-P row under rate control, and the flat CTB16
random-access and hierarchical-B engines at 1920x1072, in phases:

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the three kernels at once, one nvcc each, from
     video_codecs_tpu_torch/csrc/sad_surface.cu, sao_stats.cu and
     rdoq.cu;
  3. hold the kernel against its plain PyTorch version at the slice's
     shapes (and at search range 32), exactly, and time the kernel, the
     plain version and one PyTorch call for the same function
     (`torch.cdist` with p=1, the yardstick), each beside the kernel's
     bound at those shapes;
  4. encode a seeded 1280x720 clip (I P P P) on the card, check that the
     integer ME went through the kernel twice per P picture, decode the
     stream with the port's own H264Decoder and require the decoder's
     pictures to equal the encoder's;
  5. run the same P picture on the card and on the CPU (plain SAD) at
     search ranges 16 and 32 and a small clip's whole stream on both, and
     report where they differ (motion fields must agree exactly);
  6. rdoq-kernel: hold the full-RDOQ kernel against its plain version
     (`rdoq_dev_ref`) on the same CUDA tensors at the paths' shapes --
     the 1080p B picture's TU16 luma, TU8 chroma, RQT TU8 luma and TU4
     chroma (slice type 0, with the rate), the 1080p IDR's TU8, TU16 and
     TU32 trials (slice type 2, with the rate) and the LD-P P picture's
     TU16 luma and TU8 chroma (B = 1,560) -- on the forward transform of
     the seeded clips' residuals with an all-zero block and two at the
     coefficient clamp: levels exactly, rates bit for bit; time the
     kernel, the plain version and the bound at each shape;
     hevc-intra: encode one 416x240 picture through the port's HEVC
     all-intra CTB32 quadtree (`QuadtreeFastEncoder`) on the card and on
     the CPU and require equal state dicts and equal NAL bytes (the 1080p
     IDR now runs as the first picture of phase 7's GOP);
  7. hevc-ra: the repo's 1080p headline, HEVC random access GOP-8 on the
     CTB32 device quadtree (`QtDeviceRandomAccessEncoder`, bench.py:84-107
     settings: 1920x1072, QP 32, SR64 pyramid ME, CU8 tree off, TMVP,
     full RDOQ, one reference per list, MD5 picture-hash SEI):
     a. hold the SAD kernel against its plain version at the pyramid's
        shapes (4x4-pooled quarter-resolution stage n=4 r=16, the +-3
        full-resolution windows n=16 r=3; the CU8 tree's n=2 and n=8
        checked) and time the kernel, the plain version and
        `torch.cdist` beside the bound, per B picture;
     b. encode 9 pictures of a seeded 1920x1072 clip on the card, timing
        per picture the device phase (the IDR's quadtree, or
        encode_b_frame_dev + qt_merge_dev, with the copy back) and the
        host phase (CABAC serializer, hash SEI, TMVP store), with bytes,
        kbps, Y-PSNR, CU counts, the SAD kernel's launches (3 per list
        and reference: 6 per B picture, 3 for the anchor P) and the RDOQ
        kernel's (none of them may run the plain `rdoq_dev_ref`);
     c. decode the stream with the port's GeneralDecoder: every picture
        hash must match and the pictures must equal the encoder's; the
        stream's SHA-1 must be the JAX package's for the same clip and
        settings (computed on the CPU: RA_SHA1);
     d. encode small GOPs (96x64: 9 pictures at the headline settings,
        5 pictures with the CU8 tree and 2 references per list; 112x80:
        9 pictures with SAO, partial edge CTBs) on the card and on the
        CPU and require byte-equal streams (the card's through the RDOQ
        kernel, the CPU's through its plain version);
     e. sao-kernel: hold the SAO-statistics kernel against its plain
        version, all four outputs exactly, at the 1080p picture's padded
        planes (luma 1920x1088 at CTB 32, each chroma 960x544 at CTB 16)
        and at 112x80's, and time it beside its bound and the plain
        version per picture (no single PyTorch call computes it);
     f. hevc-ra-sao: the same GOP as b with SAO on (`cfg.sao`, HM's RA
        main tool set): per picture the device phase, the host phase,
        the SAO decision (statistics on the card, 3 kernel launches, and
        the offset search on the host) and the OFF/BO/EO CTBs per plane;
        the stream's SHA-1 must be the JAX package's (RA_SAO_SHA1), the
        port's GeneralDecoder must give every hash OK and the encoder's
        pictures, and the SAO kernel must run 24 times;
  8. hevc-ldp: bench.py's `bench_ldp_480` (bench.py:171-186) exactly,
     HEVC low-delay P on `inter_dev.DeviceLowDelayEncoder`: 832x480, QP 32
     with HM's LD-P QP/lambda ladder, 4 references, merge 5, TMVP, SBH,
     SR64 pyramid ME, MD5 picture-hash SEI, on bench.synth_clip's clip:
     a. hold the SAD kernel against its plain version at the LD-P
        pyramid's shapes (B = 52 x 30 blocks: n=4 r=16 and n=16 r=3)
        and time it beside its bound and `torch.cdist`;
     b. encode the 9 pictures on the card, printing per picture the
        device phase (the flat IDR, or encode_p_frame_dev, with the copy
        back, synchronised), the host phase (`_reconcile`, CABAC slice,
        hash SEI), the QP, bytes, Y-PSNR, intra / skip / merge / AMVP
        block counts, the SAD launches (3 per reference, 78 in all) and
        the RDOQ kernel's;
     c. decode with the port's GeneralDecoder (every hash OK, pictures
        equal the encoder's) and require the stream's SHA-1 to be the
        JAX package's with its AMVP predictor list repaired as the port
        repairs it (LDP_SHA1, computed on the CPU);
     d. encode a 96x64 clip with a scene cut (intra blocks in its P
        pictures) at 4 references on the card and on the CPU and
        require byte-equal streams;
  9. HM's motion search and rate control:
     a. sad-kernel-r64: hold the SAD kernel against its plain version at
        the search range 64 surfaces of TZSearch and the full search
        (n=16 B=1,560: the LD-P picture; n=16 B=8,040 and n=8 B=32,160:
        the 1080p picture and its CU8 tree) and time it beside its
        bound, the plain version and `torch.cdist`;
     b. hevc-ldp-tz: bench_ldp_480 with `me_method="tz"` (BASELINE's
        config 2, HM's FastSearch 1 at SearchRange 64) as in 8b-c: one
        SAD launch per reference (26), every hash OK, the SHA-1 the JAX
        package's with the spec AMVP list (LDP_TZ_SHA1);
     c. hevc-ra-tz: the GOP of 7b with `me_method="tz"`: one SAD launch
        per list and reference (15), every hash OK, RA_TZ_SHA1;
     d. hevc-ldp-rc: bench_ldp_480 (pyramid ME) with a RateLambdaControl
        at 2 Mb/s setting each picture's QP: the QPs, bits and kbps
        against the target, every hash OK, LDP_RC_SHA1; then pictures
        0-4 encoded, the state written with `checkpoint.save`, read
        back with `checkpoint.load`, and pictures 5-8 encoded from it:
        the resumed NALs must be the JAX package's resumed run's
        (RC_RESUMED_SHA1), and whether they equal pictures 5-8 of the
        one run is printed;
 10. the flat CTB16 B engines (scripts/diag_ra_gap.py's settings: QP 32,
     SBH, SR64 pyramid ME, one merge candidate, the intra candidate,
     deblocking, full RDOQ, MD5 hash SEI):
     a. hevc-flat-ra: `inter_dev.DeviceRandomAccessEncoder` over phase
        7's 9 pictures (GOP-8), per picture the device phase (the flat
        IDR, or the upload, encode_b_frame_dev and the copy back,
        synchronised), the host phase (`_reconcile_b`, CABAC slice, hash
        SEI), bytes, Y-PSNR, intra / skip / merge / AMVP / bi blocks,
        the SAD launches (3 per list, 45 in all) and the RDOQ kernel's
        (3 per inter picture, 24); every hash OK in the port's
        GeneralDecoder and the JAX package's SHA-1 (FLAT_RA_SHA1);
     b. hevc-hierb: `inter_dev.DeviceHierarchicalBEncoder` over the
        first 5 of those pictures (I0 P2 B1 P4 B3) as in a (18 SAD and
        12 RDOQ launches, HIERB_SHA1);
     c. flat-ra-cuda-vs-cpu: the flat RA GOP at 96x64 over 9 pictures on
        the card and on the CPU, byte-equal streams;
 11. require that nothing of the JAX package was imported.

Kernel times come from torch.profiler alone (asked up to three times);
where it records none the time is "not measured" (null in the JSON
line, with the reason), left out of any per-picture sum, and no share
of the bound is printed.  A wrapper call's CUDA-event time prints
beside the kernel's, never in its place.

Any failed check exits non-zero.  The last line is the result JSON; the
line before it lists the kernels, with the launches of the main paths'
encodes (a line before gives each path's), the SAD kernel's RA pyramid
per-B-picture times and bound, the SAO kernel's per 1080p picture and
the RDOQ kernel's for the 1080p B picture's TU16 luma call; the search
range 64 surfaces' and the RDOQ shapes' times print on JSON lines of
their own before them.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as hevc_bs
from video_codecs_tpu_torch.models.h264 import inter_dev
from video_codecs_tpu_torch.models.h264.inter_codec import H264Decoder
from video_codecs_tpu_torch.models.hevc import checkpoint
from video_codecs_tpu_torch.models.hevc import decoder as hevc_decoder
from video_codecs_tpu_torch.models.hevc import headers as hevc_headers
from video_codecs_tpu_torch.models.hevc import inter_dev as hevc_inter_dev
from video_codecs_tpu_torch.models.hevc import inter_qt, quadtree_codec
from video_codecs_tpu_torch.models.hevc import ratectrl
from video_codecs_tpu_torch.ops import rdoq_dev as rdoq_ops
from video_codecs_tpu_torch.ops import sad_surface as ss
from video_codecs_tpu_torch.ops import sao as sao_ops
from video_codecs_tpu_torch.ops import transform as tr_ops

# Files this script writes (the resumed run's checkpoint), in the
# repository's build directory.
BUILD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
KERNEL_SRC = "video_codecs_tpu_torch/csrc/sad_surface.cu"
REPLACES = "video_codecs_tpu/ops/pallas_sad.py:32"
SAO_SRC = "video_codecs_tpu_torch/csrc/sao_stats.cu"
SAO_REPLACES = "video_codecs_tpu/ops/sao.py:127"
RDOQ_SRC = "video_codecs_tpu_torch/csrc/rdoq.cu"
RDOQ_REPLACES = "video_codecs_tpu/ops/rdoq_jax.py:227"
W, H, QP, SR = 1280, 720, 28, 16
# The 1080p headline (bench.py:84-107): picture size, QP, search range
# and GOP length.
HEVC_W, HEVC_H, HEVC_QP = 1920, 1072, 32
RA_SR, RA_PICTURES = 64, 9
# The JAX package's stream for phase 7's GOP (synth_clip(1920, 1072, 9,
# seed=5) at ra_cfg's settings), on the CPU: bytes and SHA-1.
RA_BYTES, RA_SHA1 = 313869, "97c3eed7555fdec8392e28f0190c99645943f680"
# The same GOP with SAO on (scripts/jax_reference_sha1.py --ra-sao; all 9
# hashes OK in the JAX package's decoder).
RA_SAO_BYTES = 317260
RA_SAO_SHA1 = "48bee427dce04acf683246853f7ce746599d1127"
# bench_ldp_480 (bench.py:171-186): 832x480, 9 pictures of bench's clip,
# and the JAX package's stream for it on the CPU with its AMVP predictor
# list (motion.amvp_candidates) swapped for the spec's, which the port
# carries: bytes and SHA-1 (scripts/jax_reference_sha1.py).  As the JAX
# package writes it (172,535 bytes, SHA-1 0bbbb609...) the stream fails
# its picture hashes from POC 2 on in either package's decoder.
LDP_W, LDP_H, LDP_PICTURES, LDP_SR = 832, 480, 9, 64
LDP_BYTES, LDP_SHA1 = 172528, "321996139e1d64922af23de231bf6dd498493e12"
# HM's motion search and rate control (scripts/jax_reference_sha1.py
# --ldp-tz --ra-tz --ldp-rc, the JAX package on the CPU; the LD-P runs
# with the spec AMVP list, all 9 hashes OK in the JAX package's decoder):
# bench_ldp_480 with TZSearch (as the JAX package writes it: 173,411
# bytes, SHA-1 2b554799..., hashes fail from POC 2 on), the RA GOP with
# TZSearch, and bench_ldp_480's pyramid run under a RateLambdaControl at
# RC_BPS: its QPs, bytes and SHA-1, and those of pictures 5-8 resumed
# from a checkpoint of pictures 0-4 (the resumed pictures' NALs, Annex B).
LDP_TZ_BYTES, LDP_TZ_SHA1 = 173413, "4fc4fc4db26c698e6782bbcbabc60182478e8e1b"
RA_TZ_BYTES, RA_TZ_SHA1 = 314555, "6da8f0df6691e6e0e86b5802cd61840cb78ed3c6"
RC_BPS = 2_000_000
LDP_RC_BYTES, LDP_RC_SHA1 = 185151, "51771df4d0137e4389fb0405dfd93e1f8842ff74"
LDP_RC_QPS = [30, 32, 34, 36, 38, 40, 42, 44, 46]
# The flat CTB16 B engines at scripts/diag_ra_gap.py's settings on phase
# 7's clip (scripts/jax_reference_sha1.py --flat-ra --hierb, the JAX
# package on the CPU; every hash OK in both packages' GeneralDecoders):
# the RA GOP-8 over its 9 pictures and the hierarchical-B run over its
# first HIERB_PICTURES (I0 P2 B1 P4 B3).
HIERB_PICTURES = 5
FLAT_RA_BYTES = 344846
FLAT_RA_SHA1 = "c837e7b257cb85bd937dbaac2d3c05e499795ded"
HIERB_BYTES = 351522
HIERB_SHA1 = "1535391b4838b43c8e6c1bddc90530ae624706b9"
RC_RESUME_AT = 5
RC_RESUMED_BYTES = 15567
RC_RESUMED_SHA1 = "cd2aaec4a7421f5f56138a7e2797a3341d4e504b"
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and
# operations/s on 8-bit integers, the type of the SAD kernel's inputs,
# and on float32 outside the tensor cores, the RDOQ costs' type.
PEAK_BYTES, PEAK_OPS = 3.35e12, 1979e12
PEAK_F32 = 67e12


# The card's name and power limit as nvidia-smi gives them (main sets it).
CARD = ""

# Calls of the plain RDOQ (`rdoq_dev_ref`) by the device its coefficients
# lie on, counted by the wrapper `count_rdoq_ref` installs.
RDOQ_REF_CALLS = {"cuda": 0, "cpu": 0}


def count_rdoq_ref() -> None:
    """Count every call of `rdoq_dev_ref` (the wrapper `rdoq_dev` reaches
    it through the module's name) in RDOQ_REF_CALLS."""
    ref = rdoq_ops.rdoq_dev_ref

    def counted(coeff, *a, **kw):
        RDOQ_REF_CALLS[coeff.device.type] += 1
        return ref(coeff, *a, **kw)

    rdoq_ops.rdoq_dev_ref = counted


def rdoq_routes(fn):
    """(fn's result, RDOQ-kernel launches, plain-version calls on CUDA
    tensors, on CPU tensors) of one call of fn()."""
    k0 = rdoq_ops.rdoq_dev.launches
    g0, c0 = RDOQ_REF_CALLS["cuda"], RDOQ_REF_CALLS["cpu"]
    out = fn()
    return (out, rdoq_ops.rdoq_dev.launches - k0,
            RDOQ_REF_CALLS["cuda"] - g0, RDOQ_REF_CALLS["cpu"] - c0)


def check_rdoq_routes(what: str, card: tuple, cpu: tuple) -> str:
    """The card's run launched the RDOQ kernel and never its plain version;
    the CPU's ran the plain version and launched nothing.  card and cpu
    are rdoq_routes' counts; returns them as words."""
    check(card[0] > 0 and card[1] == 0,
          f"{what}: on the card {card[0]} RDOQ-kernel launches and "
          f"{card[1]} plain-version calls (want > 0 and 0)")
    check(cpu[0] == 0 and cpu[2] > 0,
          f"{what}: on the CPU {cpu[0]} RDOQ-kernel launches and "
          f"{cpu[2]} plain-version calls (want 0 and > 0)")
    return (f"RDOQ kernel {card[0]} launches on the card, plain version "
            f"{cpu[2]} calls on the CPU")


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events, synchronised)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _smooth(a: np.ndarray, passes: int = 2) -> np.ndarray:
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for _ in range(passes):
        for ax in (0, 1):
            p = np.pad(a, [(2, 2) if i == ax else (0, 0) for i in (0, 1)],
                       mode="edge")
            n = a.shape[ax]
            a = sum(k[i] * np.take(p, np.arange(i, i + n), axis=ax)
                    for i in range(5))
    return a


def synth_clip(w: int, h: int, nf: int, seed: int):
    """Seeded 4:2:0 clip: a smooth textured background panning by (2, 1)
    px per frame, an object of a fifth of the width moving by (-5, 3), and
    sensor noise."""
    rng = np.random.default_rng(seed)
    m = 64
    bg = _smooth(rng.integers(0, 256, (h + 2 * m, w + 2 * m)).astype(float))
    bg = (bg - bg.mean()) * 2 + 128
    oh, ow = h // 4, w // 5
    obj = _smooth(rng.integers(0, 256, (oh, ow)).astype(float), 1)
    frames = []
    for f in range(nf):
        y = bg[m + f:m + f + h, m + 2 * f:m + 2 * f + w].copy()
        oy, ox = h // 3 + 3 * f, w // 2 - 5 * f
        y[oy:oy + oh, ox:ox + ow] = obj
        y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255).astype(np.uint8)
        u = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        v = ((255 - y[1::2, 1::2]) // 2 + 32).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def bench_synth_clip(w, h, n, seed=42):
    """bench.py's `synth_clip`, copied: a diagonal ramp with a moving
    sine band and seeded texture, sinusoidal chroma."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    tex = rng.integers(-24, 25, (h, w))
    frames = []
    for f in range(n):
        y = np.clip(((xx * 3 + yy * 2 + f * 7) % 256) * 0.7 + tex + 30 +
                    20 * np.sin(2 * np.pi * (xx + 8 * f) / 64),
                    0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(2 * np.pi * (xx[::2, ::2] + 4 * f)
                                      / 128), 0, 255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(2 * np.pi * (yy[::2, ::2] + 4 * f)
                                      / 128), 0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def cut_clip(w: int, h: int, nf: int, cut: int = 3):
    """A texture panning by (2, 1) px, then from picture `cut` on a smooth
    ramp no reference holds: the P pictures after it code intra blocks."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h + nf + 1, w + 2 * nf + 1)).astype(
        np.int32)
    yy, xx = np.mgrid[0:base.shape[0], 0:base.shape[1]]
    frames = []
    for f in range(nf):
        b = (128 + 60 * np.sin(xx / 5.0 + f) * np.cos(yy / 7.0) +
             (base - 128) // 6) if f < cut else 40 + 2 * xx + (yy // 8) * 9
        y = np.ascontiguousarray(np.clip(b, 0, 255).astype(np.uint8)[
            f:f + h, 2 * f:2 * f + w])
        frames.append((y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2 + 32))
    return frames


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def sad_bound(n: int, b: int, r: int) -> tuple[float, float, float]:
    """(ms, bytes, operations) the card needs at least for one SAD
    surface: uint8 cur and windows read once, the int32 surface written
    once, a subtract and an add for every absolute difference."""
    span = 2 * r + 1
    nbytes = b * (n * n + (n + 2 * r) ** 2) + 4 * b * span * span
    ops = 2 * b * span * span * n * n
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS) * 1e3, nbytes, ops


def sad_cdist(cur: torch.Tensor, win: torch.Tensor, n: int,
              r: int) -> torch.Tensor:
    """The yardstick: one PyTorch call (torch.cdist, p=1) for the same
    surface, in the chunks sad_surface_ref takes."""
    b, span = cur.shape[0], 2 * r + 1
    chunk = max(1, ss._CHUNK_ELEMS // (span * span * n * n))
    out = torch.empty((b, span * span), dtype=torch.float32,
                      device=cur.device)
    for s in range(0, b, chunk):
        c = cur[s:s + chunk].float().reshape(-1, 1, n * n)
        p = win[s:s + chunk].float().unfold(1, n, 1).unfold(2, n, 1)
        out[s:s + chunk] = torch.cdist(c, p.reshape(-1, span * span, n * n),
                                       p=1)[:, 0]
    return out.reshape(b, span, span)


def build_kernels() -> None:
    """Phase 2: one nvcc for each kernel's source, all started together,
    then load each library."""
    t0 = time.perf_counter()
    mods = (ss, sao_ops, rdoq_ops)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = list(pool.map(lambda m: m.build(), mods))
    for mod, (so, build_s, log) in zip(mods, builds):
        mod._load()
        print(f"[build] {so.name}: nvcc {build_s:.2f} s (0 = cached)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
    print(f"[build] all three kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernel() -> dict:
    """Phase 3: the SAD kernel vs plain (and the yardstick) at the H.264
    slice's shapes."""
    rng = np.random.default_rng(2024)
    pic = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0, ops=0)
    max_err = 0
    for n, b, r in ((16, 3600, 16), (8, 14400, 16), (16, 3600, 32),
                    (8, 37, 8)):
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        max_err = max(max_err, err)
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        if b < 100:                      # the ragged case: checked only
            print(f"[sad] n={n} B={b} r={r}: equal")
            continue
        tm = sad_times(cur, win, n, r, reps=7)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        gdiff = ops / 2e9
        rate = "" if ms is None else f", {gdiff / ms * 1e3:.0f} G/s"
        print(f"[sad] n={n} B={b} r={r}: equal; kernel {kms(ms, 3)} "
              f"(profiler{', ' + tm['note'] if tm['note'] else ''}; "
              f"{gdiff:.2f} G abs-diffs{rate}), {tm['event_ms']:.3f} ms a "
              f"wrapper call (CUDA events); bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G ops), "
              f"{of_bound(bound, ms)}; plain {plain:.3f} ms "
              f"({bound / plain:.2%}); torch.cdist {lib:.3f} ms "
              f"({bound / lib:.2%}, max abs err {lib_err:g})")
        if r == SR:
            add_kernel_ms(pic, 1, ms, tm["note"], f"n={n}")
            pic["plain_ms"] += plain
            pic["library_ms"] += lib
            pic["bytes"] += nbytes
            pic["ops"] += ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[sad] per 720p P picture at SR{SR} (n=16 + n=8): kernel "
          f"{kms(pic['ms'], 3)}, bound {pic['bound_ms']:.4f} ms "
          f"({pic['bound_by']}), {of_bound(pic['bound_ms'], pic['ms'])}; "
          f"plain {pic['plain_ms']:.3f} ms; torch.cdist "
          f"{pic['library_ms']:.3f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["max_abs_err"] = max_err
    return pic


def phase_encode_720p() -> int:
    """Phase 4: the slice end to end on the card.  Returns the kernel's
    launch count during the encode."""
    frames = synth_clip(W, H, 4, seed=7)
    enc = inter_dev.DeviceH264Encoder(W, H, qp=QP, search_range=SR,
                                      device="cuda")
    ss.sad_surface.launches = 0
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence(frames)
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    n_p = len(frames) - 1
    check(launches == 2 * n_p,
          f"{launches} SAD-kernel launches for {n_p} P pictures "
          "(want 2 each)")
    check(len(enc.p_times) == n_p, "P pictures did not take the device path")
    t0 = time.perf_counter()
    out = H264Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c], np.uint8),
                                 np.asarray(o[c], np.uint8)),
                  f"decoded frame {i} plane {c} != encoder recon")
    psnrs = [psnr(f[0], np.asarray(r[0])) for f, r in zip(frames, recons)]
    check(all(np.isfinite(p) and p > 25 for p in psnrs),
          f"implausible Y-PSNR {psnrs}")
    kbps = len(stream) * 8 / len(frames) * 30 / 1000
    print(f"[720p] {W}x{H} QP{QP} SR{SR} IPPP: {len(stream)} bytes, "
          f"{kbps:.1f} kbps at 30 fps, Y-PSNR "
          + " ".join(f"{p:.2f}" for p in psnrs)
          + f" dB; encode {t_enc:.2f} s, decode {t_dec:.2f} s; "
          f"SAD-kernel launches {launches}; decode bit-exact in the "
          "port's H264Decoder")
    for i, (dev_s, host_s) in enumerate(enc.p_times):
        print(f"[720p] P{i + 1}: device phase {dev_s * 1e3:.1f} ms, "
              f"host phase {host_s * 1e3:.1f} ms")
    return launches


def phase_cuda_vs_cpu() -> None:
    """Phase 5: the same work on the card and on the CPU (plain SAD)."""
    frames = synth_clip(W, H, 2, seed=11)
    (y, u, v), ref = frames[1], [p.astype(np.int32) for p in frames[0]]
    lam = 0.85 * 2.0 ** ((QP - 12) / 3.0)
    for sr in (16, 32):
        outs = []
        for dev in ("cuda", "cpu"):
            planes = [torch.from_numpy(p).to(dev) for p in (y, u, v, *ref)]
            with torch.inference_mode():
                t0 = time.perf_counter()
                st = inter_dev.encode_p_dev(*planes, qp=QP, w=W, h=H, sr=sr,
                                            lam=lam)
                st = {k: t.cpu().numpy() for k, t in st.items()}
            outs.append((st, time.perf_counter() - t0))
        (g, tg), (c, tc) = outs
        for k in ("mv16x", "mv16y", "mv8x", "mv8y"):
            check(np.array_equal(g[k], c[k]), f"{k} cuda != cpu at SR{sr}")
        diff = [k for k in g if not np.array_equal(g[k], c[k])]
        print(f"[cuda-vs-cpu] 720p P SR{sr}: motion fields equal; "
              f"split8 differences {int((g['split8'] != c['split8']).sum())}"
              f" of {g['split8'].size}; keys differing {diff or 'none'}; "
              f"cuda {tg * 1e3:.1f} ms, cpu {tc * 1e3:.1f} ms")

    small = synth_clip(176, 144, 3, seed=3)
    streams = {}
    for dev in ("cuda", "cpu"):
        enc = inter_dev.DeviceH264Encoder(176, 144, qp=QP, search_range=SR,
                                          device=dev)
        streams[dev] = enc.encode_sequence(small)[0]
    print(f"[cuda-vs-cpu] 176x144 IPP streams byte-equal: "
          f"{streams['cuda'] == streams['cpu']} "
          f"({len(streams['cuda'])} / {len(streams['cpu'])} bytes)")


def hevc_cfg(w: int, h: int):
    """The IDR settings of the 1080p headline (CTB32, min CU 8, max TB 32,
    RDOQ-lite, SBH), with deblocking and the MD5 picture-hash SEI on."""
    return hevc_headers.HevcConfig(
        width=w, height=h, qp=HEVC_QP, log2_ctb=5, log2_min_cb=3,
        log2_max_tb=5, sign_data_hiding=True, rdoq="lite", hash_sei=True)


def rdoq_coeffs(cur: np.ndarray, ref: np.ndarray | None,
                log2: int) -> torch.Tensor:
    """[B, n, n] int32 coefficients on the card for every n x n block of a
    plane: the port's forward transform of cur - ref (ref None: cur less
    each block's rounded mean, an intra DC residual), then block 0 zeroed
    and blocks 1 and 2 set to the coefficient clamp (32,767; then
    alternating rows of -32,768 and 32,767)."""
    n = 1 << log2
    h, w = (d // n * n for d in cur.shape)
    res = cur[:h, :w].astype(np.int32)
    if ref is not None:
        res = res - ref[:h, :w].astype(np.int32)
    blk = res.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3).reshape(
        -1, n, n)
    if ref is None:
        blk = blk - np.round(blk.mean(axis=(1, 2), keepdims=True)).astype(
            np.int32)
    co = tr_ops.forward_transform(torch.from_numpy(
        np.ascontiguousarray(blk)).cuda(), log2)    # strided, as on the path
    co[0] = 0
    co[1] = 32767
    co[2, ::2] = -32768
    co[2, 1::2] = 32767
    return co


# Float32 operations per position of csrc/rdoq.cu: the level-0
# distortion (2), the level-0 cost (1), two candidate costs (4 each), the
# significance cost (1), the CG sums (2), the last-position total with
# its prefix and suffix sums (9) and the rate's final distortion (4).
RDOQ_OPS_PER_POS = 27


def rdoq_bound(b: int, log2: int, rate: bool,
               table_bytes: int) -> tuple[float, float, float]:
    """(ms, bytes, operations) the card needs at least for one RDOQ call:
    int32 coefficients read once, int32 levels written once, the float32
    rates written once (with the rate), the tables read once; the float32
    operations at the card's float32 rate."""
    nn = 1 << (2 * log2)
    nbytes = 8 * b * nn + (4 * b if rate else 0) + table_bytes
    ops = RDOQ_OPS_PER_POS * b * nn
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3, nbytes, ops


# RDOQ calls per RA B picture at each of phase_rdoq_kernel's B-picture
# shapes (inter_dev.encode_b_frame_dev and inter_qt.qt_merge_dev): TU16
# luma twice, TU8 chroma four times, the RQT's TU8 luma once and TU4
# chroma twice, 9 launches.
RA_B_RDOQ_CALLS = {"1080p B TU16 luma": 2, "1080p B TU8 chroma": 4,
                   "1080p B RQT TU8 luma": 1, "1080p B RQT TU4 chroma": 2}


def rdoq_shapes() -> list:
    """The RDOQ calls of the paths, on the card: (what, coefficients,
    log2, is_luma, slice type, with the rate, qp), the 1080p B picture's
    TU16 luma call first."""
    ra = synth_clip(HEVC_W, HEVC_H, 2, seed=5)
    ldp = bench_synth_clip(LDP_W, LDP_H, 2)
    idr = np.pad(ra[0][0], ((0, 16), (0, 0)), mode="edge")   # 1920x1088
    qb, qi, ql = HEVC_QP + 2, HEVC_QP, 37        # a B picture's, IDR, LD-P
    # (what, cur, ref, log2, luma, slice type, rate, qp)
    shapes = [
        ("1080p B TU16 luma", ra[1][0], ra[0][0], 4, True, 0, True, qb),
        ("1080p B TU8 chroma", ra[1][1], ra[0][1], 3, False, 0, True, qb),
        ("1080p B RQT TU8 luma", ra[1][0], ra[0][0], 3, True, 0, True, qb),
        ("1080p B RQT TU4 chroma", ra[1][1], ra[0][1], 2, False, 0, True,
         qb),
        ("1080p IDR TU8 trial", idr, None, 3, True, 2, True, qi),
        ("1080p IDR TU16 trial", idr, None, 4, True, 2, True, qi),
        ("1080p IDR TU32 trial", idr, None, 5, True, 2, True, qi),
        ("LD-P P TU16 luma", ldp[1][0], ldp[0][0], 4, True, 0, False, ql),
        ("LD-P P TU8 chroma", ldp[1][1], ldp[0][1], 3, False, 0, False, ql),
    ]
    return [(what, rdoq_coeffs(cur, ref, log2), log2, luma, st, rate, qp)
            for what, cur, ref, log2, luma, st, rate, qp in shapes]


def rdoq_lam(qp: int) -> float:
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def phase_rdoq_kernel() -> list:
    """Phase 6 (first): the full-RDOQ kernel against `rdoq_dev_ref` on the
    same CUDA tensors at the paths' shapes, levels exactly and rates bit
    for bit, each timed beside its bound and the plain version.  Returns
    one row per shape, the 1080p B picture's TU16 luma call first."""
    rows = []
    for what, co, log2, luma, st, rate, qp in rdoq_shapes():
        b = co.shape[0]
        kw = dict(lam=rdoq_lam(qp), is_luma=luma, slice_type=st,
                  return_rate=rate)
        got = rdoq_ops.rdoq_dev(co, qp, log2, **kw)
        torch.cuda.synchronize()
        want = rdoq_ops.rdoq_dev_ref(co, qp, log2, **kw)
        (g, gb), (w_, wb) = (got, want) if rate else ((got, None),
                                                      (want, None))
        err = int((g - w_).abs().max())
        same_bits = gb is None or torch.equal(gb.view(torch.int32),
                                              wb.view(torch.int32))
        check(err == 0 and same_bits,
              f"RDOQ kernel != plain at {what} B={b} (levels max abs err "
              f"{err}, rates bitwise equal {same_bits})")
        ev = cuda_ms(lambda: rdoq_ops.rdoq_dev(co, qp, log2, **kw), reps=11)
        ms, note = kernel_ms(lambda: rdoq_ops.rdoq_dev(co, qp, log2, **kw),
                             "rdoq_kernel")
        plain = cuda_ms(lambda: rdoq_ops.rdoq_dev_ref(co, qp, log2, **kw),
                        reps=3, warm=1)
        tab, rl = rdoq_ops._kernel_tables(qp, log2, luma, st, 0, co.device)
        bound, nbytes, ops = rdoq_bound(b, log2, rate,
                                        4 * (tab.numel() + rl.numel()))
        by = "operations" if ops / PEAK_F32 >= nbytes / PEAK_BYTES \
            else "bytes"
        nz = float((g != 0).float().mean())
        print(f"[rdoq-kernel] {what}: B={b} QP{qp} slice type {st}"
              f"{', with the rate' if rate else ''}: levels equal (max abs "
              f"err 0){', rates bitwise equal' if rate else ''}, "
              f"{nz:.2%} of levels nonzero; kernel {kms(ms)} (profiler"
              f"{', ' + note if note else ''}), {ev:.4f} ms a wrapper call "
              f"(CUDA events); bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} G float32 ops, {by}), "
              f"{of_bound(bound, ms)}; plain {plain:.2f} ms"
              f"{'' if ms is None else f' ({plain / ms:.0f}x the kernel)'}")
        rows.append(dict(what=what, b=b, log2=log2, qp=qp, ms=ms,
                         event_ms=ev, plain_ms=plain, bound_ms=bound,
                         bound_by=by, library_ms=None, max_abs_err=err,
                         note=note or None))
        del co, got, want
    torch.cuda.empty_cache()
    b_rows = [r for r in rows if r["what"] in RA_B_RDOQ_CALLS]
    timed = [r for r in b_rows if r["ms"] is not None]
    per_b = {k: sum(RA_B_RDOQ_CALLS[r["what"]] * r[k] for r in timed)
             for k in ("ms", "event_ms", "bound_ms")}
    left_out = [r["what"] for r in b_rows if r["ms"] is None]
    calls = sum(RA_B_RDOQ_CALLS[r["what"]] for r in timed)
    gone = ("; left out, kernel not measured: " + ", ".join(left_out)
            if left_out else "")
    print(f"[rdoq-kernel] per 1080p RA B picture ({calls} of "
          f"{sum(RA_B_RDOQ_CALLS.values())} calls at the B shapes above"
          f"{gone}): kernel {per_b['ms']:.4f} ms, wrapper calls "
          f"{per_b['event_ms']:.4f} ms, bound {per_b['bound_ms']:.4f} ms")
    print("[rdoq-kernel] no single PyTorch call computes RDOQ (library_ms "
          "null)")
    return rows


def phase_hevc_intra() -> None:
    """Phase 6: the HEVC all-intra quadtree on the card against the CPU.
    The 1080p IDR now runs inside the RA GOP of phase 7."""
    # the 35-mode prediction is a float32 matmul that is exact only
    # without TF32 (the package turns it off at import)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    sw, sh = 416, 240                    # the repo's bench_intra_qt size
    y, u, v = synth_clip(sw, sh, 1, seed=9)[0]
    res = {}
    routes = {}
    for dev in ("cuda", "cpu"):
        e = quadtree_codec.QuadtreeFastEncoder(hevc_cfg(sw, sh), device=dev)
        t0 = time.perf_counter()
        st, *routes[dev] = rdoq_routes(lambda: {
            k: a.cpu().numpy() for k, a in e._dispatch(y, u, v).items()})
        res[dev] = (st, e.serialize_frame(st)[0],
                    time.perf_counter() - t0)
    (g, gn, tg), (c, cn, tc) = res["cuda"], res["cpu"]
    routed = check_rdoq_routes(f"hevc-intra {sw}x{sh}", routes["cuda"],
                               routes["cpu"])
    diff = {k: int((g[k] != c[k]).sum()) for k in g
            if not np.array_equal(g[k], c[k])}
    check(not diff, f"cuda != cpu at {sw}x{sh}: elements differing per "
                    f"key {diff}")
    check(gn == cn, f"cuda and cpu NAL bytes differ at {sw}x{sh}")
    print(f"[hevc-intra] {sw}x{sh} picture on the card and on the CPU: all "
          f"{len(g)} state keys equal, NAL bytes equal ({routed}) "
          f"({sum(len(n) for n in gn if n)} bytes); cuda {tg:.2f} s, "
          f"cpu {tc:.2f} s")


def ra_cfg(w: int, h: int, **kw):
    """The 1080p headline's settings (bench.py:84-107): CTB32, min CU 8,
    max TB 32, QP 32, SBH, merge-5, TMVP, with the MD5 picture-hash SEI."""
    cfg = hevc_headers.HevcConfig(
        width=w, height=h, qp=HEVC_QP, log2_ctb=5, log2_min_cb=3,
        log2_max_tb=5, reorder_pics=3, sign_data_hiding=True, rdoq="lite",
        merge_cands=5, hash_sei=True, temporal_mvp=True)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def ra_sad_shapes(w: int, h: int, sr: int, n: int = 16):
    """(n, B, r) of the pyramid's three SAD surfaces per list and
    reference: the 4x4-pooled exhaustive stage and two +-3 windows."""
    b = (w // n) * (h // n)
    return [(n // 4, b, max(1, (sr + 3) // 4)), (n, b, 3), (n, b, 3)]


def phase_ra_kernel() -> dict:
    """Phase 7a: the kernel against its plain version at the RA path's
    shapes (and the CU8 tree's), timed beside its bound; the totals are
    per B picture (two lists, one reference each)."""
    rng = np.random.default_rng(2025)
    pic = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    max_err = 0
    shapes = ra_sad_shapes(HEVC_W, HEVC_H, RA_SR)
    cu8 = ra_sad_shapes(HEVC_W, HEVC_H, RA_SR, n=8)
    for i, (n, b, r) in enumerate(shapes[:2] + cu8[:2]):
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        max_err = max(max_err, err)
        if i >= 2:                       # the CU8 tree's shapes: checked
            print(f"[ra-sad] n={n} B={b} r={r} (CU8 tree): equal")
            continue
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        tm = sad_times(cur, win, n, r)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        print(f"[ra-sad] n={n} B={b} r={r}: equal; kernel {kms(ms)} "
              f"(profiler{', ' + tm['note'] if tm['note'] else ''}), "
              f"{tm['event_ms']:.4f} ms a wrapper call (CUDA events); "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} G ops), {of_bound(bound, ms)}; plain "
              f"{plain:.3f} ms; torch.cdist {lib:.3f} ms (max abs err "
              f"{lib_err:g})")
        k = 2 * (1 if i == 0 else 2)     # per B picture: 2 lists
        add_kernel_ms(pic, k, ms, tm["note"], f"n={n} r={r}")
        pic["plain_ms"] += k * plain
        pic["library_ms"] += k * lib
        pic["bytes"] += k * nbytes
        pic["ops"] += k * ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[ra-sad] per 1080p B picture at SR{RA_SR} (2 lists x (quarter "
          f"stage + 2 windows), 6 launches): kernel {kms(pic['ms'])}, "
          f"bound {pic['bound_ms']:.4f} ms ({pic['bound_by']}), "
          f"{of_bound(pic['bound_ms'], pic['ms'])}; plain "
          f"{pic['plain_ms']:.3f} ms; torch.cdist {pic['library_ms']:.3f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["max_abs_err"] = max_err
    return pic


def sao_bound(h: int, w: int, ctb: int) -> tuple[float, float, float]:
    """(ms, bytes, operations) the card needs at least for one plane's SAO
    statistics: uint8 orig and rec read once, the 104 four-byte values of
    each CTB (EO counts and sums 4 x 5 each, band counts and sums 32 each)
    written once; per sample 8 neighbour differences, the orig - rec
    difference, the band shift and 10 accumulations."""
    nbytes = 2 * h * w + 104 * 4 * (h // ctb) * (w // ctb)
    ops = 20 * h * w
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS) * 1e3, nbytes, ops


def kernel_device_ms(fn, name: str, reps: int = 21) -> float | None:
    """Median device time in ms of the kernels called `name` that reps
    calls of fn() launch, from torch.profiler; None if the profiler saw
    none (kernel_ms asks again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return statistics.median(times) / 1e3 if times else None


def kernel_ms(fn, name: str, reps: int = 21,
              tries: int = 3) -> tuple[float | None, str]:
    """(kernel time in ms, "") from kernel_device_ms, asked up to `tries`
    times, or (None, the reason) when no profiler session recorded a
    kernel called `name`.  A wrapper call's CUDA-event time is never
    taken for the kernel's: it holds the wrapper's host work too."""
    for _ in range(tries):
        ms = kernel_device_ms(fn, name, reps)
        if ms is not None:
            return ms, ""
    return None, f"torch.profiler recorded no {name} in {tries} tries"


def of_bound(bound: float, ms: float | None) -> str:
    """The kernel time's share of its bound, from a kernel time only."""
    if ms is None:
        return "share of the bound not measured"
    return f"{bound / ms:.1%} of it"


def kms(ms: float | None, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def sad_times(cur, win, n: int, r: int, reps: int = 21) -> dict:
    """The SAD kernel's time from the profiler (`ms`, None with `note`
    when unrecorded), one wrapper call's from CUDA events (`event_ms`),
    the plain version's and torch.cdist's."""
    ms, note = kernel_ms(lambda: ss.sad_surface(cur, win, n, r),
                         "sad_surface_u8", reps)
    return dict(ms=ms, note=note,
                event_ms=cuda_ms(lambda: ss.sad_surface(cur, win, n, r),
                                 reps=reps),
                plain_ms=cuda_ms(lambda: ss.sad_surface_ref(cur, win, n, r),
                                 reps=3, warm=1),
                library_ms=cuda_ms(lambda: sad_cdist(cur, win, n, r),
                                   reps=3, warm=1))


def add_kernel_ms(pic: dict, k: float, ms: float | None, note: str,
                  what: str) -> None:
    """Add k kernel times to a per-picture total; an unrecorded one makes
    the total None, with the reason in pic["note"]."""
    if ms is None:
        pic["ms"] = None
        pic["note"] = "; ".join(filter(None, (pic.get("note"),
                                              f"{what}: {note}")))
    elif pic["ms"] is not None:
        pic["ms"] += k * ms


def sao_planes() -> list:
    """(what, orig, rec, ctb, timed) on the card: the RA SAO path's padded
    planes of a 1080p picture (timed) and of 112x80, rec within +-3 of
    orig."""
    y, u, v = synth_clip(HEVC_W, HEVC_H, 1, seed=5)[0]
    rng = np.random.default_rng(2027)
    planes = []
    for what, plane, ctb, timed in (
            ("1080p luma", y, 32, True), ("1080p Cb", u, 16, True),
            ("1080p Cr", v, 16, True), ("112x80 luma", y[:80, :112], 32,
                                        False),
            ("112x80 Cb", u[:40, :56], 16, False)):
        o = inter_qt._pad_to(np.ascontiguousarray(plane), ctb)
        r = np.clip(o.astype(np.int16) + rng.integers(-3, 4, o.shape),
                    0, 255).astype(np.uint8)
        planes.append((what, torch.from_numpy(np.ascontiguousarray(o)).cuda(),
                       torch.from_numpy(r).cuda(), ctb, timed))
    return planes


def phase_sao_kernel() -> dict:
    """Phase 7e: the SAO-statistics kernel against its plain version at
    the RA SAO path's padded planes, exactly, timed beside its bound; the
    totals are per 1080p picture (luma + two chroma planes, 3 launches)."""
    pic = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    max_err = 0.0
    for what, to, tr, ctb, timed in sao_planes():
        got = sao_ops.sao_stats(to, tr, ctb)
        torch.cuda.synchronize()
        want = sao_ops.sao_stats_ref(to, tr, ctb)
        check(all(g.dtype == w_.dtype and g.shape == w_.shape and
                  g.stride() == w_.contiguous().stride()
                  for g, w_ in zip(got, want)),
              f"SAO kernel outputs' dtypes, shapes or strides differ "
              f"({what})")
        err = max(float((g.double() - w_.double()).abs().max())
                  for g, w_ in zip(got, want))
        check(err == 0, f"SAO kernel != plain at {what} "
                        f"{tuple(to.shape)} (max abs err {err})")
        max_err = max(max_err, err)
        hp, wp = to.shape
        if not timed:
            print(f"[sao-kernel] {what} ({wp}x{hp} padded, CTB {ctb}): "
                  "all four outputs equal")
            continue
        ev = cuda_ms(lambda: sao_ops.sao_stats(to, tr, ctb), reps=21)
        ms, note = kernel_ms(lambda: sao_ops.sao_stats(to, tr, ctb),
                             "sao_stats_kernel")
        plain = cuda_ms(lambda: sao_ops.sao_stats_ref(to, tr, ctb), reps=3,
                        warm=1)
        bound, nbytes, ops = sao_bound(hp, wp, ctb)
        print(f"[sao-kernel] {what} ({wp}x{hp} padded, CTB {ctb}, "
              f"{(hp // ctb) * (wp // ctb)} CTBs): all four outputs equal; "
              f"kernel {kms(ms)} (profiler{', ' + note if note else ''}), "
              f"{ev:.4f} ms a wrapper call (CUDA events); bound "
              f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB), "
              f"{of_bound(bound, ms)}; plain {plain:.3f} ms")
        add_kernel_ms(pic, 1, ms, note, what)
        pic["event_ms"] += ev
        pic["plain_ms"] += plain
        pic["bytes"] += nbytes
        pic["ops"] += ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[sao-kernel] per 1080p picture (3 launches): kernel "
          f"{kms(pic['ms'])} ({pic['event_ms']:.4f} ms in wrapper calls), "
          f"bound {pic['bound_ms']:.4f} ms ({pic['bytes'] / 1e6:.2f} MB, "
          f"{pic['bound_by']}), {of_bound(pic['bound_ms'], pic['ms'])}; "
          f"plain {pic['plain_ms']:.3f} ms; no single PyTorch call computes "
          "these statistics (library_ms null)"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["library_ms"] = None
    pic["max_abs_err"] = max_err
    return pic


def _ra_instrument(enc):
    """Time each picture of an RA encode: the device phase (device work +
    copy back, synchronised), the host phase (CABAC serializer, hash SEI,
    TMVP store), with SAO the decision (`_sao_decide_qt`) and within it
    the statistics on the card (`inter_qt._sao_stats`, synchronised, which
    this patches until the returned restore() is called), and the SAD,
    SAO and RDOQ kernels' launches; keep each picture's maps and SAO
    parameters."""
    log, cur = [], {}

    def timed(name, fn, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            n0 = ss.sad_surface.launches
            s0 = sao_ops.sao_stats.launches
            r0 = rdoq_ops.rdoq_dev.launches
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if name == "sao_stats":
                torch.cuda.synchronize()
            cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
            if name != "sao_stats":     # counted in "sao" around it
                cur["launches"] = cur.get("launches", 0) + \
                    ss.sad_surface.launches - n0
                cur["sao_launches"] = cur.get("sao_launches", 0) + \
                    sao_ops.sao_stats.launches - s0
                cur["rdoq"] = cur.get("rdoq", 0) + \
                    rdoq_ops.rdoq_dev.launches - r0
            if name in ("device", "sao"):
                cur["qt" if name == "device" else "sao_params"] = out
            return out
        return run

    enc._device_phase = timed("device", enc._device_phase, sync=True)
    enc._sao_decide_qt = timed("sao", enc._sao_decide_qt, sync=True)
    for name in ("_serialize_qt_slice", "_hash_sei", "_store_motion"):
        setattr(enc, name, timed("host", getattr(enc, name)))
    stats_fn = inter_qt._sao_stats
    inter_qt._sao_stats = timed("sao_stats", stats_fn, sync=True)
    orig_b = enc._encode_b_frame

    def b_frame(frame, poc, refs, is_anchor):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec = orig_b(frame, poc, refs, is_anchor)
        log.append(dict(poc=poc, kind="P" if is_anchor else "B",
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        **cur))
        return nals, rec

    def idr(y, u, v, *a, **kw):
        qi = enc._qt_intra
        torch.cuda.synchronize()
        n0 = ss.sad_surface.launches
        r0 = rdoq_ops.rdoq_dev.launches
        t0 = time.perf_counter()
        st = {k: t.cpu() for k, t in qi._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        nals, rec = qi.serialize_frame(st)
        t2 = time.perf_counter()
        log.append(dict(poc=0, kind="I", device=t1 - t0, host=t2 - t1,
                        total=t2 - t0, nals=nals, rec=rec,
                        launches=ss.sad_surface.launches - n0,
                        rdoq=rdoq_ops.rdoq_dev.launches - r0,
                        depth8=st["depth8"].numpy()))
        return nals, rec

    def restore():
        inter_qt._sao_stats = stats_fn

    enc._encode_b_frame = b_frame
    enc.encode_frame = idr
    return log, restore


def _sao_counts(params) -> str:
    """OFF / BO / EO CTBs per plane of one picture's SAO parameters."""
    out = []
    for c, plane in enumerate(("Y", "Cb", "Cr")):
        types = [p3[c].type_idx for p3 in params]
        out.append(f"{plane} " + "/".join(
            str(types.count(t)) for t in (sao_ops.SAO_OFF, sao_ops.SAO_BO,
                                          sao_ops.SAO_EO)))
    return "SAO CTBs OFF/BO/EO " + ", ".join(out)


def sad_launches_per_search(me_method: str) -> int:
    """SAD-kernel launches of one integer search: the pyramid's pooled
    stage and two +-3 windows, or TZ's / the full search's one surface."""
    return 3 if me_method == "pyr" else 1


def phase_hevc_ra(sao: bool = False,
                  me_method: str = "pyr") -> tuple[int, int, int]:
    """Phase 7b-c (7f with sao, 9b with me_method="tz"): the RA GOP-8
    headline at 1920x1072 on the card, decoded by the port's
    GeneralDecoder.  Returns the SAD-, SAO- and RDOQ-kernel launches of
    the encode."""
    w, h = HEVC_W, HEVC_H
    tag = ("hevc-ra-sao" if sao else "hevc-ra") + \
        ("" if me_method == "pyr" else f"-{me_method}")
    k = sad_launches_per_search(me_method)
    search = "pyramid" if me_method == "pyr" else \
        "TZSearch (HM FastSearch 1)"
    frames = synth_clip(w, h, RA_PICTURES, seed=5)
    print(f"[{tag}] {w}x{h} QP{HEVC_QP} GOP-8 random access, "
          f"{RA_PICTURES} pictures (POC 0..{RA_PICTURES - 1}: IDR, anchor "
          f"P at 8, B at 4 2 1 3 6 5 7); SR{RA_SR} {search} ME, CU8 tree "
          "off, TMVP, full RDOQ in the B pictures, 1 reference per list; "
          "SAO " + ("on" if sao else "off"))
    enc = inter_qt.QtDeviceRandomAccessEncoder(
        ra_cfg(w, h, sao=sao), search_range=RA_SR, me_method=me_method,
        cu8=False, num_refs_active=1, device="cuda")
    log, restore = _ra_instrument(enc)
    ss.sad_surface.launches = 0
    sao_ops.sao_stats.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    try:
        stream, recons = enc.encode_sequence_ra(frames)
    finally:
        restore()
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    sao_launches = sao_ops.sao_stats.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on the card")
    want = 0
    for e in log:
        nbytes = sum(len(n) for n in e["nals"] if n)
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            d8 = e["depth8"][:h // 8, :w // 8]
            cus = "CUs 32/16/8 (intra) " + "/".join(
                str(int((d8 == d).sum()) // (16 >> (2 * d)))
                for d in (0, 1, 2))
            other = 0.0
        else:
            qt = e["qt"]
            m2 = np.zeros(qt["split8"].shape, bool)
            g = np.repeat(np.repeat(qt["merged32"], 2, 0), 2, 1)
            m2[:g.shape[0], :g.shape[1]] = g
            cus = (f"CU32 merged {int(qt['merged32'].sum())} (residual "
                   f"{int(qt['res32'].sum())}), CU16 "
                   f"{int((~m2 & ~qt['split8']).sum())}, CU8 "
                   f"{4 * int(qt['split8'].sum())}")
            other = (e["total"] - e["device"] - e["host"] -
                     e.get("sao", 0.0))
            want += k * (2 if e["kind"] == "B" else 1)
            check(e["launches"] == k * (2 if e["kind"] == "B" else 1),
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches "
                  f"(want {k} per list and reference)")
            check(e["sao_launches"] == (3 if sao else 0),
                  f"POC {e['poc']}: {e['sao_launches']} SAO-kernel "
                  f"launches (want {3 if sao else 0})")
        check(e["rdoq"] > 0, f"POC {e['poc']}: no RDOQ-kernel launch")
        if sao and e["kind"] != "I":
            cus += (f"; SAO {e['sao'] * 1e3:.1f} ms (statistics on the card "
                    f"{e['sao_stats'] * 1e3:.1f} ms, {e['sao_launches']} "
                    f"launches; offset search on the host "
                    f"{(e['sao'] - e['sao_stats']) * 1e3:.1f} ms); "
                    + _sao_counts(e["sao_params"]))
        print(f"[{tag}] POC {e['poc']} ({e['kind']}): device phase "
              f"{e['device'] * 1e3:.1f} ms, host phase {e['host'] * 1e3:.1f}"
              f" ms, other {other * 1e3:.1f} ms; {nbytes} bytes, "
              f"{nbytes * 8 * 30 / 1000:.1f} kbps at 30 fps, Y-PSNR "
              f"{p:.2f} dB; {cus}; SAD-kernel launches {e['launches']}, "
              f"RDOQ-kernel launches {e['rdoq']}")
    check(launches == want, f"{launches} SAD-kernel launches in the GOP, "
                            f"want {want}")
    check(sao_launches == (24 if sao else 0),
          f"{sao_launches} SAO-kernel launches in the GOP, want "
          f"{24 if sao else 0}")
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    sha = hashlib.sha1(stream).hexdigest()
    y_psnr = np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)])
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, mean "
          f"Y-PSNR {y_psnr:.3f} dB, encode {t_enc:.2f} s "
          f"({len(frames) / t_enc:.3f} fps); SAD-kernel launches {launches}"
          f", SAO-kernel launches {sao_launches}, RDOQ-kernel launches "
          f"{rdoq_launches} (the plain version 0 times); SHA-1 {sha}")
    ref_bytes, ref_sha = ((RA_SAO_BYTES, RA_SAO_SHA1) if sao
                          else (RA_TZ_BYTES, RA_TZ_SHA1)
                          if me_method == "tz" else (RA_BYTES, RA_SHA1))
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"RA stream {len(stream)} bytes SHA-1 {sha}, the JAX package's "
          f"is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's, byte for byte "
          "(SHA-1)")

    t0 = time.perf_counter()
    dec = hevc_decoder.GeneralDecoder()
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    print(f"[{tag}] the port's GeneralDecoder: hash SEI OK on all "
          f"{len(frames)} pictures, pictures equal the encoder's, "
          f"{t_dec:.2f} s")
    return launches, sao_launches, rdoq_launches


def phase_ra_cuda_vs_cpu() -> None:
    """Phase 7d: small RA GOPs on the card and on the CPU; the streams
    must be byte-equal."""
    runs = [("96x64, 9 pictures, headline settings", 96, 64, 9,
             dict(search_range=RA_SR, cu8=False), {}),
            ("96x64, 5 pictures, CU8 tree + 2 refs per list", 96, 64, 5,
             dict(search_range=16, cu8=True, num_refs_active=2),
             dict(temporal_mvp=False)),
            ("112x80, 9 pictures, SAO, CU8 tree, SR8 (partial edge CTBs)",
             112, 80, 9, dict(search_range=8, cu8=True),
             dict(sao=True, temporal_mvp=False))]
    for what, w, h, n, kw, cfg_kw in runs:
        frames = synth_clip(w, h, n, seed=17)
        res = {}
        routes = {}
        for dev in ("cuda", "cpu"):
            enc = inter_qt.QtDeviceRandomAccessEncoder(
                ra_cfg(w, h, **cfg_kw), device=dev, **kw)
            s0 = sao_ops.sao_stats.launches
            t0 = time.perf_counter()
            stream, *routes[dev] = rdoq_routes(
                lambda: enc.encode_sequence_ra(frames)[0])
            res[dev] = (stream, time.perf_counter() - t0,
                        sao_ops.sao_stats.launches - s0)
        (g, tg, gl), (c, tc, cl) = res["cuda"], res["cpu"]
        routed = check_rdoq_routes(f"RA {what}", routes["cuda"],
                                   routes["cpu"])
        want = 3 * (n - 1) if cfg_kw.get("sao") else 0
        check((gl, cl) == (want, 0),
              f"RA {what}: SAO-kernel launches {gl} on the card, {cl} on "
              f"the CPU (want {want}, 0)")
        check(g == c, f"RA {what}: card and CPU streams differ "
                      f"({len(g)} / {len(c)} bytes)")
        dec = hevc_decoder.GeneralDecoder()
        dec.decode(g)
        check(dec.hash_status == [True] * n, f"RA {what}: hash mismatch")
        print(f"[ra-cuda-vs-cpu] {what}: streams byte-equal ({len(g)} "
              f"bytes), hash OK; {routed}; cuda {tg:.2f} s, cpu "
              f"{tc:.2f} s")


def ldp_cfg(w: int, h: int):
    """bench_ldp_480's settings (bench.py:171-186): QP 32, 4 references,
    merge 5, TMVP, SBH, CTB 16, deblocking and the MD5 hash SEI on (the
    HevcConfig defaults)."""
    return hevc_headers.HevcConfig(width=w, height=h, qp=32, num_refs=4,
                                   merge_cands=5, temporal_mvp=True,
                                   sign_data_hiding=True)


def phase_ldp_kernel() -> dict:
    """Phase 8a: the kernel against its plain version at the LD-P
    pyramid's shapes, timed beside its bound; the totals are per P
    picture with all 4 references (4 x (pooled stage + 2 windows))."""
    rng = np.random.default_rng(2026)
    pic = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    max_err = 0
    for i, (n, b, r) in enumerate(ra_sad_shapes(LDP_W, LDP_H, LDP_SR)[:2]):
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        max_err = max(max_err, err)
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        tm = sad_times(cur, win, n, r)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        print(f"[ldp-sad] n={n} B={b} r={r}: equal; kernel {kms(ms)} "
              f"(profiler{', ' + tm['note'] if tm['note'] else ''}), "
              f"{tm['event_ms']:.4f} ms a wrapper call (CUDA events); "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} G ops), {of_bound(bound, ms)}; plain "
              f"{plain:.3f} ms; torch.cdist {lib:.3f} ms (max abs err "
              f"{lib_err:g})")
        k = 4 * (1 if i == 0 else 2)     # per P picture: 4 references
        add_kernel_ms(pic, k, ms, tm["note"], f"n={n} r={r}")
        pic["plain_ms"] += k * plain
        pic["library_ms"] += k * lib
        pic["bytes"] += k * nbytes
        pic["ops"] += k * ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[ldp-sad] per 832x480 P picture at 4 references (12 launches): "
          f"kernel {kms(pic['ms'])}, bound {pic['bound_ms']:.4f} ms "
          f"({pic['bound_by']}), {of_bound(pic['bound_ms'], pic['ms'])}; "
          f"plain {pic['plain_ms']:.3f} ms; torch.cdist "
          f"{pic['library_ms']:.3f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["max_abs_err"] = max_err
    return pic


def _timer(cur: dict):
    """timed(name, fn, sync): fn wrapped to add its host-clock seconds to
    cur[name] (after a synchronise when sync), its SAD- and RDOQ-kernel
    launches to cur["launches"] and cur["rdoq"], and to keep its result
    as cur[fn.__name__]."""
    def timed(name, fn, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            n0 = ss.sad_surface.launches
            r0 = rdoq_ops.rdoq_dev.launches
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
            cur["launches"] = cur.get("launches", 0) + \
                ss.sad_surface.launches - n0
            cur["rdoq"] = cur.get("rdoq", 0) + \
                rdoq_ops.rdoq_dev.launches - r0
            cur[fn.__name__] = out
            return out
        return run
    return timed


def _ldp_instrument(enc):
    """Time each picture of an LD-P encode: the device phase (upload,
    device work, copy back, synchronised), the host phase (`_reconcile`,
    CABAC slice, hash SEI) and the SAD- and RDOQ-kernel launches; keep
    each picture's block decisions."""
    log, cur = [], {}
    timed = _timer(cur)

    enc._device_phase = timed("device", enc._device_phase, sync=True)
    for name in ("_reconcile", "_encode_p_slice", "_hash_sei"):
        setattr(enc, name, timed("host", getattr(enc, name)))
    orig_p = enc.encode_p_frame

    def p_frame(y, u, v, dpb, poc):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec, mf = orig_p(y, u, v, dpb, poc)
        log.append(dict(poc=poc, kind="P", qp=enc.cfg.qp,
                        refs=min(len(dpb), enc.cfg.num_refs),
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        info=cur["_reconcile"], **{
                            k: cur[k] for k in ("device", "host",
                                                "launches", "rdoq")}))
        return nals, rec, mf

    def idr(y, u, v, *a, **kw):
        torch.cuda.synchronize()
        n0 = ss.sad_surface.launches
        r0 = rdoq_ops.rdoq_dev.launches
        t0 = time.perf_counter()
        st = {k: t.cpu() for k, t in enc._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        nals, rec = enc.serialize_frame(st)
        t2 = time.perf_counter()
        log.append(dict(poc=0, kind="I", qp=enc.cfg.qp, refs=0,
                        device=t1 - t0, host=t2 - t1, total=t2 - t0,
                        nals=nals, rec=rec,
                        launches=ss.sad_surface.launches - n0,
                        rdoq=rdoq_ops.rdoq_dev.launches - r0))
        return nals, rec

    enc.encode_p_frame = p_frame
    enc.encode_frame = idr
    return log


def _ldp_expected(me_method: str, rc: bool) -> tuple[int, str, str]:
    """(bytes, SHA-1, what) of the JAX package's stream for an LD-P run."""
    if rc:
        return (LDP_RC_BYTES, LDP_RC_SHA1,
                "the spec AMVP list and the same controller")
    if me_method == "tz":
        return LDP_TZ_BYTES, LDP_TZ_SHA1, "the spec AMVP list"
    return LDP_BYTES, LDP_SHA1, "the spec AMVP list"


def phase_hevc_ldp(me_method: str = "pyr", rc: bool = False):
    """Phase 8b-c (9a with me_method="tz", 9c with rc): bench_ldp_480 on
    the card, decoded by the port's GeneralDecoder and held to the JAX
    package's stream.  With rc a `RateLambdaControl` at RC_BPS sets each
    picture's QP instead of HM's LD-P ladder.  Returns the SAD-kernel
    launches of the encode, the per-picture log and the RDOQ-kernel
    launches."""
    w, h = LDP_W, LDP_H
    tag = "hevc-ldp" + ("" if me_method == "pyr" else f"-{me_method}") + \
        ("-rc" if rc else "")
    k = sad_launches_per_search(me_method)
    frames = bench_synth_clip(w, h, LDP_PICTURES)
    search = "pyramid" if me_method == "pyr" else \
        "TZSearch (HM FastSearch 1)"
    qps = (f"RateLambdaControl at {RC_BPS / 1e6:g} Mb/s (base QP 32)" if rc
           else "QP 32 with HM's LD-P ladder")
    print(f"[{tag}] {w}x{h} low-delay P, {LDP_PICTURES} pictures of "
          f"bench.py's clip (seed 42): IDR + 8 P, {qps}, 4 references, "
          f"merge 5, TMVP, SBH, SR{LDP_SR} {search} ME, full RDOQ in the P "
          "pictures")
    enc = hevc_inter_dev.DeviceLowDelayEncoder(
        ldp_cfg(w, h), search_range=LDP_SR, me_method=me_method,
        device="cuda")
    controller = ratectrl.RateLambdaControl(RC_BPS, 30.0, w, h,
                                            base_qp=32) if rc else None
    log = _ldp_instrument(enc)
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence_ldp(frames, controller)
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on the card")
    want = 0
    for e in log:
        nbytes = sum(len(n) for n in e["nals"] if n)
        e["bytes"] = nbytes
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            blocks = f"{(w // 16) * (h // 16)} intra (IDR)"
        else:
            cnt = dict(intra=0, skip=0, merge=0, amvp=0)
            for row in e["info"]:
                for b in row:
                    cnt["intra" if b.pred_mode == 1 else "skip" if b.skip
                        else "merge" if b.merge else "amvp"] += 1
            blocks = " / ".join(f"{k_} {v}" for k_, v in cnt.items())
            want += k * e["refs"]
            check(e["rdoq"] > 0, f"POC {e['poc']}: no RDOQ-kernel launch")
            check(e["launches"] == k * e["refs"],
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches "
                  f"(want {k} per reference, {e['refs']} references)")
        other = e["total"] - e["device"] - e["host"]
        print(f"[{tag}] POC {e['poc']} ({e['kind']}, QP {e['qp']}, "
              f"{e['refs']} refs): device phase {e['device'] * 1e3:.1f} ms,"
              f" host phase {e['host'] * 1e3:.1f} ms, other "
              f"{other * 1e3:.1f} ms; {nbytes} bytes ({nbytes * 8} bits), "
              f"Y-PSNR {p:.2f} dB; blocks {blocks}; SAD-kernel launches "
              f"{e['launches']}, RDOQ-kernel launches {e['rdoq']}")
    check(launches == want == k * 26,
          f"{launches} SAD-kernel launches in the run, want {want} = "
          f"{k * 26}")
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    sha = hashlib.sha1(stream).hexdigest()
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, "
          f"encode {t_enc:.2f} s ({len(frames) / t_enc:.3f} fps); "
          f"SAD-kernel launches {launches}, RDOQ-kernel launches "
          f"{rdoq_launches} (the plain version 0 times); SHA-1 {sha}")
    if rc:
        check(enc.frame_qps == LDP_RC_QPS,
              f"rate-controlled QPs {enc.frame_qps}, the JAX package's "
              f"are {LDP_RC_QPS}")
        print(f"[{tag}] QPs {enc.frame_qps} (the JAX package's); "
              f"{kbps:.1f} kbps achieved against the {RC_BPS / 1e3:.0f} "
              f"kbps target ({kbps / (RC_BPS / 1e3):.2f}x); the IDR "
              f"{log[0]['bytes'] * 8} bits against "
              f"{RC_BPS / 30:.0f} bits a picture")

    t0 = time.perf_counter()
    dec = hevc_decoder.GeneralDecoder()
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    print(f"[{tag}] the port's GeneralDecoder: hash SEI OK on all "
          f"{len(frames)} pictures, pictures equal the encoder's, "
          f"{t_dec:.2f} s")
    ref_bytes, ref_sha, what = _ldp_expected(me_method, rc)
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"LD-P stream {len(stream)} bytes SHA-1 {sha}, the JAX "
          f"package's ({what}) is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's with {what}, byte for "
          "byte (SHA-1)")
    return launches, log, rdoq_launches


def phase_ldp_rc_resume(one_run: list) -> int:
    """Phase 9d: the rate-controlled run stopped after picture
    RC_RESUME_AT - 1, its state written with `checkpoint.save` and read
    back with `checkpoint.load`, and pictures RC_RESUME_AT.. encoded from
    it by a new encoder and a new controller.  The resumed NALs must be
    the JAX package's resumed run's; whether they also equal those
    pictures of the one run is printed (the state keeps only the newest
    picture, so the resumed run starts with one reference and the
    reference promises no such equality).  Returns the SAD- and
    RDOQ-kernel launches of both encodes."""
    w, h = LDP_W, LDP_H
    frames = bench_synth_clip(w, h, LDP_PICTURES)
    path = BUILD_DIR / "ldp_rc_state.npz"
    path.parent.mkdir(parents=True, exist_ok=True)

    def encoder():
        return (hevc_inter_dev.DeviceLowDelayEncoder(
                    ldp_cfg(w, h), search_range=LDP_SR, device="cuda"),
                ratectrl.RateLambdaControl(RC_BPS, 30.0, w, h, base_qp=32))

    enc, rc = encoder()
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    _, _, state = enc.encode_frames(frames[:RC_RESUME_AT], None, rc)
    checkpoint.save(state, str(path))
    t1 = time.perf_counter()
    enc, rc = encoder()
    loaded = checkpoint.load(str(path))
    check(loaded.poc == RC_RESUME_AT and loaded.rc == state.rc and all(
        np.array_equal(a, b) for a, b in zip(loaded.ref, state.ref)),
        "checkpoint.load did not give back the saved state")
    nals, recons, _ = enc.encode_frames(frames[RC_RESUME_AT:], loaded, rc)
    t2 = time.perf_counter()
    launches = ss.sad_surface.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    check(rdoq_launches > 0 and RDOQ_REF_CALLS["cuda"] == 0,
          f"the resumed encodes: {rdoq_launches} RDOQ-kernel launches, the "
          f"plain version {RDOQ_REF_CALLS['cuda']} times on the card")
    n_first = sum(min(p, 4) for p in range(RC_RESUME_AT))
    n_second = sum(min(p + 1, 4) for p in range(LDP_PICTURES - RC_RESUME_AT))
    want = 3 * (n_first + n_second)
    check(launches == want, f"{launches} SAD-kernel launches in the two "
                            f"resumed encodes, want {want}")
    resumed = hevc_bs.annexb(nals)
    sha = hashlib.sha1(resumed).hexdigest()
    same = [e["nals"] for e in one_run[RC_RESUME_AT:]] == [
        nals[2 * i:2 * i + 2] for i in range(LDP_PICTURES - RC_RESUME_AT)]
    print(f"[hevc-ldp-rc] resume: pictures 0-{RC_RESUME_AT - 1} encoded "
          f"({t1 - t0:.2f} s), the state (POC {loaded.poc}, the newest "
          f"picture's planes, {len(loaded.rc) - 1} controller values) "
          f"written with checkpoint.save ({path.stat().st_size} bytes) and "
          f"read back; pictures {RC_RESUME_AT}-{LDP_PICTURES - 1} encoded "
          f"from it by a new encoder and controller ({t2 - t1:.2f} s): QPs "
          f"{enc.frame_qps}, {len(resumed)} bytes, SHA-1 {sha}; "
          f"SAD-kernel launches {launches}, RDOQ-kernel launches "
          f"{rdoq_launches}")
    check(enc.frame_qps == LDP_RC_QPS[RC_RESUME_AT:],
          f"resumed QPs {enc.frame_qps}, want {LDP_RC_QPS[RC_RESUME_AT:]}")
    for i, r in enumerate(recons):
        p = psnr(frames[RC_RESUME_AT + i][0], r[0])
        check(np.isfinite(p) and p > 20, f"implausible Y-PSNR {p}")
    check((len(resumed), sha) == (RC_RESUMED_BYTES, RC_RESUMED_SHA1),
          f"resumed NALs {len(resumed)} bytes SHA-1 {sha}, the JAX "
          f"package's are {RC_RESUMED_BYTES} bytes {RC_RESUMED_SHA1}")
    print(f"[hevc-ldp-rc] the resumed NALs are the JAX package's resumed "
          f"run's, byte for byte (SHA-1); equal to pictures "
          f"{RC_RESUME_AT}-{LDP_PICTURES - 1} of the one run: {same}")
    return launches, rdoq_launches


def phase_ldp_cuda_vs_cpu() -> None:
    """Phase 8d: a 96x64 LD-P run at 4 references on the card and on
    the CPU, with intra blocks in its P pictures: byte-equal streams."""
    w, h, n = 96, 64, 5
    frames = cut_clip(w, h, n)
    res, routes = {}, {}
    for dev in ("cuda", "cpu"):
        enc = hevc_inter_dev.DeviceLowDelayEncoder(
            ldp_cfg(w, h), search_range=LDP_SR, device=dev)
        modes = []
        phase = enc._device_phase

        def keep(*a, **kw):
            st = phase(*a, **kw)
            modes.append(st["pred_mode"])
            return st

        enc._device_phase = keep
        t0 = time.perf_counter()
        stream, *routes[dev] = rdoq_routes(
            lambda: enc.encode_sequence_ldp(frames)[0])
        res[dev] = (stream, time.perf_counter() - t0, modes)
    (g, tg, gm), (c, tc, cm) = res["cuda"], res["cpu"]
    routed = check_rdoq_routes("LD-P 96x64", routes["cuda"], routes["cpu"])
    intra = [int((m == 1).sum()) for m in gm]
    check(all(np.array_equal(a, b) for a, b in zip(gm, cm)),
          "LD-P 96x64: card and CPU block modes differ")
    check(sum(intra) > 0, "LD-P 96x64: no intra block in the P pictures")
    check(g == c, f"LD-P 96x64: card and CPU streams differ ({len(g)} / "
                  f"{len(c)} bytes)")
    dec = hevc_decoder.GeneralDecoder()
    dec.decode(g)
    check(dec.hash_status == [True] * n, "LD-P 96x64: hash mismatch")
    print(f"[ldp-cuda-vs-cpu] 96x64, 5 pictures, 4 references, scene cut "
          f"at 3: intra blocks per P picture {intra} (through the "
          f"wavefront on the card); streams byte-equal ({len(g)} bytes), "
          f"hash OK; {routed}; cuda {tg:.2f} s, cpu {tc:.2f} s")


def phase_sad_r64() -> list:
    """Phase 9 (first): the kernel against its plain version at the
    search range 64 surfaces that TZ and the full search take, exactly,
    timed beside its bound, the plain version and `torch.cdist`: the
    LD-P picture's blocks (n=16, B=1,560, one launch per reference), the
    1080p picture's (n=16, B=8,040, one per list and reference) and the
    1080p CU8 tree's (n=8, B=32,160).  Returns one row per shape."""
    rng = np.random.default_rng(2028)
    rows = []
    for what, n, b in (("LD-P 832x480", 16, LDP_W * LDP_H // 256),
                       ("RA 1920x1072", 16, HEVC_W * HEVC_H // 256),
                       ("RA 1920x1072 CU8", 8, HEVC_W * HEVC_H // 64)):
        r = 64
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        del got
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        del want
        tm = sad_times(cur, win, n, r, reps=11)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        by = "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES \
            else "bytes"
        gdiff = ops / 2e9
        rate = "" if ms is None else (f", {gdiff / ms * 1e3:.0f} G/s; "
                                      f"{ms / bound:.2f}x the bound")
        print(f"[sad-kernel-r64] {what}: n={n} B={b} r={r}: equal (max abs "
              f"err 0); kernel {kms(ms)} (profiler"
              f"{', ' + tm['note'] if tm['note'] else ''}; {gdiff:.2f} G "
              f"abs-diffs{rate}), {tm['event_ms']:.4f} ms a wrapper call "
              f"(CUDA events); bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} G ops, {by}), {of_bound(bound, ms)}; plain "
              f"{plain:.3f} ms; torch.cdist {lib:.3f} ms (max abs err "
              f"{lib_err:g})")
        rows.append(dict(what=what, n=n, b=b, r=r, ms=ms,
                         event_ms=tm["event_ms"], plain_ms=plain,
                         library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err, note=tm["note"] or None))
        del cur, win
        torch.cuda.empty_cache()
    return rows


def flat_cfg(w: int, h: int, reorder: int):
    """scripts/diag_ra_gap.py's settings of the flat CTB16 B engines: QP
    32, SBH, CTB = CU = TU 16, one merge candidate, no TMVP, deblocking
    and the MD5 hash SEI on (the HevcConfig defaults)."""
    return hevc_headers.HevcConfig(width=w, height=h, qp=HEVC_QP,
                                   reorder_pics=reorder,
                                   sign_data_hiding=True)


def flat_encoder(kind: str, w: int, h: int, device: str):
    """The flat RA GOP-8 ("ra") or hierarchical-B ("hierb") engine at
    search range 64 with the pyramid ME, and its encode call."""
    if kind == "ra":
        enc = hevc_inter_dev.DeviceRandomAccessEncoder(
            flat_cfg(w, h, 3), search_range=RA_SR, device=device)
        return enc, enc.encode_sequence_ra
    enc = hevc_inter_dev.DeviceHierarchicalBEncoder(
        flat_cfg(w, h, 1), search_range=RA_SR, device=device)
    return enc, enc.encode_sequence_rab


def _flat_instrument(enc):
    """Time each picture of a flat B-engine encode: the device phase
    (`inter_dev._b_device_phase`: upload, encode_b_frame_dev, copy back,
    synchronised; the IDR's flat intra dispatch and copy back), the host
    phase (`_reconcile_b`, CABAC slice, hash SEI; the IDR's serializer)
    and the SAD- and RDOQ-kernel launches; keep each picture's block
    grid.  The module functions are patched until restore() is called."""
    log, cur = [], {}
    timed = _timer(cur)
    mod = hevc_inter_dev

    keep = mod._b_device_phase, mod._reconcile_b
    mod._b_device_phase = timed("device", keep[0], sync=True)
    mod._reconcile_b = timed("host", keep[1])
    for name in ("_encode_b_slice", "_hash_sei"):
        setattr(enc, name, timed("host", getattr(enc, name)))
    orig_b = enc._encode_b_frame

    def b_frame(frame, poc, refs, is_anchor):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec = orig_b(frame, poc, refs, is_anchor)
        log.append(dict(poc=poc, kind="P" if is_anchor else "B",
                        lists=len(refs), total=time.perf_counter() - t0,
                        nals=nals, rec=rec, info=cur["_reconcile_b"], **{
                            k: cur[k] for k in ("device", "host",
                                                "launches", "rdoq")}))
        return nals, rec

    def idr(y, u, v, *a, **kw):
        torch.cuda.synchronize()
        n0 = ss.sad_surface.launches
        r0 = rdoq_ops.rdoq_dev.launches
        t0 = time.perf_counter()
        st = {k: t.cpu() for k, t in enc._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        nals, rec = enc.serialize_frame(st)
        t2 = time.perf_counter()
        log.append(dict(poc=0, kind="I", lists=0, device=t1 - t0,
                        host=t2 - t1, total=t2 - t0, nals=nals, rec=rec,
                        info=None, launches=ss.sad_surface.launches - n0,
                        rdoq=rdoq_ops.rdoq_dev.launches - r0))
        return nals, rec

    def restore():
        mod._b_device_phase, mod._reconcile_b = keep

    enc._encode_b_frame = b_frame
    enc.encode_frame = idr
    return log, restore


def phase_hevc_flat(kind: str) -> tuple[int, int]:
    """Phase 10 (hevc-flat-ra, hevc-hierb): the flat CTB16 B engines at
    1920x1072 on the card, decoded by the port's GeneralDecoder and held
    to the JAX package's stream.  Returns the SAD- and RDOQ-kernel
    launches of the encode."""
    w, h = HEVC_W, HEVC_H
    tag = "hevc-flat-ra" if kind == "ra" else "hevc-hierb"
    frames = synth_clip(w, h, RA_PICTURES, seed=5)
    if kind == "ra":
        order = ("GOP-8 random access (DeviceRandomAccessEncoder), 9 "
                 "pictures: IDR, anchor P at 8, B at 4 2 1 3 6 5 7")
    else:
        frames = frames[:HIERB_PICTURES]
        order = ("2-level hierarchical B (DeviceHierarchicalBEncoder), "
                 f"{HIERB_PICTURES} pictures: I0 P2 B1 P4 B3")
    print(f"[{tag}] {w}x{h} QP{HEVC_QP} {order}; flat CTB = CU = TU 16, "
          f"SR{RA_SR} pyramid ME, one merge candidate, intra blocks in "
          "the inter pictures, deblocking, full RDOQ in the inter "
          f"pictures, SBH, MD5 hash SEI; card {CARD}")
    enc, encode = flat_encoder(kind, w, h, "cuda")
    log, restore = _flat_instrument(enc)
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    try:
        stream, recons = encode(frames)
    finally:
        restore()
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on the card")
    want = 0
    for e in log:
        nbytes = sum(len(n) for n in e["nals"] if n)
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            blocks = f"{(w // 16) * (h // 16)} intra (IDR)"
            check(e["launches"] == 0 and e["rdoq"] == 0,
                  f"POC 0: {e['launches']} SAD and {e['rdoq']} RDOQ "
                  "launches in the IDR (want 0 and 0)")
        else:
            cnt = dict(intra=0, skip=0, merge=0, amvp=0, bi=0)
            for row in e["info"]:
                for b in row:
                    cnt["intra" if b.pred_mode == 1 else "skip" if b.skip
                        else "merge" if b.merge else "amvp"] += 1
                    cnt["bi"] += int(b.pred_mode == 0 and b.inter_dir == 3)
            blocks = " / ".join(f"{k_} {v}" for k_, v in cnt.items())
            want += 3 * e["lists"]
            check(e["launches"] == 3 * e["lists"],
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches "
                  f"(want 3 per list, {e['lists']} lists)")
            check(e["rdoq"] == 3,
                  f"POC {e['poc']}: {e['rdoq']} RDOQ-kernel launches (want "
                  "3: TU16 luma, TU8 Cb, TU8 Cr)")
        other = e["total"] - e["device"] - e["host"]
        print(f"[{tag}] POC {e['poc']} ({e['kind']}): device phase "
              f"{e['device'] * 1e3:.1f} ms, host phase "
              f"{e['host'] * 1e3:.1f} ms, other {other * 1e3:.1f} ms; "
              f"{nbytes} bytes, Y-PSNR {p:.2f} dB; blocks {blocks}; "
              f"SAD-kernel launches {e['launches']}, RDOQ-kernel launches "
              f"{e['rdoq']}")
    n_inter = len(frames) - 1
    check(launches == want == (45 if kind == "ra" else 18),
          f"{launches} SAD-kernel launches in the run, want {want}")
    check(rdoq_launches == 3 * n_inter,
          f"{rdoq_launches} RDOQ-kernel launches, want {3 * n_inter}")
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    sha = hashlib.sha1(stream).hexdigest()
    y_psnr = np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)])
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, mean "
          f"Y-PSNR {y_psnr:.3f} dB, encode {t_enc:.2f} s "
          f"({len(frames) / t_enc:.3f} fps); SAD-kernel launches {launches},"
          f" RDOQ-kernel launches {rdoq_launches} (the plain version 0 "
          f"times); SHA-1 {sha}")
    ref_bytes, ref_sha = ((FLAT_RA_BYTES, FLAT_RA_SHA1) if kind == "ra"
                          else (HIERB_BYTES, HIERB_SHA1))
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"{tag} stream {len(stream)} bytes SHA-1 {sha}, the JAX "
          f"package's is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's, byte for byte "
          "(SHA-1)")
    t0 = time.perf_counter()
    dec = hevc_decoder.GeneralDecoder()
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    print(f"[{tag}] the port's GeneralDecoder: hash SEI OK on all "
          f"{len(frames)} pictures, pictures equal the encoder's, "
          f"{t_dec:.2f} s")
    return launches, rdoq_launches


def phase_flat_ra_cuda_vs_cpu() -> None:
    """Phase 10 (flat-ra-cuda-vs-cpu): the flat RA GOP-8 at 96x64 over 9
    pictures on the card and on the CPU: byte-equal streams, the card's
    through the RDOQ kernel, the CPU's through its plain version."""
    w, h, n = 96, 64, 9
    frames = synth_clip(w, h, n, seed=17)
    res, routes = {}, {}
    for dev in ("cuda", "cpu"):
        enc, encode = flat_encoder("ra", w, h, dev)
        t0 = time.perf_counter()
        stream, *routes[dev] = rdoq_routes(lambda: encode(frames)[0])
        res[dev] = (stream, time.perf_counter() - t0)
    (g, tg), (c, tc) = res["cuda"], res["cpu"]
    routed = check_rdoq_routes("flat RA 96x64", routes["cuda"],
                               routes["cpu"])
    check(g == c, f"flat RA 96x64: card and CPU streams differ ({len(g)} "
                  f"/ {len(c)} bytes)")
    dec = hevc_decoder.GeneralDecoder()
    dec.decode(g)
    check(dec.hash_status == [True] * n, "flat RA 96x64: hash mismatch")
    print(f"[flat-ra-cuda-vs-cpu] 96x64, 9 pictures: streams byte-equal "
          f"({len(g)} bytes), hash OK; {routed}; cuda {tg:.2f} s, cpu "
          f"{tc:.2f} s")


def main() -> None:
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    build_kernels()
    count_rdoq_ref()
    phase_kernel()
    phase_encode_720p()
    phase_cuda_vs_cpu()
    rq = phase_rdoq_kernel()
    phase_hevc_intra()
    k = phase_ra_kernel()
    ra_launches, _, ra_rdoq = phase_hevc_ra()
    phase_ra_cuda_vs_cpu()
    sk = phase_sao_kernel()
    ra_sao_sad, sao_launches, ra_sao_rdoq = phase_hevc_ra(sao=True)
    phase_ldp_kernel()
    ldp_launches, _, ldp_rdoq = phase_hevc_ldp()
    phase_ldp_cuda_vs_cpu()
    r64 = phase_sad_r64()
    ldp_tz, _, ldp_tz_rdoq = phase_hevc_ldp(me_method="tz")
    ra_tz, _, ra_tz_rdoq = phase_hevc_ra(me_method="tz")
    ldp_rc, rc_log, ldp_rc_rdoq = phase_hevc_ldp(rc=True)
    rc_resumed, resumed_rdoq = phase_ldp_rc_resume(rc_log)
    flat_ra, flat_ra_rdoq = phase_hevc_flat("ra")
    hierb, hierb_rdoq = phase_hevc_flat("hierb")
    phase_flat_ra_cuda_vs_cpu()
    jax_mods = [m for m in sys.modules
                if m.split(".")[0] in ("video_codecs_tpu", "jax")]
    check(not jax_mods, f"the JAX package was imported: {jax_mods[:5]}")
    print("[imports] nothing of video_codecs_tpu or jax was imported")

    launches = (ra_launches + ra_sao_sad + ldp_launches + ldp_tz + ra_tz +
                ldp_rc + rc_resumed + flat_ra + hierb)
    print(f"[kernels] sad_surface launches: RA GOP {ra_launches}, RA GOP "
          f"with SAO {ra_sao_sad}, LD-P run {ldp_launches}, LD-P TZ run "
          f"{ldp_tz}, RA TZ GOP {ra_tz}, LD-P rate-controlled run {ldp_rc} "
          f"and its resumed run {rc_resumed}, flat RA GOP {flat_ra}, flat "
          f"hierarchical-B run {hierb}, together {launches}; its "
          "times and bound below are the RA pyramid path's per B picture "
          "(the search range 64 surfaces' on the next line). sao_stats "
          f"launches: RA GOP with SAO {sao_launches}; its times and bound "
          "are per 1080p picture (3 planes)")
    rdoq_launches = (ra_rdoq + ra_sao_rdoq + ldp_rdoq + ldp_tz_rdoq +
                     ra_tz_rdoq + ldp_rc_rdoq + resumed_rdoq + flat_ra_rdoq +
                     hierb_rdoq)
    r = rq[0]
    print(f"[kernels] rdoq_dev launches: RA GOP {ra_rdoq}, RA GOP with SAO "
          f"{ra_sao_rdoq}, LD-P run {ldp_rdoq}, LD-P TZ run {ldp_tz_rdoq}, "
          f"RA TZ GOP {ra_tz_rdoq}, LD-P rate-controlled run {ldp_rc_rdoq} "
          f"and its resumed run {resumed_rdoq}, flat RA GOP {flat_ra_rdoq}, "
          f"flat hierarchical-B run {hierb_rdoq}, together {rdoq_launches}; "
          f"the plain version ran 0 times in them; its times and bound are "
          f"the {r['what']} call's (B={r['b']}; every shape on the next "
          "line)")
    print(json.dumps({"sad_surface_r64": r64}))
    print(json.dumps({"rdoq_dev_shapes": rq}))
    print(f"[time] {time.perf_counter() - t_start:.1f} s from the start, "
          "the kernels' build included")

    print(json.dumps({"kernels": [{
        "name": "sad_surface", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "ms_note": k.get("note")}, {
        "name": "sao_stats", "route": "cuda", "source": SAO_SRC,
        "replaces": SAO_REPLACES, "launches": sao_launches,
        "max_abs_err": sk["max_abs_err"], "ms": sk["ms"],
        "plain_ms": sk["plain_ms"], "bound_ms": sk["bound_ms"],
        "bound_by": sk["bound_by"], "library_ms": sk["library_ms"],
        "ms_note": sk.get("note")}, {
        "name": "rdoq_dev", "route": "cuda", "source": RDOQ_SRC,
        "replaces": RDOQ_REPLACES, "launches": rdoq_launches,
        "max_abs_err": max(x["max_abs_err"] for x in rq), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "ms_note": r["note"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
