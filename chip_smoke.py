#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's H.264 device P-slice engine end to end at 1280x720
through the hand-written CUDA SAD-surface kernel, in phases:

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the kernel from video_codecs_tpu_torch/csrc/sad_surface.cu;
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
  6. hevc-intra: encode 2 pictures of a seeded 1920x1072 clip through the
     port's HEVC all-intra CTB32 quadtree (`QuadtreeFastEncoder` on the
     card: QP 32, RDOQ-lite, sign-data hiding, deblocking, MD5 picture
     hash SEI; the IDR settings of the repo's 1080p headline), timing
     the device phase and the host phase (native CABAC + hash) of each
     picture; decode the stream with the port's QuadtreeIntraDecoder,
     require every picture hash to match and the pictures to equal the
     encoder's; encode one 416x240 picture on the card and on the CPU and
     require equal state dicts and equal NAL bytes.  This path has no
     hand-written kernel (the reference has no Pallas kernel on it): the
     phase checks that the SAD kernel's launch count does not move;
  7. require that nothing of the JAX package was imported.

Any failed check exits non-zero.  The last line is the result JSON; the
line before it lists the kernels.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as hevc_bs
from video_codecs_tpu_torch.models.h264 import inter_dev
from video_codecs_tpu_torch.models.h264.inter_codec import H264Decoder
from video_codecs_tpu_torch.models.hevc import headers as hevc_headers
from video_codecs_tpu_torch.models.hevc import quadtree_codec
from video_codecs_tpu_torch.ops import sad_surface as ss

KERNEL_SRC = "video_codecs_tpu_torch/csrc/sad_surface.cu"
REPLACES = "video_codecs_tpu/ops/pallas_sad.py:32"
W, H, QP, SR = 1280, 720, 28, 16
# HEVC all-intra quadtree: the 1080p headline's picture size and QP.
HEVC_W, HEVC_H, HEVC_QP = 1920, 1072, 32
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and
# operations/s on 8-bit integers, the type of the SAD kernel's inputs.
PEAK_BYTES, PEAK_OPS = 3.35e12, 1979e12


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


def phase_kernel() -> dict:
    """Phases 2-3: build, then kernel vs plain (and the yardstick) at the
    slice's shapes."""
    t0 = time.perf_counter()
    so, build_s, log = ss.build()
    ss._load()
    print(f"[build] {so.name}: nvcc {build_s:.2f} s (0 = cached), "
          f"build and load {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

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
        ms = cuda_ms(lambda: ss.sad_surface(cur, win, n, r))
        plain = cuda_ms(lambda: ss.sad_surface_ref(cur, win, n, r), reps=3,
                        warm=1)
        lib = cuda_ms(lambda: sad_cdist(cur, win, n, r), reps=3, warm=1)
        bound, nbytes, ops = sad_bound(n, b, r)
        gdiff = ops / 2e9
        print(f"[sad] n={n} B={b} r={r}: equal; kernel {ms:.3f} ms "
              f"({gdiff:.2f} G abs-diffs, {gdiff / ms * 1e3:.0f} G/s), "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} G ops), {bound / ms:.1%} of it; plain "
              f"{plain:.3f} ms ({bound / plain:.2%}); torch.cdist "
              f"{lib:.3f} ms ({bound / lib:.2%}, max abs err {lib_err:g})")
        if r == SR:
            pic["ms"] += ms
            pic["plain_ms"] += plain
            pic["library_ms"] += lib
            pic["bytes"] += nbytes
            pic["ops"] += ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[sad] per 720p P picture at SR{SR} (n=16 + n=8): kernel "
          f"{pic['ms']:.3f} ms, bound {pic['bound_ms']:.4f} ms "
          f"({pic['bound_by']}), {pic['bound_ms'] / pic['ms']:.1%} of it; "
          f"plain {pic['plain_ms']:.3f} ms; torch.cdist "
          f"{pic['library_ms']:.3f} ms")
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


def phase_hevc_intra() -> None:
    """Phase 6: the HEVC all-intra quadtree end to end on the card."""
    w, h = HEVC_W, HEVC_H
    # the 35-mode prediction is a float32 matmul that is exact only
    # without TF32 (the package turns it off at import)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    frames = synth_clip(w, h, 2, seed=5)
    enc = quadtree_codec.QuadtreeFastEncoder(hevc_cfg(w, h), device="cuda")
    sad_before = ss.sad_surface.launches
    nals = enc.stream_headers()
    recons = []
    for i, (y, u, v) in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = {k: a.cpu() for k, a in enc._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        frame_nals, rec = enc.serialize_frame(st)
        t2 = time.perf_counter()
        nals.extend(frame_nals)
        recons.append(rec)
        nbytes = sum(len(n) for n in frame_nals if n)
        d8 = st["depth8"].numpy()[:h // 8, :w // 8]
        cus = [int((d8 == d).sum()) // (16 >> (2 * d)) for d in (0, 1, 2)]
        p = psnr(y, rec[0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        print(f"[hevc-intra] picture {i}: device phase "
              f"{(t1 - t0) * 1e3:.1f} ms (dispatch + copy back), host phase "
              f"{(t2 - t1) * 1e3:.1f} ms (native CABAC + hash SEI); "
              f"{nbytes} bytes, {nbytes * 8 * 30 / 1000:.1f} kbps at 30 fps, "
              f"Y-PSNR {p:.2f} dB; CUs 32/16/8: {cus[0]}/{cus[1]}/{cus[2]}")
    stream = hevc_bs.annexb(nals)
    check(ss.sad_surface.launches == sad_before,
          "the HEVC intra phase launched the SAD kernel")
    print(f"[hevc-intra] this phase runs no hand-written kernel: the SAD "
          f"kernel's launch count stayed at {sad_before}")

    t0 = time.perf_counter()
    dec = quadtree_codec.QuadtreeIntraDecoder()
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    print(f"[hevc-intra] {w}x{h} QP{HEVC_QP}: {len(stream)} bytes for "
          f"{len(frames)} pictures; the port's QuadtreeIntraDecoder: hash "
          f"SEI OK on every picture, pictures equal the encoder's, "
          f"{t_dec:.2f} s")

    sw, sh = 416, 240                    # the repo's bench_intra_qt size
    y, u, v = synth_clip(sw, sh, 1, seed=9)[0]
    res = {}
    for dev in ("cuda", "cpu"):
        e = quadtree_codec.QuadtreeFastEncoder(hevc_cfg(sw, sh), device=dev)
        t0 = time.perf_counter()
        st = {k: a.cpu().numpy() for k, a in e._dispatch(y, u, v).items()}
        res[dev] = (st, e.serialize_frame(st)[0],
                    time.perf_counter() - t0)
    (g, gn, tg), (c, cn, tc) = res["cuda"], res["cpu"]
    diff = {k: int((g[k] != c[k]).sum()) for k in g
            if not np.array_equal(g[k], c[k])}
    check(not diff, f"cuda != cpu at {sw}x{sh}: elements differing per "
                    f"key {diff}")
    check(gn == cn, f"cuda and cpu NAL bytes differ at {sw}x{sh}")
    print(f"[hevc-intra] {sw}x{sh} picture on the card and on the CPU: all "
          f"{len(g)} state keys equal, NAL bytes equal "
          f"({sum(len(n) for n in gn if n)} bytes); cuda {tg:.2f} s, "
          f"cpu {tc:.2f} s")


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device: this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    k = phase_kernel()
    launches = phase_encode_720p()
    phase_cuda_vs_cpu()
    phase_hevc_intra()
    jax_mods = [m for m in sys.modules
                if m.split(".")[0] in ("video_codecs_tpu", "jax")]
    check(not jax_mods, f"the JAX package was imported: {jax_mods[:5]}")
    print("[imports] nothing of video_codecs_tpu or jax was imported")

    print(json.dumps({"kernels": [{
        "name": "sad_surface", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
