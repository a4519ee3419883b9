"""Bytes and SHA-1 of the JAX package's streams that chip_smoke.py holds
the port's to, computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_sha1.py [--ra] [--ra-sao] \
        [--ldp-tz] [--ra-tz] [--ldp-rc] [--flat-ra] [--hierb] \
        [--ldp-sao] [--ldp-conf] [--ldp-host] [--ldp-wp] [--ldp-dqp] \
        [--cli-ra] [--jm-main] [--jm-baseline] [--h264-high] [--h264-b] \
        [--h264-ltr] [--h264-wp] [--h264-perc] [--h264-loss] \
        [--tiles] [--wpp] [--cli-ai-tiles] [--qt-host] [--no-ldp]

LD-P: bench.py's `bench_ldp_480` (bench.py:171-186) on bench.py's clip,
`inter_jax.DeviceLowDelayEncoder(cfg, search_range=64)` with the config's
default MD5 hash SEI, twice: as the JAX package writes it, and with its
AMVP predictor derivation `motion.amvp_candidates` replaced in memory by
the spec's (the port's repaired copy; no file of the JAX package is
edited).  Each stream is decoded by the JAX package's GeneralDecoder and
its picture-hash results printed.  --ra adds the HEVC RA GOP-8 of
chip_smoke.py's phase 7 (1920x1072, its clip and settings), which takes
about five minutes; --ra-sao the same GOP with SAO on (`cfg.sao=True`,
HM's RA main tool set), chip_smoke.py's `[hevc-ra-sao]` phase; --no-ldp
skips the LD-P streams.  HM's motion search and rate control
(chip_smoke.py's `[hevc-ldp-tz]`, `[hevc-ra-tz]` and `[hevc-ldp-rc]`):
--ldp-tz is the LD-P pair with `me_method="tz"` (HM's FastSearch 1 at
SearchRange 64), --ra-tz the RA GOP with `me_method="tz"`, and --ldp-rc
the LD-P pair with the pyramid search and a `RateLambdaControl` at
2 Mb/s (each picture's QP printed), then, with the spec AMVP list, the
same controller's run resumed from a checkpoint: pictures 0-4 encoded,
the state written with `checkpoint.save` and read back with
`checkpoint.load`, pictures 5-8 encoded from it by a new encoder and a
new controller; the SHA-1 of the resumed pictures' NALs (Annex B) is
printed.  The flat CTB16 B engines (chip_smoke.py's `[hevc-flat-ra]`
and `[hevc-hierb]`, scripts/diag_ra_gap.py's settings: QP 32, SBH,
SR64 pyramid ME, one merge candidate, no TMVP, MD5 hash SEI):
--flat-ra is `inter_jax.DeviceRandomAccessEncoder` over phase 7's 9
pictures (GOP-8, reorder_pics 3), --hierb `DeviceHierarchicalBEncoder`
over their first 5 (I0 P2 B1 P4 B3, reorder_pics 1); each stream is
also decoded by the port's GeneralDecoder (spec merge and AMVP).  HM's
LD-P main tool set and a conferencing sender's stream (chip_smoke.py's
`[hevc-ldp-sao]` and `[hevc-ldp-conf]`, spec AMVP list only): --ldp-sao
is the LD-P stream with `cfg.sao=True` (the JAX package codes its IDR on
the host CTB loop and decides SAO per CTB on the host: about 15-20
minutes on a CPU), --ldp-conf the LD-P stream with `timing_sei`,
`long_term_idr` and no TMVP (buffering-period / picture-timing SEI, every
P picture predicted from the IDR as a long-term reference).  The
reference's host low-delay P coder (`inter_codec.LowDelayEncoder`, what
its encoder CLI builds for HM's encoder_lowdelay_P_main.cfg; chip_smoke.py's
`host_ldp_cfg`: QP 32, SBH, SAO, full RDOQ, merge 5, TMVP, 4 references,
TZSearch at search range 64, on bench_synth_clip(832, 480, n, seed=42)):
--ldp-host is its 9-picture stream (chip_smoke.py's `[hevc-ldp-host]`,
about an hour on a CPU for the two streams: the host P loop and the host
SAO decision take minutes a picture), --ldp-wp 5 pictures of the faded
clip (`chip_smoke.fade_clip`) with weighted prediction, one reference and
SAO off (`[hevc-ldp-wp]`), --ldp-dqp 5 pictures with cu_qp_delta, a
`CtuRateControl` and a `RateLambdaControl` at 2 Mb/s, SAO off
(`[hevc-ldp-dqp]`).  Each is encoded twice, as written and with the spec
AMVP list, and each stream decoded by the JAX package's
`LowDelayDecoder` and `GeneralDecoder` and by the port's.  --cli-ra runs
the JAX package's encoder CLI (`tools/encoder_app.main`) on HM's
encoder_randomaccess_main.cfg and a per-sequence cfg as chip_smoke.py's
`[cli-ra]` writes them (`chip_smoke.hm_cli_files`: 832x480, 9 pictures of
bench_synth_clip(832, 480, 9, seed=42)), which builds the reference's
host random-access B coder (`ra_codec.RandomAccessEncoder`, TZSearch at
search range 64, SAO switched off with a warning, the IDR with the full
RDOQ), and decodes the stream with the JAX package's
`RandomAccessDecoder` and `GeneralDecoder`, the port's, and both
packages' decoder CLIs (the JAX one routes random-access streams to
`LowDelayDecoder`; ROADMAP queue 3, reference fault 10).  --jm-main and
--jm-baseline run the JAX package's JM encoder CLI
(`tools/jm_encoder_app.main`) on the JM-style cfg and YUV file that
chip_smoke.py's `[jm-main]` / `[jm-baseline]` write
(`chip_smoke.jm_cli_files`: 176x144, 5 pictures of
bench_synth_clip(176, 144, 5, seed=42), QP 28, search range 16; Main:
CABAC, EPZS, 3 references, trellis; baseline: CAVLC, full search, 1
reference, adaptive rounding) and decode the stream with both packages'
H264Decoder.  --h264-high and --h264-b run the JAX package's host H.264
coder as chip_smoke.py's `[h264-high]` / `[h264-b]` do (176x144, QP 28,
search range 16: `H264Encoder` with the 8x8 transform, CABAC, EPZS, 3
references and trellis over 5 pictures; `H264BEncoder` with 2 B pictures
between anchors, CABAC and b_qp_offset 2 over 7) and decode the stream
with both packages' decoders.  --h264-ltr, --h264-wp, --h264-perc and
--h264-loss run it on chip_smoke.py's phase 16 (`H264_CONF_KW` on
`h264_conf_clip`, 176x144): long-term references with MMCO 4+6 and list
reordering over 9 pictures, weighted prediction at [jm-main]'s settings
on 5 faded pictures, perceptual RDO over 5, and intra refresh over 12,
whose stream --h264-loss then sends through `chip_smoke.h264_lossy` (the
JAX package's SEI and RTP modules) and decodes with both concealment
modes, printing the `concealed` lists and the pictures' SHA-1.
--tiles, --wpp, --cli-ai-tiles and --qt-host give the SHA-1s of
chip_smoke.py's `[hevc-tiles]` (`parallel.tiles.encode_sequence_tiles`
with its 4 tile columns on 4 forced host devices), `[hevc-wpp]` (the
device encoder `encode_frame_jit` then the WPP slice writer, which
tests/test_encoder_jax.py:9 holds to the host loop at rdoq off),
`[cli-ai-tiles]` (the JAX encoder CLI on HM's all-intra structure with
2 tile columns) and `[hevc-qt-host]` (`QuadtreeIntraEncoder`), each
decoded by the JAX package's GeneralDecoder; the first three with the
port's repaired tile / WPP slice writers swapped in (entry points in
EBSP bytes, `repair_entry_points`).  This is
a tool for the reference side: it
imports the JAX package, the port's `motion` module for the repaired
function and the port's decoders for a second opinion.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import contextlib
import io
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--tiles" in sys.argv:
    # parallel.tiles shards the tile columns over one host device each,
    # which XLA creates only when asked before JAX's first use
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        " --xla_force_host_platform_device_count=4").strip()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from video_codecs_tpu.entropy import bitstream  # noqa: E402
from video_codecs_tpu.models.hevc import checkpoint  # noqa: E402
from video_codecs_tpu.models.hevc import decoder, headers  # noqa: E402
from video_codecs_tpu.models.hevc import inter_codec  # noqa: E402
from video_codecs_tpu.models.hevc import inter_jax, inter_qt  # noqa: E402
from video_codecs_tpu.models.hevc import motion, ratectrl  # noqa: E402
from video_codecs_tpu_torch.models.hevc import decoder as tdecoder  # noqa: E402
from video_codecs_tpu_torch.models.hevc import motion as tmotion  # noqa: E402

AMVP_AS_WRITTEN = motion.amvp_candidates


def report(what: str, stream: bytes, n: int, t: float) -> None:
    dec = decoder.GeneralDecoder()
    dec.decode(stream)
    print(f"{what}: {len(stream)} bytes, SHA-1 "
          f"{hashlib.sha1(stream).hexdigest()}, encode {t:.1f} s, JAX "
          f"GeneralDecoder hash OK {sum(dec.hash_status)} of {n}: "
          f"{dec.hash_status}", flush=True)


def ldp_cfg():
    return headers.HevcConfig(width=832, height=480, qp=32, num_refs=4,
                              merge_cands=5, temporal_mvp=True,
                              sign_data_hiding=True)


def rate_control():
    """chip_smoke.py's `[hevc-ldp-rc]` controller: 2 Mb/s at 30 fps."""
    return ratectrl.RateLambdaControl(chip_smoke.RC_BPS, 30.0, 832, 480,
                                      base_qp=32)


def ldp_spec(tag: str, **cfg_kw) -> None:
    """bench_ldp_480 with `cfg_kw` set on its configuration, the spec
    AMVP list only."""
    frames = bench.synth_clip(832, 480, 9)
    motion.amvp_candidates = tmotion.amvp_candidates
    cfg = ldp_cfg()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    enc = inter_jax.DeviceLowDelayEncoder(cfg, search_range=64)
    t0 = time.time()
    stream, _ = enc.encode_sequence_ldp(frames)
    report(f"{tag} spec AMVP", stream, len(frames), time.time() - t0)
    dec = tdecoder.GeneralDecoder()
    dec.decode(stream)
    print(f"{tag} spec AMVP: the port's GeneralDecoder hash OK "
          f"{sum(dec.hash_status)} of {len(frames)}", flush=True)
    motion.amvp_candidates = AMVP_AS_WRITTEN


def ldp(me_method: str = "pyr", rc: bool = False) -> None:
    frames = bench.synth_clip(832, 480, 9)
    tag = "ldp" + ("" if me_method == "pyr" else f" {me_method}") + \
        (" rc" if rc else "")
    for what, amvp in ((f"{tag} as written", AMVP_AS_WRITTEN),
                       (f"{tag} spec AMVP", tmotion.amvp_candidates)):
        motion.amvp_candidates = amvp
        enc = inter_jax.DeviceLowDelayEncoder(ldp_cfg(), search_range=64,
                                              me_method=me_method)
        t0 = time.time()
        stream, _ = enc.encode_sequence_ldp(
            frames, rate_control() if rc else None)
        report(what, stream, len(frames), time.time() - t0)
        print(f"{what}: QPs {enc.frame_qps}", flush=True)
    motion.amvp_candidates = AMVP_AS_WRITTEN


def ldp_rc_resumed() -> None:
    """Pictures 0-4, a checkpoint through save/load, pictures 5-8 from
    it (spec AMVP list)."""
    frames = bench.synth_clip(832, 480, 9)
    motion.amvp_candidates = tmotion.amvp_candidates
    t0 = time.time()
    enc = inter_jax.DeviceLowDelayEncoder(ldp_cfg(), search_range=64)
    _, _, state = enc.encode_frames(frames[:5], None, rate_control())
    buf = io.BytesIO()
    checkpoint.save(state, buf)
    buf.seek(0)
    enc = inter_jax.DeviceLowDelayEncoder(ldp_cfg(), search_range=64)
    nals, _, _ = enc.encode_frames(frames[5:], checkpoint.load(buf),
                                   rate_control())
    resumed = bitstream.annexb(nals)
    print(f"ldp rc resumed at POC 5 spec AMVP: {len(resumed)} bytes, "
          f"SHA-1 {hashlib.sha1(resumed).hexdigest()}, QPs "
          f"{enc.frame_qps}, {time.time() - t0:.1f} s", flush=True)
    motion.amvp_candidates = AMVP_AS_WRITTEN


def ra(sao: bool = False, me_method: str = "pyr") -> None:
    w, h = chip_smoke.HEVC_W, chip_smoke.HEVC_H
    frames = chip_smoke.synth_clip(w, h, chip_smoke.RA_PICTURES, seed=5)
    cfg = headers.HevcConfig(
        width=w, height=h, qp=chip_smoke.HEVC_QP, log2_ctb=5,
        log2_min_cb=3, log2_max_tb=5, reorder_pics=3, sign_data_hiding=True,
        rdoq="lite", merge_cands=5, hash_sei=True, temporal_mvp=True,
        sao=sao)
    enc = inter_qt.QtDeviceRandomAccessEncoder(
        cfg, search_range=chip_smoke.RA_SR, me_method=me_method, cu8=False,
        num_refs_active=1)
    t0 = time.time()
    stream, _ = enc.encode_sequence_ra(frames)
    report("ra 1080p" + (" sao" if sao else "") +
           ("" if me_method == "pyr" else f" {me_method}"), stream,
           len(frames), time.time() - t0)


def flat(kind: str) -> None:
    """The flat CTB16 RA GOP-8 ("ra") or hierarchical-B ("hierb") run of
    chip_smoke.py, decoded by both packages' GeneralDecoders."""
    w, h = chip_smoke.HEVC_W, chip_smoke.HEVC_H
    frames = chip_smoke.synth_clip(w, h, chip_smoke.RA_PICTURES, seed=5)
    cfg = headers.HevcConfig(width=w, height=h, qp=chip_smoke.HEVC_QP,
                             reorder_pics=3 if kind == "ra" else 1,
                             sign_data_hiding=True)
    t0 = time.time()
    if kind == "ra":
        enc = inter_jax.DeviceRandomAccessEncoder(
            cfg, search_range=chip_smoke.RA_SR)
        stream, _ = enc.encode_sequence_ra(frames)
    else:
        frames = frames[:chip_smoke.HIERB_PICTURES]
        enc = inter_jax.DeviceHierarchicalBEncoder(
            cfg, search_range=chip_smoke.RA_SR)
        stream, _ = enc.encode_sequence_rab(frames)
    what = "flat ra 1080p" if kind == "ra" else "hierb 1080p"
    report(what, stream, len(frames), time.time() - t0)
    dec = tdecoder.GeneralDecoder()
    dec.decode(stream)
    print(f"{what}: the port's GeneralDecoder hash OK "
          f"{sum(dec.hash_status)} of {len(frames)}: {dec.hash_status}",
          flush=True)


def host(kind: str) -> None:
    """The reference's host LD-P coder on chip_smoke.py's `host_ldp_cfg`
    (`kind` "" / "wp" / "dqp"), as written and with the spec AMVP list;
    bytes, SHA-1, QPs and every decoder's hash results."""
    from video_codecs_tpu_torch.models.hevc import inter_codec as tpc
    n = {"": chip_smoke.HOST_PICTURES, "wp": chip_smoke.WP_PICTURES,
         "dqp": chip_smoke.DQP_PICTURES}[kind]
    frames = chip_smoke.bench_synth_clip(832, 480, n)
    if kind == "wp":
        frames = chip_smoke.fade_clip(frames)
    tag = "ldp host" + (f" {kind}" if kind else "")
    for what, amvp in ((f"{tag} as written", AMVP_AS_WRITTEN),
                       (f"{tag} spec AMVP", tmotion.amvp_candidates)):
        motion.amvp_candidates = amvp
        cfg = headers.HevcConfig(**dataclasses.asdict(
            chip_smoke.host_ldp_cfg(kind)))
        enc = inter_codec.LowDelayEncoder(cfg, search_range=chip_smoke.
                                          HOST_SR,
                                          me_method=chip_smoke.HOST_ME)
        rc = None
        if kind == "dqp":
            enc.ctu_rc = ratectrl.CtuRateControl()
            rc = rate_control()
        t0 = time.time()
        stream, _ = enc.encode_sequence_ldp(frames, rc)
        report(what, stream, n, time.time() - t0)
        print(f"{what}: QPs {enc.frame_qps}", flush=True)
        for label, dec in (
                ("JAX LowDelayDecoder", inter_codec.LowDelayDecoder()),
                ("the port's GeneralDecoder", tdecoder.GeneralDecoder()),
                ("the port's LowDelayDecoder", tpc.LowDelayDecoder())):
            dec.decode(stream)
            print(f"{what}: {label} hash OK {sum(dec.hash_status)} of "
                  f"{n}: {dec.hash_status}", flush=True)
    motion.amvp_candidates = AMVP_AS_WRITTEN


def _app_oks(main, argv) -> tuple[int, int]:
    """(pictures with "(OK)", pictures decoded) that a decoder CLI's
    `main(argv)` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    text = buf.getvalue()
    return text.count("(OK)"), int(text.split(" pictures decoded")[0]
                                   .split()[-1])


def cli_ra() -> None:
    """The JAX package's encoder CLI on chip_smoke.py's `[cli-ra]` files;
    bytes, SHA-1, its SUMMARY lines and every decoder's hash results."""
    from video_codecs_tpu.models.hevc import ra_codec
    from video_codecs_tpu.tools import decoder_app, encoder_app
    from video_codecs_tpu_torch.models.hevc import ra_codec as tra
    from video_codecs_tpu_torch.tools import decoder_app as tdecoder_app
    n, w, h = chip_smoke.CLI_RA_PICTURES, chip_smoke.CLI_W, chip_smoke.CLI_H
    frames = chip_smoke.bench_synth_clip(w, h, n)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        argv = chip_smoke.hm_cli_files(d, "ra", frames, w, h)
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            encoder_app.main(argv)
        t = time.time() - t0
        stream = (d / "out.bin").read_bytes()
        print(f"cli ra: {len(stream)} bytes, SHA-1 "
              f"{hashlib.sha1(stream).hexdigest()}, encoder_app.main "
              f"{t:.1f} s; its summary:\n{buf.getvalue()}", flush=True)
        for label, dec in (
                ("JAX RandomAccessDecoder", ra_codec.RandomAccessDecoder()),
                ("JAX GeneralDecoder", decoder.GeneralDecoder()),
                ("the port's RandomAccessDecoder", tra.RandomAccessDecoder()),
                ("the port's GeneralDecoder", tdecoder.GeneralDecoder())):
            dec.decode(stream)
            print(f"cli ra: {label} hash OK {sum(dec.hash_status)} of "
                  f"{n}: {dec.hash_status}", flush=True)
        for label, app in (("JAX decoder_app", decoder_app.main),
                           ("the port's decoder_app", tdecoder_app.main)):
            ok, got = _app_oks(app, ["-b", str(d / "out.bin")])
            print(f"cli ra: {label} (OK) {ok} of {n}, {got} pictures "
                  "decoded", flush=True)


def jm(kind: str) -> None:
    """The JAX package's JM encoder CLI on chip_smoke.py's `[jm-<kind>]`
    files (`chip_smoke.jm_cli_files`); bytes, SHA-1, its summary lines
    and whether both packages' H.264 decoders give the recon file's
    pictures."""
    from video_codecs_tpu.models.h264 import inter_codec as h264
    from video_codecs_tpu.tools import jm_encoder_app
    from video_codecs_tpu.utils import yuv
    from video_codecs_tpu_torch.models.h264 import inter_codec as th264
    w, h, n = chip_smoke.JM_W, chip_smoke.JM_H, chip_smoke.JM_PICTURES
    frames = chip_smoke.bench_synth_clip(w, h, n)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        argv = chip_smoke.jm_cli_files(d, kind, frames)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            jm_encoder_app.main(argv)
        t = time.time() - t0
        stream = (d / "out.264").read_bytes()
        print(f"jm {kind}: {len(stream)} bytes, SHA-1 "
              f"{hashlib.sha1(stream).hexdigest()}, jm_encoder_app.main "
              f"{t:.1f} s; its summary:\n{out.getvalue()}its warnings:\n"
              f"{err.getvalue()}", flush=True)
        ry, ru, rv = yuv.read_frames(str(d / "rec.yuv"), w, h)
        for label, dec in (("JAX H264Decoder", h264.H264Decoder()),
                           ("the port's H264Decoder", th264.H264Decoder())):
            got = dec.decode(stream)
            same = len(got) == n and all(
                (g[c].astype("uint8") == p[i]).all()
                for i, g in enumerate(got)
                for c, p in enumerate((ry, ru, rv)))
            print(f"jm {kind}: {label} {len(got)} pictures, equal to the "
                  f"recon file: {same}", flush=True)


def h264_high_b(kind: str) -> None:
    """The JAX package's host H.264 coder on chip_smoke.py's `[h264-high]`
    (`H264Encoder(..., transform8x8=True)`, 5 pictures) or `[h264-b]`
    (`H264BEncoder`, 7 pictures) run: bench_synth_clip(176, 144, n,
    seed=42) at chip_smoke's H264_HIGH_KW / H264_B_KW; bytes, SHA-1, the
    MB statistics and whether both packages' decoders give the encoder's
    pictures."""
    from video_codecs_tpu.models.h264 import bslice_codec, inter_codec
    from video_codecs_tpu_torch.models.h264 import bslice_codec as tb
    from video_codecs_tpu_torch.models.h264 import inter_codec as ti
    w, h = chip_smoke.JM_W, chip_smoke.JM_H
    if kind == "high":
        n = chip_smoke.H264_HIGH_PICTURES
        enc = inter_codec.H264Encoder(w, h, **chip_smoke.H264_HIGH_KW)
        decs = (("JAX H264Decoder", inter_codec.H264Decoder()),
                ("the port's H264Decoder", ti.H264Decoder()))
    else:
        n = chip_smoke.H264_B_PICTURES
        enc = bslice_codec.H264BEncoder(w, h, **chip_smoke.H264_B_KW)
        decs = (("JAX H264BDecoder", bslice_codec.H264BDecoder()),
                ("the port's H264BDecoder", tb.H264BDecoder()))
    frames = chip_smoke.bench_synth_clip(w, h, n)
    t0 = time.time()
    stream, recons = enc.encode_sequence(frames)
    t = time.time() - t0
    stats = getattr(enc, "mb_type_stats", None)
    print(f"h264 {kind}: {len(stream)} bytes, SHA-1 "
          f"{hashlib.sha1(stream).hexdigest()}, encode {t:.1f} s"
          + (f", mb_type_stats {stats}" if stats else ""), flush=True)
    for label, dec in decs:
        got = dec.decode(stream)
        same = len(got) == n and all(
            (g[c] == r[c]).all() for g, r in zip(got, recons)
            for c in range(3))
        print(f"h264 {kind}: {label} {len(got)} pictures, equal to the "
              f"encoder's: {same}", flush=True)


def h264_conf(kind: str) -> None:
    """The JAX package's host H.264 coder on chip_smoke.py's phase 16 run
    `kind` ("ltr", "wp", "perc", "loss": chip_smoke's H264_CONF_KW on
    `h264_conf_clip`, 176x144): bytes, SHA-1, the list0 lengths of its P
    pictures (the SAD launches the port's card stage makes), and whether
    both packages' H264Decoders give the encoder's pictures.  For "loss"
    also the lossy stream `chip_smoke.h264_lossy` makes with the JAX
    package's SEI and RTP modules, and per concealment mode the JAX
    H264Decoder's `concealed` list and the SHA-1 of its pictures."""
    from video_codecs_tpu.models.h264 import inter_codec, sei
    from video_codecs_tpu.tools import rtp
    from video_codecs_tpu_torch.models.h264 import inter_codec as ti
    w, h = chip_smoke.JM_W, chip_smoke.JM_H
    frames = chip_smoke.h264_conf_clip(kind, w, h)
    enc = inter_codec.H264Encoder(w, h, **chip_smoke.H264_CONF_KW[kind])
    lists = []
    orig = enc._encode_p_frame

    def p_frame(y, u, v, refs, *a, **kw):
        lists.append(len(refs))
        return orig(y, u, v, refs, *a, **kw)

    enc._encode_p_frame = p_frame
    t0 = time.time()
    stream, recons = enc.encode_sequence(frames)
    t = time.time() - t0
    print(f"h264 {kind}: {len(stream)} bytes, SHA-1 "
          f"{hashlib.sha1(stream).hexdigest()}, encode {t:.1f} s; list0 "
          f"lengths {lists} (sum {sum(lists)})", flush=True)
    for label, dec in (("JAX H264Decoder", inter_codec.H264Decoder()),
                       ("the port's H264Decoder", ti.H264Decoder())):
        got = dec.decode(stream)
        same = len(got) == len(frames) and all(
            (g[c] == r[c]).all() for g, r in zip(got, recons)
            for c in range(3))
        print(f"h264 {kind}: {label} {len(got)} pictures, equal to the "
              f"encoder's: {same}", flush=True)
    if kind != "loss":
        return
    sent, lossy, n_sent, n_kept = chip_smoke.h264_lossy(stream, sei, rtp, h)
    print(f"h264 loss: sent {len(sent)} bytes SHA-1 "
          f"{hashlib.sha1(sent).hexdigest()} in {n_sent} packets; "
          f"received {n_kept} packets, {len(lossy)} bytes SHA-1 "
          f"{hashlib.sha1(lossy).hexdigest()}", flush=True)
    for mode in (1, 2):
        dec = inter_codec.H264Decoder(conceal=mode)
        got = dec.decode(lossy)
        print(f"h264 loss: JAX H264Decoder(conceal={mode}) {len(got)} "
              f"pictures, concealed {dec.concealed}, pictures SHA-1 "
              f"{chip_smoke.pictures_sha1(got)}", flush=True)


def intra_frames(frames_fn, enc, cfg) -> tuple[bytes, list]:
    """The JAX package's device CTB16 encoder (`encode_frame_jit`) for
    every picture, then `enc`'s Python slice writer (`_encode_slice`,
    which takes `_encode_slice_wpp` with WPP) and hash SEI, as
    `serialize_frame` assembles them: (Annex B stream, recons)."""
    import jax
    from video_codecs_tpu.models.hevc import encoder_jax
    from video_codecs_tpu.models.hevc import intra_codec as jic
    bw, bh = cfg.width // 16, cfg.height // 16
    nals, recons = enc.stream_headers(), []
    for (y, u, v) in frames_fn:
        st = jax.device_get(encoder_jax.encode_frame_jit(
            y, u, v, cfg.qp, bw, bh, deblock=not cfg.deblocking_disabled,
            sbh=cfg.sign_data_hiding, rdoq=bool(cfg.rdoq)))
        cbf, modes = st["cbf"], st["modes"].reshape(-1)
        ctus = [jic.CtuData(
            mode=int(modes[i]),
            levels_y=st["levels_y"][i] if cbf[0, i] else None,
            levels_cb=st["levels_cb"][i] if cbf[1, i] else None,
            levels_cr=st["levels_cr"][i] if cbf[2, i] else None)
            for i in range(bw * bh)]
        rec = (st["rec_y"], st["rec_u"], st["rec_v"])
        nals += [enc._encode_slice(ctus), enc._hash_sei(*rec)]
        recons.append(rec)
    return bitstream.annexb(nals), recons


def repair_entry_points() -> None:
    """Swap the port's repaired tile / WPP slice writers
    (`IntraEncoder._encode_slice` and `_encode_slice_wpp`, whose entry
    points count the substreams' bytes with their emulation prevention
    bytes) into the JAX package's IntraEncoder, in memory (reference
    fault 16: it counts RBSP bytes, and a spec decoder misplaces every
    substream after an emulation prevention byte)."""
    from video_codecs_tpu.models.hevc import intra_codec as jic
    from video_codecs_tpu_torch.models.hevc import intra_codec as tic
    jic.IntraEncoder._encode_slice = tic.IntraEncoder._encode_slice
    jic.IntraEncoder._encode_slice_wpp = tic.IntraEncoder._encode_slice_wpp


def intra_report(what: str, stream: bytes, recons, n: int, t: float) -> None:
    """Bytes and SHA-1 of an all-intra stream, and the JAX package's
    GeneralDecoder's hash results and whether its pictures are the
    encoder's (its IntraDecoder reads the entry points as RBSP sizes, as
    its writer signals them, so it is not asked)."""
    print(f"{what}: {len(stream)} bytes, SHA-1 "
          f"{hashlib.sha1(stream).hexdigest()}, encode {t:.1f} s",
          flush=True)
    t0 = time.time()
    dec = decoder.GeneralDecoder()
    out = dec.decode(stream)
    same = all(np.array_equal(np.asarray(o[c]), np.asarray(r[c]))
               for o, r in zip(out, recons) for c in range(3))
    print(f"{what}: JAX GeneralDecoder hash OK {sum(dec.hash_status)} of "
          f"{n} {dec.hash_status}, pictures the encoder's: {same}, "
          f"{time.time() - t0:.1f} s", flush=True)


def tiles_wpp(kind: str) -> None:
    """chip_smoke.py's [hevc-tiles] ("tiles": `parallel.tiles.
    encode_sequence_tiles`, the tile columns sharded over 4 host devices)
    or [hevc-wpp] ("wpp": `intra_frames` with the WPP slice writer) on
    synth_clip(1920, 1072, 3, seed=5) at `chip_smoke.tiles_cfg`."""
    from video_codecs_tpu.models.hevc import intra_codec as jic
    from video_codecs_tpu.parallel import tiles
    w, h, n = chip_smoke.HEVC_W, chip_smoke.HEVC_H, chip_smoke.TILES_PICTURES
    frames = chip_smoke.synth_clip(w, h, n, seed=5)
    cfg = headers.HevcConfig(**dataclasses.asdict(
        chip_smoke.tiles_cfg(w, h) if kind == "tiles"
        else chip_smoke.tiles_cfg(w, h, tile_columns=1, wpp=True)))
    t0 = time.time()
    if kind == "tiles":
        stream, recons = tiles.encode_sequence_tiles(cfg, frames)
    else:
        stream, recons = intra_frames(frames, jic.IntraEncoder(cfg), cfg)
    intra_report(f"hevc {kind}", stream, recons, n, time.time() - t0)


def cli_ai_tiles() -> None:
    """The JAX package's encoder CLI on HM's all-intra structure with two
    tile columns (`chip_smoke.hm_cli_files(d, "ai", ...,
    tile_columns=2)`: 832x480, 3 pictures of bench_synth_clip, RDOQ 1,
    SAO 1, SignHideFlag 1), which builds its IntraEncoder (the host CTB
    loop with the full RDOQ and the host SAO decision): bytes, SHA-1, the
    summary and both JAX decoders' hash results."""
    from video_codecs_tpu.tools import encoder_app
    from video_codecs_tpu.utils import yuv
    n, w, h = chip_smoke.CLI_AI_PICTURES, chip_smoke.CLI_W, chip_smoke.CLI_H
    frames = chip_smoke.bench_synth_clip(w, h, n)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        argv = chip_smoke.hm_cli_files(
            d, "ai", frames, w, h,
            tile_columns=chip_smoke.CLI_AI_TILE_COLUMNS)
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            encoder_app.main(argv)
        t = time.time() - t0
        stream = (d / "out.bin").read_bytes()
        ry, ru, rv = yuv.read_frames(str(d / "rec.yuv"), w, h)
        print(f"cli ai tiles: encoder_app.main's summary:\n{buf.getvalue()}")
        intra_report("cli ai tiles", stream, list(zip(ry, ru, rv)), n, t)


def qt_host() -> None:
    """chip_smoke.py's [hevc-qt-host]: the JAX package's
    QuadtreeIntraEncoder on one 192x128 picture of synth_clip(192, 128,
    1, seed=5) at `chip_smoke.qt_host_cfg`, decoded by its
    QuadtreeIntraDecoder and GeneralDecoder."""
    from video_codecs_tpu.models.hevc import quadtree_codec
    w, h = chip_smoke.QT_HOST_W, chip_smoke.QT_HOST_H
    cfg = headers.HevcConfig(**dataclasses.asdict(
        chip_smoke.qt_host_cfg(w, h)))
    enc = quadtree_codec.QuadtreeIntraEncoder(cfg)
    t0 = time.time()
    nals, rec = enc.encode_frame(*chip_smoke.synth_clip(w, h, 1, seed=5)[0])
    stream = bitstream.annexb(enc.stream_headers() + nals)
    t = time.time() - t0
    print(f"qt host: {len(stream)} bytes, SHA-1 "
          f"{hashlib.sha1(stream).hexdigest()}, encode {t:.1f} s", flush=True)
    for label, dec in (("QuadtreeIntraDecoder",
                        quadtree_codec.QuadtreeIntraDecoder()),
                       ("GeneralDecoder", decoder.GeneralDecoder())):
        out = dec.decode(stream)
        same = all(np.array_equal(np.asarray(out[0][c]), np.asarray(rec[c]))
                   for c in range(3))
        print(f"qt host: JAX {label} hash OK {dec.hash_status}, picture "
              f"the encoder's: {same}", flush=True)


def jax_deblock_maps(qt, qp):
    """`qt_merge_dev`'s deblock (video_codecs_tpu/models/hevc/inter_qt.py:
    380-423) as jnp on the assembled picture's maps: the tiled runs'
    repaired deblock (the port's `inter_qt.deblock_maps`)."""
    import jax.numpy as jnp
    from video_codecs_tpu.ops import deblock as deblock_ops

    def up8(f):
        return jnp.repeat(jnp.repeat(f, 2, axis=0), 2, axis=1)

    q = {k: jnp.asarray(v) for k, v in qt.items()}
    pm8 = up8(q["pred_mode"].astype(jnp.int32))
    dir8 = q["dir8"].astype(jnp.int32)
    m0x8, m0y8, m1x8, m1y8 = q["mv0x8"], q["mv0y8"], q["mv1x8"], q["mv1y8"]
    r0_8f = q["r0_8"].astype(jnp.int32)
    r1_8f = q["r1_8"].astype(jnp.int32)
    tusplit, split8m = q["tusplit"], q["split8"]
    eff8 = jnp.where(up8(tusplit | split8m), q["cbf_y8"], up8(q["cbf_y"]))

    def bs_pair8(sl_a, sl_b):
        intra2 = (pm8 == inter_qt.MODE_INTRA)[sl_a] | \
            (pm8 == inter_qt.MODE_INTRA)[sl_b]
        diff_dir = dir8[sl_a] != dir8[sl_b]
        d0 = (jnp.abs(m0x8[sl_a] - m0x8[sl_b]) >= 4) | \
             (jnp.abs(m0y8[sl_a] - m0y8[sl_b]) >= 4) | \
             (r0_8f[sl_a] != r0_8f[sl_b])
        d1 = (jnp.abs(m1x8[sl_a] - m1x8[sl_b]) >= 4) | \
             (jnp.abs(m1y8[sl_a] - m1y8[sl_b]) >= 4) | \
             (r1_8f[sl_a] != r1_8f[sl_b])
        use0 = (dir8[sl_a] & 1) > 0
        mv_diff = jnp.where(dir8[sl_a] == 3, d0 | d1,
                            jnp.where(use0, d0, d1))
        one = eff8[sl_a] | eff8[sl_b] | diff_dir | mv_diff
        return jnp.where(intra2, 2, jnp.where(one, 1, 0)).astype(jnp.int32)

    ver8 = bs_pair8(np.s_[:, :-1], np.s_[:, 1:]).T
    hor8 = bs_pair8(np.s_[:-1, :], np.s_[1:, :])
    inner = tusplit | split8m
    ver8 = ver8.at[0::2].set(
        jnp.where(jnp.repeat(inner.T, 2, axis=1), ver8[0::2], 0))
    hor8 = hor8.at[0::2].set(
        jnp.where(jnp.repeat(inner, 2, axis=1), hor8[0::2], 0))
    return deblock_ops.deblock_420_bs(
        q["rec_y"].astype(jnp.int32), q["rec_u"].astype(jnp.int32),
        q["rec_v"].astype(jnp.int32), qp, ver8, hor8, block=8)


def jax_tiled_qt(wt: int, halo: int, repaired: bool = True):
    """The dry run's `TiledRefQt` (__graft_entry__.py:143-190) over the
    JAX encoder, for tile columns of `wt` luma samples.  repaired=True
    takes the picture's QP (`cfg.qp`, where the dry run passes its base
    QP 32 whatever the picture's offset) and deblocks the assembled
    picture (`jax_deblock_maps`) where the dry run deblocks each padded
    column, the edge between a picture edge and its halo included: the
    port's `parallel.sharded.TiledRefQt`.  repaired=False is the dry
    run's as written."""
    import jax.numpy as jnp
    from video_codecs_tpu_torch.parallel import sharded

    keys = sharded.KEYS

    class TiledRefQt(inter_qt.QtDeviceRandomAccessEncoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.qt_log = {}
            self._poc = None

        def _encode_b_frame(self, frame, poc, refs, is_anchor):
            self._poc = poc
            return super()._encode_b_frame(frame, poc, refs, is_anchor)

        def _device_phase(self, y, u, v, args, has_l1, lam):
            cfg = self.cfg
            qp = cfg.qp if repaired else 32
            w, h = cfg.width, cfg.height

            def slab(a, scale=1):
                lo = (ti * wt - halo) // scale
                hi = ((ti + 1) * wt + halo) // scale
                a = np.asarray(a)
                idx = np.clip(np.arange(lo, hi), 0, a.shape[-1] - 1)
                return jnp.asarray(np.take(a, idx, axis=-1))

            outs = {k: [] for k in keys}
            for ti in range(w // wt):
                wp = wt + 2 * halo
                pl = [slab(y), slab(u, 2), slab(v, 2),
                      slab(args[0]), slab(args[1], 2), slab(args[2], 2),
                      slab(args[3]), slab(args[4], 2), slab(args[5], 2)]
                st16 = inter_jax.encode_b_frame_dev(
                    *pl, qp=qp, w=wp, h=h, has_l1=has_l1,
                    search_range=self.search_range,
                    sbh=cfg.sign_data_hiding, rdoq=True, me_method="pyr",
                    deblock=False, allow_intra=False, merge_eval="best4",
                    lam=lam, rqt=True, cu8=True,
                    gx_blk0=jnp.int32((ti * wt - halo) // 16),
                    pic_bw=jnp.int32(w // 16))
                qt = inter_qt.qt_merge_dev(
                    *pl, st16, qp=qp, w=wp, h=h, has_l1=has_l1,
                    sbh=cfg.sign_data_hiding, rdoq=True,
                    deblock=not repaired, lam=lam)
                for k in keys:
                    c = sharded.crop_cells(k, halo)
                    outs[k].append(np.asarray(qt[k][:, c:-c]))
            full = {k: np.concatenate(outs[k], axis=-1) for k in keys}
            if repaired:
                rec = jax_deblock_maps(full, qp)
                for k, r in zip(("rec_y", "rec_u", "rec_v"), rec):
                    full[k] = np.asarray(r).astype(np.uint8)
            self.qt_log[self._poc] = full
            return full

    return TiledRefQt


def tiled(kind: str) -> None:
    """chip_smoke.py's `[tiled-ra]` ("ra": synth_clip(1920, 1072, 9,
    seed=5) in 4 tile columns of 480, halo 32, the dry run's settings
    with the hash SEI) or the dry run at 4 devices ("dryrun": its
    384x96 clip in 4 columns of 96) through `jax_tiled_qt`, repaired,
    each decoded by both packages' GeneralDecoders; for the dry run
    also the stream as the dry run writes it and its hash results."""
    from video_codecs_tpu_torch import graft_entry
    if kind == "ra":
        w, h, wt = chip_smoke.HEVC_W, chip_smoke.HEVC_H, chip_smoke.TILED_WT
        frames = chip_smoke.synth_clip(w, h, chip_smoke.RA_PICTURES, seed=5)
        runs = ((True, "tiled ra 1080p"),)
    else:
        wt, h = 96, 96
        w = 4 * wt
        frames = graft_entry.dryrun_clip(w, h)
        runs = ((True, "dryrun 4 devices"),
                (False, "dryrun 4 devices as written"))
    for repaired, what in runs:
        cfg = headers.HevcConfig(**dataclasses.asdict(
            graft_entry.dryrun_cfg(w, h)))
        enc = jax_tiled_qt(wt, 32, repaired)(cfg, search_range=8)
        t0 = time.time()
        stream, _ = enc.encode_sequence_ra(frames)
        report(what, stream, len(frames), time.time() - t0)
        dec = tdecoder.GeneralDecoder()
        dec.decode(stream)
        print(f"{what}: the port's GeneralDecoder hash OK "
              f"{sum(dec.hash_status)} of {len(frames)}: {dec.hash_status}",
              flush=True)


def experiment() -> None:
    """The JAX package's experiment CLI (tools/experiment.main) on
    chip_smoke.py's `[experiment]` YUV (`chip_smoke.experiment_yuv`:
    bench_synth_clip(832, 480, 3, seed=42)) at its QPs, --codec intra,
    and --codec ldp with the spec AMVP list (queue 3, fault 0)."""
    from video_codecs_tpu.tools import experiment as jexp
    with tempfile.TemporaryDirectory() as d:
        path = chip_smoke.experiment_yuv(Path(d))
        for codec in ("intra", "ldp"):
            motion.amvp_candidates = (tmotion.amvp_candidates
                                      if codec == "ldp" else AMVP_AS_WRITTEN)
            t0 = time.time()
            jexp.main(chip_smoke.experiment_argv(path, codec))
            print(f"experiment {codec}: {time.time() - t0:.1f} s", flush=True)
    motion.amvp_candidates = AMVP_AS_WRITTEN


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ra", action="store_true",
                    help="also the 1080p RA GOP of chip_smoke phase 7")
    ap.add_argument("--ra-sao", action="store_true",
                    help="also that GOP with SAO on (phase hevc-ra-sao)")
    ap.add_argument("--ldp-tz", action="store_true",
                    help="the LD-P streams with TZSearch (hevc-ldp-tz)")
    ap.add_argument("--ra-tz", action="store_true",
                    help="the RA GOP with TZSearch (hevc-ra-tz)")
    ap.add_argument("--ldp-rc", action="store_true",
                    help="the rate-controlled LD-P streams and the resumed "
                         "run (hevc-ldp-rc)")
    ap.add_argument("--flat-ra", action="store_true",
                    help="the flat CTB16 RA GOP-8 (hevc-flat-ra)")
    ap.add_argument("--hierb", action="store_true",
                    help="the flat hierarchical-B run (hevc-hierb)")
    ap.add_argument("--ldp-sao", action="store_true",
                    help="the LD-P stream with SAO (hevc-ldp-sao)")
    ap.add_argument("--ldp-conf", action="store_true",
                    help="the LD-P stream with timing SEI and the long-term "
                         "IDR reference (hevc-ldp-conf)")
    ap.add_argument("--ldp-host", action="store_true",
                    help="the host LD-P coder on HM's LD-P main cfg "
                         "(hevc-ldp-host)")
    ap.add_argument("--ldp-wp", action="store_true",
                    help="the host LD-P coder with weighted prediction on "
                         "the faded clip (hevc-ldp-wp)")
    ap.add_argument("--ldp-dqp", action="store_true",
                    help="the host LD-P coder with cu_qp_delta under CTU "
                         "rate control (hevc-ldp-dqp)")
    ap.add_argument("--cli-ra", action="store_true",
                    help="the JAX package's encoder CLI on HM's RA main "
                         "cfg (cli-ra)")
    ap.add_argument("--jm-main", action="store_true",
                    help="the JAX package's JM encoder CLI, Main profile "
                         "(jm-main)")
    ap.add_argument("--jm-baseline", action="store_true",
                    help="the JAX package's JM encoder CLI, baseline "
                         "(jm-baseline)")
    ap.add_argument("--h264-high", action="store_true",
                    help="the host H.264 coder at High profile (h264-high)")
    ap.add_argument("--h264-b", action="store_true",
                    help="the host H.264 B coder (h264-b)")
    for kind, what in (("ltr", "long-term references, MMCO and list "
                                "reordering"),
                       ("wp", "weighted prediction on the faded clip"),
                       ("perc", "perceptual RDO"),
                       ("loss", "intra refresh, SEI, RTP loss and "
                                "concealment")):
        ap.add_argument(f"--h264-{kind}", action="store_true",
                        help=f"the host H.264 coder with {what} "
                             f"(h264-{kind})")
    ap.add_argument("--tiles", action="store_true",
                    help="the 1080p all-intra stream in 4 tile columns "
                         "through parallel.tiles (hevc-tiles)")
    ap.add_argument("--wpp", action="store_true",
                    help="the same clip with WPP (hevc-wpp)")
    ap.add_argument("--cli-ai-tiles", action="store_true",
                    help="the JAX package's encoder CLI on HM's all-intra "
                         "structure with 2 tile columns (cli-ai-tiles)")
    ap.add_argument("--qt-host", action="store_true",
                    help="the host quadtree RD encoder (hevc-qt-host)")
    ap.add_argument("--tiled-ra", action="store_true",
                    help="the 1080p RA GOP in 4 tile columns of the dry "
                         "run's decomposition (tiled-ra)")
    ap.add_argument("--dryrun", action="store_true",
                    help="the dry run's tiled stream at 4 devices (dryrun)")
    ap.add_argument("--experiment", action="store_true",
                    help="the experiment CLI's tables (experiment)")
    ap.add_argument("--no-ldp", action="store_true",
                    help="skip the LD-P streams")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    if not args.no_ldp:
        ldp()
    if args.ra:
        ra()
    if args.ra_sao:
        ra(sao=True)
    if args.ldp_tz:
        ldp(me_method="tz")
    if args.ra_tz:
        ra(me_method="tz")
    if args.ldp_rc:
        ldp(rc=True)
        ldp_rc_resumed()
    if args.flat_ra:
        flat("ra")
    if args.hierb:
        flat("hierb")
    if args.ldp_conf:
        ldp_spec("ldp conf", timing_sei=True, long_term_idr=True,
                 temporal_mvp=False)
    if args.ldp_sao:
        ldp_spec("ldp sao", sao=True)
    for kind, on in (("", args.ldp_host), ("wp", args.ldp_wp),
                     ("dqp", args.ldp_dqp)):
        if on:
            host(kind)
    if args.cli_ra:
        cli_ra()
    if args.jm_main:
        jm("main")
    if args.jm_baseline:
        jm("baseline")
    if args.h264_high:
        h264_high_b("high")
    if args.h264_b:
        h264_high_b("b")
    for kind in ("ltr", "wp", "perc", "loss"):
        if getattr(args, f"h264_{kind}"):
            h264_conf(kind)
    if args.tiles or args.wpp or args.cli_ai_tiles:
        repair_entry_points()
    for kind in ("tiles", "wpp"):
        if getattr(args, kind):
            tiles_wpp(kind)
    if args.cli_ai_tiles:
        cli_ai_tiles()
    if args.qt_host:
        qt_host()
    if args.tiled_ra:
        tiled("ra")
    if args.dryrun:
        tiled("dryrun")
    if args.experiment:
        experiment()


if __name__ == "__main__":
    main()
