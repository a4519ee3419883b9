"""Bytes and SHA-1 of the JAX package's streams that chip_smoke.py holds
the port's to, computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_sha1.py [--ra] [--ra-sao] \
        [--ldp-tz] [--ra-tz] [--ldp-rc] [--flat-ra] [--hierb] \
        [--ldp-sao] [--ldp-conf] [--ldp-host] [--ldp-wp] [--ldp-dqp] \
        [--cli-ra] [--jm-main] [--jm-baseline] [--h264-high] [--h264-b] \
        [--no-ldp]

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
with both packages' decoders.  This is a tool for the reference side: it
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

os.environ.setdefault("JAX_PLATFORMS", "cpu")
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


if __name__ == "__main__":
    main()
