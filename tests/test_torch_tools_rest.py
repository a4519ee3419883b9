"""The port's last tools against the JAX package's, on the CPU, at
tolerance 0: the syntax-element trace and the coding statistics on the
H.264 CABAC coders (and the HEVC decoder-analyser hooks), the decoder
CLI's --stats report, H264IntraEncoder's VCT_FORCE_I4 / VCT_FORCE_I8
switches, the bit-depth converter and Annex-B byte count, the leaky
bucket, YUV->RGB, and the experiment harness (Bjontegaard deltas, a QP
sweep's table and the CLI).  Clips are at most 64x48.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from video_codecs_tpu.models.h264 import bslice_codec as jbslice
from video_codecs_tpu.models.h264 import inter_codec as jinter
from video_codecs_tpu.models.h264 import intra_codec as jintra
from video_codecs_tpu.models.hevc import headers as jhdr
from video_codecs_tpu.models.hevc import intra_codec as jhevc
from video_codecs_tpu.models.hevc import motion as jmotion
from video_codecs_tpu.tools import convert as jconvert
from video_codecs_tpu.tools import decoder_app as jdapp
from video_codecs_tpu.tools import experiment as jexp
from video_codecs_tpu.tools import misc as jmisc
from video_codecs_tpu.utils import coding_stats as jstats
from video_codecs_tpu.utils import trace as jtrace
from video_codecs_tpu_torch.models.h264 import bslice_codec as tbslice
from video_codecs_tpu_torch.models.h264 import inter_codec as tinter
from video_codecs_tpu_torch.models.h264 import intra_codec as tintra
from video_codecs_tpu_torch.models.hevc import headers as thdr
from video_codecs_tpu_torch.models.hevc import inter_codec as tpc
from video_codecs_tpu_torch.models.hevc import intra_codec as thevc
from video_codecs_tpu_torch.models.hevc import motion as tmotion
from video_codecs_tpu_torch.tools import convert as tconvert
from video_codecs_tpu_torch.tools import decoder_app as tdapp
from video_codecs_tpu_torch.tools import experiment as texp
from video_codecs_tpu_torch.tools import misc as tmisc
from video_codecs_tpu_torch.utils import coding_stats as tstats
from video_codecs_tpu_torch.utils import trace as ttrace
from video_codecs_tpu_torch.utils import yuv as tyuv

torch.set_grad_enabled(False)


def clip(w, h, n, seed):
    """A smooth texture panning by (2, 1) px a picture, chroma derived."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + n + 8, w + 2 * n + 8)).astype(float)
    k = np.array([1, 4, 6, 4, 1.0]) / 16
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    out = []
    for f in range(n):
        y = np.clip(base[f:f + h, 2 * f:2 * f + w], 0, 255).astype(np.uint8)
        out.append((np.ascontiguousarray(y),
                    (y[::2, ::2] // 2 + 64).astype(np.uint8),
                    (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return out


def _h264_pair(kind):
    """(port encoder, JAX encoder) of `kind` at 48x32, CABAC."""
    if kind == "p":
        return (tinter.H264Encoder(48, 32, entropy="cabac", search_range=8,
                                   device="cpu"),
                jinter.H264Encoder(48, 32, entropy="cabac", search_range=8))
    return (tbslice.H264BEncoder(48, 32, entropy="cabac", search_range=8,
                                 device="cpu"),
            jbslice.H264BEncoder(48, 32, entropy="cabac", search_range=8))


def _decoder(kind, pkg):
    if kind == "p":
        return (tinter if pkg == "t" else jinter).H264Decoder()
    return (tbslice if pkg == "t" else jbslice).H264BDecoder()


@pytest.mark.parametrize("kind", ["p", "b"])
def test_trace_and_stats_equal_jax(kind):
    """One CABAC stream (I + P, or I P B) with the trace and the
    statistics on: the port's encode trace is the JAX encoder's and the
    decode trace of the stream; the statistics' tables are equal on
    both sides for the encode and for the decode."""
    frames = clip(48, 32, 3, seed=11)
    out = {}
    for pkg, trace, stats, enc in zip(("t", "j"), (ttrace, jtrace),
                                      (tstats, jstats), _h264_pair(kind)):
        trace.start()
        stats.start()
        stream, _ = enc.encode_sequence(frames)
        enc_stats = stats.stop().report()
        enc_trace = trace.stop()
        trace.start()
        stats.start()
        _decoder(kind, pkg).decode(stream)
        dec_stats = stats.stop().report()
        dec_trace = trace.stop()
        out[pkg] = (stream, enc_trace, dec_trace, enc_stats, dec_stats)
    assert out["t"] == out["j"]
    stream, enc_trace, dec_trace, enc_stats, dec_stats = out["t"]
    assert enc_trace == dec_trace and len(enc_trace) > 100
    assert not ttrace.active() and not tstats.active()
    assert "mb_type_i" in enc_stats and "TOTAL" in dec_stats


def test_trace_off_leaves_engines_unwrapped():
    """Without start() the engines are not wrapped: the stream is the
    same with and without a trace."""
    frames = clip(48, 32, 2, seed=12)
    plain, _ = tinter.H264Encoder(48, 32, entropy="cabac", search_range=8,
                                  device="cpu").encode_sequence(frames)
    ttrace.start()
    traced, _ = tinter.H264Encoder(48, 32, entropy="cabac", search_range=8,
                                   device="cpu").encode_sequence(frames)
    assert ttrace.stop() and traced == plain


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_decoder_app_stats_equal_jax(tmp_path):
    """`decoder_app -b ... --stats` on an H.264 CABAC stream and on an
    HEVC low-delay P stream (the HEVC CabacDecoder hooks, both packages
    routing it to LowDelayDecoder): the printed report, hash lines and
    decoded pictures are the JAX CLI's."""
    frames = clip(48, 32, 3, seed=13)
    h264, _ = tinter.H264Encoder(48, 32, entropy="cabac", search_range=8,
                                 device="cpu").encode_sequence(frames)
    cfg = thdr.HevcConfig(width=48, height=32, qp=32)
    hevc, _ = tpc.LowDelayEncoder(cfg, device="cpu").encode_sequence_ldp(
        frames)
    for name, stream in (("h264", h264), ("hevc", hevc)):
        src = tmp_path / f"{name}.bin"
        src.write_bytes(stream)
        texts = [_run_cli(main, ["-b", str(src), "-o",
                                 str(tmp_path / f"{name}_{i}.yuv"),
                                 "--stats"])
                 for i, main in enumerate((tdapp.main, jdapp.main))]
        assert texts[0] == texts[1], name
        assert "syntax class" in texts[0] and "TOTAL" in texts[0]
        assert (tmp_path / f"{name}_0.yuv").read_bytes() == \
            (tmp_path / f"{name}_1.yuv").read_bytes()
    assert not tstats.active()


@pytest.mark.parametrize("flag,t8", [("VCT_FORCE_I4", False),
                                     ("VCT_FORCE_I8", True)])
def test_force_intra_flags_equal_jax(monkeypatch, flag, t8):
    """VCT_FORCE_I4 / VCT_FORCE_I8 read through utils/debug: the forced
    stream is the JAX encoder's, and it differs from the unforced one,
    which is the same with the flag unset."""
    frames = clip(48, 32, 1, seed=14)
    kw = dict(qp=28, entropy="cabac", transform8x8=t8)
    plain = tintra.H264IntraEncoder(48, 32, device="cpu",
                                    **kw).encode_sequence(frames)[0]
    monkeypatch.setenv(flag, "1")
    enc = tintra.H264IntraEncoder(48, 32, device="cpu", **kw)
    assert enc.force_i4 == (flag == "VCT_FORCE_I4")
    assert enc.force_i8 == (flag == "VCT_FORCE_I8")
    forced = enc.encode_sequence(frames)[0]
    assert forced == jintra.H264IntraEncoder(48, 32, **kw).encode_sequence(
        frames)[0]
    assert forced != plain
    monkeypatch.delenv(flag)
    assert tintra.H264IntraEncoder(48, 32, device="cpu",
                                   **kw).encode_sequence(frames)[0] == plain


def test_convert_and_annexb_count_equal_jax(tmp_path):
    """convert_bitdepth both ways (8 -> 10 -> 8 gives the bytes back;
    10 -> 8 rounds), the CLI on files, and annexb_byte_count on an HEVC
    and an H.264 stream: equal to the JAX package's."""
    rng = np.random.default_rng(15)
    data8 = rng.integers(0, 256, 4 * 48 * 32 * 3 // 2, np.uint8).tobytes()
    data10 = rng.integers(0, 1024, 48 * 32, np.uint16).astype("<u2").tobytes()
    for data, a, b in ((data8, 8, 10), (data8, 8, 16), (data10, 10, 8),
                       (data10, 10, 9), (data8, 8, 8)):
        assert tconvert.convert_bitdepth(data, a, b) == \
            jconvert.convert_bitdepth(data, a, b)
    assert tconvert.convert_bitdepth(
        tconvert.convert_bitdepth(data8, 8, 10), 10, 8) == data8
    src = tmp_path / "in.yuv"
    src.write_bytes(data8)
    tconvert.main([str(src), str(tmp_path / "t.yuv"), "--to-bits", "10"])
    jconvert.main([str(src), str(tmp_path / "j.yuv"), "--to-bits", "10"])
    assert (tmp_path / "t.yuv").read_bytes() == \
        (tmp_path / "j.yuv").read_bytes()
    frames = clip(48, 32, 2, seed=16)
    hevc, _ = thevc.IntraEncoder(thdr.HevcConfig(width=48, height=32),
                                 device="cpu").encode_sequence(frames)
    h264, _ = tintra.H264IntraEncoder(48, 32, device="cpu").encode_sequence(
        frames)
    for stream in (hevc, h264):
        got = tconvert.annexb_byte_count(stream)
        assert got == jconvert.annexb_byte_count(stream)
        assert got["total"] + got["start_code"] == len(stream)


def test_leaky_bucket_and_yuv_to_rgb_equal_jax(tmp_path):
    """The leaky-bucket parameters of a seeded bit trace (default and
    given rates), the parameter file both ways, and YUV->RGB at 8 and 10
    bits, equal to the JAX package's."""
    rng = np.random.default_rng(17)
    bits = rng.integers(2_000, 60_000, 40)
    bits[::8] *= 5                                  # intra pictures
    for rates in (None, [400_000, 900_000, 2_500_000]):
        got = tmisc.leaky_bucket_params(bits, 30.0, rates)
        assert got == jmisc.leaky_bucket_params(bits, 30.0, rates)
    params = tmisc.leaky_bucket_params(bits, 25.0, n_buckets=3)
    tmisc.write_leaky_bucket_file(tmp_path / "t.lb", params)
    jmisc.write_leaky_bucket_file(tmp_path / "j.lb", params)
    assert (tmp_path / "t.lb").read_bytes() == (tmp_path / "j.lb").read_bytes()
    assert tmisc.read_leaky_bucket_file(tmp_path / "j.lb") == \
        jmisc.read_leaky_bucket_file(tmp_path / "t.lb") == \
        [tuple(p) for p in params]
    with pytest.raises(ValueError):
        tmisc.leaky_bucket_params([], 30.0)
    for depth, dtype in ((8, np.uint8), (10, np.uint16)):
        y = rng.integers(0, 1 << depth, (32, 48)).astype(dtype)
        u = rng.integers(0, 1 << depth, (16, 24)).astype(dtype)
        v = rng.integers(0, 1 << depth, (16, 24)).astype(dtype)
        got = tmisc.yuv_to_rgb(y, u, v, depth)
        assert got.dtype == dtype and got.shape == (32, 48, 3)
        np.testing.assert_array_equal(got, jmisc.yuv_to_rgb(y, u, v, depth))


def test_bd_metrics_equal_jax():
    """bd_rate, bd_psnr and compare on seeded RD curves (4 and 3 points),
    the disjoint-curve refusal."""
    rng = np.random.default_rng(18)
    for n in (4, 3):
        ra = np.sort(rng.uniform(100, 3000, n))
        pa = np.sort(rng.uniform(30, 42, n))
        rt = ra * rng.uniform(0.8, 1.1, n)
        pt = pa + rng.uniform(-0.3, 0.4, n)
        assert texp.bd_rate(ra, pa, rt, pt) == jexp.bd_rate(ra, pa, rt, pt)
        assert texp.bd_psnr(ra, pa, rt, pt) == jexp.bd_psnr(ra, pa, rt, pt)
        a = [texp.RDPoint(q, r, p, 40.0, 41.0) for q, r, p in
             zip(range(n), ra, pa)]
        b = [texp.RDPoint(q, r, p, 40.0, 41.0) for q, r, p in
             zip(range(n), rt, pt)]
        ja = [jexp.RDPoint(q, r, p, 40.0, 41.0) for q, r, p in
              zip(range(n), ra, pa)]
        jb = [jexp.RDPoint(q, r, p, 40.0, 41.0) for q, r, p in
              zip(range(n), rt, pt)]
        assert texp.compare(a, b) == jexp.compare(ja, jb)
    with pytest.raises(ValueError):
        texp.bd_rate([1, 2], [30, 31], [3, 4], [40, 41])


def test_qp_sweep_and_cli_equal_jax(tmp_path, monkeypatch):
    """qp_sweep with an extra metric over the port's IntraEncoder on the
    CPU against the JAX package's (format_table's text equal), then the
    experiment CLI, --codec intra and --codec ldp (the JAX package's
    with the spec AMVP list, ROADMAP queue 3 fault 0), on a YUV file:
    the printed tables are equal.  Without --device=cpu and a card the
    CLI raises."""
    frames = clip(64, 48, 2, seed=19)

    def mse(fr, rec):
        return np.mean([(f[0].astype(float) - r[0]) ** 2
                        for f, r in zip(fr, rec)])

    tpts = texp.qp_sweep(
        lambda qp: thevc.IntraEncoder(
            thdr.HevcConfig(width=64, height=48, qp=qp), device="cpu"),
        frames, (30, 38), metrics={"mse": mse})
    jpts = jexp.qp_sweep(
        lambda qp: jhevc.IntraEncoder(
            jhdr.HevcConfig(width=64, height=48, qp=qp)),
        frames, (30, 38), metrics={"mse": mse})
    assert texp.format_table("t", tpts) == jexp.format_table("t", jpts)
    path = tmp_path / "in.yuv"
    tyuv.write_frames(str(path), *(np.stack([f[c] for f in frames])
                                   for c in range(3)))
    monkeypatch.setattr(jmotion, "amvp_candidates", tmotion.amvp_candidates)
    for codec in ("intra", "ldp"):
        argv = ["-i", str(path), "-W", "64", "-H", "48", "--qps", "30,36",
                "--codec", codec]
        got = _run_cli(texp.main, argv + ["--device=cpu"])
        assert got == _run_cli(jexp.main, argv), codec
        assert got.count("\n") == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        texp.main(["-i", str(path), "-W", "64", "-H", "48"])
