"""The reference's encoder and decoder CLIs in the port against the JAX
package's, on the CPU.

The port carries the CLIs (tools/encoder_app.py, tools/decoder_app.py)
with what they need: HM's cfg parser (utils/config.py), the YUV file I/O
(utils/yuv.py), the GOPEntry table parser (`ra_codec.parse_gop_entries`)
and `analyze.sniff_codec`.  The pure functions are held to the JAX
package's on cfg texts, files and streams (one parametrised test per
function); the copied text to the original's.  Then both CLIs run in
this process on the same files, with tolerance 0:
  - HM's low-delay P settings of tests/test_config_apps.py at 64x48 over
    3 pictures (the JAX package's stream with the spec AMVP list swapped
    in, the one fault the port repairs), HM's random-access main cfg at
    80x48 over 9 pictures, and an all-intra cfg at 64x48 over 2 pictures
    with and without --fast=1: equal streams, recon files, summaries
    (but the time) and warnings;
  - both decoder CLIs on the low-delay P and all-intra streams: equal
    output and files;
  - on the random-access stream, the reference's decoder CLI routes to
    `LowDelayDecoder(conceal=True)`, which skips the TRAIL_N pictures and
    conceals the B pictures it cannot parse: "(OK)" for 1 picture of 9,
    5 pictures written (ROADMAP queue 3, reference fault 10).  The port's
    decoder CLI sends the stream to the general decoder: "(OK)" for 9 of
    9 and the encoder's pictures.
The port's CLI also runs as `python -m` in a process where JAX and the
JAX package cannot be imported.
"""

import contextlib
import dataclasses
import io
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from chip_smoke import (HM_LDP_STRUCTURE, HM_MAIN_CFG, HM_RA_STRUCTURE,
                        HM_SEQUENCE_CFG, bench_synth_clip, hm_cli_files)
from test_torch_h264_host import _ported
from test_torch_hevc_host import _defs

from video_codecs_tpu.models.hevc import motion as jmotion
from video_codecs_tpu.models.hevc import ra_codec as jra
from video_codecs_tpu.tools import analyze as janalyze
from video_codecs_tpu.tools import decoder_app as jdapp
from video_codecs_tpu.tools import encoder_app as jeapp
from video_codecs_tpu.utils import config as jconfig
from video_codecs_tpu.utils import yuv as jyuv
from video_codecs_tpu_torch.models.h264 import inter_dev as th264
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.models.hevc import motion as tmotion
from video_codecs_tpu_torch.models.hevc import ra_codec as tra
from video_codecs_tpu_torch.tools import analyze as tanalyze
from video_codecs_tpu_torch.tools import decoder_app as tdapp
from video_codecs_tpu_torch.tools import encoder_app as teapp
from video_codecs_tpu_torch.utils import config as tconfig
from video_codecs_tpu_torch.utils import yuv as tyuv

REPO = pathlib.Path(__file__).resolve().parents[1]

# ---- the copied text --------------------------------------------------------

# port module -> (functions whose text the port changed, functions only
# the port has); every other function must be the original's text, its
# imports of the JAX package's modules read as the port's
_CLI_COPIES = {
    "utils/yuv.py": (set(), set()),
    "utils/config.py": ({"to_encoder_settings"}, set()),
    "tools/analyze.py": (set(), set()),
    "tools/encoder_app.py": ({"main"}, set()),
    "tools/decoder_app.py": ({"main"}, {"_needs_general"}),
}


@pytest.mark.parametrize("mod", sorted(_CLI_COPIES))
def test_cli_copies_are_the_originals(mod):
    trimmed, added = _CLI_COPIES[mod]
    port, lines = _defs(REPO / "video_codecs_tpu_torch" / mod)
    orig, _ = _defs(REPO / "video_codecs_tpu" / mod)
    tag = re.compile(r"#\s*video_codecs_tpu/" + re.escape(mod) + r":(\d+)$")
    assert (trimmed | added) <= set(port)
    for name, (first, src) in port.items():
        if name in added:
            continue
        m = tag.search(lines[first - 2].strip())
        assert m, f"{mod}: {name} lacks its provenance comment"
        assert int(m.group(1)) == orig[name][0], f"{mod}: {name} line"
        if name not in trimmed:
            assert src == _ported(orig[name][1]), f"{mod}: {name} differs"
    if mod == "utils/config.py":
        assert tconfig._SUPPORTED == jconfig._SUPPORTED
        assert [(f.name, f.default) for f in
                dataclasses.fields(tconfig.EncoderSettings)] == \
            [(f.name, f.default) for f in
             dataclasses.fields(jconfig.EncoderSettings)]
    if mod == "tools/analyze.py":
        assert tanalyze.H264_NAL_NAMES == janalyze.H264_NAL_NAMES


# ---- the pure functions --------------------------------------------------------

_ODD_CFG = """\
# a comment line, then blank lines and lines without a colon

SourceWidth:64
SourceHeight :   48   # trailing comment
QP : 31.0
IntraPeriod: 1
FastSearch : 2
SearchRange : 16
RDOQ : lite
SignHideFlag : false
SAO : 0
RateControl : 1
TargetBitrate : 250000
InputBitDepth : 10
InputChromaFormat : 422
NumTileColumnsMinus1 : 1
LoopFilterDisable : 1
TransformSkip : 1
ECU :
just a line
QP : 30   # a later line wins
"""

_CFG_TEXTS = {
    "ra": HM_MAIN_CFG.format(structure=HM_RA_STRUCTURE),
    "ldp": HM_MAIN_CFG.format(structure=HM_LDP_STRUCTURE),
    "apps": ("SourceWidth : 64\nSourceHeight : 48\nQP : 30   # qp\n"
             "FramesToBeEncoded : 3\nIntraPeriod : -1\nGOPSize : 1\n"),
    "odd": _ODD_CFG,
}


def _cfg_files(tmp_path, case):
    main = tmp_path / f"{case}.cfg"
    main.write_text(_CFG_TEXTS[case])
    seq = tmp_path / "seq.cfg"
    seq.write_text(HM_SEQUENCE_CFG.format(w=80, h=48, n=9))
    return [str(main), str(seq)]


def _settings(s):
    """EncoderSettings as plain values (GOPEntry rows as tuples)."""
    d = dataclasses.asdict(s)
    d["gop_entries"] = tuple(dataclasses.astuple(e) for e in s.gop_entries)
    return d


@pytest.mark.parametrize("case", sorted(_CFG_TEXTS))
def test_parse_cfg_file_equal(tmp_path, case):
    path = _cfg_files(tmp_path, case)[0]
    assert tconfig.parse_cfg_file(path) == jconfig.parse_cfg_file(path)


@pytest.mark.parametrize("case", sorted(_CFG_TEXTS))
def test_load_config_equal(tmp_path, case):
    """A main cfg stacked with a per-sequence cfg, then CLI overrides."""
    files = _cfg_files(tmp_path, case)
    for overrides in (None, {"QP": "37", "FrameRate": "50"}):
        got = tconfig.load_config(files, overrides)
        assert got == jconfig.load_config(files, overrides)
        assert got == jconfig.load_config(files[::-1] + files, overrides)
    assert tconfig.load_config(files, {"QP": "37"})["QP"] == "37"


@pytest.mark.parametrize("case", sorted(_CFG_TEXTS))
def test_to_encoder_settings_equal(tmp_path, case):
    """Every field, the unsupported options and the GOPEntry table; HM's
    RA main cfg gives GOP8_RA."""
    opts = jconfig.load_config(_cfg_files(tmp_path, case))
    got = tconfig.to_encoder_settings(opts)
    assert _settings(got) == _settings(jconfig.to_encoder_settings(opts))
    if case == "ra":
        assert tuple(got.gop_entries) == tra.GOP8_RA
        assert (got.me_method, got.search_range, got.rdoq, got.sao,
                got.merge_cands, got.temporal_mvp) == \
            ("tz", 64, "full", True, 5, True)
    if case == "odd":            # alone, without the per-sequence cfg
        alone = jconfig.parse_cfg_file(_cfg_files(tmp_path, case)[0])
        got = tconfig.to_encoder_settings(alone)
        assert _settings(got) == \
            _settings(jconfig.to_encoder_settings(alone))
        assert got.unsupported == {"InputBitDepth": "10",
                                   "InputChromaFormat": "422",
                                   "TransformSkip": "1"}
        assert (got.qp, got.me_method, got.rdoq, got.target_bitrate,
                got.tile_columns) == (30, "auto", "lite", 250000, 2)


@pytest.mark.parametrize("case", ["short", "long", "stacked", "unknown"])
def test_parse_cli_equal(case):
    argv = {"short": ["-i", "a.yuv", "-b", "o.bin", "-o", "r.yuv", "-wdt",
                      "64", "-hgt", "48", "-q", "30", "-f", "3", "-fr", "25",
                      "-ip", "1"],
            "long": ["--QP=33", "--SAO=1", "--Frame1=P 1 0 0.4 0 0 0 1 1 -1"],
            "stacked": ["-c", "a.cfg", "-c", "b.cfg", "-q", "22", "--QP=27",
                        "-c", "c.cfg"],
            "unknown": ["-c", "a.cfg", "--nonsense"]}[case]
    if case == "unknown":
        for mod in (tconfig, jconfig):
            with pytest.raises(SystemExit, match="unknown option"):
                mod.parse_cli(argv)
        return
    assert tconfig.parse_cli(argv) == jconfig.parse_cli(argv)


@pytest.mark.parametrize("case", ["ra", "ldp", "unordered"])
def test_parse_gop_entries_equal(case):
    """HM's RA main table (GOP8_RA in both packages), its LD-P main table,
    and a table whose lines are out of POC order (coding order kept)."""
    text = {"ra": HM_RA_STRUCTURE, "ldp": HM_LDP_STRUCTURE,
            "unordered": "Frame1: B 4 1 0.5 0 0 0 1 2 -4 4 # c\n"
                         "Frame2: B 2 2 0.5 0 0 1 1 2 -2 2\n"
                         "Frame3: B 1 3 0.5 0 0 2 1 2 -1 1\n"
                         "Frame4: B 3 3 0.5 0 0 2 1 2 -1 1\n"}[case]
    got = tra.parse_gop_entries(text)
    want = jra.parse_gop_entries(text)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    if case == "ra":
        assert tuple(got) == tra.GOP8_RA
        assert tuple(want) == jra.GOP8_RA
    if case == "unordered":
        assert [e.poc for e in got] == [4, 2, 1, 3]


@pytest.mark.parametrize("frames,skip", [(None, 0), (3, 1), (9, 2)])
def test_yuv_io_and_psnr_equal(tmp_path, frames, skip):
    """write_frames / read_frames (a count past the file's end is cut to
    it) and psnr (inf on equal planes), against the JAX package's."""
    clip = bench_synth_clip(48, 32, 5)
    planes = [np.stack([f[c] for f in clip]) for c in range(3)]
    a, b = tmp_path / "a.yuv", tmp_path / "b.yuv"
    tyuv.write_frames(str(a), *[p.astype(np.int32) for p in planes])
    jyuv.write_frames(str(b), *planes)
    assert a.read_bytes() == b.read_bytes()
    assert a.stat().st_size == 5 * tyuv.frame_size_bytes(48, 32) == \
        5 * jyuv.frame_size_bytes(48, 32)
    got = tyuv.read_frames(str(a), 48, 32, frames, skip)
    want = jyuv.read_frames(str(a), 48, 32, frames, skip)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype == np.uint8
        np.testing.assert_array_equal(g, w_)
    n = got[0].shape[0]
    assert n == min(frames or 5 - skip, 5 - skip)
    noisy = np.clip(planes[0][skip:skip + n].astype(np.int32) + 3, 0, 255)
    for x, y in ((got[0], noisy), (got[0], got[0]), (got[1], got[2])):
        assert tyuv.psnr(x, y) == jyuv.psnr(x, y)
    assert tyuv.psnr(got[0], got[0]) == float("inf")


def _h264_stream():
    enc = th264.DeviceH264Encoder(48, 32, qp=28, search_range=8,
                                  device="cpu")
    return enc.encode_sequence(bench_synth_clip(48, 32, 2))[0]


def _hevc_stream():
    cfg = theaders.HevcConfig(width=48, height=32, qp=32)
    f = bench_synth_clip(48, 32, 1)
    return tic.IntraEncoder(cfg, device="cpu").encode_sequence(f)[0]


@pytest.mark.parametrize("case", ["hevc", "h264", "empty", "garbage"])
def test_sniff_codec_equal(case):
    stream = {"hevc": _hevc_stream, "h264": _h264_stream,
              "empty": lambda: b"",
              "garbage": lambda: b"\x00\x00\x01\x0b\x22\x33"}[case]()
    got = tanalyze.sniff_codec(stream)
    assert got == janalyze.sniff_codec(stream)
    if case in ("hevc", "h264"):
        assert got == case


# ---- the CLIs end to end --------------------------------------------------

_INTRA_CFG = ("SourceWidth : 64\nSourceHeight : 48\nFramesToBeEncoded : 2\n"
              "IntraPeriod : 1\nQP : 32\nRDOQ : 1\nSignHideFlag : 1\n"
              "SAO : 1\nMaxCUWidth : 64\n")


def _files(d, case):
    """The encoder CLI's arguments for a case, its files written into d."""
    d.mkdir()
    if case == "ra":
        return hm_cli_files(d, "ra", bench_synth_clip(80, 48, 9), 80, 48)
    from test_intra_codec import synth_frame
    n = 3 if case == "ldp" else 2
    w = 128 if case == "intra-tiles" else 64
    frames = [synth_frame(w, 48, s) for s in range(n)]
    src = d / "in.yuv"
    tyuv.write_frames(str(src), *(np.stack([f[c] for f in frames])
                                  for c in range(3)))
    cfg = d / "test.cfg"
    cfg.write_text(_CFG_TEXTS["apps"] if case == "ldp" else
                   _INTRA_CFG.replace("Width : 64", "Width : 128") +
                   "NumTileColumnsMinus1 : 1\n" if case == "intra-tiles"
                   else _INTRA_CFG)
    argv = ["-c", str(cfg), "-i", str(src), "-b", str(d / "out.bin"),
            "-o", str(d / "rec.yuv")]
    return argv + (["--fast=1"] if case == "intra-fast" else [])


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def _summary(text):
    """The SUMMARY lines without the time line."""
    return [ln for ln in text.splitlines() if "Total Time" not in ln]


@pytest.mark.parametrize("case", ["ldp", "ra", "intra", "intra-fast",
                                  "intra-tiles"])
def test_cli_matches_jax(tmp_path, monkeypatch, case):
    """Both encoder CLIs on the same files: the same stream, recon file,
    summary (but its time) and warnings; then both decoder CLIs.
    "intra-tiles": the all-intra cfg with two tile columns at 128x48."""
    if case == "ldp":
        monkeypatch.setattr(jmotion, "amvp_candidates",
                            tmotion.amvp_candidates)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jout, jerr = _run(jeapp.main, _files(jd, case))
    tout, terr = _run(teapp.main, _files(td, case) + ["--device=cpu"])
    stream = (td / "out.bin").read_bytes()
    assert stream == (jd / "out.bin").read_bytes()
    assert (td / "rec.yuv").read_bytes() == (jd / "rec.yuv").read_bytes()
    assert _summary(tout) == _summary(jout) and "SUMMARY" in tout
    assert terr == jerr
    n = {"ldp": 3, "ra": 9}.get(case, 2)
    argv = ["-b", str(td / "out.bin"), "-o", str(td / "dec.yuv")]
    tdec, _ = _run(tdapp.main, argv)
    assert tdec.count("(OK)") == n and f"{n} pictures decoded (hevc)" in tdec
    assert (td / "dec.yuv").read_bytes() == (td / "rec.yuv").read_bytes()
    jargv = ["-b", str(td / "out.bin"), "-o", str(jd / "dec.yuv")]
    jdec, _ = _run(jdapp.main, jargv)
    if case != "ra":
        assert tdec == jdec
        assert (jd / "dec.yuv").read_bytes() == (td / "dec.yuv").read_bytes()
        assert not tdapp._needs_general(stream)
        return
    # reference fault 10: the reference's decoder CLI takes
    # LowDelayDecoder(conceal=True) for the random-access stream
    assert "SAO on the hierarchical-B build not implemented" in terr
    assert tdapp._needs_general(stream)
    assert jdec.count("(OK)") == 1 and "5 pictures decoded (hevc)" in jdec
    assert (jd / "dec.yuv").stat().st_size == \
        5 * tyuv.frame_size_bytes(80, 48)


def test_cli_ldp_stream_is_a_prefix_of_the_host_run(tmp_path):
    """HM's LD-P main cfg through the port's CLI builds chip_smoke's
    `host_ldp_cfg` coder: its NAL units over 3 pictures are the first of
    that coder's stream over 5 (a picture is coded from the ones before
    it only), the gate of chip_smoke's `[cli-ldp]`."""
    from chip_smoke import host_ldp_cfg
    from video_codecs_tpu_torch.entropy import bitstream as tbs
    from video_codecs_tpu_torch.models.hevc import inter_codec as tpc
    frames = bench_synth_clip(64, 48, 5)
    _run(teapp.main, hm_cli_files(tmp_path, "ldp", frames[:3], 64, 48) +
         ["--device=cpu"])
    cfg = host_ldp_cfg()
    cfg.width, cfg.height = 64, 48
    host, _ = tpc.LowDelayEncoder(cfg, search_range=64, me_method="tz",
                                  device="cpu").encode_sequence_ldp(frames)
    nals = tbs.split_annexb((tmp_path / "out.bin").read_bytes())
    assert len(nals) == 9 and nals == tbs.split_annexb(host)[:9]


def test_encoder_app_needs_a_card(tmp_path, monkeypatch):
    """Without --device=cpu the encoder CLI runs on the card, and raises
    where there is none (before it reads a file)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        teapp.main(["-c", str(tmp_path / "absent.cfg")])


def test_decoder_app_stats_is_not_ported(tmp_path):
    """`--stats` (ported, utils/coding_stats.py): on an HEVC all-intra
    stream, which both CLIs decode with LowDelayDecoder, the port's
    report of bins per CABAC context class and its hash lines are the
    JAX CLI's (tests/test_torch_tools_rest.py: H.264 and LD-P)."""
    frames = bench_synth_clip(64, 48, 2)
    stream, _ = tic.IntraEncoder(theaders.HevcConfig(width=64, height=48),
                                 device="cpu").encode_sequence(frames)
    src = tmp_path / "ai.bin"
    src.write_bytes(stream)
    outs = []
    for main in (tdapp.main, jdapp.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["-b", str(src), "--stats"])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "sig_flag" in outs[0] and "POC    1 [(OK)]" in outs[0]


def test_cli_runs_as_module_without_jax(tmp_path):
    """`python -m video_codecs_tpu_torch.tools.encoder_app ... --device=cpu`
    and the decoder CLI in a process where `jax` and `video_codecs_tpu`
    cannot be imported: HM's LD-P main cfg at 48x32 over 2 pictures, every
    picture "(OK)", and nothing of either package loaded."""
    files = hm_cli_files(tmp_path, "ldp", bench_synth_clip(48, 32, 2), 48,
                         32)
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["video_codecs_tpu"] = None
        for mod, args in (
                ("encoder_app", {files + ['--device=cpu']!r}),
                ("decoder_app", ["-b", {str(tmp_path / 'out.bin')!r}])):
            sys.argv = [mod] + args
            runpy.run_module("video_codecs_tpu_torch.tools." + mod,
                             run_name="__main__")
        bad = [m for m in sys.modules
               if m in ("jax", "video_codecs_tpu")
               or m.startswith(("jax.", "video_codecs_tpu."))
               if sys.modules[m] is not None]
        assert not bad, bad
        """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "SUMMARY" in res.stdout
    assert res.stdout.count("(OK)") == 2
    assert "2 pictures decoded (hevc)" in res.stdout
