"""The H.264 SEI messages, the RTP tools, the full syntax parsers, the
bitstream analyzer and the quality metrics in the port, against the JAX
package's, on the CPU.

SEI payloads, RTP packets and dump files, `h264_syntax` dicts and
`analyze` rows (and both CLIs' output) are equal; the metrics, float32
convolutions in a different summation order on each side, agree within
the tolerances below.  The last test runs the lossy-network chain of
chip_smoke's `[h264-loss]` at 64x48: an intra-refresh stream with an SEI
NAL, RTP packets, the reference's deterministic loss, and both
concealment modes, whose `concealed` lists and pictures must be the JAX
decoders'.
"""

import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

from video_codecs_tpu.entropy import bitstream as jbs
from video_codecs_tpu.models.h264 import inter_codec as jinter
from video_codecs_tpu.models.h264 import intra_codec as jintra
from video_codecs_tpu.models.h264 import sei as jsei
from video_codecs_tpu.ops import metrics as jmetrics
from video_codecs_tpu.tools import analyze as janalyze
from video_codecs_tpu.tools import h264_syntax as jsyn
from video_codecs_tpu.tools import rtp as jrtp
from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.models.h264 import inter_codec as tinter
from video_codecs_tpu_torch.models.h264 import intra_codec as tintra
from video_codecs_tpu_torch.models.h264 import sei as tsei
from video_codecs_tpu_torch.models.hevc import headers as thdr
from video_codecs_tpu_torch.models.hevc import intra_codec as thevc
from video_codecs_tpu_torch.ops import metrics as tmetrics
from video_codecs_tpu_torch.tools import analyze as tanalyze
from video_codecs_tpu_torch.tools import h264_syntax as tsyn
from video_codecs_tpu_torch.tools import rtp as trtp

torch.set_grad_enabled(False)

#: |port - JAX| of ssim, ssim3d, stvssim and the saliency map: float32
#: maps, a few ulps apart (measured up to 1.3e-6)
METRIC_ATOL = 1e-5
#: ms_ssim's coarsest scales are 3x3 to 6x6 pictures, where the
#: variance's cancellation (E[x^2] - E[x]^2 of 8-bit samples in float32)
#: magnifies the convolutions' rounding (measured up to 1.2e-5)
MS_SSIM_ATOL = 5e-5
#: the per-MB lambda weights (tests/test_torch_h264_conf.py)
ETA_ATOL = 1e-5


def smooth(w, h, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 8, w + 8)).astype(float)
    k = np.array([1, 4, 6, 4, 1.0]) / 16
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, "same")
    y = base[4:4 + h, 4:4 + w] + rng.normal(0, noise, (h, w))
    return np.clip(y, 0, 255).astype(np.uint8)


def frames_of(w, h, n, seed):
    out = []
    for t in range(n):
        y = np.roll(smooth(w + 16, h + 16, seed), (t, 2 * t), (0, 1))[
            8:8 + h, 8:8 + w]
        out.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                    (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return out


# ---- SEI ----------------------------------------------------------------------

def _messages(mod):
    return [
        mod.BufferingPeriod(sps_id=0, initial_cpb_removal_delay=45000,
                            initial_cpb_removal_delay_offset=7),
        mod.PicTiming(cpb_removal_delay=12, dpb_output_delay=2,
                      pic_struct=0),
        mod.UserDataUnregistered(uuid=bytes(range(16)), data=b"vct-h264"),
        mod.UserDataRegistered(country_code=0xB5, data=b"\x00\x31abc"),
        mod.UserDataRegistered(country_code=0xFF, data=b"ext"),
        mod.RecoveryPoint(recovery_frame_cnt=4, exact_match=False,
                          broken_link=True, changing_slice_group_idc=0),
        mod.SceneInfo(scene_id=3, scene_transition_type=1),
        mod.SceneInfo(scene_id=3, scene_transition_type=5,
                      second_scene_id=9),
        mod.SceneInfo(scene_info_present=False),
        mod.FullFrameFreeze(full_frame_freeze_repetition_period=2),
        mod.FramePacking(arrangement_id=1, arrangement_type=3,
                         content_interpretation=2, repetition_period=1),
        mod.FramePacking(arrangement_id=2, cancel=True),
    ]


def _plain(msgs):
    return [(type(m).__name__, dataclasses.asdict(m))
            if dataclasses.is_dataclass(m) else m for m in msgs]


@pytest.mark.parametrize("i", range(12))
def test_sei_message_equal_both_ways(i):
    """One message: the payload bytes equal, each package parses the
    other's bytes back to the message."""
    mt, mj = _messages(tsei)[i], _messages(jsei)[i]
    rt, rj = tsei.write_sei_rbsp([mt]), jsei.write_sei_rbsp([mj])
    assert rt == rj
    assert tsei.parse_sei_rbsp(rj) == [mt]
    assert _plain(jsei.parse_sei_rbsp(rt)) == _plain([mt])
    assert tsei.sei_nal([mt]) == jsei.sei_nal([mj])


def test_sei_multi_unknown_and_long_payload_equal():
    """All messages in one NAL, an unknown type kept as raw bytes, and a
    user-data payload longer than 255 bytes (ff-escaped size)."""
    mt, mj = _messages(tsei), _messages(jsei)
    assert tsei.write_sei_rbsp(mt) == jsei.write_sei_rbsp(mj)
    assert tsei.parse_sei_rbsp(tsei.write_sei_rbsp(mt)) == mt
    rbsp = bytes([200, 2, 0xAA, 0xBB]) + b"\x80"
    assert tsei.parse_sei_rbsp(rbsp) == jsei.parse_sei_rbsp(rbsp) == \
        [(200, b"\xaa\xbb")]
    big_t = tsei.UserDataUnregistered(bytes(16), bytes(range(256)) * 2)
    big_j = jsei.UserDataUnregistered(bytes(16), bytes(range(256)) * 2)
    rb = tsei.write_sei_rbsp([big_t])
    assert rb == jsei.write_sei_rbsp([big_j])
    assert tsei.parse_sei_rbsp(rb) == [big_t]


# ---- RTP ----------------------------------------------------------------------

def _stream(n=4, **kw):
    frames = frames_of(64, 48, n, seed=1)
    return tinter.H264Encoder(64, 48, qp=30, search_range=8, device="cpu",
                              **kw).encode_sequence(frames)


@pytest.mark.parametrize("loss,keep", [(0, 0), (20, 3), (50, 1), (100, 3)])
def test_rtp_packets_dump_and_loss_equal(loss, keep, tmp_path):
    stream, _ = _stream()
    pt, pj = trtp.packetize(stream), jrtp.packetize(stream)
    assert pt == pj
    trtp.write_dump(str(tmp_path / "t.rtp"), pt)
    jrtp.write_dump(str(tmp_path / "j.rtp"), pj)
    assert (tmp_path / "t.rtp").read_bytes() == \
        (tmp_path / "j.rtp").read_bytes()
    back = trtp.read_dump(str(tmp_path / "j.rtp"))
    assert back == jrtp.read_dump(str(tmp_path / "t.rtp")) == pt
    assert trtp.depacketize(back) == jrtp.depacketize(back) == stream
    assert trtp.dump_table(back) == jrtp.dump_table(back)
    lt, lj = trtp.inject_loss(pt, loss, keep), jrtp.inject_loss(pj, loss,
                                                                keep)
    assert lt == lj
    assert trtp.depacketize(lt) == jrtp.depacketize(lj)


def _main_out(mod, argv):
    """What `mod.main()` prints for `argv`, and the error it raised."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = argv
    err = None
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    except Exception as e:           # compared, not hidden
        err = f"{type(e).__name__}: {e}"
    finally:
        sys.argv = old
    return out.getvalue(), err


def test_rtp_cli_equal(tmp_path):
    """`packetize`, `loss` and `dump` through both CLIs: files and
    printed lines equal."""
    stream, _ = _stream(n=3)
    (tmp_path / "s.264").write_bytes(stream)
    outs = {}
    for name, mod in (("t", trtp), ("j", jrtp)):
        d = tmp_path / name
        d.mkdir()
        got = [_main_out(mod, ["rtp", "packetize", str(tmp_path / "s.264"),
                               str(d / "a.rtp")]),
               _main_out(mod, ["rtp", "loss", str(d / "a.rtp"),
                               str(d / "b.rtp"), "50", "1"]),
               _main_out(mod, ["rtp", "dump", str(d / "b.rtp")])]
        assert all(e is None for _, e in got)
        outs[name] = ([g.replace(str(d), "D") for g, _ in got],
                      (d / "a.rtp").read_bytes(), (d / "b.rtp").read_bytes())
    assert outs["t"] == outs["j"]
    assert "kept" in outs["t"][0][1]


# ---- h264_syntax and the analyzer ------------------------------------------------

@pytest.fixture(scope="module")
def streams():
    """H.264 streams with every header feature the port writes: long-term
    IDR, MMCO, reordering, WP tables, CABAC and High profile; an SEI NAL
    after the PPS of the first."""
    ltr, _ = _stream(n=5, n_refs=2, long_term=True, lt_period=2,
                     reorder="lt_first")
    nals = tbs.split_annexb(ltr)
    sei = tsei.sei_nal(_messages(tsei))
    ltr = tintra.annexb(nals[:2] + [sei] + nals[2:])
    wp, _ = _stream(n=3, entropy="cabac", n_refs=2, weighted_pred=True)
    high, _ = _stream(n=3, entropy="cabac", transform8x8=True)
    return {"ltr": ltr, "wp": wp, "high": high}


@pytest.mark.parametrize("name", ["ltr", "wp", "high"])
def test_h264_syntax_dicts_equal(name, streams):
    """Every NAL of the stream through the full parsers: SPS, PPS and
    slice-header dicts (reordering, pred_weight_table,
    dec_ref_pic_marking) equal."""
    stream = streams[name]
    sps_t, pps_t, sps_j, pps_j = {}, {}, {}, {}
    seen = set()
    for nal in tbs.split_annexb(stream):
        t, ref_idc = nal[0] & 0x1F, nal[0] >> 5
        rbsp = tbs.strip_emulation_prevention(nal[1:])
        if t == 7:
            a, b = tsyn.parse_sps_full(rbsp), jsyn.parse_sps_full(rbsp)
            sps_t[a["seq_parameter_set_id"]] = a
            sps_j[b["seq_parameter_set_id"]] = b
        elif t == 8:
            a, b = tsyn.parse_pps_full(rbsp), jsyn.parse_pps_full(rbsp)
            pps_t[a["pic_parameter_set_id"]] = a
            pps_j[b["pic_parameter_set_id"]] = b
        elif t in (1, 5):
            a = tsyn.parse_slice_header_full(rbsp, t, ref_idc, sps_t, pps_t)
            b = jsyn.parse_slice_header_full(rbsp, t, ref_idc, sps_j, pps_j)
            seen.update(k for k in a if k in ("reorder_l0",
                                               "pred_weight_table"))
            if "mmco" in a.get("dec_ref_pic_marking", {}):
                seen.add("mmco")
        else:
            continue
        assert a == b, t
    want = {"ltr": {"reorder_l0", "mmco"}, "wp": {"pred_weight_table"},
            "high": set()}[name]
    assert want <= seen


def test_avcc_roundtrip():
    """tests/test_h264_sei.py's twin: the avcC record built and parsed
    again, equal to the JAX package's."""
    sps = tintra.nal_unit(tintra.NAL_SPS, tintra.write_sps(6, 5), ref_idc=3)
    pps = tintra.nal_unit(tintra.NAL_PPS, tintra.write_pps(), ref_idc=3)
    rec = tsyn.write_avcc(sps, pps)
    assert rec == jsyn.write_avcc(sps, pps)
    parsed = tsyn.parse_avcc(rec)
    assert parsed == jsyn.parse_avcc(rec)
    assert parsed["configurationVersion"] == 1
    assert parsed["lengthSizeMinusOne"] == 3
    assert parsed["sps"][0]["width"] == 96
    assert parsed["annexb"].startswith(b"\x00\x00\x00\x01")
    assert sps in parsed["annexb"] and pps in parsed["annexb"]


def _hevc_stream():
    cfg = thdr.HevcConfig(width=64, height=48, qp=32)
    enc = thevc.IntraEncoder(cfg, device="cpu")
    f = frames_of(64, 48, 2, seed=4)
    stream, _ = enc.encode_sequence(f)
    return stream


@pytest.mark.parametrize("name,verbose", [
    ("ltr", False), ("ltr", True), ("wp", False), ("wp", True),
    ("high", False), ("hevc", False), ("hevc", True)])
def test_analyze_rows_equal(name, verbose, streams):
    """`analyze` on H.264 streams (the MMCO, reordering, long-term and WP
    fields the short rows report) and on an HEVC stream: rows equal."""
    stream = _hevc_stream() if name == "hevc" else streams[name]
    rows = tanalyze.analyze(stream, verbose=verbose)
    assert rows == janalyze.analyze(stream, verbose=verbose)
    assert not any("note" in r for r in rows), rows
    if name == "ltr" and not verbose:
        slices = [r for r in rows if r["type"] in (1, 5)]
        assert [("reorder_l0" in r, "mmco" in r) for r in slices] == \
            [(False, False), (True, False), (True, True), (True, False),
             (True, True)]
        sei = next(r for r in rows if r["type"] == 6)
        assert "RecoveryPoint" in sei["messages"]


@pytest.mark.parametrize("flags", [[], ["-v"], ["--json"],
                                   ["--codec", "h264", "-v", "--json"]])
def test_analyze_cli_equal(flags, tmp_path, streams):
    """Both CLIs print the same lines.  With -v and --json both stop at
    the SEI NAL's user data, bytes that json.dumps refuses: the
    reference's behaviour, kept."""
    p = tmp_path / "s.264"
    p.write_bytes(streams["ltr"])
    argv = ["analyze", str(p)] + flags
    got = _main_out(tanalyze, argv)
    assert got == _main_out(janalyze, argv)
    assert (got[1] is not None) == ("-v" in flags and "--json" in flags)


# ---- metrics ----------------------------------------------------------------------

def _pairs():
    out = []
    for seed, (w, h) in enumerate(((64, 48), (96, 96), (96, 64))):
        a = smooth(w, h, seed)
        rng = np.random.default_rng(seed + 50)
        b = np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8)
        out.append((a, b))
    return out


@pytest.mark.parametrize("k", range(3))
def test_ssim_family_equal(k):
    a, b = _pairs()[k]
    st, sj = np.stack([a, b, a, b]), np.stack([b, a, b, a])
    np.testing.assert_allclose(
        tmetrics.ssim_map(a, b, device="cpu").numpy(),
        np.asarray(jmetrics.ssim_map(a, b)), rtol=0, atol=METRIC_ATOL)
    for win in (8, 4):
        assert abs(tmetrics.ssim(a, b, win, device="cpu") -
                   jmetrics.ssim(a, b, win)) < METRIC_ATOL
    assert abs(tmetrics.ms_ssim(a, b, device="cpu") -
               jmetrics.ms_ssim(a, b)) < MS_SSIM_ATOL
    assert abs(tmetrics.ssim3d(st, sj, device="cpu") -
               jmetrics.ssim3d(st, sj)) < METRIC_ATOL
    assert abs(tmetrics.stvssim(st, sj, device="cpu") -
               jmetrics.stvssim(st, sj)) < METRIC_ATOL
    assert abs(tmetrics.ssim(a, a, device="cpu") - 1.0) < METRIC_ATOL


def test_metric_kernels_equal():
    np.testing.assert_array_equal(tmetrics._oriented_kernels(),
                                  jmetrics._oriented_kernels())
    np.testing.assert_array_equal(tmetrics._gabor_bank(),
                                  jmetrics._gabor_bank())


@pytest.mark.parametrize("k", range(3))
def test_saliency_and_lambda_weights_equal(k):
    """The saliency map without and with the motion term, and eta from
    the JAX map and from the port's: within METRIC_ATOL and ETA_ATOL."""
    a, b = _pairs()[k]
    for prev in (None, b):
        st = tmetrics.saliency_map(a, prev, device="cpu")
        sj = jmetrics.saliency_map(a, prev)
        assert st.dtype == torch.float32 and st.shape == a.shape
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                                   atol=METRIC_ATOL)
        ej = np.asarray(jmetrics.attention_lambda_weights(sj, 16))
        et = tmetrics.attention_lambda_weights(st, 16).numpy()
        np.testing.assert_allclose(et, ej, rtol=0, atol=ETA_ATOL)
        # the same map in: the block sums are XLA's, in XLA's order
        e2 = tmetrics.attention_lambda_weights(
            torch.from_numpy(np.array(sj)), 16).numpy()
        np.testing.assert_allclose(e2, ej, rtol=0, atol=ETA_ATOL)


# ---- the lossy-network chain ----------------------------------------------------------

def test_sei_rtp_loss_conceal_chain_equal():
    """chip_smoke's [h264-loss] at 64x48: 12 pictures with one MB row of
    intra refresh a picture, CAVLC; a recovery-point + user-data SEI
    after the PPS; RTP packets; 20 % loss after the first 3 packets (the
    reference's fixed LCG drops packet 13, picture 10); both concealment
    modes against the JAX decoders."""
    frames = frames_of(64, 48, 12, seed=6)
    stream, recons = tinter.H264Encoder(
        64, 48, qp=28, search_range=8, entropy="cavlc", intra_refresh=4,
        device="cpu").encode_sequence(frames)
    nals = tbs.split_annexb(stream)
    msgs = [tsei.RecoveryPoint(recovery_frame_cnt=3),
            tsei.UserDataUnregistered(bytes(range(16)), b"h264-loss")]
    full = tintra.annexb(nals[:2] + [tsei.sei_nal(msgs)] + nals[2:])
    pkts = trtp.packetize(full)
    lossy = trtp.depacketize(trtp.inject_loss(pkts, 20, keep_leading=3))
    assert len(pkts) == 15 and len(tbs.split_annexb(lossy)) == 14
    for mode in (1, 2):
        dt, dj = tinter.H264Decoder(conceal=mode), jinter.H264Decoder(
            conceal=mode)
        ot, oj = dt.decode(lossy), dj.decode(lossy)
        assert dt.concealed == dj.concealed == [10]
        assert len(ot) == len(oj) == 12
        for i, (a, b) in enumerate(zip(ot, oj)):
            for c in range(3):
                np.testing.assert_array_equal(
                    np.asarray(a[c], np.int32), np.asarray(b[c], np.int32),
                    err_msg=f"mode {mode} picture {i} plane {c}")
        for i in range(10):
            np.testing.assert_array_equal(ot[i][0], recons[i][0])
    rows = tanalyze.analyze(full)
    assert rows == janalyze.analyze(full)
    assert jbs.split_annexb(full) == tbs.split_annexb(full)
    assert [type(m).__name__ for m in tsei.parse_sei_rbsp(
        tbs.strip_emulation_prevention(tbs.split_annexb(full)[2][1:]))] \
        == ["RecoveryPoint", "UserDataUnregistered"]
    assert jintra.nal_unit(6, b"\x80") == tintra.nal_unit(6, b"\x80")
