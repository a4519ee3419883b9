"""The port's own H.264 baseline host stack against the JAX package's.

The port carries a copy of the reference's host code (bit writer, CAVLC,
transforms, deblocking, MC, DPB, the baseline intra encoder and the IPPP
decoder) so that it imports nothing of `video_codecs_tpu`.  These tests
hold the copy to the original: source text function by function, then
bits, arrays, streams and decoded pictures on seeded inputs, with
tolerance 0.  Clips are at most 96x64.
"""

import ast
import pathlib
import re

import numpy as np
import pytest

from video_codecs_tpu.entropy import bitstream as jbs
from video_codecs_tpu.entropy import cavlc as jcavlc
from video_codecs_tpu.models.h264 import inter_codec as jinter
from video_codecs_tpu.models.h264 import intra_codec as jintra
from video_codecs_tpu.ops import h264_deblock as jdbk
from video_codecs_tpu.ops import h264_interp as jinterp
from video_codecs_tpu.ops import h264_transform as jht
from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.entropy import cavlc as tcavlc
from video_codecs_tpu_torch.models.h264 import inter_codec as tinter
from video_codecs_tpu_torch.models.h264 import intra_codec as tintra
from video_codecs_tpu_torch.models.h264 import inter_dev as tid
from video_codecs_tpu_torch.ops import h264_deblock as tdbk
from video_codecs_tpu_torch.ops import h264_interp as tinterp
from video_codecs_tpu_torch.ops import h264_transform as tht

REPO = pathlib.Path(__file__).resolve().parents[1]

# Port module -> the functions whose bodies the copy changed: the
# branches behind options the port rejects were cut from them.  Every
# other function and method kept must be the original's text exactly,
# its imports of the JAX package's modules read as imports of the
# port's (`_ported`).
_TRIMMED = {
    "entropy/bitstream.py": set(),
    "entropy/cavlc.py": set(),
    "entropy/h264_cabac.py": set(),
    "entropy/h264_ctx_data.py": set(),
    "ops/h264_transform.py": set(),
    "ops/h264_deblock.py": set(),
    "ops/h264_interp.py": set(),
    "ops/h264_rdoq.py": set(),
    "tools/misc.py": set(),
    "tools/jm_encoder_app.py": {"main"},
    "models/h264/dpb.py": set(),
    "models/h264/sei.py": set(),
    "tools/rtp.py": set(),
    "tools/h264_syntax.py": set(),
    "models/h264/intra_codec.py": {
        "H264IntraEncoder.__init__", "H264IntraEncoder._att_eta"},
    "models/h264/intra8.py": set(),
    "models/h264/bslice_codec.py": {
        "H264BEncoder.__init__", "H264BEncoder._encode_b_frame",
        "H264BEncoder._write_b_mb_cabac", "H264BDecoder.decode",
        "H264BDecoder._decode_b_slice", "H264BDecoder._decode_b_mbs_cabac"},
    "models/h264/inter_codec.py": {
        "H264Encoder.__init__",
        "H264Encoder._search", "H264Encoder._subpel_refine",
        "H264Encoder._search_epzs", "H264Encoder._search_umhex",
        "H264Encoder._encode_p_frame"},
    "utils/trace.py": set(),
    "utils/coding_stats.py": set(),
    "tools/convert.py": set(),
    "tools/experiment.py": {"main"},
}
# Functions only the port has.
_ADDED = {"models/h264/inter_codec.py": {"H264Encoder._card_stage"}}


def _ported(src):
    """The original's text with its imports of the JAX package's modules
    made imports of the port's."""
    return re.sub(r"\b(from|import) video_codecs_tpu\.",
                  r"\1 video_codecs_tpu_torch.", src)


def _defs(path):
    """Qualified name -> (first line incl. decorators, source text) of
    the module-level functions and the methods of module-level classes."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef):
            subs = [(f"{node.name}.{s.name}", s) for s in node.body
                    if isinstance(s, ast.FunctionDef)]
        elif isinstance(node, ast.FunctionDef):
            subs = [(node.name, node)]
        else:
            continue
        for name, fn in subs:
            first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
            out[name] = (first, ast.get_source_segment(text, fn))
    return out, text.split("\n")


@pytest.mark.parametrize("mod", sorted(_TRIMMED))
def test_copy_matches_original_source(mod):
    port, lines = _defs(REPO / "video_codecs_tpu_torch" / mod)
    orig, _ = _defs(REPO / "video_codecs_tpu" / mod)
    tag = re.compile(r"#\s*video_codecs_tpu/" + re.escape(mod) + r":(\d+)$")
    added = _ADDED.get(mod, set())
    assert added <= set(port)
    for name, (first, src) in port.items():
        if name in added:
            continue
        assert name in orig, f"{mod}: {name} has no original"
        m = tag.search(lines[first - 2].strip())
        assert m, f"{mod}: {name} lacks its provenance comment"
        assert int(m.group(1)) == orig[name][0], f"{mod}: {name} line"
        if name not in _TRIMMED[mod]:
            assert src == _ported(orig[name][1]), f"{mod}: {name} differs"
    assert _TRIMMED[mod] <= set(port)


# ---- rows 1-6: bit I/O, CAVLC, transforms, deblocking, MC -------------

def _bit_ops(seed, n=400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        if k == 0:
            nb = int(rng.integers(1, 25))
            ops.append(("write", int(rng.integers(0, 1 << nb)), nb))
        elif k == 1:
            ops.append(("ue", int(rng.integers(0, 70000))))
        elif k == 2:
            ops.append(("se", int(rng.integers(-40000, 40000))))
        else:
            ops.append(("flag", int(rng.integers(0, 2))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitwriter_reader_roundtrip_equal(seed):
    ops = _bit_ops(seed)
    ws = [tbs.BitWriter(), jbs.BitWriter()]
    for w in ws:
        for op, *args in ops:
            getattr(w, op)(*args)
        w.rbsp_trailing_bits()
    assert ws[0].data() == ws[1].data()
    assert ws[0].num_bits() == ws[1].num_bits()
    r = tbs.BitReader(ws[0].data())
    for op, *args in ops:
        got = r.read(args[1]) if op == "write" else getattr(r, op)()
        assert got == args[0], op
    assert not r.more_rbsp_data()


@pytest.mark.parametrize("seed", [3, 4])
def test_emulation_prevention_and_annexb_equal(seed):
    rng = np.random.default_rng(seed)
    rbsps = [bytes(np.where(rng.random(300) < 0.6, 0,
                            rng.integers(0, 4, 300)).astype(np.uint8)) + b"\x80"
             for _ in range(4)]
    for rb in rbsps:
        ebsp = tbs.insert_emulation_prevention(rb)
        assert ebsp == jbs.insert_emulation_prevention(rb)
        assert tbs.strip_emulation_prevention(ebsp) == rb
        assert tbs.nal_unit(1, rb) == jbs.nal_unit(1, rb)
        assert tintra.nal_unit(5, rb) == jintra.nal_unit(5, rb)
    nals = [tintra.nal_unit(1, rb) for rb in rbsps]
    stream = tintra.annexb(nals)
    assert stream == jintra.annexb(nals) == tbs.annexb(nals)
    assert tbs.split_annexb(stream) == jbs.split_annexb(stream) == nals


def _cavlc_blocks(seed, max_coeffs, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dens = (i % 6 + 1) / 6
        mag = [1, 2, 3, 8, 40, 3000][i % 6]
        c = rng.integers(-mag, mag + 1, max_coeffs)
        c[rng.random(max_coeffs) > dens] = 0
        out.append([int(v) for v in c])
    out.append([0] * max_coeffs)
    return out


@pytest.mark.parametrize("nc,max_coeffs", [
    (0, 16), (1, 16), (2, 16), (3, 15), (4, 16), (7, 15), (8, 16),
    (16, 16), (-1, 4)])
def test_cavlc_bits_equal_every_nc_class(nc, max_coeffs):
    blocks = _cavlc_blocks(nc + 10 * max_coeffs, max_coeffs)
    wt, wj = tbs.BitWriter(), jbs.BitWriter()
    for blk in blocks:
        assert tcavlc.encode_block(wt, blk, nc, max_coeffs) == \
            jcavlc.encode_block(wj, blk, nc, max_coeffs)
    wt.rbsp_trailing_bits()
    wj.rbsp_trailing_bits()
    assert wt.data() == wj.data()
    r = tbs.BitReader(wt.data())
    for blk in blocks:
        assert tcavlc.decode_block(r, nc, max_coeffs) == blk
    np.testing.assert_array_equal(tcavlc.ZIGZAG_4x4, jcavlc.ZIGZAG_4x4)


@pytest.mark.parametrize("qp", [0, 11, 22, 28, 36, 51])
def test_transform_and_quant_equal(qp):
    rng = np.random.default_rng(qp)
    res = rng.integers(-255, 256, (8, 4, 4))
    for fn in ("forward4x4", "hadamard4x4", "fwd_hadamard4x4_dc"):
        np.testing.assert_array_equal(getattr(tht, fn)(res),
                                      getattr(jht, fn)(res), err_msg=fn)
    w = tht.forward4x4(res)
    for intra in (True, False):
        np.testing.assert_array_equal(tht.quant_ac(w, qp, intra),
                                      jht.quant_ac(w, qp, intra))
        np.testing.assert_array_equal(
            tht.quant_luma_dc(w[:, 0], qp, intra),
            jht.quant_luma_dc(w[:, 0], qp, intra))
        np.testing.assert_array_equal(
            tht.quant_chroma_dc(w[:, :2, :2], qp, intra),
            jht.quant_chroma_dc(w[:, :2, :2], qp, intra))
    lv = rng.integers(-30, 31, (8, 4, 4))
    np.testing.assert_array_equal(tht.dequant_ac(lv, qp),
                                  jht.dequant_ac(lv, qp))
    np.testing.assert_array_equal(tht.inverse4x4(lv * 64),
                                  jht.inverse4x4(lv * 64))
    np.testing.assert_array_equal(tht.dequant_luma_dc(lv[0], qp),
                                  jht.dequant_luma_dc(lv[0], qp))
    np.testing.assert_array_equal(tht.dequant_chroma_dc(lv[0, :2, :2], qp),
                                  jht.dequant_chroma_dc(lv[0, :2, :2], qp))
    np.testing.assert_array_equal(tht.CHROMA_QP, jht.CHROMA_QP)


@pytest.mark.parametrize("qp,aoff,boff", [(22, 0, 0), (30, 2, -2),
                                          (40, -4, 4)])
def test_deblock_equal(qp, aoff, boff):
    rng = np.random.default_rng(qp)
    h, w = 32, 48
    y = rng.integers(60, 200, (h, w)).astype(np.int32)
    u = rng.integers(60, 200, (h // 2, w // 2)).astype(np.int32)
    v = rng.integers(60, 200, (h // 2, w // 2)).astype(np.int32)
    bs_ver = rng.integers(0, 5, (h // 4, w // 4)).astype(np.int32)
    bs_hor = rng.integers(0, 5, (h // 4, w // 4)).astype(np.int32)
    qpc = int(tht.CHROMA_QP[qp])
    got = tdbk.deblock_frame(y, u, v, qp, qpc, bs_ver, bs_hor, aoff, boff)
    want = jdbk.deblock_frame(y, u, v, qp, qpc, bs_ver, bs_hor, aoff, boff)
    got_i = tdbk.deblock_frame_intra(y, u, v, qp, qpc, aoff, boff)
    want_i = jdbk.deblock_frame_intra(y, u, v, qp, qpc, aoff, boff)
    for a, b in zip(got + got_i, want + want_i):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,h", [(16, 16), (8, 8), (8, 4), (4, 4)])
def test_mc_equal_every_fraction(w, h):
    rng = np.random.default_rng(w * h)
    ref = rng.integers(0, 256, (32, 48)).astype(np.int32)
    refc = rng.integers(0, 256, (16, 24)).astype(np.int32)
    for mvx in range(-70, 70, 5):
        for mvy in (-41, -3, -2, -1, 0, 1, 2, 3, 37):
            for x, y in ((0, 0), (32, 16)):
                np.testing.assert_array_equal(
                    tinterp.mc_luma_np(ref, x, y, mvx, mvy, w, h),
                    jinterp.mc_luma_np(ref, x, y, mvx, mvy, w, h))
                np.testing.assert_array_equal(
                    tinterp.mc_chroma_np(refc, x // 2, y // 2, mvx, mvy,
                                         w // 2, h // 2),
                    jinterp.mc_chroma_np(refc, x // 2, y // 2, mvx, mvy,
                                         w // 2, h // 2))


# ---- row 7: the IDR encoder and the intra decoder ----------------------

def _texture(w, h, seed):
    """Seeded picture with flat, smooth, striped and noisy regions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 90 + 60 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    y[:, w // 2:] += rng.normal(0, 25, (h, w - w // 2))
    y[h // 2:, :w // 3] = 128
    y[:h // 2, :w // 3] = np.where(((xx + yy) // 3) % 2, 40, 200)[
        :h // 2, :w // 3]
    y = np.clip(y, 0, 255).astype(np.uint8)
    return y, (y[::2, ::2] // 2 + 64).astype(np.uint8), \
        (y[1::2, ::2] // 2 + 32).astype(np.uint8)


def _planes_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(a[c], np.int32), np.asarray(b[c], np.int32),
                err_msg=f"picture {i} plane {c}")


@pytest.mark.parametrize("w,h", [(48, 32), (96, 64)])
@pytest.mark.parametrize("qp", [22, 28, 36])
def test_idr_byte_equal_to_jax(w, h, qp):
    frames = [_texture(w, h, seed=qp), _texture(w, h, seed=qp + 1)]
    tenc = tintra.H264IntraEncoder(w, h, qp=qp)
    st, rt = tenc.encode_sequence(frames)
    sj, rj = jintra.H264IntraEncoder(w, h, qp=qp).encode_sequence(frames)
    assert st == sj
    _planes_equal(rt, rj)
    _planes_equal(tintra.H264IntraDecoder().decode(st), rj)


@pytest.mark.parametrize("qp", [0, 4, 8])
def test_idr_i4_byte_equal_to_jax(qp):
    """The encoder's cost picks I_4x4 only at low QP (its rate term
    charges 4 bits a block for a mode that is not the predicted one)."""
    frames = [_texture(96, 64, seed=qp)]
    tenc = tintra.H264IntraEncoder(96, 64, qp=qp)
    st, rt = tenc.encode_sequence(frames)
    sj, rj = jintra.H264IntraEncoder(96, 64, qp=qp).encode_sequence(frames)
    assert st == sj
    assert 0 < int(tenc._is_i4.sum()) < tenc._is_i4.size
    _planes_equal(tintra.H264IntraDecoder().decode(st), rj)


@pytest.mark.parametrize("qp", [22, 36])
def test_intra_decoder_reads_jax_all_i4_stream(qp):
    frames = [_texture(48, 32, seed=qp)]
    enc = jintra.H264IntraEncoder(48, 32, qp=qp)
    enc.force_i4 = True                   # every MB I_4x4
    stream, recons = enc.encode_sequence(frames)
    assert int(enc._is_i4.sum()) == enc._is_i4.size
    _planes_equal(tintra.H264IntraDecoder().decode(stream), recons)


# ---- row 8: the IPPP decoder -------------------------------------------

def _partition_clip(w, h, nf, seed):
    """Smooth texture; each MB of a P picture moves whole, in two
    horizontal or vertical halves, or in four quadrants, and one MB row
    is new content, so P_16x16, P_16x8, P_8x16, P_8x8, P_Skip and intra
    MBs all win somewhere."""
    rng = np.random.default_rng(seed)
    pad = 24
    base = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad)).astype(float)
    k = np.array([1, 4, 6, 4, 1.0]) / 16
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, "same")
    halves = {0: [(0, 0, 16, 16)], 1: [(0, 0, 16, 8), (0, 8, 16, 8)],
              2: [(0, 0, 8, 16), (8, 0, 8, 16)],
              3: [(0, 0, 8, 8), (8, 0, 8, 8), (0, 8, 8, 8), (8, 8, 8, 8)]}
    frames = []
    for f in range(nf):
        y = base[pad:pad + h, pad:pad + w].copy()
        if f:
            for my in range(0, h, 16):
                for mx in range(0, w, 16):
                    kind = int(rng.integers(0, 5))
                    if kind == 4:
                        continue                     # static: P_Skip
                    for ox, oy, pw, ph in halves[kind]:
                        d = rng.integers(-6, 7, 2)
                        sy, sx = pad + my + oy + d[1], pad + mx + ox + d[0]
                        y[my + oy:my + oy + ph, mx + ox:mx + ox + pw] = \
                            base[sy:sy + ph, sx:sx + pw]
            y[16:32, :] = rng.integers(0, 256, (16, w))  # new content
        y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255).astype(np.uint8)
        frames.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                       (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return frames


def test_decoder_reads_jax_streams_all_partitions(monkeypatch):
    frames = _partition_clip(96, 64, 3, seed=5)
    stream, recons = jinter.H264Encoder(
        96, 64, qp=26, search_range=8).encode_sequence(frames)
    seen = set()
    parse = tinter.H264Decoder._parse_p_parts_cavlc
    pred = tinter.mv_pred_part

    def parse_rec(self, r, mb_type, *a):
        seen.add(mb_type)
        return parse(self, r, mb_type, *a)

    def pred_rec(mvg, refg, dec4, gx, gy, pw4, ph4, *a):
        if (pw4, ph4) == (4, 4):
            seen.add(0)
        return pred(mvg, refg, dec4, gx, gy, pw4, ph4, *a)

    i4 = tintra.H264IntraDecoder._decode_i4_mb
    i16 = tintra.H264IntraDecoder._decode_i16_mb

    def i4_rec(self, *a):
        seen.add("I4")
        return i4(self, *a)

    def i16_rec(self, *a):
        seen.add("I16")
        return i16(self, *a)

    monkeypatch.setattr(tinter.H264Decoder, "_parse_p_parts_cavlc",
                        parse_rec)
    monkeypatch.setattr(tinter, "mv_pred_part", pred_rec)
    monkeypatch.setattr(tinter.H264Decoder, "_decode_i4_mb", i4_rec)
    monkeypatch.setattr(tinter.H264Decoder, "_decode_i16_mb", i16_rec)
    got = tinter.H264Decoder().decode(stream)
    _planes_equal(got, jinter.H264Decoder().decode(stream))
    _planes_equal(got, recons)
    assert {0, 1, 2, 3} <= seen, seen       # all four P partition types
    assert seen & {"I4", "I16"}, seen       # intra MBs


@pytest.mark.parametrize("gop", [0, 2])
def test_decoder_reads_port_device_streams(gop):
    frames = _partition_clip(64, 48, 4, seed=gop + 7)
    enc = tid.DeviceH264Encoder(64, 48, qp=30, search_range=8, gop=gop,
                                device="cpu")
    stream, recons = enc.encode_sequence(frames)
    got = tinter.H264Decoder().decode(stream)
    _planes_equal(got, jinter.H264Decoder().decode(stream))
    _planes_equal(got, recons)


@pytest.mark.parametrize("opt", [
    dict(entropy="cabac"), dict(quant="trellis"), dict(quant="around"),
    dict(perceptual="att"), dict(perceptual="ssim"),
    dict(transform8x8=True), dict(n_refs=2), dict(me="epzs"),
    dict(me="umhex"), dict(weighted_pred=True), dict(partitions=False),
    dict(long_term=True), dict(lt_period=2), dict(reorder="lt_first"),
    dict(intra_refresh=4)])
def test_cut_options_raise(opt):
    with pytest.raises(NotImplementedError):
        tid.DeviceH264Encoder(32, 32, device="cpu", **opt)


@pytest.mark.parametrize("opt", [dict(weighted_pred=True),
                                 dict(transform8x8=True),
                                 dict(long_term=True)])
def test_decoder_rejects_cut_stream_features(opt):
    """Weighted prediction, the 8x8 transform (High profile) and the
    long-term IDR, which the port's decoder once refused, decode to the
    JAX decoder's and the encoder's pictures; a decoder that conceals
    finds nothing to conceal in the clean stream."""
    frames = _partition_clip(32, 32, 2, seed=1)
    stream, recons = jinter.H264Encoder(32, 32, qp=30, search_range=4,
                                        **opt).encode_sequence(frames)
    got = tinter.H264Decoder().decode(stream)
    _planes_equal(got, jinter.H264Decoder().decode(stream))
    _planes_equal(got, recons)
    dec = tinter.H264Decoder(conceal=1)
    _planes_equal(dec.decode(stream), recons)
    assert dec.concealed == []
