"""The reference's H.264 Main-profile host coder and its JM encoder CLI in
the port, against the JAX package's, on the CPU.

Covers the copied CABAC engine (every syntax element, both ways), the
trellis and adaptive-rounding quantizers, the card stage of the host P
coder (`models/h264/host_me.py`: the SAD surfaces and the quarter-pel
phase planes) against the reference's per-call numpy values, whole IPPP
streams of `H264Encoder` over CAVLC / CABAC, full / EPZS / UMHex search,
hard / trellis / adaptive-rounding quantization, 1 and 3 references and
an IDR period, decoded by both packages' decoders, and the JM encoder
CLI run in process on a seeded YUV file.  Clips are at most 64x48,
search range 8; tolerance 0 everywhere.

The `cuda` cases hold the card stage and a whole stream on the card to
the CPU's.  They run where JAX is not installed, so JAX is imported only
inside the tests that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_h264_main.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.entropy import h264_cabac as thc
from video_codecs_tpu_torch.entropy import h264_ctx_data as ttab
from video_codecs_tpu_torch.models.h264 import host_me
from video_codecs_tpu_torch.models.h264 import inter_codec as tinter
from video_codecs_tpu_torch.ops import h264_interp as tinterp
from video_codecs_tpu_torch.ops import h264_rdoq as trdoq
from video_codecs_tpu_torch.ops import h264_transform as tht
from video_codecs_tpu_torch.ops import sad_surface as tsad
from video_codecs_tpu_torch.tools import jm_encoder_app as tjm
from video_codecs_tpu_torch.tools import misc as tmisc
from video_codecs_tpu_torch.utils import yuv as tyuv

torch.set_grad_enabled(False)


def _jax():
    """The JAX package's modules these tests compare with."""
    pytest.importorskip("jax")
    from video_codecs_tpu.entropy import bitstream
    from video_codecs_tpu.entropy import h264_cabac, h264_ctx_data
    from video_codecs_tpu.models.h264 import inter_codec
    from video_codecs_tpu.ops import h264_rdoq
    from video_codecs_tpu.tools import jm_encoder_app, misc
    return dict(bs=bitstream, hc=h264_cabac, tab=h264_ctx_data,
                inter=inter_codec, rdoq=h264_rdoq, jm=jm_encoder_app,
                misc=misc)


def _clip(w, h, nf, seed):
    """Smooth texture; each MB of a P picture moves whole, in two halves
    or in four quadrants, or stays; one MB row is new flat content, a
    level no earlier picture has (intra MBs in P slices); a little
    noise."""
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
                        continue
                    for ox, oy, pw, ph in halves[kind]:
                        d = rng.integers(-6, 7, 2)
                        sy, sx = pad + my + oy + d[1], pad + mx + ox + d[0]
                        y[my + oy:my + oy + ph, mx + ox:mx + ox + pw] = \
                            base[sy:sy + ph, sx:sx + pw]
            y[16:32, :] = 40 + 70 * f            # new flat content
        y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255).astype(np.uint8)
        frames.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                       (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return frames


def _planes_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(a[c], np.int32), np.asarray(b[c], np.int32),
                err_msg=f"picture {i} plane {c}")


# ---- the CABAC engine ------------------------------------------------------

def test_context_tables_equal():
    j = _jax()["tab"]
    names = [n for n in dir(j) if n.startswith("INIT_")]
    assert len(names) == 28
    for n in names:
        np.testing.assert_array_equal(getattr(ttab, n), getattr(j, n), n)
    jhc = _jax()["hc"]
    for st, model in (("I", 0), ("P", 0), ("P", 1), ("P", 2)):
        for qp in (0, 26, 51):
            np.testing.assert_array_equal(thc.init_states(st, qp, model),
                                          jhc.init_states(st, qp, model))


def _elements(seed, n=400):
    """Seeded (encoder method, its arguments, decoder arguments) of every
    syntax element the encoder writes (P_8x8's two mb_type codes and the
    PCM codes aside, which read back as other values)."""
    rng = np.random.default_rng(seed)
    ri = lambda lo, hi: int(rng.integers(lo, hi + 1))      # noqa: E731

    def nb():
        return None if rng.random() < 0.2 else \
            {"cbp": ri(0, 47), "ipcm": False}

    def coeffs(length, dens):
        c = rng.integers(-3, 4, length) * np.where(
            rng.random(length) < 0.15, rng.integers(1, 40, length), 1)
        c[rng.random(length) > dens] = 0
        return [int(v) for v in c]

    out = []
    for _ in range(n):
        k = ri(0, 14)
        if k == 0:
            a, b = ri(0, 1), ri(0, 1)
            out.append(("mb_skip_flag_p", (ri(0, 1), a, b), (a, b)))
        elif k == 1:
            c = ri(0, 2)
            out.append(("mb_type_i", (ri(0, 24), c), (c,)))
        elif k == 2:
            out.append(("mb_type_p", (int(rng.choice([1, 2, 3, 4, 6, 7])),
                                      ri(0, 23)), ()))
        elif k == 3:
            out.append(("sub_mb_type_p", (ri(0, 3),), ()))
        elif k == 4:
            out.append(("sub_mb_type_b", (ri(0, 12),), ()))
        elif k == 5:
            a, b = ri(0, 1), ri(0, 1)
            out.append(("mb_skip_flag_b", (ri(0, 1), a, b), (a, b)))
        elif k == 6:
            c = ri(0, 2)
            out.append(("mb_type_b", (ri(0, 24), c, ri(0, 23)), (c,)))
        elif k == 7:
            p = ri(0, 8)
            out.append(("intra4x4_pred_mode", (ri(0, 8), p), (p,)))
        elif k == 8:
            c = ri(0, 2)
            out.append(("transform_size_8x8_flag", (ri(0, 1), c), (c,)))
        elif k == 9:
            c = ri(0, 2)
            out.append(("intra_chroma_pred_mode", (ri(0, 3), c), (c,)))
        elif k == 10:
            up, left = nb(), nb()
            out.append(("cbp", (ri(0, 47), up, left), (up, left)))
        elif k == 11:
            p = bool(ri(0, 1))
            out.append(("mb_qp_delta", (ri(-26, 25), p), (p,)))
        elif k == 12:
            c = ri(0, 3)
            out.append(("ref_idx", (ri(0, 5), c), (c,)))
        elif k == 13:
            comp, err = ri(0, 1), ri(0, 60)
            mag = int(rng.choice([3, 20, 600]))
            out.append(("mvd", (ri(-mag, mag), comp, err), (comp, err)))
        else:
            bt = int(rng.choice([thc.LUMA_16DC, thc.LUMA_16AC, thc.LUMA_8x8,
                                 thc.LUMA_4x4, thc.CHROMA_DC,
                                 thc.CHROMA_AC]))
            length = {thc.LUMA_16DC: 16, thc.LUMA_16AC: 15,
                      thc.LUMA_8x8: 64, thc.LUMA_4x4: 16,
                      thc.CHROMA_DC: 4, thc.CHROMA_AC: 15}[bt]
            c = coeffs(length, [0.0, 0.3, 1.0][ri(0, 2)])
            if bt == thc.LUMA_8x8:
                if not any(c):
                    c[ri(0, 63)] = 1
                out.append(("residual_block", (bt, c, 0, False),
                            (bt, length, 0, False)))
            else:
                cbf = ri(0, 3)
                out.append(("residual_block", (bt, c, cbf),
                            (bt, length, cbf)))
    return out


_ROUNDTRIP = {"mb_skip_flag_p": 0, "mb_type_i": 0, "sub_mb_type_p": 0,
              "sub_mb_type_b": 0, "mb_skip_flag_b": 0,
              "intra4x4_pred_mode": 0, "transform_size_8x8_flag": 0,
              "intra_chroma_pred_mode": 0, "cbp": 0, "mb_qp_delta": 0,
              "ref_idx": 0, "mvd": 0, "residual_block": 1}


@pytest.mark.parametrize("slice_type,model,qp", [
    ("I", 0, 28), ("P", 0, 22), ("P", 1, 36), ("P", 2, 44)])
def test_cabac_syntax_elements_equal_both_ways(slice_type, model, qp):
    """Seeded sequences of every syntax element give equal bytes from the
    JAX and port encoders; the port decoder reads back what the JAX
    decoder reads, and every element that maps one to one as written."""
    jx = _jax()
    seq = _elements(qp + model)
    streams = []
    for bs, hc in ((tbs, thc), (jx["bs"], jx["hc"])):
        w = bs.BitWriter()
        w.ue(5)                              # an unaligned header
        ce = (hc.H264CabacEncoder(w, slice_type, qp, model)
              if slice_type == "P" else hc.H264CabacEncoder(w, "I", qp))
        for i, (name, args, _) in enumerate(seq):
            getattr(ce, name)(*args)
            ce.final(1 if i == len(seq) - 1 else 0)
        ce.finish()
        streams.append(w.data())
    assert streams[0] == streams[1]
    reads = []
    for bs, hc in ((tbs, thc), (jx["bs"], jx["hc"])):
        r = bs.BitReader(streams[0])
        assert r.ue() == 5
        cd = hc.H264CabacDecoder(r, slice_type, qp, model)
        got = []
        for i, (name, _, dargs) in enumerate(seq):
            got.append(getattr(cd, name)(*dargs))
            assert cd.final() == (1 if i == len(seq) - 1 else 0)
        reads.append(got)
    assert reads[0] == reads[1]
    for (name, args, _), v in zip(seq, reads[0]):
        if name in _ROUNDTRIP:
            assert v == args[_ROUNDTRIP[name]], (name, args, v)
        elif name == "mb_type_p":
            assert v == (args[0], args[1] if args[0] == 7 else 0), (args, v)


# ---- trellis and adaptive rounding -----------------------------------------

@pytest.mark.parametrize("qp", [8, 22, 28, 36, 46])
def test_trellis_and_adaptive_rounding_equal(qp):
    """`trellis_quant_ac` on seeded transformed residuals, and one
    `AdaptiveRounding` per package fed the same five pictures' blocks in
    turn (intra and inter), their offsets after every call equal."""
    j = _jax()["rdoq"]
    rng = np.random.default_rng(qp)
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    ta, ja = trdoq.AdaptiveRounding(), j.AdaptiveRounding()
    for pic in range(5):
        res = rng.integers(-90, 91, (24, 4, 4, 4)) // (1 + pic)
        w = tht.forward4x4(res)
        for intra in (True, False):
            np.testing.assert_array_equal(
                trdoq.trellis_quant_ac(w, qp, lam, intra),
                j.trellis_quant_ac(w, qp, lam, intra))
            np.testing.assert_array_equal(ta.quant_ac(w, qp, intra),
                                          ja.quant_ac(w, qp, intra))
            for k in (True, False):
                np.testing.assert_array_equal(ta.off[k], ja.off[k])
    assert not np.array_equal(ta.off[True], np.full((4, 4), 1 / 3))


# ---- the card stage (on the CPU) -------------------------------------------

def _stage_planes(seed, w=64, h=48):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = np.clip(np.roll(cur, (3, -5), (0, 1))
                  + rng.integers(-9, 10, (h, w)), 0, 255).astype(np.int32)
    return cur, ref


@pytest.mark.parametrize("sr", [4, 8])
def test_card_stage_sad_surfaces_equal_numpy_sad(sr):
    """Every partition's SAD window equals the numpy SAD surface
    `_search` computes, at every block position and at predictors in the
    window's corners and centre."""
    cur, ref = _stage_planes(sr)
    h, w = cur.shape
    me = host_me.RefSearch(cur, ref, sr, "cpu")
    pad = 2 * sr + 2
    refp = np.pad(ref, pad, mode="edge")
    for pw, ph in host_me.SHAPES:
        assert me.sad[(pw, ph)].shape == (h // ph, w // pw, 4 * sr + 1,
                                          4 * sr + 1)
        for y in range(0, h, ph):
            for x in range(0, w, pw):
                orig = cur[y:y + ph, x:x + pw]
                for px, py in ((-sr, -sr), (sr, sr), (-sr, sr), (0, 0),
                               (3, -2)):
                    x0, y0 = x + pad + px - sr, y + pad + py - sr
                    area = refp[y0:y0 + 2 * sr + ph, x0:x0 + 2 * sr + pw]
                    win = np.lib.stride_tricks.sliding_window_view(
                        area, (ph, pw))
                    sad = np.abs(win.astype(np.int32)
                                 - orig[None, None]).sum((2, 3))
                    np.testing.assert_array_equal(
                        me.window(x, y, pw, ph, px, py), sad,
                        err_msg=f"{pw}x{ph} at ({x}, {y}) pred ({px}, {py})")


@pytest.mark.parametrize("pw,ph", [(16, 16), (8, 4), (4, 8), (4, 4)])
def test_card_stage_phase_planes_equal_mc_luma_np(pw, ph):
    """Each phase-plane window equals `mc_luma_np` at all 16 fractions,
    at the picture's corners, at MVs reaching 2 sr + 3 pels outside."""
    sr = 8
    cur, ref = _stage_planes(11)
    h, w = cur.shape
    me = host_me.RefSearch(cur, ref, sr, "cpu")
    reach = (2 * sr + 3) * 4
    for x, y in ((0, 0), (w - pw, 0), (0, h - ph), (w - pw, h - ph),
                 (16, 8)):
        for ix in (-reach, -37, -4, 0, 9, reach):
            for iy in (-reach, -6, 0, 21, reach):
                for fy in range(4):
                    for fx in range(4):
                        mvx, mvy = (ix & ~3) + fx, (iy & ~3) + fy
                        np.testing.assert_array_equal(
                            me.block(x, y, mvx, mvy, pw, ph),
                            tinterp.mc_luma_np(ref, x, y, mvx, mvy, pw, ph),
                            err_msg=f"({x}, {y}) mv ({mvx}, {mvy})")


@pytest.mark.parametrize("me_kind", ["full", "epzs", "umhex"])
def test_searches_equal_reference_per_call(me_kind):
    """Each search of the port (its SADs from the card stage) returns the
    reference's (cost, mvx, mvy) at every MB and, for the full search,
    every partition, with the reference's neighbour grids."""
    jx = _jax()
    sr = 8
    frames = _clip(64, 48, 2, seed=3)
    cur = frames[1][0].astype(np.int32)
    ref = frames[0][0].astype(np.int32)
    kw = dict(qp=28, search_range=sr, me=me_kind)
    tenc = tinter.H264Encoder(64, 48, device="cpu", **kw)
    jenc = jx["inter"].H264Encoder(64, 48, **kw)
    me = host_me.RefSearch(cur, ref, sr, "cpu")
    rng = np.random.default_rng(4)
    mvg = rng.integers(-40, 41, (12, 16, 2)).astype(np.int32)
    refg = rng.integers(-1, 1, (12, 16)).astype(np.int32)
    prev = rng.integers(-50, 51, (12, 16, 2)).astype(np.int32)
    lam = (0.85 * 2.0 ** ((28 - 12) / 3.0)) ** 0.5
    n = 0
    for pw, ph in ((16, 16),) if me_kind != "full" else host_me.SHAPES:
        for y in range(0, 48, ph):
            for x in range(0, 64, pw):
                pmv = (int(rng.integers(-70, 71)), int(rng.integers(-70, 71)))
                orig = cur[y:y + ph, x:x + pw]
                if me_kind == "full":
                    got = tenc._search(orig, me, x, y, pmv, lam, pw, ph)
                    want = jenc._search(orig, ref, x, y, pmv, lam, pw, ph)
                elif me_kind == "epzs":
                    a = (mvg, refg, x // 4, y // 4, 16, prev)
                    got = tenc._search_epzs(orig, me, x, y, pmv, lam, *a)
                    want = jenc._search_epzs(orig, ref, x, y, pmv, lam, *a)
                else:
                    a = (mvg, refg, x // 4, y // 4, 16)
                    got = tenc._search_umhex(orig, me, x, y, pmv, lam, *a)
                    want = jenc._search_umhex(orig, ref, x, y, pmv, lam, *a)
                assert got == want, (pw, ph, x, y, pmv)
                n += 1
    assert n == (12 if me_kind != "full" else 12 * (1 + 2 + 2 + 4 + 8 + 8
                                                     + 16))


# ---- whole streams ---------------------------------------------------------

_CASES = [
    dict(entropy="cavlc", me="full", quant="normal", n_refs=1, gop=0),
    dict(entropy="cabac", me="epzs", quant="trellis", n_refs=3, gop=0),
    dict(entropy="cabac", me="umhex", quant="around", n_refs=1, gop=2),
    dict(entropy="cavlc", me="epzs", quant="around", n_refs=3, gop=2),
    dict(entropy="cabac", me="full", quant="normal", n_refs=3, gop=0),
    dict(entropy="cavlc", me="umhex", quant="trellis", n_refs=1, gop=0),
]


@pytest.mark.parametrize("case", _CASES,
                         ids=["-".join(str(v) for v in c.values())
                              for c in _CASES])
def test_host_coder_stream_byte_equal(case, monkeypatch):
    """The port's host IPPP coder writes the JAX package's stream byte for
    byte; both decoders give the encoder's pictures.  The clip's P
    pictures hold intra MBs; one card stage per P picture, with the
    sliding window's references."""
    jx = _jax()
    frames = _clip(64, 48, 3, seed=5)
    kinds = set()
    orig_mb = tinter.H264Encoder._encode_mb
    orig_stage = tinter.H264Encoder._card_stage

    def encode_mb(self, *a, **kw):
        kinds.add("intra" if kw.get("p_slice") or kw.get("mb_type_offset")
                  else "idr")
        return orig_mb(self, *a, **kw)

    stages = []

    def card_stage(self, y, refs):
        stages.append(len(refs))
        return orig_stage(self, y, refs)

    monkeypatch.setattr(tinter.H264Encoder, "_encode_mb", encode_mb)
    monkeypatch.setattr(tinter.H264Encoder, "_card_stage", card_stage)
    enc = tinter.H264Encoder(64, 48, qp=26, search_range=8, device="cpu",
                             **case)
    st, rt = enc.encode_sequence(frames)
    sj, rj = jx["inter"].H264Encoder(64, 48, qp=26, search_range=8,
                                     **case).encode_sequence(frames)
    assert st == sj
    _planes_equal(rt, rj)
    _planes_equal(tinter.H264Decoder().decode(st), rj)
    _planes_equal(jx["inter"].H264Decoder().decode(st), rj)
    assert "intra" in kinds
    p_refs = {0: [1, min(2, case["n_refs"])], 2: [1]}[case["gop"]]
    assert stages == p_refs


def _write_yuv(path, frames):
    tyuv.write_frames(str(path), *(np.stack([f[c] for f in frames])
                                   for c in range(3)))


_JM_CFG = """# JM-style cfg: mapped keys, comments, a quoted value, unmapped keys
FramesToBeEncoded     = 3     # three pictures
SourceWidth           = 64
SourceHeight          = 48
IntraPeriod           = 2
QPISlice              = 30
QPPSlice              = 29
SearchRange           = 8
NumberReferenceFrames = 3
SymbolMode            = 1
SearchMode            = 3
UseRDOQuant           = 1
LevelIDC              = 11
ProfileIDC            = 77
RDOptimization        = 1
NumberBFrames         = 0
Transform8x8Mode      = 0
ReconFile             = "{rec}"
"""


@pytest.mark.parametrize("kind", ["cfg-main", "p-baseline"])
def test_jm_cli_equals_jax_cli(kind, tmp_path):
    """`jm_encoder_app.main` with --device=cpu writes the JAX CLI's
    output file and recon file, and prints its summary (the timing line
    aside) and warnings, on a seeded YUV file."""
    jx = _jax()
    frames = _clip(64, 48, 3, seed=9)
    _write_yuv(tmp_path / "in.yuv", frames)
    runs = []
    for tag, main in (("port", tjm.main), ("jax", jx["jm"].main)):
        d = tmp_path / tag
        d.mkdir()
        if kind == "cfg-main":
            (d / "enc.cfg").write_text(_JM_CFG.format(rec=d / "rec.yuv"))
            argv = ["-d", str(d / "enc.cfg"),
                    "-p", f"InputFile={tmp_path / 'in.yuv'}",
                    "-p", f"OutputFile={d / 'out.264'}"]
        else:
            argv = ["-p", f"InputFile={tmp_path / 'in.yuv'}",
                    "-p", "SourceWidth=64", "-p", "SourceHeight=48",
                    "-p", "FramesToBeEncoded=3", "-p", "QPPSlice=30",
                    "-p", "SearchRange=8", "-p", "SymbolMode=0",
                    "-p", "SearchMode=0", "-p", "UseAdaptiveRounding=1",
                    "-p", f"OutputFile={d / 'out.264'}",
                    "-p", f"ReconFile={d / 'rec.yuv'}"]
        if tag == "port":
            argv.append("--device=cpu")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
        lines = [ln for ln in out.getvalue().splitlines()
                 if "Total encoding time" not in ln]
        runs.append(((d / "out.264").read_bytes(),
                     (d / "rec.yuv").read_bytes(),
                     [ln.replace(str(d), "D") for ln in lines],
                     err.getvalue()))
    assert runs[0] == runs[1]
    stream, _, lines, warn = runs[0]
    assert len(lines) == (3 if kind == "cfg-main" else 4)
    if kind == "cfg-main":
        assert "RDOptimization=1 not implemented" in warn
        assert "Transform8x8Mode" not in warn
    got = tinter.H264Decoder().decode(stream)
    ry, ru, rv = tyuv.read_frames(str(tmp_path / "port" / "rec.yuv"), 64, 48)
    for i, g in enumerate(got):
        for c, plane in enumerate((ry, ru, rv)):
            np.testing.assert_array_equal(plane[i], g[c].astype(np.uint8))


@pytest.mark.parametrize("args", [
    (176, 144, 30.0, 10, 0, 1), (176, 144, 30.0, 11, 900_000, 3),
    (1920, 1088, 60.0, 40, 30e6, 4), (1280, 720, 30.0, 31, 0, 5),
    (3840, 2160, 30.0, 42, 0, 0)])
def test_level_conformance_equal(args):
    j = _jax()["misc"]
    w, h, fps, level, br, dpb = args
    assert tmisc.check_level_conformance(w, h, fps, level, br, dpb) == \
        j.check_level_conformance(w, h, fps, level, br, dpb)
    assert tmisc.level_limits(level) == j.level_limits(level)
    try:
        want = j.minimum_level(w, h, fps, dpb)
    except ValueError:
        with pytest.raises(ValueError):
            tmisc.minimum_level(w, h, fps, dpb)
    else:
        assert tmisc.minimum_level(w, h, fps, dpb) == want


def test_cli_needs_card_without_device_flag(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        tjm.main(["-p", f"InputFile={tmp_path / 'none.yuv'}"])


@pytest.mark.parametrize("opt", [
    dict(perceptual="att"), dict(transform8x8=True),
    dict(weighted_pred=True), dict(long_term=True), dict(lt_period=2),
    dict(reorder="lt_first"), dict(intra_refresh=4)])
def test_host_coder_cut_options_raise(opt):
    """The options the port once refused (it carries them all now) give
    the JAX encoder's stream and pictures."""
    jx = _jax()
    frames = _clip(32, 32, 3, seed=3)
    st, rt = tinter.H264Encoder(32, 32, qp=26, search_range=4,
                                device="cpu", **opt).encode_sequence(frames)
    sj, rj = jx["inter"].H264Encoder(32, 32, qp=26, search_range=4,
                                     **opt).encode_sequence(frames)
    assert st == sj
    _planes_equal(rt, rj)


# ---- on the card -----------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


@pytest.mark.cuda
def test_card_stage_on_card_equals_cpu():
    """At 176x144 and search range 16 (n = 4, r = 32, B = 1,584): one
    SAD-kernel launch, surfaces and phase planes equal to the CPU's."""
    _needs_card()
    rng = np.random.default_rng(1)
    cur = rng.integers(0, 256, (144, 176)).astype(np.int32)
    ref = np.clip(np.roll(cur, (2, 7), (0, 1)) + rng.integers(-5, 6, cur.shape),
                  0, 255).astype(np.int32)
    tsad.sad_surface.launches = 0
    got = host_me.RefSearch(cur, ref, 16, "cuda")
    assert tsad.sad_surface.launches == 1
    want = host_me.RefSearch(cur, ref, 16, "cpu")
    for key in host_me.SHAPES:
        np.testing.assert_array_equal(got.sad[key], want.sad[key])
    np.testing.assert_array_equal(got.planes, want.planes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [_CASES[1], _CASES[3]],
                         ids=["cabac-epzs-trellis-3", "cavlc-epzs-around-3"])
def test_host_coder_on_card_equals_cpu(case):
    _needs_card()
    frames = _clip(64, 48, 4, seed=6)
    out = []
    for dev in ("cuda", "cpu"):
        tsad.sad_surface.launches = 0
        enc = tinter.H264Encoder(64, 48, qp=26, search_range=8, device=dev,
                                 **case)
        out.append(enc.encode_sequence(frames) + (tsad.sad_surface.launches,))
    (sg, rg, ng), (sc, rc, nc) = out
    assert sg == sc
    _planes_equal(rg, rc)
    assert nc == 0
    assert ng == {0: 1 + 2 + 3, 2: 1 + 1}[case["gop"]]


_CONF_CASES = {
    "ltr-mmco-reorder": dict(entropy="cavlc", n_refs=2, long_term=True,
                             lt_period=2, reorder="lt_first"),
    "wp-epzs-3": dict(entropy="cabac", me="epzs", n_refs=3,
                      weighted_pred=True),
    "perceptual": dict(perceptual="att+ssim"),
    "intra-refresh": dict(intra_refresh=4, quant="around"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_CONF_CASES))
def test_conf_options_on_card_equal_cpu(name, monkeypatch):
    """Long-term references with MMCO and reordering, weighted prediction,
    perceptual RDO (the saliency maps on the card) and intra refresh: the
    card's stream is the CPU's, one SAD-kernel launch per list0 entry and
    P picture on the card and none on the CPU."""
    _needs_card()
    frames = _clip(64, 48, 5, seed=7)
    stages = []
    orig = tinter.H264Encoder._card_stage

    def card_stage(self, y, refs):
        stages.append(len(refs))
        return orig(self, y, refs)

    monkeypatch.setattr(tinter.H264Encoder, "_card_stage", card_stage)
    out = []
    for dev in ("cuda", "cpu"):
        tsad.sad_surface.launches = 0
        stages.clear()
        enc = tinter.H264Encoder(64, 48, qp=28, search_range=8, device=dev,
                                 **_CONF_CASES[name])
        out.append(enc.encode_sequence(frames) +
                   (tsad.sad_surface.launches, sum(stages)))
    (sg, rg, ng, kg), (sc, rc, nc, kc) = out
    assert sg == sc
    _planes_equal(rg, rc)
    assert nc == 0 and ng == kg == kc > 0
    _planes_equal(tinter.H264Decoder().decode(sg), rg)
