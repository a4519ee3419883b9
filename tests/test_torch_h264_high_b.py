"""H.264 High profile (the 8x8 transform, I_8x8) and B slices in the port,
against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages, tolerance 0: the
8x8 transform, quantizer and zigzag; `intra8`'s references, filtering
and every mode at every 8x8 position of a picture (every availability);
`spatial_direct` and `bs_maps_b` on seeded motion grids; High-profile
`H264IntraEncoder` and `H264Encoder` streams and the B coder's
(`H264BEncoder`: 64x48 with 1 and 2 B pictures, 96x64 with partitions;
CAVLC and CABAC) byte for byte, decoded by both packages' decoders to the
encoder's pictures; the B decoder's implicit and explicit weighted
bipred on a JAX B stream whose PPS and slice headers ask for it.

The `cuda` case holds the B coder's card stream to its CPU stream.  It
runs where JAX is not installed, so JAX is imported only inside the tests
that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_h264_high_b.py
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.models.h264 import bslice_codec as tb
from video_codecs_tpu_torch.models.h264 import intra8 as ti8
from video_codecs_tpu_torch.models.h264 import intra_codec as tintra
from video_codecs_tpu_torch.models.h264 import inter_codec as tinter
from video_codecs_tpu_torch.ops import h264_transform as tht
from video_codecs_tpu_torch.ops import sad_surface as tsad

torch.set_grad_enabled(False)


def _jax():
    """The JAX package's modules these tests compare with."""
    pytest.importorskip("jax")
    from video_codecs_tpu.models.h264 import bslice_codec, intra8
    from video_codecs_tpu.models.h264 import inter_codec, intra_codec
    from video_codecs_tpu.ops import h264_transform
    return dict(b=bslice_codec, i8=intra8, inter=inter_codec,
                intra=intra_codec, ht=h264_transform)


def _planes_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(a[c], np.int32), np.asarray(b[c], np.int32),
                err_msg=f"picture {i} plane {c}")


def _translating_frames(n=5, w=64, h=48, seed=3):
    """tests/test_h264_bslice.py's clip: a noise texture moving by (2, 1)."""
    rng = np.random.default_rng(seed)
    by = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    bu = rng.integers(0, 256, (h // 2 + 8, w // 2 + 8)).astype(np.uint8)
    bv = rng.integers(0, 256, (h // 2 + 8, w // 2 + 8)).astype(np.uint8)
    out = []
    for t in range(n):
        dx, dy = t * 2, t
        out.append((by[dy:dy + h, dx:dx + w],
                    bu[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2],
                    bv[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2]))
    return out


def _shear_frames(n=5, w=96, h=64, seed=3):
    """tests/test_h264_bslice.py's shear clip: the top and bottom halves
    move differently, so 16x8 / 8x16 / B_8x8 partitions win."""
    rng = np.random.default_rng(seed)
    by = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    out = []
    for t in range(n):
        y = np.roll(by, (t, 2 * t), (0, 1)).copy()
        y[:h // 2 + 8] = np.roll(y[:h // 2 + 8], -3 * t, 1)
        y = y[:h, :w]
        u = (y[::2, ::2] // 2 + 60).astype(np.uint8)
        v = (y[1::2, ::2] // 2 + 30).astype(np.uint8)
        out.append((y, u, v))
    return out


def _smooth_clip(w, h, nf, seed):
    """A smooth texture panning by (2, 1) px with a little noise: flat
    enough for the 8x8 transform and I_8x8 to win somewhere."""
    rng = np.random.default_rng(seed)
    pad = 16
    base = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad)).astype(float)
    k = np.array([1, 4, 6, 4, 1.0]) / 16
    for _ in range(2):
        for ax in (0, 1):
            base = np.apply_along_axis(np.convolve, ax, base, k, "same")
    frames = []
    for f in range(nf):
        y = base[pad + f:pad + f + h, pad + 2 * f:pad + 2 * f + w].copy()
        y = np.clip(y + rng.normal(0, 1.5, y.shape), 0, 255).astype(np.uint8)
        frames.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                       (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return frames


# ---- the 8x8 transform -----------------------------------------------------

@pytest.mark.parametrize("seed,qp", [(0, 0), (1, 17), (2, 28), (3, 51)])
def test_transform8x8_quant_equal(seed, qp):
    jht = _jax()["ht"]
    rng = np.random.default_rng(seed)
    res = rng.integers(-255, 256, (6, 8, 8)).astype(np.int64)
    np.testing.assert_array_equal(tht.mf8(qp), jht.mf8(qp))
    np.testing.assert_array_equal(tht.vmat8(qp), jht.vmat8(qp))
    w = tht.forward8x8(res)
    np.testing.assert_array_equal(w, jht.forward8x8(res))
    for intra in (True, False):
        lv = tht.quant8x8(w, qp, intra=intra)
        np.testing.assert_array_equal(lv, jht.quant8x8(w, qp, intra=intra))
        d = tht.dequant8x8(lv, qp)
        np.testing.assert_array_equal(d, jht.dequant8x8(lv, qp))
        np.testing.assert_array_equal(tht.inverse8x8(d), jht.inverse8x8(d))
    lv = rng.integers(-40, 41, (6, 8, 8)).astype(np.int64)
    np.testing.assert_array_equal(tht.inverse8x8(tht.dequant8x8(lv, qp)),
                                  jht.inverse8x8(jht.dequant8x8(lv, qp)))


def test_zigzag8x8_equal():
    jht = _jax()["ht"]
    np.testing.assert_array_equal(tht.zigzag8x8(), jht.zigzag8x8())
    np.testing.assert_array_equal(tht.ZIGZAG_8x8, jht.ZIGZAG_8x8)
    assert sorted(tht.ZIGZAG_8x8.tolist()) == list(range(64))


# ---- I_8x8 prediction -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_intra8_refs_filter_and_modes_equal(seed):
    """Every 8x8 block position of a 48x48 picture: picture edges, the
    blocks of an MB whose top-right is not yet decoded, and inner ones
    give every availability of left / top / top-left / top-right."""
    ji8 = _jax()["i8"]
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (48, 48)).astype(np.int32)
    mb_w = 3
    seen = set()
    for y in range(0, 48, 8):
        for x in range(0, 48, 8):
            got = ti8.gather_ref8(rec, x, y, mb_w)
            want = ji8.gather_ref8(rec, x, y, mb_w)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
            assert got[3] == want[3]
            av = got[3]
            seen.add(tuple(sorted(av.items())))
            f_got = ti8.filter_ref8(*got)
            f_want = ji8.filter_ref8(*want)
            for a, b in zip(f_got, f_want):
                np.testing.assert_array_equal(a, b)
            modes = ti8.allowed_modes8(av)
            assert list(modes) == list(ji8.allowed_modes8(av))
            for m in modes:
                np.testing.assert_array_equal(
                    ti8.pred_luma8(*f_got, av, m),
                    ji8.pred_luma8(*f_want, av, m))
                np.testing.assert_array_equal(
                    ti8.predict8(rec, x, y, mb_w, m),
                    ji8.predict8(rec, x, y, mb_w, m))
    assert len(seen) >= 5, seen


# ---- spatial direct and the B deblock's boundary strengths ---------------

def _motion_grids(rng, h4, w4):
    mv = rng.integers(-12, 13, (h4, w4, 2)).astype(np.int32)
    ref = rng.integers(-1, 2, (h4, w4)).astype(np.int32)
    mv[ref < 0] = 0
    # colocated "still" blocks (|mv| <= 1 on refIdx 0) where col_zero holds
    still = rng.random((h4, w4)) < 0.3
    mv[still] = rng.integers(-1, 2, (int(still.sum()), 2))
    return mv, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spatial_direct_equal(seed):
    jb = _jax()["b"]
    rng = np.random.default_rng(seed)
    h4, w4 = 16, 20
    mvg0, refg0 = _motion_grids(rng, h4, w4)
    mvg1, refg1 = _motion_grids(rng, h4, w4)
    col_mvg, col_refg = _motion_grids(rng, h4, w4)
    kinds = set()
    for gy in range(0, h4, 4):
        for gx in range(0, w4, 4):
            got = tb.spatial_direct(mvg0, refg0, mvg1, refg1, gx, gy, w4,
                                    col_mvg, col_refg)
            want = jb.spatial_direct(mvg0, refg0, mvg1, refg1, gx, gy, w4,
                                     col_mvg, col_refg)
            assert got[:2] == want[:2]
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(got[3], want[3])
            kinds.add((got[0] >= 0, got[1] >= 0))
    assert len(kinds) >= 2, kinds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bs_maps_b_equal(seed):
    jb = _jax()["b"]
    rng = np.random.default_rng(seed)
    mbh, mbw = 3, 5
    h4, w4 = mbh * 4, mbw * 4
    intra = rng.random((mbh, mbw)) < 0.2
    nz = (rng.random((h4, w4)) < 0.3).astype(np.int32)
    mv0, _ = _motion_grids(rng, h4, w4)
    mv1, _ = _motion_grids(rng, h4, w4)
    pocs = np.array([-1, 0, 2, 6])
    poc0 = pocs[rng.integers(0, 3, (h4, w4))]
    poc1 = pocs[rng.integers(0, 4, (h4, w4)) * (rng.random((h4, w4)) < .6)]
    poc1[(poc0 < 0) & (poc1 < 0)] = 6
    got = tb.bs_maps_b(intra, nz, mv0, poc0, mv1, poc1)
    want = jb.bs_maps_b(intra, nz, mv0, poc0, mv1, poc1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert {0, 1, 2, 3, 4} <= set(np.unique(np.concatenate(
        [got[0].ravel(), got[1].ravel()])).tolist())


# ---- High-profile streams ---------------------------------------------------

@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_high_intra_stream_equal(entropy):
    """`H264IntraEncoder(transform8x8=True)`: High profile 100, I_8x8 MBs
    among I_16x16 and I_4x4; both decoders give the encoder's
    pictures."""
    jx = _jax()
    frames = _smooth_clip(64, 48, 2, seed=4)
    enc = tintra.H264IntraEncoder(64, 48, qp=34, entropy=entropy,
                                  transform8x8=True)
    jenc = jx["intra"].H264IntraEncoder(64, 48, qp=34, entropy=entropy,
                                        transform8x8=True)
    i8 = {"port": [], "jax": []}
    for key, e in (("port", enc), ("jax", jenc)):
        orig = e.encode_frame

        def frame(*a, _orig=orig, _key=key, _e=e, **kw):
            out = _orig(*a, **kw)
            i8[_key].append(_e._trans8.copy())
            return out
        e.encode_frame = frame
    st, rt = enc.encode_sequence(frames)
    sj, rj = jenc.encode_sequence(frames)
    assert st == sj
    assert st[4] & 0x1F == 7 and st[5] == 100      # SPS, profile_idc High
    _planes_equal(rt, rj)
    for a, b in zip(i8["port"], i8["jax"]):
        np.testing.assert_array_equal(a, b)
    used = np.stack(i8["port"])
    assert used.any() and not used.all()            # I_8x8 among the MBs
    _planes_equal(tintra.H264IntraDecoder().decode(st), rj)
    _planes_equal(tinter.H264Decoder().decode(st), rj)
    _planes_equal(jx["inter"].H264Decoder().decode(st), rj)


_HIGH_CASES = [
    dict(entropy="cavlc", me="full", quant="normal", n_refs=1),
    dict(entropy="cabac", me="epzs", quant="trellis", n_refs=3),
]


@pytest.mark.parametrize("case", _HIGH_CASES,
                         ids=["-".join(str(v) for v in c.values())
                              for c in _HIGH_CASES])
def test_high_ippp_stream_equal(case):
    """`H264Encoder(transform8x8=True)` over 4 pictures: the 4x4 / 8x8
    decision of every inter MB, I_8x8 in the IDR; the stream byte-equal,
    the 8x8 MBs of each picture equal, both decoders give the encoder's
    pictures."""
    jx = _jax()
    frames = _smooth_clip(64, 48, 4, seed=6)
    enc = tinter.H264Encoder(64, 48, qp=26, search_range=8, device="cpu",
                             transform8x8=True, **case)
    jenc = jx["inter"].H264Encoder(64, 48, qp=26, search_range=8,
                                   transform8x8=True, **case)
    t8 = {"port": [], "jax": []}
    for key, e in (("port", enc), ("jax", jenc)):
        orig = e._encode_p_frame

        def p_frame(*a, _orig=orig, _key=key, _e=e, **kw):
            out = _orig(*a, **kw)
            t8[_key].append(_e._trans8.copy())
            return out
        e._encode_p_frame = p_frame
    st, rt = enc.encode_sequence(frames)
    sj, rj = jenc.encode_sequence(frames)
    assert st == sj
    _planes_equal(rt, rj)
    assert len(t8["port"]) == 3
    for a, b in zip(t8["port"], t8["jax"]):
        np.testing.assert_array_equal(a, b)
    assert any(a.any() for a in t8["port"])
    _planes_equal(tinter.H264Decoder().decode(st), rj)
    _planes_equal(jx["inter"].H264Decoder().decode(st), rj)


# ---- B slices ---------------------------------------------------------------

def _b_streams(jx, frames, monkeypatch, **kw):
    """The port's and the JAX package's B coder on `frames`; the port's
    card stages (the number of reference pictures each was made for)
    recorded."""
    stages = []
    orig = tinter.H264Encoder._card_stage

    def card_stage(self, y, refs):
        stages.append(len(refs))
        return orig(self, y, refs)

    monkeypatch.setattr(tinter.H264Encoder, "_card_stage", card_stage)
    enc = tb.H264BEncoder(device="cpu", **kw)
    st, rt = enc.encode_sequence(frames)
    jenc = jx["b"].H264BEncoder(**kw)
    sj, rj = jenc.encode_sequence(frames)
    assert st == sj
    _planes_equal(rt, rj)
    assert enc.mb_type_stats == jenc.mb_type_stats
    got = tb.H264BDecoder().decode(sj)
    _planes_equal(got, rj)
    _planes_equal(got, jx["b"].H264BDecoder().decode(sj))
    return enc, stages


@pytest.mark.parametrize("entropy,b_frames", [
    ("cavlc", 1), ("cabac", 1), ("cavlc", 2), ("cabac", 2)])
def test_b_stream_64x48(entropy, b_frames, monkeypatch):
    """tests/test_h264_bslice.py's 64x48 settings: IDR, P anchors and
    non-reference B pictures with spatial direct; one card stage per P
    anchor (one reference) and per B picture (two lists)."""
    jx = _jax()
    n = 7 if b_frames == 2 else 5
    enc, stages = _b_streams(jx, _translating_frames(n=n), monkeypatch,
                             width=64, height=48, qp=28 if b_frames == 2
                             else 30, b_frames=b_frames, entropy=entropy)
    n_p = -(-(n - 1) // (b_frames + 1))
    assert stages.count(1) == n_p and stages.count(2) == n - 1 - n_p
    assert enc.mb_type_stats.get(0, 0) > 0          # direct / skip MBs


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_b_stream_partitions_96x64(entropy, monkeypatch):
    """The shear clip at 96x64: 16x8 / 8x16 and B_8x8 MBs (Table 7-14
    mb_types 4..22) engage, byte-equal, decoded in display order."""
    jx = _jax()
    enc, _ = _b_streams(jx, _shear_frames(), monkeypatch, width=96,
                        height=64, qp=30, b_frames=1, entropy=entropy)
    stats = enc.mb_type_stats
    assert sum(v for k, v in stats.items()
               if isinstance(k, int) and 4 <= k <= 21) > 0, stats
    assert stats.get(22, 0) > 0, stats


def test_b_encoder_runs_on_the_card_by_default():
    assert tb.H264BEncoder(64, 48).device.type == "cuda"
    assert tb.H264BEncoder(64, 48, device="cpu").device.type == "cpu"


# ---- weighted bipred in the B decoder ------------------------------------

def _pps(cabac: bool, wbp_idc: int) -> bytes:
    """intra_codec.write_pps with weighted_bipred_idc set."""
    w = tbs.BitWriter()
    w.ue(0)
    w.ue(0)
    w.flag(int(cabac))
    w.flag(0)
    w.ue(0)
    w.ue(0)
    w.ue(0)
    w.flag(0)                 # weighted_pred_flag
    w.write(wbp_idc, 2)       # weighted_bipred_idc
    w.se(0)
    w.se(0)
    w.se(0)
    w.flag(1)
    w.flag(0)
    w.flag(0)
    w.rbsp_trailing_bits()
    return w.data()


def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def _with_weights(rbsp: bytes, log2_poc: int) -> bytes:
    """A CAVLC B slice's rbsp with a pred_weight_table inserted after the
    ref_pic_list_modification flags (spec 7.3.3): explicit weights for
    both lists, luma and chroma."""
    r = tbs.BitReader(rbsp)
    r.ue(), r.ue(), r.ue()
    r.read(8)                 # frame_num
    r.read(log2_poc)          # pic_order_cnt_lsb
    r.flag()                  # direct_spatial_mv_pred_flag
    assert r.flag() == 0      # num_ref_idx_active_override_flag
    r.flag(), r.flag()        # ref_pic_list_modification_flag_l0 / l1
    at = r.bit_pos()
    w = tbs.BitWriter()
    w.ue(5)                   # luma_log2_weight_denom
    w.ue(4)                   # chroma_log2_weight_denom
    for luma, chroma in (((40, 3), ((20, -4), (12, 5))),
                         ((24, -2), None)):
        w.flag(1)
        w.se(luma[0])
        w.se(luma[1])
        w.flag(chroma is not None)
        for cw, co in chroma or ():
            w.se(cw)
            w.se(co)
    n_ins = w.num_bits()
    w.rbsp_trailing_bits()
    ins = _bits(w.data())[:n_ins]
    bits = _bits(rbsp).rstrip("0")[:-1]     # without rbsp_trailing_bits
    bits = bits[:at] + ins + bits[at:] + "1"
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


@pytest.mark.parametrize("kind", ["implicit", "explicit"])
def test_b_decoder_weighted_bipred_equal(kind):
    """The B decoder's weighted bipred (spec 8.4.2.3): a JAX B stream
    rewritten to ask for implicit weights (weighted_bipred_idc 2: B
    pictures at 1/3 and 2/3 of their anchors' distance) or explicit ones
    (idc 1, a pred_weight_table in each B slice header); both packages'
    H264BDecoder give the same pictures; the anchors are the unweighted
    stream's, and the B pictures' weighted blocks differ from it."""
    jx = _jax()
    cabac = kind == "implicit"
    frames = _translating_frames(n=7)
    stream, recons = jx["b"].H264BEncoder(
        64, 48, qp=28, b_frames=2,
        entropy="cabac" if cabac else "cavlc").encode_sequence(frames)
    nals = []
    log2_poc = None
    for nal in tbs.split_annexb(stream):
        nt, idc = nal[0] & 0x1F, nal[0] >> 5
        rbsp = tbs.strip_emulation_prevention(nal[1:])
        if nt == 7:
            log2_poc = tintra.parse_sps(rbsp, full=True)[2][
                "log2_max_poc_lsb"]
        elif nt == 8:
            rbsp = _pps(cabac, 2 if cabac else 1)
        elif nt == 1 and idc == 0 and not cabac:
            rbsp = _with_weights(rbsp, log2_poc)
        nals.append(tintra.nal_unit(nt, rbsp, ref_idc=idc))
    weighted = tintra.annexb(nals)
    got = tb.H264BDecoder().decode(weighted)
    want = jx["b"].H264BDecoder().decode(weighted)
    _planes_equal(got, want)
    b_pics = [i for i in range(7) if i % 3]
    for i in (0, 3, 6):                 # the anchors are unweighted
        _planes_equal([got[i]], [recons[i]])
    differ = [not np.array_equal(got[i][0], recons[i][0]) for i in b_pics]
    assert all(differ) if kind == "explicit" else any(differ), differ


# ---- on the card ------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_b_coder_on_card_equals_cpu(entropy):
    """The B coder at 96x64 with partitions: its card stages through the
    SAD kernel (1 launch per P anchor, 2 per B picture), the same stream
    as the CPU's plain SADs."""
    _needs_card()
    frames = _shear_frames(n=7)
    out = []
    for dev in ("cuda", "cpu"):
        tsad.sad_surface.launches = 0
        enc = tb.H264BEncoder(96, 64, qp=30, b_frames=2, entropy=entropy,
                              device=dev)
        out.append(enc.encode_sequence(frames) +
                   (tsad.sad_surface.launches,))
    (sg, rg, ng), (sc, rc, nc) = out
    assert sg == sc
    _planes_equal(rg, rc)
    assert (ng, nc) == (2 + 2 * 4, 0)
    _planes_equal(tb.H264BDecoder().decode(sg), rg)
