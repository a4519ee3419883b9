"""The reference's host flat 16x16 B coder in the port against the JAX
package's, on the CPU.

The port carries the host B coder that the reference's encoder CLI
builds for HM's random-access cfgs (models/hevc/bframe_codec.
HierarchicalBEncoder under ra_codec.RandomAccessEncoder), its decoders
(`HierarchicalBDecoder`, `RandomAccessDecoder`), the bi-prediction numpy
MC twins and the slice-header parsers.  Seeded numpy inputs go through
the JAX function and the port's; tolerance 0 everywhere (integers and
bytes).

The stream tests run a JAX package test's configuration at its size and
settings: tests/test_bframes.py's moving clip and its static-plus-noise
clip that forces bi-prediction (64x48, I0 P2 B1 P4 B3), and
tests/test_ra_codec.py's 80x48 GOP-8 over 17 pictures, and over 9 with
SAO.  The port's stream is the JAX encoder's byte for byte, the
reconstructions are equal, the port's three decoders (its own flat
decoder, `GeneralDecoder`, and for RA streams `RandomAccessDecoder`)
give every picture hash OK and the encoder's pictures, and on the JAX
stream the JAX decoder's pictures.

The `cuda` case runs where JAX is not installed, so JAX is imported only
inside the tests that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_hevc_host_b.py
"""

import numpy as np
import pytest
import torch
from chip_smoke import bench_synth_clip

from video_codecs_tpu_torch.models.hevc import bframe_codec as tbc
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import inter_qt as tqt
from video_codecs_tpu_torch.models.hevc import ra_codec as tra
from video_codecs_tpu_torch.ops import interp as tinterp

torch.set_grad_enabled(False)


def _jax():
    """The JAX package's modules these tests compare with, as a namespace
    (imported here so that the `cuda` case runs without JAX)."""
    pytest.importorskip("jax")
    import types

    from video_codecs_tpu.models.hevc import bframe_codec, headers, ra_codec
    from video_codecs_tpu.ops import interp
    return types.SimpleNamespace(bc=bframe_codec, headers=headers,
                                 ra=ra_codec, interp=interp)


def _same(got, want, what=""):
    assert np.asarray(got).dtype == np.asarray(want).dtype, what
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


# ---- the bi-prediction MC twins -------------------------------------------

@pytest.mark.parametrize("comp", ["luma", "chroma"])
def test_bi_mc_twins_equal(comp):
    """mc_luma_bi_np / mc_chroma_bi_np on random planes, at every pair of
    fractional phases and at MVs that reach past the picture edges."""
    j = _jax()
    rng = np.random.default_rng(["luma", "chroma"].index(comp))
    h, w = (48, 64) if comp == "luma" else (24, 32)
    n = 16 if comp == "luma" else 8
    r0, r1 = (rng.integers(0, 256, (h, w)).astype(np.int32)
              for _ in range(2))
    name = f"mc_{comp}_bi_np"
    jf, tf = getattr(j.interp, name), getattr(tinterp, name)
    mvs = [((f0, f1), (f1, f0)) for f0 in range(8) for f1 in range(8)]
    mvs += [((-600, -500), (600, 500)), ((-7, 389), (391, -13))]
    mvs += [(tuple(int(x) for x in rng.integers(-300, 300, 2)),
             tuple(int(x) for x in rng.integers(-300, 300, 2)))
            for _ in range(40)]
    for mv0, mv1 in mvs:
        x0 = int(rng.integers(0, w - n + 1))
        y0 = int(rng.integers(0, h - n + 1))
        _same(tf(r0, r1, x0, y0, mv0, mv1, n),
              jf(r0, r1, x0, y0, mv0, mv1, n), f"{name} {mv0} {mv1}")


# ---- slice-header parsers -----------------------------------------------------

def test_b_and_ra_slice_header_parsers_equal():
    """parse_b_slice_header and parse_ra_slice_header (with and without
    the SAO flags) on the headers the writers give for every slice type,
    POC and RPS, against the JAX package's."""
    j = _jax()
    for sao in (False, True):
        cfg = theaders.HevcConfig(width=64, height=48, qp=30, sao=sao,
                                  reorder_pics=1)
        pps = theaders.parse_pps(theaders.write_pps(cfg))
        for anchor in (False, True):
            for poc, nd in ((1, 1), (2, 2), (7, 4), (300, 2)):
                w = tbc.write_b_slice_header(cfg, poc, anchor, nd)
                rb = w.data()
                assert tbc.parse_b_slice_header(rb, pps, sao) == \
                    j.bc.parse_b_slice_header(rb, pps, sao)
        for st in (0, 1):
            for neg, pos in ((((-1, True),), ()),
                             (((-2, True), (-6, False)), ((2, True),)),
                             (((-1, True), (-3, False)),
                              ((1, True), (5, False)))):
                w = tra.write_ra_slice_header(cfg, 5, st, 33, list(neg),
                                              list(pos))
                rb = w.data()
                assert tra.parse_ra_slice_header(rb, pps, sao) == \
                    j.ra.parse_ra_slice_header(rb, pps, sao)


# ---- whole streams --------------------------------------------------------------

def _streams(frames, cfg_kw, kind, enc_kw=()):
    """Encode `frames` with the JAX package's host B coder ("hierb":
    HierarchicalBEncoder.encode_sequence_rab, "ra": RandomAccessEncoder.
    encode_sequence_ra) and the port's on the CPU; require equal bytes
    and recons, every hash OK with the encoder's pictures in the port's
    decoders, and the JAX decoder's pictures from the port's flat decoder
    on the (equal) stream.  Returns the port's per-picture BBlock grids."""
    j = _jax()
    enc_kw = dict(enc_kw)
    grids = []
    if kind == "hierb":
        jenc = j.bc.HierarchicalBEncoder(j.headers.HevcConfig(**cfg_kw),
                                         **enc_kw)
        tenc = tbc.HierarchicalBEncoder(theaders.HevcConfig(**cfg_kw),
                                        device="cpu", **enc_kw)
    else:
        jenc = j.ra.RandomAccessEncoder(j.headers.HevcConfig(**cfg_kw),
                                        **enc_kw)
        tenc = tra.RandomAccessEncoder(theaders.HevcConfig(**cfg_kw),
                                       device="cpu", **enc_kw)
    raster = tenc._b_raster

    def rec(*a):
        out = raster(*a)
        grids.append(out[0])
        return out
    tenc._b_raster = rec
    run = "encode_sequence_rab" if kind == "hierb" else "encode_sequence_ra"
    js, jrec = getattr(jenc, run)(frames)
    ts, trec = getattr(tenc, run)(frames)
    assert ts == js
    for k, (a, b) in enumerate(zip(trec, jrec)):
        for c in range(3):
            np.testing.assert_array_equal(a[c], np.asarray(b[c]),
                                          err_msg=f"picture {k} plane {c}")
    flat = tbc.HierarchicalBDecoder if kind == "hierb" else \
        tra.RandomAccessDecoder
    for cls in (flat, tdec.GeneralDecoder):
        dec = cls()
        out = dec.decode(ts)
        assert dec.hash_status == [True] * len(frames), cls.__name__
        for k, (a, b) in enumerate(zip(trec, out)):
            for c in range(3):
                np.testing.assert_array_equal(
                    a[c], b[c], err_msg=f"{cls.__name__} picture {k}")
    jflat = j.bc.HierarchicalBDecoder if kind == "hierb" else \
        j.ra.RandomAccessDecoder
    for a, b in zip(flat().decode(js), jflat().decode(js)):
        for c in range(3):
            np.testing.assert_array_equal(a[c], np.asarray(b[c]))
    return grids


def _bi_blocks(grids, merge: bool):
    """Bi-predicted blocks of the grids: merged ones (merge=True) or
    those with their own two MVs."""
    return sum(b.pred_mode == tbc.MODE_INTER and b.inter_dir == 3 and
               b.merge == merge for g in grids for row in g for b in row)


def test_hierb_moving_clip_64x48():
    """tests/test_bframes.py::test_bframes_roundtrip's configuration:
    64x48, QP 30, the "auto" search at range 8, its translating clip over
    I0 P2 B1 P4 B3."""
    from test_inter_codec import moving_clip
    grids = _streams(moving_clip(64, 48, 5),
                     dict(width=64, height=48, qp=30, reorder_pics=1),
                     "hierb")
    bl = [b for g in grids for row in g for b in row]
    assert any(b.pred_mode == tbc.MODE_INTER and not b.merge for b in bl)


def test_hierb_bipred_64x48():
    """test_bipred_hm_conformance's static-plus-noise clip (QP 35), which
    codes bi-predicted blocks (merged from the B slice's zero candidate:
    the bi MC twins in the raster and in the decoders)."""
    rng = np.random.default_rng(3)
    base_y = rng.integers(60, 200, (48, 64)).astype(np.int32)
    frames = []
    for _ in range(5):
        y = np.clip(base_y + rng.integers(-9, 10, base_y.shape),
                    0, 255).astype(np.uint8)
        frames.append((y, np.full((24, 32), 120, np.uint8),
                       np.full((24, 32), 130, np.uint8)))
    grids = _streams(frames, dict(width=64, height=48, qp=35,
                                  reorder_pics=1), "hierb")
    assert _bi_blocks(grids, merge=True) > 0


def _ra_clip(n):
    """tests/test_ra_codec.py's clip: 80x48 crops of bench.py's."""
    from bench import synth_clip
    return [(f[0][:48, :80], f[1][:24, :40], f[2][:24, :40])
            for f in synth_clip(416, 240, n)]


def test_ra_gop8_80x48():
    """tests/test_ra_codec.py::test_ra_gop8_roundtrip_and_order's
    configuration: 80x48, QP 32, 4 DPB pictures, search range 8, 17
    pictures (two GOPs of 8 after the IDR)."""
    grids = _streams(_ra_clip(17), dict(width=80, height=48, qp=32,
                                        reorder_pics=3, num_refs=4),
                     "ra", dict(search_range=8))
    assert _bi_blocks(grids, merge=False) > 0
    assert _bi_blocks(grids, merge=True) > 0


def test_ra_gop8_sao_80x48():
    """test_ra_gop8_sao_hm_conformance's host configuration: the same
    settings with SAO over 9 pictures (the SAO statistics through
    `sao_stats`' plain version on the CPU)."""
    _streams(_ra_clip(9), dict(width=80, height=48, qp=32, reorder_pics=3,
                               num_refs=4, sao=True),
             "ra", dict(search_range=8))


def test_host_b_coder_refusals():
    """The host B coders run on the card by default and refuse what the
    flat B syntax writes wrongly (TMVP; in the RA header MaxNumMergeCand
    other than 1 with no merge_idx coded) or the port does not carry; the
    CTB32 quadtree RA encoder, which writes its own slices, still takes
    merge 5 and TMVP."""
    ok = theaders.HevcConfig(width=64, height=48, qp=32, reorder_pics=3)
    for cls in (tbc.HierarchicalBEncoder, tra.RandomAccessEncoder):
        assert cls(ok).device == torch.device("cuda")
        for opt, val in (("temporal_mvp", True), ("tile_columns", 2),
                         ("wpp", True), ("weighted_pred", True),
                         ("cu_qp_delta", True), ("timing_sei", True),
                         ("long_term_idr", True), ("log2_ctb", 5)):
            cfg = theaders.HevcConfig(width=64, height=48, qp=32,
                                      **{opt: val})
            with pytest.raises(ValueError, match=cls.__name__):
                cls(cfg, device="cpu")
    with pytest.raises(ValueError, match="merge_cands"):
        tra.RandomAccessEncoder(theaders.HevcConfig(
            width=64, height=48, merge_cands=5), device="cpu")
    assert tbc.HierarchicalBEncoder(theaders.HevcConfig(
        width=64, height=48, merge_cands=5), device="cpu").cfg.merge_cands
    qt = theaders.HevcConfig(width=64, height=64, qp=32, log2_ctb=5,
                             log2_min_cb=3, log2_max_tb=5, merge_cands=5,
                             temporal_mvp=True, reorder_pics=3)
    assert tqt.QtDeviceRandomAccessEncoder(qt, device="cpu").flat_syntax \
        is False
    with pytest.raises(ValueError, match="DeviceRandomAccessEncoder"):
        tinter.DeviceRandomAccessEncoder(theaders.HevcConfig(
            width=64, height=48, merge_cands=5), device="cpu")


# ---- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_host_ra_card_equals_cpu():
    """HM's RA main settings as the encoder CLI builds them (TZSearch at
    search range 64, RDOQ "full" in the IDR, SBH, one merge candidate, no
    TMVP) at 80x48 over 9 pictures: pass 1, the IDR's sweep and the
    deblocks on the card give the CPU's stream byte for byte, one SAD
    launch per list."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels, no interpret mode)")
    from video_codecs_tpu_torch.ops import sad_surface as ss
    frames = bench_synth_clip(80, 48, 9)
    streams, launches = [], []
    for dev in ("cuda", "cpu"):
        cfg = theaders.HevcConfig(width=80, height=48, qp=32,
                                  sign_data_hiding=True, rdoq="full",
                                  reorder_pics=3, num_refs=4)
        enc = tra.RandomAccessEncoder(cfg, search_range=64, me_method="tz",
                                      device=dev)
        n0 = ss.sad_surface.launches
        streams.append(enc.encode_sequence_ra(frames)[0])
        launches.append(ss.sad_surface.launches - n0)
    assert streams[0] == streams[1]
    assert launches == [15, 0]
    dec = tra.RandomAccessDecoder()
    dec.decode(streams[0])
    assert dec.hash_status == [True] * 9
