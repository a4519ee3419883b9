"""The port's flat CTB16 hierarchical-B and random-access device engines
against the JAX package's, on the CPU.

For each configuration (one test each, so that no pytest-xdist worker
compiles another's JAX programs) the JAX encoder (`inter_jax.
DeviceRandomAccessEncoder` over a GOP-8 of 9 pictures, `inter_jax.
DeviceHierarchicalBEncoder` over I0 P2 B1 P4 B3) and the port's encode
the same seeded clip at 64x48, at the settings of tests/test_inter_jax.py's
`test_device_ra_gop8_roundtrip` and `test_device_hierb_roundtrip` (so
that a run's shared compilation cache serves both; chip_smoke.py holds
search range 64 at 1920x1072 to the JAX package's stream):
  - the streams are byte-equal, decode with every picture hash OK in the
    port's `GeneralDecoder` (spec merge and AMVP, which the reference's
    own decoders share with its encoder), and the decoded pictures are
    the encoder's;
  - stage parity without cascades: the JAX encoder's device stage
    `inter_jax.encode_b_frame_dev` (merge_eval "first", the intra
    candidate, deblock at block 16) and its host reconciliation
    `_reconcile_b` are wrapped inside the test to record their inputs and
    outputs (no file of the JAX package is edited); the same inputs go
    through the port's, the dicts are compared key by key and the B
    blocks field by field;
  - the port's device BS maps of each picture equal `_bs_maps_b` of its
    reconciled block grid.
Tolerance 0 everywhere.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from test_torch_hevc_host import _defs
from test_torch_hevc_ra import _dict_equal, _t, clip

from video_codecs_tpu.models.hevc import bframe_codec as jbc
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import inter_jax as jinter
from video_codecs_tpu_torch.models.hevc import bframe_codec as tbc
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import ra_codec as tra

torch.set_grad_enabled(False)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cfg(mod, w, h, reorder, qp=32, **kw):
    """The flat engines' settings (CTB16, SBH, hash SEI)."""
    cfg = mod.HevcConfig(width=w, height=h, qp=qp, reorder_pics=reorder,
                         sign_data_hiding=True)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _blocks_equal(got, want, what):
    """Two BBlock grids equal field by field (levels by value)."""
    assert len(got) == len(want), what
    for by, (grow, wrow) in enumerate(zip(got, want)):
        for bx, (g, w_) in enumerate(zip(grow, wrow)):
            for f in dataclasses.fields(jbc.BBlock):
                a, b = getattr(g, f.name), getattr(w_, f.name)
                if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                    assert a is not None and b is not None and \
                        a.dtype == b.dtype and np.array_equal(a, b), \
                        (what, by, bx, f.name)
                else:
                    assert a == b, (what, by, bx, f.name, a, b)


def _run(monkeypatch, kind, w, h, n, seed, qp, sr):
    """Encode with both engines, recording the JAX engine's device stage
    and reconciliation; check streams, the decoder and stage parity."""
    calls = {"b": [], "rec": []}
    orig_b, orig_rec = jinter.encode_b_frame_dev, jinter._reconcile_b

    def rec_b(*args, **kw):
        out = orig_b(*args, **kw)
        calls["b"].append((args, kw, {k: np.asarray(v)
                                      for k, v in out.items()}))
        return out

    def rec_rec(st, bw, bh, ref_poc, poc, is_anchor):
        info = orig_rec(st, bw, bh, ref_poc, poc, is_anchor)
        calls["rec"].append(((st, bw, bh, dict(ref_poc), poc, is_anchor),
                             info))
        return info

    monkeypatch.setattr(jinter, "encode_b_frame_dev", rec_b)
    monkeypatch.setattr(jinter, "_reconcile_b", rec_rec)
    frames = clip(w, h, n, seed=seed)
    reorder = 3 if kind == "ra" else 1
    if kind == "ra":
        js, _ = jinter.DeviceRandomAccessEncoder(
            _cfg(jheaders, w, h, reorder, qp),
            search_range=sr).encode_sequence_ra(frames)
        ts, trec = tinter.DeviceRandomAccessEncoder(
            _cfg(theaders, w, h, reorder, qp), search_range=sr,
            device="cpu").encode_sequence_ra(frames)
    else:
        js, _ = jinter.DeviceHierarchicalBEncoder(
            _cfg(jheaders, w, h, reorder, qp),
            search_range=sr).encode_sequence_rab(frames)
        ts, trec = tinter.DeviceHierarchicalBEncoder(
            _cfg(theaders, w, h, reorder, qp), search_range=sr,
            device="cpu").encode_sequence_rab(frames)
    assert len(ts) == len(js)
    assert ts == js
    dec = tdec.GeneralDecoder()
    out = dec.decode(ts)
    assert dec.hash_status == [True] * n
    for k, (r, o) in enumerate(zip(trec, out)):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c],
                                          err_msg=f"picture {k} plane {c}")

    # stage parity, each stage fed the reference's own inputs
    assert len(calls["b"]) == len(calls["rec"]) == n - 1
    bw, bh = w // 16, h // 16
    for i, ((ba, bkw, bout), (ra_, jinfo)) in enumerate(
            zip(calls["b"], calls["rec"])):
        assert bkw["deblock"] and "allow_intra" not in bkw and \
            "merge_eval" not in bkw      # the flat path's defaults
        st = tinter.encode_b_frame_dev(*(_t(a) for a in ba), **bkw)
        _dict_equal(st, bout, f"encode_b_frame_dev, call {i}")
        st_np, _, _, ref_poc, poc, is_anchor = ra_
        st_np = {k: np.asarray(v) for k, v in st_np.items()}
        tinfo = tinter._reconcile_b(st_np, bw, bh, ref_poc, poc, is_anchor)
        _blocks_equal(tinfo, jinfo, f"_reconcile_b, call {i}")
        bs_v, bs_h = tinter.bs_maps_b_dev(*(
            torch.from_numpy(st_np[k].astype(bool if k == "cbf_y"
                                             else np.int32))
            for k in ("pred_mode", "cbf_y", "inter_dir", "mv0x", "mv0y",
                      "mv1x", "mv1y")))
        hv, hh = tbc._bs_maps_b(tinfo, bw, bh, ref_poc)
        np.testing.assert_array_equal(bs_v.numpy(), hv)
        np.testing.assert_array_equal(bs_h.numpy(), hh)
    return calls


def test_flat_ra_gop8_64x48_streams_decoder_and_stages(monkeypatch):
    """The flat RA GOP-8 over 9 pictures (the anchor P at POC 8, B
    pictures at every temporal layer, HM's lambda ladder), with intra
    blocks in its inter pictures (the seed-5 clip codes some)."""
    calls = _run(monkeypatch, "ra", 64, 48, 9, seed=5, qp=32, sr=16)
    assert any((c[2]["pred_mode"] == 1).any() for c in calls["b"])


def test_flat_hierb_64x48_streams_decoder_and_stages(monkeypatch):
    """The 2-level hierarchical-B engine over I0 P2 B1 P4 B3, with
    intra blocks in its inter pictures."""
    calls = _run(monkeypatch, "hierb", 64, 48, 5, seed=5, qp=30, sr=16)
    assert any((c[2]["pred_mode"] == 1).any() for c in calls["b"])


# the copied host functions of this slice, which must be the original's
# text (test_torch_hevc_host.py checks every function of these modules;
# this names the ones the flat engines added)
_FLAT_COPIES = {
    "models/hevc/bframe_codec.py": (
        "models/hevc/bframe_codec.py",
        ("mv_scale", "derive_merge", "derive_amvp_b", "write_b_slice_header",
         "HierarchicalBEncoder.encode_sequence_rab",
         "HierarchicalBEncoder._encode_b_slice",
         "HierarchicalBEncoder._encode_b_ctu",
         "HierarchicalBEncoder._write_residuals", "_AsP.__init__",
         "_bs_maps_b")),
    "models/hevc/ra_codec.py": (
        "models/hevc/ra_codec.py",
        ("RandomAccessEncoder._encode_b_slice",
         "RandomAccessEncoder._encode_b_frame")),
    "models/hevc/inter_dev.py": (
        "models/hevc/inter_jax.py",
        ("_reconcile_b", "DeviceHierarchicalBEncoder._encode_b_frame",
         "DeviceRandomAccessEncoder._encode_b_frame")),
}


@pytest.mark.parametrize("mod", sorted(_FLAT_COPIES))
def test_flat_b_host_copies_are_the_originals(mod):
    orig_mod, names = _FLAT_COPIES[mod]
    port, _ = _defs(REPO / "video_codecs_tpu_torch" / mod)
    orig, _ = _defs(REPO / "video_codecs_tpu" / orig_mod)
    for name in names:
        assert port[name][1] == orig[name][1], f"{mod}: {name} differs"
    if mod.endswith("bframe_codec.py"):
        src = (REPO / "video_codecs_tpu_torch" / mod).read_text()
        ref = (REPO / "video_codecs_tpu" / orig_mod).read_text()
        for cls in ("class BBlock:", "class _AsP:"):
            i, j = src.index(cls), ref.index(cls)
            assert src[i:src.index("\n\n", i)] == ref[j:ref.index("\n\n", j)]


def test_flat_b_merge_amvp_and_headers_match():
    """The spec derivations and the slice headers on a seeded block grid
    and every slice type, against the JAX package's."""
    rng = np.random.default_rng(4)
    bw, bh = 6, 4
    grids = []
    for mod in (jbc, tbc):
        g = [[None] * bw for _ in range(bh)]
        r2 = np.random.default_rng(7)
        for by in range(bh):
            for bx in range(bw):
                b = mod.BBlock()
                if r2.random() < 0.8:
                    b.pred_mode = mod.MODE_INTER
                    b.inter_dir = int(r2.integers(1, 4))
                    b.mv = {lx: tuple(int(x) for x in
                                      r2.integers(-40, 40, 2))
                            for lx in (0, 1) if b.inter_dir & (1 << lx)}
                    b.cbf_y = bool(r2.random() < 0.5)
                g[by][bx] = b
        grids.append(g)
    ref_poc = {0: 0, 1: 4}
    for by in range(bh):
        for bx in range(bw):
            for is_b in (False, True):
                assert tbc.derive_merge(grids[1], bx, by, bw, bh, is_b) == \
                    jbc.derive_merge(grids[0], bx, by, bw, bh, is_b)
            for lx in (0, 1):
                assert tbc.derive_amvp_b(grids[1], bx, by, bw, bh, lx, 2,
                                         ref_poc) == \
                    jbc.derive_amvp_b(grids[0], bx, by, bw, bh, lx, 2,
                                      ref_poc)
    for a, b in zip(tbc._bs_maps_b(grids[1], bw, bh, ref_poc),
                    jbc._bs_maps_b(grids[0], bw, bh, ref_poc)):
        np.testing.assert_array_equal(a, b)
    for _ in range(20):
        mv = tuple(int(x) for x in rng.integers(-500, 500, 2))
        tb, td = (int(x) for x in rng.integers(-16, 17, 2))
        if td:
            assert tbc.mv_scale(mv, tb, td) == jbc.mv_scale(mv, tb, td)
    for dbk in (False, True):
        for anchor in (False, True):
            for nd in (1, 2, 4):
                c_t = _cfg(theaders, 64, 48, 1, deblocking_disabled=dbk)
                c_j = _cfg(jheaders, 64, 48, 1, deblocking_disabled=dbk)
                assert tbc.write_b_slice_header(c_t, 6, anchor,
                                                nd).data() == \
                    jbc.write_b_slice_header(c_j, 6, anchor, nd).data()


def test_flat_b_cut_options_raise():
    """What the reference codes on its host path (tiles) or mis-codes
    (TMVP, merge_idx under MaxNumMergeCand > 1 in the RA header, timing
    SEI and the long-term IDR, which its B loop does not write), and the
    options the port does not carry, raise ValueError; SAO is taken; the
    engines run on the card by default; the host B coder (ported since)
    codes an anchor picture."""
    ok = _cfg(theaders, 64, 48, 3)
    for cls in (tinter.DeviceRandomAccessEncoder,
                tinter.DeviceHierarchicalBEncoder):
        enc = cls(ok)
        assert enc.device == torch.device("cuda")
        for m in tinter.ME_METHODS:
            assert cls(ok, me_method=m, device="cpu").me_method == m
        with pytest.raises(ValueError):
            cls(ok, me_method="hex", device="cpu")
        for opt, val in (("tile_columns", 2), ("wpp", True),
                         ("weighted_pred", True), ("cu_qp_delta", True),
                         ("timing_sei", True), ("long_term_idr", True),
                         ("temporal_mvp", True), ("log2_ctb", 5)):
            with pytest.raises(ValueError):
                cls(_cfg(theaders, 64, 48, 3, **{opt: val}), device="cpu")
        assert cls(_cfg(theaders, 64, 48, 3, sao=True),
                   device="cpu").cfg.sao
    with pytest.raises(ValueError):
        tinter.DeviceRandomAccessEncoder(
            _cfg(theaders, 64, 48, 3, merge_cands=5), device="cpu")
    z = np.zeros((48, 64), np.uint8)
    zc = z[::2, ::2]
    host = tra.RandomAccessEncoder(ok, device="cpu")
    nals, _ = host._encode_b_frame((z, zc, zc), 2, {0: (0, (z, zc, zc))},
                                   True)
    assert len(nals) == 2            # the host B coder codes the picture
    zt = torch.zeros((48, 64), dtype=torch.uint8)
    ztc = zt[::2, ::2]
    args = (zt, ztc, ztc) * 3
    kw = dict(qp=32, w=64, h=48, has_l1=False, search_range=8, sbh=True,
              rdoq=True)
    with pytest.raises(ValueError):
        tinter.encode_b_frame_dev(*args, merge_eval="best5", **kw)
    # the tile-sharded inputs (ported): gx_blk0 = 0 and pic_bw = the
    # picture's width are the untiled geometry, so the flat path's dict
    # is the untiled one (tests/test_torch_multichip.py holds a tile's to
    # the JAX function)
    frames = clip(64, 48, 2, seed=9)
    planes = [torch.from_numpy(p) for p in frames[1] + frames[0] * 2]
    _dict_equal(tinter.encode_b_frame_dev(*planes, gx_blk0=0, pic_bw=4,
                                          **kw),
                tinter.encode_b_frame_dev(*planes, **kw), "gx_blk0")
