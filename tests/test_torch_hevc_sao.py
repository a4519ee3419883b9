"""Sample adaptive offset (SAO) in the port against the JAX package's, on
the CPU: the per-CTB statistics, the decisions, the apply, the sao()
syntax, the RA quadtree encoder with `cfg.sao`, the flat CTB16 engines
with `cfg.sao` (their decision at luma CTB 16 and chroma CTB 8, their IDR
against the reference's host CTB loop, the LD-P and flat RA streams) and
the general decoder.

Inputs are made from seeds with numpy and go through the JAX function
and the port's; tolerance 0 everywhere (the statistics' float32 sums are
integers below 2^24, exact in any order).  Each stream configuration is
one test, so that no pytest-xdist worker compiles another's JAX
programs; clips are at most 112x80.

The `cuda` cases hold the CUDA kernel of `ops/sao.sao_stats` against its
plain version on the card and skip where there is none.  The card's
machine has no JAX, so JAX is imported only inside the tests that need
it:

    python -m pytest --noconftest -m cuda tests/test_torch_hevc_sao.py
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.entropy import cabac as tcabac
from video_codecs_tpu_torch.entropy import ctx as tctx
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import inter_qt as tqt
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.ops import sao as tsao

torch.set_grad_enabled(False)


def _jsao():
    pytest.importorskip("jax")
    from video_codecs_tpu.ops import sao
    return sao


def _planes(seed, h, w, noise=6, flat=False):
    """A smooth orig and a recon with coding-like errors: a blur, a
    per-region bias and noise, so that every SAO type pays somewhere."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    orig = 128 + 70 * np.sin(xx / 5.0 + seed) * np.cos(yy / 7.0)
    if not flat:
        orig = orig + rng.normal(0, 12, (h, w))
    orig = np.clip(orig, 0, 255)
    blur = (orig + np.roll(orig, 1, 0) + np.roll(orig, 1, 1) +
            np.roll(orig, -1, 1)) / 4
    bias = np.where((yy // 16 + xx // 16) % 3 == 0, 4, 0)
    rec = np.clip(blur + bias + rng.integers(-noise, noise + 1, (h, w)),
                  0, 255)
    return orig.astype(np.uint8), rec.astype(np.uint8)


def _key_grid(params):
    return [[p.key() if p is not None else None for p in p3]
            for p3 in params]


# ---- (a) statistics ------------------------------------------------------

@pytest.mark.parametrize("ctb,h,w", [(16, 40, 56), (32, 80, 112),
                                     (32, 64, 96), (16, 48, 64),
                                     (8, 24, 32), (8, 44, 60)])
def test_sao_stats_ref_equals_jax(ctb, h, w):
    """sao_stats_ref against the JAX `sao_stats_dev`, all four outputs,
    dtypes too, on planes `_pad_to` edge-pads to a CTB multiple."""
    jsao = _jsao()
    import jax.numpy as jnp
    from video_codecs_tpu.models.hevc import inter_qt as jqt
    o0, r0 = _planes(ctb + h + w, h, w)
    r0[:5, :7] = 77                      # a flat patch: category 0 runs
    o = jqt._pad_to(o0.astype(np.int32), ctb)
    r = jqt._pad_to(r0.astype(np.int32), ctb)
    np.testing.assert_array_equal(tqt._pad_to(o0, ctb), o)
    want = [np.asarray(a) for a in jsao.sao_stats_dev(jnp.asarray(o),
                                                      jnp.asarray(r), ctb)]
    for dt in (np.uint8, np.int32):      # the kernel's type and the JAX's
        got = [a.numpy() for a in tqt._sao_stats(
            torch.from_numpy(o.astype(dt)), torch.from_numpy(r.astype(dt)),
            ctb)]
        for g, w_, name in zip(got, want, ("eo_count", "eo_sum",
                                           "bo_count", "bo_sum")):
            assert g.dtype == w_.dtype, name
            np.testing.assert_array_equal(g, w_, err_msg=name)
    cy, cx = o.shape[0] // ctb, o.shape[1] // ctb
    assert int(got[0][0].sum()) == cy * cx * ctb * ctb   # padding counts


def test_sao_stats_wrapper_checks_and_cpu_path():
    o, r = _planes(1, 32, 64)
    to, tr = torch.from_numpy(o), torch.from_numpy(r)
    n0 = tsao.sao_stats.launches
    got = tsao.sao_stats(to, tr, 32)
    assert tsao.sao_stats.launches == n0          # the CPU runs the plain
    for g, w_ in zip(got, tsao.sao_stats_ref(to, tr, 32)):
        assert torch.equal(g, w_)
    with pytest.raises(ValueError):
        tsao.sao_stats(to, tr, 48)                # not a CTB multiple
    with pytest.raises(ValueError):
        tsao.sao_stats(to[:16], tr, 16)           # shapes differ
    assert tuple(got[0].shape) == (4, 5, 1, 2)
    assert tuple(got[2].shape) == (32, 1, 2)


# ---- (b) decisions, category maps, apply --------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_maps_and_apply_equal_jax(seed):
    jsao = _jsao()
    h, w, ctb = 64, 96, 16
    o, r = _planes(seed, h, w, flat=seed == 2)
    ec, es, bc, bsum = [a.numpy() for a in tsao.sao_stats_ref(
        torch.from_numpy(o), torch.from_numpy(r), ctb)]
    kinds = set()
    params = []
    for lam in (2.0, 30.0, 300.0):
        for by in range(h // ctb):
            for bx in range(w // ctb):
                a = (ec[:, :, by, bx], es[:, :, by, bx], bc[:, by, bx],
                     bsum[:, by, bx])
                t = tsao.decide_from_stats(*a, lam)
                assert t.key() == jsao.decide_from_stats(*a, lam).key()
                for k in range(4):
                    assert tsao.decide_eo_from_stats(
                        a[0], a[1], k, lam).key() == \
                        jsao.decide_eo_from_stats(a[0], a[1], k, lam).key()
                assert tsao.decide_bo_from_stats(a[2], a[3], lam).key() == \
                    jsao.decide_bo_from_stats(a[2], a[3], lam).key()
                if lam == 30.0:
                    params.append([t, tsao.decide_eo_from_stats(
                        a[0], a[1], (bx + by) % 4, lam),
                        tsao.decide_bo_from_stats(a[2], a[3], lam)])
                kinds.add(t.type_idx)
    # decide_ctu on the planes themselves (the host twin)
    for lam in (2.0, 30.0):
        for (x0, y0) in ((0, 0), (16, 32), (80, 48)):
            assert tsao.decide_ctu(o, r, x0, y0, ctb, lam).key() == \
                jsao.decide_ctu(o, r, x0, y0, ctb, lam).key()
    if seed < 2:                         # the textured planes: all types
        assert kinds == {tsao.SAO_OFF, tsao.SAO_BO, tsao.SAO_EO}
    for k in range(4):
        np.testing.assert_array_equal(tsao.eo_category_map(r, k),
                                      jsao.eo_category_map(r, k))
    jparams = [[jsao.SaoParam(*p.key()) for p in p3] for p3 in params]
    for comp in range(3):
        np.testing.assert_array_equal(
            tsao.apply_frame(r, params, ctb, comp),
            jsao.apply_frame(r, jparams, ctb, comp))


# ---- (c) sao() syntax -----------------------------------------------------

def _param_grid(mod, seed, bw, bh):
    """Seeded per-CTB params with left and up merges; Cr follows Cb's
    type (and EO class), as the syntax requires."""
    rng = np.random.default_rng(seed)

    def one(t, cls=None):
        if t == mod.SAO_OFF:
            return mod.SaoParam()
        if t == mod.SAO_EO:
            return mod.SaoParam(mod.SAO_EO, int(rng.integers(0, 4))
                                if cls is None else cls, 0,
                                tuple(int(v) for v in rng.integers(0, 8, 4)))
        offs = rng.integers(-7, 8, 4)
        offs[rng.random(4) < 0.3] = 0
        return mod.SaoParam(mod.SAO_BO, 0, int(rng.integers(0, 32)),
                            tuple(int(v) for v in offs))

    params = []
    for i in range(bw * bh):
        bx, by = i % bw, i // bw
        u = rng.random()
        if bx and u < 0.25:
            params.append(list(params[i - 1]))
            continue
        if by and u < 0.4:
            params.append(list(params[i - bw]))
            continue
        y = one(int(rng.integers(0, 3)))
        cb = one(int(rng.integers(0, 3)))
        cr = one(cb.type_idx, cb.eo_class if cb.type_idx == mod.SAO_EO
                 else None)
        params.append([y, cb, cr])
    return params


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sao_syntax_bytes_equal_and_read_back(seed):
    jsao = _jsao()
    from video_codecs_tpu.entropy import bitstream as jbs
    from video_codecs_tpu.entropy import cabac as jcabac
    from video_codecs_tpu.entropy import ctx as jctx
    from video_codecs_tpu.models.hevc import intra_codec as jic
    bw, bh = 6, 4
    tparams = _param_grid(tsao, seed, bw, bh)
    jparams = [[jsao.SaoParam(*p.key()) for p in p3] for p3 in tparams]
    data = []
    for bsm, cab, cx, ic, params in ((tbs, tcabac, tctx, tic, tparams),
                                     (jbs, jcabac, jctx, jic, jparams)):
        w = bsm.BitWriter()
        enc = cab.CabacEncoder(w, cx.init_states(cx.B, 32))
        for i in range(bw * bh):
            ic.encode_sao_ctu(enc, params, i, i % bw, i // bw, bw, 0)
            enc.encode_terminate(1 if i == bw * bh - 1 else 0)
        enc.finish_slice()
        data.append(w.data())
    assert data[0] == data[1]
    assert len(data[0]) > 20
    for cab, cx, ic, bsm in ((tcabac, tctx, tic, tbs),
                             (jcabac, jctx, jic, jbs)):
        dec = cab.CabacDecoder(bsm.BitReader(data[0]),
                               cx.init_states(cx.B, 32))
        got = [None] * (bw * bh)
        for i in range(bw * bh):
            ic.decode_sao_ctu(dec, got, i, i % bw, i // bw, bw, 0)
            assert dec.decode_terminate() == (i == bw * bh - 1)
        assert _key_grid(got) == _key_grid(tparams)


# ---- (d) the decoder's apply ---------------------------------------------

@pytest.mark.parametrize("size,bit_depth", [(32, 8), (16, 8), (16, 10),
                                            (8, 8)])
def test_decoder_apply_equals_apply_ctu_loop(size, bit_depth):
    """ops/sao.apply_ctus (each EO map once per plane) against a loop of
    the JAX `apply_ctu` per CTB, as the reference decoder runs it; the
    plane is not a CTB multiple (partial edge CTBs)."""
    jsao = _jsao()
    h, w = 3 * size + size // 2, 4 * size + size // 4
    rng = np.random.default_rng(size + bit_depth)
    pre = rng.integers(0, 1 << bit_depth, (h, w)).astype(np.int32)
    pre[: size, : size] = (1 << bit_depth) - 2          # near the clip
    cw, ch = -(-w // size), -(-h // size)
    params = [p3[0] for p3 in _param_grid(tsao, size, cw, ch)]
    want = pre.copy()
    for i, p in enumerate(params):
        jsao.apply_ctu(pre, want, (i % cw) * size, (i // cw) * size, size,
                       jsao.SaoParam(*p.key()), bit_depth=bit_depth)
    got = tsao.apply_ctus(pre, params, size, cw, bit_depth)
    assert got.dtype == pre.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, pre)


# ---- (e) the RA quadtree encoder with SAO, and the decoder ---------------

def test_ra_sao_stream_equals_jax_and_decodes(monkeypatch):
    """tests/test_inter_qt.py::test_qt_ra_sao_roundtrip's configuration
    (112x80: partial edge CTBs; SR8, the CU8 tree): the port's stream is
    the JAX encoder's byte for byte, every picture's statistics (recorded
    at the JAX `_sao_stats_jit`) and SAO parameters are equal, and the
    port's GeneralDecoder gives every hash OK and the encoder's
    pictures."""
    pytest.importorskip("jax")
    import test_inter_qt
    from video_codecs_tpu.models.hevc import inter_qt as jqt
    w, h = 112, 80
    frames = test_inter_qt.clip(w, h, 9, seed=11)
    stats, params = [], {"jax": [], "port": []}
    orig_stats = jqt._sao_stats_jit

    def rec_stats(o, r, ctb):
        out = orig_stats(o, r, ctb)
        stats.append((np.asarray(o), np.asarray(r), ctb,
                      [np.asarray(a) for a in out]))
        return out

    monkeypatch.setattr(jqt, "_sao_stats_jit", rec_stats)
    streams = {}
    for name, mod, kw in (("jax", jqt, {}), ("port", tqt, {"device": "cpu"})):
        cfg = test_inter_qt._cfg(w, h)
        if name == "port":
            cfg = theaders.HevcConfig(**vars(cfg))
        cfg.sao = True
        enc = mod.QtDeviceRandomAccessEncoder(cfg, search_range=8, **kw)
        decide = enc._sao_decide_qt

        def keep(*a, _d=decide, _l=params[name], **k):
            p = _d(*a, **k)
            _l.append(_key_grid(p))
            return p

        enc._sao_decide_qt = keep
        streams[name] = enc.encode_sequence_ra(frames)
    (js, _), (ts, trec) = streams["jax"], streams["port"]
    assert len(stats) == 3 * 8           # 3 planes of 8 B/P pictures
    for o, r, ctb, want in stats:
        got = tqt._sao_stats(torch.from_numpy(o.astype(np.uint8)),
                             torch.from_numpy(r.astype(np.uint8)), ctb)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w_)
    assert params["port"] == params["jax"]
    types = {p[c][0] for pic in params["port"] for p in pic for c in range(3)}
    assert types == {tsao.SAO_OFF, tsao.SAO_BO, tsao.SAO_EO}
    assert ts == js
    dec = tdec.GeneralDecoder()
    out = dec.decode(ts)
    assert dec.hash_status == [True] * len(frames)
    for k, (r, o) in enumerate(zip(trec, out)):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c],
                                          err_msg=f"picture {k} plane {c}")


# ---- (f) the flat CTB16 engines with SAO ---------------------------------

def _flat_cfgs(w, h, qp, **kw):
    from video_codecs_tpu.models.hevc import headers as jheaders
    return tuple(m.HevcConfig(width=w, height=h, qp=qp, sao=True,
                              sign_data_hiding=True, **kw)
                 for m in (jheaders, theaders))


def _flat_planes(seed, w, h):
    """Luma and chroma planes (int32, as the encoders pass them) with
    coding-like errors; the first chroma CTB of both Cb and Cr holds only
    bands 12-14 with a bias of +5, so that Cb takes band offsets and Cr's
    two windows 11 and 12 tie (bands 11 and 15 are empty)."""
    oy, ry = _planes(seed, h, w)
    ou, ru = _planes(seed + 100, h // 2, w // 2, noise=3)
    ov, rv = _planes(seed + 200, h // 2, w // 2, noise=9)
    rng = np.random.default_rng(seed)
    for o, r in ((ou, ru), (ov, rv)):
        r[:8, :8] = rng.integers(96, 120, (8, 8))
        o[:8, :8] = r[:8, :8] + 5
    return (tuple(p.astype(np.int32) for p in (oy, ou, ov)),
            tuple(p.astype(np.int32) for p in (ry, ru, rv)))


@pytest.mark.parametrize("w,h,qp", [(64, 48, 32), (96, 64, 27),
                                    (96, 64, 37)])
def test_flat_sao_decide_apply_equals_jax(w, h, qp):
    """`IntraEncoder._sao_decide_apply` of the flat engines (luma CTB 16,
    chroma CTB 8, Cr following Cb's type and class) from the statistics
    of `sao_stats` against the reference's host decision from the planes:
    the same SaoParam CTU by CTU and the same output planes.  At QP 27
    and 32 the first CTU's Cr band offsets pick the first of two tied
    windows: the port's decision from statistics with numpy's window sums
    (`decide_bo_from_stats`) and the reference's left-to-right loop
    (`_sao_bo_for`) agree there (at QP 37 lambda makes that CTU's Cb take
    no offset)."""
    _jsao()
    from video_codecs_tpu.models.hevc import intra_codec as jic
    jcfg, tcfg = _flat_cfgs(w, h, qp)
    origs, recs = _flat_planes(qp + w, w, h)
    jp, jout = jic.IntraEncoder(jcfg)._sao_decide_apply(origs, recs)
    tp, tout = tic.IntraEncoder(tcfg, device="cpu")._sao_decide_apply(
        origs, recs)
    assert _key_grid(tp) == _key_grid(jp)
    for c in range(3):
        assert tout[c].dtype == jout[c].dtype
        np.testing.assert_array_equal(tout[c], jout[c], err_msg=f"plane {c}")
    kinds = {p3[c].type_idx for p3 in tp for c in range(3)}
    assert len(kinds) >= 2
    if qp > 32:
        return
    # the tie: Cb takes BO at CTU 0, Cr's windows 11 and 12 cost the same
    assert tp[0][1].type_idx == tsao.SAO_BO
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    band = recs[2][:8, :8] >> 3
    assert set(np.unique(band)) == {12, 13, 14}
    counts = np.bincount(band.reshape(-1), minlength=32)
    sums = np.bincount(band.reshape(-1), minlength=32, weights=(
        origs[2][:8, :8] - recs[2][:8, :8]).reshape(-1).astype(np.float64))
    costs = []
    for bnd in range(32):
        cp = tsao._best_offset(sums[bnd], int(counts[bnd]), True, lam)[1]
        cn = tsao._best_offset(sums[bnd], int(counts[bnd]), False, lam)[1]
        costs.append(min(cp, cn))
    win = [sum(costs[p:p + 4]) for p in range(29)]
    assert win[11] == win[12] == min(win)
    assert tp[0][2].band_position == 11
    assert tp[0][2].key() == jic.IntraEncoder._sao_bo_for(
        origs[2], recs[2], 0, 0, 8, lam).key() == \
        tsao.decide_bo_from_stats(counts, sums, lam).key()


def test_general_decoder_decodes_jax_ldp_sao_stream(monkeypatch):
    """tests/test_inter_jax.py::test_device_ldp_roundtrip's SAO case
    (64x48, 4 references, TMVP, 5 pictures): CTB16 SAO in I and P slices
    (the JAX package codes this IDR on its host path).  The port's
    `DeviceLowDelayEncoder` on the CPU writes the same bytes; every
    picture's SAO parameters are the JAX encoder's, and the port's
    decision on the JAX encoder's own planes gives the JAX encoder's
    parameters and output; every hash OK in the port's GeneralDecoder,
    pictures equal to the JAX recon."""
    pytest.importorskip("jax")
    import test_inter_jax
    from video_codecs_tpu.models.hevc import headers as jheaders
    from video_codecs_tpu.models.hevc import intra_codec as jic
    from video_codecs_tpu.models.hevc import inter_jax as jinter
    calls = {"jax": [], "port": []}

    def recorder(cls, key):
        orig = cls._sao_decide_apply

        def rec(self, origs, recs):
            params, outs = orig(self, origs, recs)
            calls[key].append((self.cfg.qp, origs, recs, params, outs))
            return params, outs
        monkeypatch.setattr(cls, "_sao_decide_apply", rec)

    recorder(jic.IntraEncoder, "jax")
    recorder(tic.IntraEncoder, "port")
    w, h = 64, 48
    cfg = jheaders.HevcConfig(width=w, height=h, qp=30, num_refs=4,
                              temporal_mvp=True, sao=True, merge_cands=5,
                              sign_data_hiding=True)
    enc = jinter.DeviceLowDelayEncoder(cfg, search_range=16)
    frames = test_inter_jax.clip(w, h, 5)
    stream, recons = enc.encode_sequence_ldp(frames)
    tstream, _ = tinter.DeviceLowDelayEncoder(
        theaders.HevcConfig(**vars(cfg)), search_range=16,
        device="cpu").encode_sequence_ldp(frames)
    assert tstream == stream
    assert len(calls["jax"]) == len(calls["port"]) == len(frames)
    tenc = tic.IntraEncoder(theaders.HevcConfig(**vars(cfg)), device="cpu")
    for k, (j, t) in enumerate(zip(calls["jax"], calls["port"])):
        assert j[0] == t[0], k                       # the picture's QP
        assert _key_grid(t[3]) == _key_grid(j[3]), k
        tenc.cfg.qp = j[0]
        params, outs = tenc._sao_decide_apply(j[1], j[2])
        assert _key_grid(params) == _key_grid(j[3]), k
        for c in range(3):
            np.testing.assert_array_equal(outs[c], j[4][c])
    assert {p.type_idx for call in calls["jax"] for p3 in call[3]
            for p in p3} == {tsao.SAO_OFF, tsao.SAO_BO, tsao.SAO_EO}
    dec = tdec.GeneralDecoder()
    out = dec.decode(stream)
    assert dec.sps.sao and dec.sps.log2_ctb == 4
    assert dec.hash_status == [True] * len(frames)
    for k, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(r[c]), o[c],
                                          err_msg=f"picture {k} plane {c}")


def test_flat_ra_sao_gop8_64x48_equals_jax():
    """The flat RA GOP-8 over 9 pictures with SAO (the settings of
    tests/test_inter_jax.py::test_device_ra_gop8_roundtrip, whose JAX
    programs a run's shared cache holds): the port's stream is the JAX
    package's byte for byte and decodes hash OK in the port."""
    pytest.importorskip("jax")
    from test_torch_hevc_ra import clip
    from video_codecs_tpu.models.hevc import inter_jax as jinter
    jcfg, tcfg = _flat_cfgs(64, 48, 32, reorder_pics=3)
    frames = clip(64, 48, 9, seed=5)
    js, _ = jinter.DeviceRandomAccessEncoder(
        jcfg, search_range=16).encode_sequence_ra(frames)
    ts, trec = tinter.DeviceRandomAccessEncoder(
        tcfg, search_range=16, device="cpu").encode_sequence_ra(frames)
    assert ts == js
    dec = tdec.GeneralDecoder()
    out = dec.decode(ts)
    assert dec.sps.sao and dec.hash_status == [True] * len(frames)
    for k, (r, o) in enumerate(zip(trec, out)):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c],
                                          err_msg=f"picture {k} plane {c}")


@pytest.mark.parametrize("rdoq", [False, "lite", True, "full"])
def test_sao_idr_equals_jax_host_loop(rdoq):
    """The SAO IDR: the port's `encode_frame` against the reference's
    host CTB loop `encode_frame`, bytes and pictures, at 64x48 and 96x64
    and two QPs.  At rdoq off the port codes it with the flat device
    encoder, SAO from the device statistics and the Python slice writer;
    with RDOQ it takes the host CTB loop as the reference does (float64
    `rdoq_lite_np`, or at "full" the host full RDOQ), because there the
    reference's device path (float32 RDOQ-lite) writes another stream,
    which the "lite" case shows on this picture without SAO."""
    pytest.importorskip("jax")
    import bench
    from video_codecs_tpu.models.hevc import intra_codec as jic
    for w, h in ((64, 48), (96, 64)):
        for qp in (27, 37):
            jcfg, tcfg = _flat_cfgs(w, h, qp, rdoq=rdoq)
            tenc = tic.IntraEncoder(tcfg, device="cpu")
            y, u, v = bench.synth_clip(w, h, 1, seed=qp)[0]
            jn, jr = jic.IntraEncoder(jcfg).encode_frame(y, u, v)
            tn, tr = tenc.encode_frame(y, u, v)
            assert tn == jn
            for c in range(3):
                assert tr[c].dtype == np.int32
                np.testing.assert_array_equal(tr[c], jr[c])
            if rdoq == "lite" and (w, qp) == (64, 27):
                jcfg.sao = False
                jenc = jic.IntraEncoder(jcfg)
                assert jenc.encode_frame(y, u, v)[0][0] != \
                    jenc.encode_frame_fast(y, u, v)[0][0]


# ---- (g) the kernel on the card --------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("ctb,h,w", [(16, 48, 64), (32, 96, 128),
                                     (16, 16, 16), (32, 1088, 1920),
                                     (16, 544, 960), (8, 240, 416),
                                     (8, 536, 960), (16, 480, 832),
                                     (8, 24, 48), (8, 8, 8)])
def test_sao_kernel_matches_plain_on_card(ctb, h, w):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    o, r = _planes(ctb * 7 + h, h, w)
    r[:9, :11] = 200
    to, tr = torch.from_numpy(o).cuda(), torch.from_numpy(r).cuda()
    n0 = tsao.sao_stats.launches
    got = tsao.sao_stats(to, tr, ctb)
    torch.cuda.synchronize()
    assert tsao.sao_stats.launches == n0 + 1
    for g, w_ in zip(got, tsao.sao_stats_ref(to, tr, ctb)):
        assert g.dtype == w_.dtype
        assert (g - w_).abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ctb,h,w", [
    ("one_bin", 16, 64, 96), ("one_bin", 32, 128, 192),
    ("random", 16, 48, 80), ("random", 32, 96, 160),
    ("one_ctb", 16, 16, 16), ("one_ctb", 32, 32, 32),
    ("one_bin", 8, 40, 72), ("random", 8, 48, 104), ("one_ctb", 8, 8, 8)])
def test_sao_kernel_crowded_and_spread_bins(kind, ctb, h, w):
    """Planes for the kernel's per-lane bins: a flat rec, where every
    sample of a CTB lands in EO category 0 and one band (every lane of a
    warp on one bin); uniform noise in orig and rec, where the lanes spread
    over all bins; and a plane of one CTB (a strip of one CTB).  At CTB 8
    the widths 72 and 104 (9 and 13 CTBs) end in a partial strip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    rng = np.random.default_rng(ctb * 31 + h)
    o = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "one_bin":
        r = np.full((h, w), 141, np.uint8)
    elif kind == "random":
        r = rng.integers(0, 256, (h, w), dtype=np.uint8)
    else:
        o, r = _planes(ctb, h, w)
    to, tr = torch.from_numpy(o).cuda(), torch.from_numpy(r).cuda()
    got = tsao.sao_stats(to, tr, ctb)
    torch.cuda.synchronize()
    want = tsao.sao_stats_ref(to, tr, ctb)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert g.stride() == w_.contiguous().stride()
        assert torch.equal(g, w_)
    if kind == "one_bin":
        assert int(got[0][:, 0].sum()) == 4 * h * w     # EO category 0
        assert int(got[2][141 >> 3].sum()) == h * w     # one band


@pytest.mark.cuda
def test_sao_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    z = torch.zeros((32, 32), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        tsao.sao_stats(z, z, 4)                   # not a kernel CTB
    with pytest.raises(ValueError):
        tsao.sao_stats(z[:, :12], z[:, :12], 8)   # not a CTB 8 multiple
    with pytest.raises(TypeError):
        tsao.sao_stats(z.int(), z.int(), 32)
    with pytest.raises(ValueError):
        tsao.sao_stats(z.t()[:, :16], z.t()[:, :16], 16)


@pytest.mark.cuda
def test_sao_kernel_refuses_a_misaligned_orig():
    """The kernel reads orig in aligned 32-bit words: a plane that starts
    off a 4-byte boundary is refused, not read wrong."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    o, r = _planes(5, 32, 64)
    buf = torch.zeros(32 * 64 + 1, dtype=torch.uint8, device="cuda")
    to = buf[1:].view(32, 64)
    to.copy_(torch.from_numpy(o).cuda())
    assert to.is_contiguous() and to.data_ptr() % 4
    with pytest.raises(RuntimeError, match="cudaError"):
        tsao.sao_stats(to, torch.from_numpy(r).cuda(), 32)
