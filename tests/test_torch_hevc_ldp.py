"""The port's HEVC low-delay P encoder against the JAX package's, on the
CPU: the four-reference device engine `DeviceLowDelayEncoder`, its flat
CTB16 intra device path (the IDR) and intra wavefront, and the host
P-slice coder.

For each stream configuration (one test each, so that no pytest-xdist
worker compiles another's JAX programs) the JAX encoder and the port's
encode the same seeded clip (chip_smoke's scene cut, bench.py's clip),
whose P pictures code intra blocks through the wavefront:
  - the streams are byte-equal, decode with every picture hash OK in the
    port's `GeneralDecoder`, and the decoded pictures are the encoder's.
    The port repairs one fault of the reference: its AMVP predictor list
    (`motion.amvp_candidates`) differs from a decoder's for a block with
    no left neighbour whose upper neighbours use different references,
    so its stream can fail a picture hash (bench.py's clip at 96x64 and
    4 references does).  There the port's stream is held to the JAX
    encoder's with that one function swapped for the spec's;
  - stage parity without cascades: the JAX encoder's device stages
    (`encoder_jax.encode_frame_jit`, `inter_jax.encode_p_frame_dev`)
    are wrapped inside the test to record their inputs and outputs (no
    file of the JAX package is edited), the same inputs go through the
    port's stages, and the dicts are compared key by key.
Tolerance 0 everywhere.  Clips are 96x64.
"""

import ast
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from bench import synth_clip
from chip_smoke import cut_clip

from video_codecs_tpu.models.hevc import encoder_jax as jenc
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import inter_jax as jinter
from video_codecs_tpu.models.hevc import intra_codec as jic
from video_codecs_tpu.models.hevc import motion as jmotion
from video_codecs_tpu.ops import deblock as jdbk
from video_codecs_tpu.ops import interp as jinterp
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import encoder_dev as tenc
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import inter_codec as tpc
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.models.hevc import motion as tmotion
from video_codecs_tpu_torch.ops import deblock as tdbk
from video_codecs_tpu_torch.ops import interp as tinterp

torch.set_grad_enabled(False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


def _t(v):
    """A recorded JAX input as the port takes it: arrays as CPU tensors,
    0-d integers as Python ints."""
    a = np.asarray(v)
    return int(a) if a.ndim == 0 else torch.from_numpy(a.copy())


def _dict_equal(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    bad = []
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w_ = np.asarray(want[k])
        assert g.dtype == w_.dtype, (what, k, g.dtype, w_.dtype)
        if not np.array_equal(g, w_):
            bad.append((k, int((g != w_).sum())))
    assert not bad, (what, bad)


def _cfg(mod, w, h, **kw):
    return mod.HevcConfig(width=w, height=h, qp=32, **kw)


# ---- leaf ops of the slice ------------------------------------------------

def test_mc_chroma_multi_and_deblock_420():
    """Clipped uni-pred chroma MC from a reference stack at MVs that
    reach past every picture edge, and the uniform-grid deblock."""
    rng = np.random.default_rng(21)
    refs = rng.integers(0, 256, (3, 32, 48)).astype(np.int32)
    b = 24
    x0 = np.tile(np.arange(6, dtype=np.int32) * 8, 4)
    y0 = np.repeat(np.arange(4, dtype=np.int32) * 8, 6)
    ridx = rng.integers(0, 3, b).astype(np.int32)
    mvx = rng.integers(-200, 200, b).astype(np.int32)
    mvy = rng.integers(-200, 200, b).astype(np.int32)
    mvx[:4] = (-600, 600, -7, 391)
    mvy[:4] = (-500, 500, 389, -13)
    want = jax.jit(lambda *a: jinterp.mc_chroma_multi(*a, 8))(
        refs, ridx, x0, y0, mvx, mvy)
    got = tinterp.mc_chroma_multi(T(refs), T(ridx), T(x0), T(y0), T(mvx),
                                  T(mvy), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    yy, xx = np.mgrid[0:64, 0:96]
    for qp in (22, 32, 40):
        ry = np.clip(((xx // 16) * 37 + (yy // 16) * 23) % 200 + 20 +
                     rng.integers(-3, 4, (64, 96)), 0, 255).astype(np.int32)
        ru = ry[::2, ::2] // 2 + 40
        rv = ry[1::2, ::2] // 2 + 20
        want = jax.jit(lambda a, b_, c: jdbk.deblock_420(a, b_, c, qp))(
            ry, ru, rv)
        got = tdbk.deblock_420(T(ry), T(ru), T(rv), qp)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


# ---- the flat CTB16 intra device path (the LD-P IDR) -----------------------

@pytest.mark.parametrize("rdoq", [False, "lite"])
def test_flat_idr_dict_and_slice_bytes(rdoq):
    """encode_frame (the port's encode_frame_jit): the state dict key by
    key, and the slice from the port's native and Python serializers and
    the JAX package's Python serializer, byte for byte."""
    w, h = 96, 64
    y, u, v = synth_clip(w, h, 1)[0]
    kw = dict(sign_data_hiding=True, rdoq=rdoq)
    want = jenc.encode_frame_jit(y, u, v, 32, w // 16, h // 16,
                                 deblock=True, sbh=True, rdoq=bool(rdoq))
    want = {k: np.asarray(a) for k, a in want.items()}
    enc = tic.IntraEncoder(_cfg(theaders, w, h, **kw), device="cpu")
    got = enc._dispatch(y, u, v)
    _dict_equal(got, want, "encode_frame")
    assert int(np.asarray(want["cbf"]).sum()) > 0
    jslice = jic.IntraEncoder(_cfg(jheaders, w, h, **kw)).serialize_frame(
        want, use_native=False)[0][0]
    native = enc.serialize_frame(got)[0][0]
    python = enc.serialize_frame(got, use_native=False)[0][0]
    assert native == python == jslice


# ---- the intra wavefront ------------------------------------------------

def test_reference_inlines_the_intra_wavefront():
    """inter_jax.encode_p_frame_dev inlines _intra_wavefront's body (its
    step 4); the port calls the one function from the P pipeline.  The
    two reference bodies are the same statements: the loop body, the
    branch on intra blocks and the fori_loop, with the local alias
    `scatter` for `_scatter_blocks` and the initial cbfs built in place."""
    wf = ast.parse(textwrap.dedent(inspect.getsource(
        jinter._intra_wavefront))).body[0]
    p = ast.parse(textwrap.dedent(inspect.getsource(
        jinter.encode_p_frame_dev))).body[0]

    def body_fn(fn):
        return next(s for s in fn.body if isinstance(s, ast.FunctionDef)
                    and s.name == "body")

    a = ast.unparse(body_fn(wf)).replace("_scatter_blocks(", "scatter(")
    b = ast.unparse(body_fn(p))
    assert a == b
    src = inspect.getsource(jinter.encode_p_frame_dev)
    assert "jax.lax.fori_loop(0, steps, body, s)" in src
    assert "encoder_jax._wavefront_schedule(bw, bh)" in src


def test_intra_wavefront_with_intra_blocks():
    """_intra_wavefront over a grid with intra blocks on many diagonals,
    the planes prefilled as an inter picture leaves them."""
    w, h = 96, 64
    bw, bh = w // 16, h // 16
    rng = np.random.default_rng(8)
    y, u, v = (p.astype(np.int32) for p in synth_clip(w, h, 1)[0])
    grid = rng.random((bh, bw)) < 0.5
    grid[0, 0] = grid[-1, -1] = True
    modes = rng.integers(0, 35, (bh, bw)).astype(np.int32)
    planes = (rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h // 2,
                                                                 w // 2)),
              rng.integers(0, 256, (h // 2, w // 2)),
              rng.integers(-9, 10, (h, w)), rng.integers(-9, 10,
                                                         (h // 2, w // 2)),
              rng.integers(-9, 10, (h // 2, w // 2)))
    planes = tuple(p.astype(np.int32) for p in planes)
    cbfs = tuple(rng.random(bw * bh) < 0.5 for _ in range(3))
    for qp, sbh, rdoq in ((32, True, True), (27, False, False)):
        qp_c = jic.chroma_qp(qp)
        f = jax.jit(lambda *a: jinter._intra_wavefront(
            *a, qp, qp_c, sbh, rdoq, bw, bh))
        wp, wc = f(y, u, v, grid, modes, planes, cbfs)
        gp, gc = tinter._intra_wavefront(
            T(y), T(u), T(v), T(grid), T(modes), tuple(T(p) for p in planes),
            tuple(T(c) for c in cbfs), qp, qp_c, sbh, rdoq, bw, bh)
        for g, w_ in zip(gp + gc, tuple(wp) + tuple(wc)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert any(not np.array_equal(np.asarray(a), b)
                   for a, b in zip(wp, planes))


# ---- whole LD-P streams and their device stages ----------------------------

def _run(monkeypatch, w, h, frames, spec_amvp=False, me_method="pyr",
         **cfg_kw):
    """Encode `frames` with both encoders (LD ladder on, SR64, the
    pyramid search unless me_method says otherwise), recording the JAX
    encoder's device stages; check streams, decoder and stage parity.
    spec_amvp: the reference's own stream must fail a picture hash, and
    the port's must equal the one it writes with the spec's AMVP list.
    Returns the recorded P-picture dicts."""
    calls = {"idr": [], "p": []}
    orig_i, orig_p = jenc.encode_frame_jit, jinter.encode_p_frame_dev

    def rec_i(*args, **kw):
        out = orig_i(*args, **kw)
        calls["idr"].append((args, kw, {k: np.asarray(v)
                                        for k, v in out.items()}))
        return out

    def rec_p(*args, **kw):
        out = orig_p(*args, **kw)
        calls["p"].append((args, kw, {k: np.asarray(v)
                                      for k, v in out.items()}))
        return out

    monkeypatch.setattr(jenc, "encode_frame_jit", rec_i)
    monkeypatch.setattr(jinter, "encode_p_frame_dev", rec_p)
    jenc_ = jinter.DeviceLowDelayEncoder(_cfg(jheaders, w, h, **cfg_kw),
                                         search_range=64,
                                         me_method=me_method)
    js, _ = jenc_.encode_sequence_ldp(frames)
    tenc_ = tinter.DeviceLowDelayEncoder(_cfg(theaders, w, h, **cfg_kw),
                                         search_range=64,
                                         me_method=me_method, device="cpu")
    ts, trec = tenc_.encode_sequence_ldp(frames)
    assert tenc_.frame_qps == jenc_.frame_qps == [32, 37, 36, 37, 33][
        :len(frames)]
    first = {k: list(v) for k, v in calls.items()}
    if spec_amvp:
        jd = tdec.GeneralDecoder()
        jd.decode(js)
        assert not all(jd.hash_status), jd.hash_status
        monkeypatch.setattr(jmotion, "amvp_candidates",
                            tmotion.amvp_candidates)
        js, _ = jinter.DeviceLowDelayEncoder(
            _cfg(jheaders, w, h, **cfg_kw), search_range=64,
            me_method=me_method).encode_sequence_ldp(frames)
    assert ts == js
    dec = tdec.GeneralDecoder()
    out = dec.decode(ts)
    assert dec.hash_status == [True] * len(frames)
    for k, (r, o) in enumerate(zip(trec, out)):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c],
                                          err_msg=f"picture {k} plane {c}")

    (ia, ikw, iout), = first["idr"]
    y, u, v, qp, bw, bh = ia
    got = tenc.encode_frame(*(_t(p) for p in (y, u, v)), qp, bw, bh, **ikw)
    _dict_equal(got, iout, "encode_frame (IDR)")
    assert len(first["p"]) == len(frames) - 1
    for i, (pa, pkw, pout) in enumerate(first["p"]):
        st = tinter.encode_p_frame_dev(*(_t(a) for a in pa), **pkw)
        _dict_equal(st, pout, f"encode_p_frame_dev, P picture {i + 1}")
    return [c[2] for c in first["p"]]


def test_ldp_one_ref_no_tmvp(monkeypatch):
    """num_refs 1, merge 1, no TMVP, no SBH: 4 pictures."""
    w, h = 96, 64
    st = _run(monkeypatch, w, h, cut_clip(w, h, 4))
    assert sum(int((d["pred_mode"] == 1).sum()) for d in st) > 0


def test_ldp_four_refs_tmvp_merge5_sbh(monkeypatch):
    """bench_ldp_480's settings and clip (bench.synth_clip) at 96x64: 4
    references, merge 5, TMVP, SBH; 5 pictures, so the last P picture
    has all 4 references.  The reference's AMVP fault shows here."""
    w, h = 96, 64
    st = _run(monkeypatch, w, h, synth_clip(w, h, 5, seed=0),
              spec_amvp=True, num_refs=4, merge_cands=5, temporal_mvp=True,
              sign_data_hiding=True)
    assert sum(int((d["pred_mode"] == 1).sum()) for d in st) > 0
    assert sum(int((d["ref_idx"] > 0).sum()) for d in st) > 0


def test_ldp_tz_four_refs(monkeypatch):
    """HM's TZSearch (FastSearch 1, SearchRange 64: BASELINE's config 2)
    at bench_ldp_480's settings and clip at 96x64, 5 pictures, every
    encode_p_frame_dev dict recorded and compared.  With TZ's motion
    fields the reference's AMVP fault does not strike this clip (its
    stream decodes hash OK), so the port's stream is the JAX encoder's
    as written; at 832x480 it strikes, and chip_smoke.py holds the card
    to the stream with the spec AMVP list."""
    w, h = 96, 64
    st = _run(monkeypatch, w, h, synth_clip(w, h, 5, seed=0),
              me_method="tz", num_refs=4, merge_cands=5,
              temporal_mvp=True, sign_data_hiding=True)
    assert sum(int((d["ref_idx"] > 0).sum()) for d in st) > 0


def test_amvp_without_a_neighbour_follows_the_spec():
    """A block on the left edge (no A neighbour) whose B0 points to
    another reference than B1: the spec makes the unscaled B1 the first
    predictor and B0, scaled, the second; the reference's list pads with
    the zero MV instead."""
    info = [[None, None], [None, None]]
    b0 = tpc.BlockInfo(pred_mode=0, mv=(8, 4), ref_idx=1, ref_poc=1)
    b1 = tpc.BlockInfo(pred_mode=0, mv=(12, -4), ref_idx=0, ref_poc=2)
    info[0][1], info[0][0] = b0, b1
    args = (0, 1, 0, [2, 1], 3, None, False)
    assert tmotion.amvp_candidates(tmotion.NeighborGrid(info, 2, 2),
                                   *args) == [(12, -4), (4, 2)]
    assert jmotion.amvp_candidates(jmotion.NeighborGrid(info, 2, 2),
                                   *args) == [(12, -4), (0, 0)]


def test_ldp_cut_options_raise():
    for opt in ("wpp", "weighted_pred", "cu_qp_delta"):
        cfg = _cfg(theaders, 64, 64)
        setattr(cfg, opt, True)
        with pytest.raises(ValueError):
            tinter.DeviceLowDelayEncoder(cfg, device="cpu")
    with pytest.raises(ValueError):
        tinter.DeviceLowDelayEncoder(_cfg(theaders, 64, 64, tile_columns=2),
                                     device="cpu")
    with pytest.raises(ValueError):              # no such search
        tinter.DeviceLowDelayEncoder(_cfg(theaders, 64, 64), me_method="hex",
                                     device="cpu")
    enc = tinter.DeviceLowDelayEncoder(_cfg(theaders, 64, 64))
    assert enc.device == torch.device("cuda")     # the card by default
    for opt in ("sao", "timing_sei", "long_term_idr"):  # ported options
        cfg = _cfg(theaders, 64, 64)
        setattr(cfg, opt, True)
        assert tinter.DeviceLowDelayEncoder(cfg, device="cpu").cfg is cfg
    frames = cut_clip(64, 64, 2)
    # the long-term IDR still stops a resumed picture loop, with or
    # without a controller (the reference signals the IDR for the
    # checkpoint's last picture)
    enc = tinter.DeviceLowDelayEncoder(_cfg(theaders, 64, 64),
                                       device="cpu")
    enc.cfg.long_term_idr = True
    enc.cfg.temporal_mvp = False
    with pytest.raises(ValueError):
        enc.encode_frames(frames, start_state=tpc.checkpoint.capture(
            1, frames[0]))
    # the host CTB loop's RDOQ and the host P coder, cut before, now run
    # and give the reference's bytes and pictures
    jn, jr = jic.IntraEncoder(_cfg(jheaders, 64, 64, rdoq="lite")) \
        .encode_frame(*frames[0])
    tn, tr = tic.IntraEncoder(_cfg(theaders, 64, 64, rdoq="lite"),
                              device="cpu").encode_frame(*frames[0])
    assert tn == jn
    from video_codecs_tpu.models.hevc import inter_codec as jpc
    outs = []
    for pc, mo, hd, kw in ((jpc, jmotion, jheaders, {}),
                           (tpc, tmotion, theaders, {"device": "cpu"})):
        dpb = [(0, tuple(np.asarray(p) for p in jr),
                mo.MotionField.empty(4, 4, 0))]
        outs.append(pc.LowDelayEncoder(_cfg(hd, 64, 64), **kw)
                    .encode_p_frame(*frames[1], dpb, 1))
    (jnals, jrec, _), (tnals, trec, _) = outs
    assert tnals == jnals
    for c in range(3):
        np.testing.assert_array_equal(trec[c], jrec[c])
    for c in range(3):
        np.testing.assert_array_equal(tr[c], jr[c])
    cfg = _cfg(theaders, 64, 64)
    cfg.sao = True
    with pytest.raises(ValueError):
        tic.IntraEncoder(cfg, device="cpu").encode_frame_fast(*frames[0])


def test_ldp_runs_without_jax(tmp_path):
    """The LD-P encoder (flat IDR, four references, TMVP, intra blocks
    after a cut), the host LD-P coder on HM's LD-P main tool set (the
    host CTB loop's IDR with the full RDOQ, SAO, TZSearch, weighted
    prediction, cu_qp_delta) and both decoders import nothing of JAX or
    of the JAX package."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["video_codecs_tpu"] = None
        import numpy as np
        from video_codecs_tpu_torch.models.hevc import decoder, headers
        from video_codecs_tpu_torch.models.hevc import inter_dev
        rng = np.random.default_rng(3)
        base = rng.integers(0, 256, (40, 72), np.uint8)
        yy, xx = np.mgrid[0:32, 0:64]
        ramp = (40 + 2 * xx + 9 * (yy // 8)).astype(np.uint8)
        frames = []
        for f in range(5):
            y = (np.ascontiguousarray(base[f:f + 32, f:f + 64]) if f < 3
                 else ramp)
            frames.append((y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2))
        cfg = headers.HevcConfig(width=64, height=32, qp=32, num_refs=4,
                                 merge_cands=5, temporal_mvp=True,
                                 sign_data_hiding=True)
        enc = inter_dev.DeviceLowDelayEncoder(cfg, search_range=64,
                                              device="cpu")
        stream, recons = enc.encode_sequence_ldp(frames)
        dec = decoder.GeneralDecoder()
        out = dec.decode(stream)
        assert dec.hash_status == [True] * 5, dec.hash_status
        assert all(np.array_equal(r[c], o[c])
                   for r, o in zip(recons, out) for c in range(3))
        from video_codecs_tpu_torch.models.hevc import inter_codec
        for opts in (dict(sao=True), dict(weighted_pred=True, num_refs=1),
                     dict(cu_qp_delta=True)):
            cfg = headers.HevcConfig(width=64, height=32, qp=32,
                                     sign_data_hiding=True, rdoq="full",
                                     merge_cands=5, temporal_mvp=True,
                                     num_refs=4)
            for k, v in opts.items():
                setattr(cfg, k, v)
            enc = inter_codec.LowDelayEncoder(cfg, search_range=64,
                                              me_method="tz", device="cpu")
            s2, r2 = enc.encode_sequence_ldp(frames[:3])
            for dec in (decoder.GeneralDecoder(),
                        inter_codec.LowDelayDecoder()):
                o2 = dec.decode(s2)
                assert dec.hash_status == [True] * 3, (opts, dec)
                assert all(np.array_equal(r[c], o[c])
                           for r, o in zip(r2, o2) for c in range(3))
        bad = [m for m in sys.modules
               if m in ("jax", "video_codecs_tpu")
               or m.startswith(("jax.", "video_codecs_tpu."))
               if sys.modules[m] is not None]
        assert not bad, bad
        print("OK", len(stream))
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")
