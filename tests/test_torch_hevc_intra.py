"""The port's HEVC all-intra quadtree path against the JAX package's.

`QuadtreeFastEncoder` (CTB 32, CUs 32/16/8, max TB 32) of the port runs
on CPU tensors and must give the JAX encoder's decisions, state dict and
stream bytes at 96x64 and 80x48 (boundary CTBs), QP 30 and 32, with
RDOQ-lite and without; the port's decoder and the JAX package's general
decoder both decode the port's stream with every picture hash OK.  The
JAX encoder compiles once per configuration, so each configuration is
one test that makes every check on the encodes it shares (a module
fixture would be rebuilt in every pytest-xdist worker).  Tolerance 0
throughout: no decision of these clips splits
from the reference (a split would have to be a float32 near-tie; see
ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_codecs_tpu.models.hevc import decoder as jdecoder
from video_codecs_tpu.models.hevc import encoder_jax_qt as jqt
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import quadtree_codec as jqc
from video_codecs_tpu_torch.models.hevc import encoder_qt_dev as tqt
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.models.hevc import quadtree_codec as tqc
from video_codecs_tpu_torch.ops import deblock as tdbk

torch.set_grad_enabled(False)

# (w, h, qp, rdoq): each size, QP and RDOQ setting appears twice
CASES = [(96, 64, 30, "lite"), (96, 64, 32, False), (80, 48, 32, "lite"),
         (80, 48, 30, False)]


def synth(w, h, seed, nf=2):
    """Seeded 4:2:0 pictures: smooth waves and a ramp, a flat object and
    mild noise, so the quadtree mixes 32, 16 and 8 CUs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for f in range(nf):
        base = (128 + 60 * np.sin(xx / 7.0 + seed + f) * np.cos(yy / 11.0)
                + 0.8 * (xx - yy))
        base[h // 3:h // 2, w // 4 + 2 * f:w // 2 + 2 * f] = 200
        y = np.clip(base + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] // 2 + 64 + rng.normal(0, 3, (h // 2, w // 2)),
                    0, 255).astype(np.uint8)
        v = np.clip(y[1::2, ::2] // 2 + 32 + rng.normal(0, 3, (h // 2, w // 2)),
                    0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def cfg_kw(w, h, qp, rdoq):
    return dict(width=w, height=h, qp=qp, log2_ctb=5, log2_min_cb=3,
                log2_max_tb=5, sign_data_hiding=True, rdoq=rdoq)


def encode_both(w, h, qp, rdoq):
    frames = synth(w, h, seed=w + h + qp)
    kw = cfg_kw(w, h, qp, rdoq)
    jenc = jqc.QuadtreeFastEncoder(jheaders.HevcConfig(**kw))
    jstream, jrecons = jenc.encode_sequence(frames)
    jst = {k: np.asarray(a) for k, a in
           jax.device_get(jenc._dispatch(*frames[0])).items()}
    tenc = tqc.QuadtreeFastEncoder(theaders.HevcConfig(**kw), device="cpu")
    tstream, trecons = tenc.encode_sequence(frames)
    tst = {k: a.numpy() for k, a in tenc._dispatch(*frames[0]).items()}
    return dict(w=w, h=h, qp=qp, rdoq=rdoq, frames=frames, jstream=jstream,
                jrecons=jrecons, jst=jst, tstream=tstream, trecons=trecons,
                tst=tst)


def _padded(case):
    w, h = case["w"], case["h"]
    pw, ph = tqt._ceil_to(w, 32), tqt._ceil_to(h, 32)
    y, u, v = (torch.from_numpy(p) for p in case["frames"][0])
    return (tqt._pad_edge(y, ph, pw), tqt._pad_edge(u, ph // 2, pw // 2),
            tqt._pad_edge(v, ph // 2, pw // 2))


def check_decide_qt_device_maps(case):
    yi, _, _ = _padded(case)
    depth8, m8, m16, m32 = tqt.decide_qt_device(
        yi, case["qp"], case["w"], case["h"], bool(case["rdoq"]))
    jst = case["jst"]
    for name, got in (("depth8", depth8), ("m8", m8), ("m16", m16),
                      ("m32", m32)):
        np.testing.assert_array_equal(got.numpy(), jst[name], err_msg=name)
    # the clips exercise every CU size
    assert len(np.unique(jst["depth8"][:case["h"] // 8, :case["w"] // 8])) >= 2


def check_wavefront_fed_the_jax_decision(case):
    """encode_frame_qt_device given the reference's own decision maps, so
    a decision split could not cascade into the reconstruction."""
    w, h, qp = case["w"], case["h"], case["qp"]
    jst = case["jst"]
    maps = [torch.from_numpy(jst[k].astype(np.int32))
            for k in ("depth8", "m8", "m16", "m32")]
    yi, ui, vi = _padded(case)
    st = tqt.encode_frame_qt_device(yi, ui, vi, *maps, qp, tic.chroma_qp(qp),
                                    w, h, True, bool(case["rdoq"]))
    np.testing.assert_array_equal(st["coef_y"][:h, :w].numpy(),
                                  jst["coef_y"])
    np.testing.assert_array_equal(st["coef_u"][:h // 2, :w // 2].numpy(),
                                  jst["coef_u"])
    np.testing.assert_array_equal(st["coef_v"][:h // 2, :w // 2].numpy(),
                                  jst["coef_v"])
    bs_v, bs_h = tqt.bs_maps_from_depth(maps[0], w, h)
    jbs = jqt.bs_maps_from_depth(jnp.asarray(jst["depth8"], jnp.int32), w, h)
    np.testing.assert_array_equal(bs_v.numpy(), np.asarray(jbs[0]))
    np.testing.assert_array_equal(bs_h.numpy(), np.asarray(jbs[1]))
    rec = tdbk.deblock_420_bs(st["rec_y"][:h, :w], st["rec_u"][:h // 2, :w // 2],
                              st["rec_v"][:h // 2, :w // 2], qp, bs_v, bs_h,
                              block=8)
    for got, key in zip(rec, ("rec_y", "rec_u", "rec_v")):
        np.testing.assert_array_equal(got.numpy(), jst[key], err_msg=key)


def check_state_dict_key_by_key(case):
    jst, tst = case["jst"], case["tst"]
    assert tst.keys() == jst.keys()
    for k in jst:
        assert tst[k].dtype == jst[k].dtype, k
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)


def check_stream_bytes(case):
    assert case["tstream"] == case["jstream"]
    for tr, jr in zip(case["trecons"], case["jrecons"]):
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a, np.asarray(b))


def check_decoders_hash_ok(case, jax_decoder):
    stream, recons = case["tstream"], case["trecons"]
    decs = [tqc.QuadtreeIntraDecoder()]
    if jax_decoder:
        decs.append(jdecoder.GeneralIntraDecoder())
    for dec in decs:
        out = dec.decode(stream)
        assert dec.hash_status == [True] * len(recons), type(dec)
        for o, r in zip(out, recons):
            for a, b in zip(o, r):
                np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("w,h,qp,rdoq", CASES,
                         ids=[f"{w}x{h}-qp{q}-{r or 'hard'}"
                              for w, h, q, r in CASES])
def test_quadtree_path_equal(w, h, qp, rdoq):
    """Decision maps, the wavefront fed the reference's decision, the
    state dict key by key, the stream bytes (two pictures) and the port's
    decoder, for one configuration; the JAX package's general decoder
    too for the boundary-CTB size with RDOQ-lite (it deblocks eagerly,
    ~10 s a stream here)."""
    case = encode_both(w, h, qp, rdoq)
    check_decide_qt_device_maps(case)
    check_wavefront_fed_the_jax_decision(case)
    check_state_dict_key_by_key(case)
    check_stream_bytes(case)
    check_decoders_hash_ok(case, jax_decoder=(w, h, rdoq) == (80, 48, "lite"))


def test_trial_costs_bit_equal():
    """The float32 J = SSE + lambda * R of every CU candidate (the values
    the tree decision compares) equals the reference's bit for bit."""
    w, h, qp = 96, 64, 32
    y = synth(w, h, seed=3, nf=1)[0][0].astype(np.int32)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    for n in (8, 16, 32):
        modes = jax.jit(lambda a: jqt._mode_sweep(a, qp, n))(y)
        jcost = jax.jit(lambda a, m: jqt._trial_cost(a, qp, n, m, lam,
                                                      True))(y, modes)
        tmodes = tqt._mode_sweep(torch.from_numpy(y), qp, n)
        np.testing.assert_array_equal(tmodes.numpy(), np.asarray(modes))
        tcost = tqt._trial_cost(torch.from_numpy(y), qp, n, tmodes, lam, True)
        np.testing.assert_array_equal(tcost.numpy(), np.asarray(jcost))


def test_cut_options_raise():
    base = cfg_kw(64, 32, 32, "lite")
    for bad in (dict(log2_ctb=4), dict(log2_min_cb=4), dict(log2_max_tb=4),
                dict(tile_columns=2), dict(wpp=True), dict(width=68)):
        with pytest.raises(ValueError):
            tqc.QuadtreeFastEncoder(theaders.HevcConfig(**{**base, **bad}),
                                    device="cpu")
    # the host full RDOQ, cut before, now codes a TB as the reference does
    from video_codecs_tpu.models.hevc import intra_codec as jic
    rng = np.random.default_rng(7)
    o = rng.integers(0, 256, (4, 4)).astype(np.int32)
    p = rng.integers(0, 256, (4, 4)).astype(np.int32)
    got = tic.code_tb_np(o, p, 32, 2, False, rdoq="full")
    want = jic.code_tb_np(o, p, 32, 2, False, rdoq="full")
    assert got[0].any()
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
