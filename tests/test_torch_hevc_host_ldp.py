"""The reference's host low-delay P coder in the port against the JAX
package's, on the CPU.

The port carries the host LD-P coder that the reference's encoder CLI
builds for HM's low-delay cfgs (models/hevc/inter_codec.LowDelayEncoder),
its IDR (the host CTB loop of `IntraEncoder.encode_frame`, taken at
cfg.rdoq) and `LowDelayDecoder`, with the pieces they need: the numpy MC
twins with explicit weighted prediction, the host full RDOQ `rdoq_np`,
the deblock's per-block QP maps, the 35-mode `decide_modes`, and the
controllers that set QPs inside a picture.  Seeded numpy inputs go
through the JAX function and the port's; tolerance 0 everywhere
(integers, bytes, and the controllers' float64 state).

The stream tests run each configuration of a JAX package test at its
size and settings (and a 64x48 weighted-prediction fade, and the device
LD-P engine with SAO and the full RDOQ): the port's stream is the JAX
encoder's byte for byte with the reference's AMVP predictor list swapped
for the spec's in memory (`motion.amvp_candidates`, the one fault the
port repairs; tests/test_torch_hevc_ldp.py), the reconstructions are
equal, and both of the port's decoders (`GeneralDecoder`,
`LowDelayDecoder`) give every picture hash OK and the encoder's
pictures.

The `cuda` case runs where JAX is not installed, so JAX is imported only
inside the tests that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_hevc_host_ldp.py
"""

import numpy as np
import pytest
import torch
from chip_smoke import bench_synth_clip, fade_clip, host_ldp_cfg

from video_codecs_tpu_torch.entropy import ctx as tctx
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_codec as tpc
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.models.hevc import motion as tmotion
from video_codecs_tpu_torch.models.hevc import ratectrl as trc
from video_codecs_tpu_torch.ops import deblock as tdbk
from video_codecs_tpu_torch.ops import interp as tinterp
from video_codecs_tpu_torch.ops import rdoq as trdoq
from video_codecs_tpu_torch.ops import transform as ttr

torch.set_grad_enabled(False)


def _jax():
    """The JAX package's modules these tests compare with, as a namespace
    (imported here so that the `cuda` case runs without JAX)."""
    pytest.importorskip("jax")
    import types

    from video_codecs_tpu.models.hevc import headers, inter_codec
    from video_codecs_tpu.models.hevc import inter_jax, intra_codec
    from video_codecs_tpu.models.hevc import motion, ratectrl
    from video_codecs_tpu.ops import deblock, interp, rdoq
    return types.SimpleNamespace(
        headers=headers, pc=inter_codec, inter=inter_jax, ic=intra_codec,
        motion=motion, rc=ratectrl, dbk=deblock, interp=interp, rdoq=rdoq)


def _same(got, want, what=""):
    assert np.asarray(got).dtype == np.asarray(want).dtype, what
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


# ---- the numpy MC twins ---------------------------------------------------

@pytest.mark.parametrize("comp", ["luma", "chroma"])
@pytest.mark.parametrize("kind", ["uni", "14", "wp"])
def test_mc_twins_equal(comp, kind):
    """mc_luma_np / mc_chroma_np, their 14-bit cores and the weighted
    uni-prediction twins, at every fractional phase and at MVs that reach
    past each picture edge (edge replication), dtypes included."""
    j = _jax()
    rng = np.random.default_rng(["luma", "chroma"].index(comp) * 3 +
                                ["uni", "14", "wp"].index(kind))
    h, w = (48, 64) if comp == "luma" else (24, 32)
    n = 16 if comp == "luma" else 8
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    name = {"uni": f"mc_{comp}_np", "14": f"_mc_{comp}14_np",
            "wp": f"mc_{comp}_wp_np"}[kind]
    jf, tf = getattr(j.interp, name), getattr(tinterp, name)
    mvs = [(fx, fy) for fx in range(8) for fy in range(8)]
    mvs += [(-600, -500), (600, 500), (-7, 389), (391, -13), (-256, 3)]
    mvs += [tuple(rng.integers(-300, 300, 2)) for _ in range(40)]
    wps = [(64, 0, 6), (45, -17, 6), (127, 40, 6), (1, 127, 6), (9, -3, 3)]
    for k, (mvx, mvy) in enumerate(mvs):
        x0, y0 = int(rng.integers(0, w - n + 1)), int(rng.integers(0, h - n
                                                                   + 1))
        args = (ref, x0, y0, int(mvx), int(mvy), n)
        if kind == "wp":
            args += wps[k % len(wps)]
        _same(tf(*args), jf(*args), f"{name} {args[1:]}")


# ---- the host full RDOQ -----------------------------------------------------

@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("luma", [True, False])
def test_rdoq_np_equal(log2, luma):
    """rdoq_np on transformed residuals at two QPs, from the slice-initial
    states of I and P slices and from a seeded state snapshot, with and
    without context adaptation and the whole-block zero."""
    j = _jax()
    rng = np.random.default_rng(10 * log2 + luma)
    n = 1 << log2
    nz = 0
    for qp in (27, 37):
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        for t in range(6):
            amp = (8, 30, 90)[t % 3]
            res = rng.integers(-amp, amp + 1, (n, n)).astype(np.int32)
            coeff = ttr.forward_transform_np(res, log2)
            kw = dict(lam=lam, is_luma=luma, slice_type=(2, 1)[t % 2],
                      adapt_ctx=t != 4, allow_all_zero=t != 5)
            if t == 3:
                states = rng.integers(0, 126, len(tctx.init_states(
                    tctx.P, qp))).astype(np.uint8)
                kw["states"] = states
            got = trdoq.rdoq_np(coeff, qp, log2, **kw)
            want = j.rdoq.rdoq_np(coeff, qp, log2, **kw)
            _same(got, want, f"qp {qp} case {t}")
            nz += int(got.any())
    assert nz >= 6


# ---- the deblock's per-block QP maps ----------------------------------------

@pytest.mark.parametrize("grid", ["block16", "block8", "seg4"])
def test_deblock_qp_map_equal(grid):
    """deblock_420_bs with a QP map: per 16x16 block (the host LD-P
    coder), per 8x8 block, and the general decoder's per-4x4 map with
    4-sample BS segments; with and without the slice and PPS offsets."""
    j = _jax()
    rng = np.random.default_rng(len(grid))
    h, w = 48, 80
    y = np.clip(128 + rng.normal(0, 7, (h, w)).cumsum(1) / 3, 0,
                255).astype(np.int32)
    u = rng.integers(70, 190, (h // 2, w // 2)).astype(np.int32)
    v = rng.integers(70, 190, (h // 2, w // 2)).astype(np.int32)
    block = 16 if grid == "block16" else 8
    seg4 = grid == "seg4"
    if seg4:
        bv = rng.integers(0, 3, (w // 8 - 1, h // 4)).astype(np.int32)
        bh = rng.integers(0, 3, (h // 8 - 1, w // 4)).astype(np.int32)
        qm = rng.integers(18, 50, (h // 4, w // 4)).astype(np.int32)
    else:
        bv = rng.integers(0, 3, (w // block - 1, h // block)).astype(
            np.int32)
        bh = rng.integers(0, 3, (h // block - 1, w // block)).astype(
            np.int32)
        qm = rng.integers(18, 50, (h // block, w // block)).astype(np.int32)
    for kw in (dict(), dict(beta_off=2, tc_off=-1, cb_qp_off=3,
                            cr_qp_off=-2)):
        want = j.dbk.deblock_420_bs_np(y, u, v, 32, bv, bh, block=block,
                                       qp_map=qm, seg4=seg4, **kw)
        got = tdbk.deblock_420_bs_np(y, u, v, 32, bv, bh, block=block,
                                     qp_map=qm, seg4=seg4, **kw)
        for c, (g, w_) in enumerate(zip(got, want)):
            _same(g, w_, f"{kw} plane {c}")
            assert not np.array_equal(g, (y, u, v)[c])


# ---- the IDR: decide_modes and the host CTB loop ---------------------------

def test_decide_modes_equal():
    """The 35-mode sweep (device ops on CPU tensors) and the float64 MPM
    raster, at 64x48 on two clips and two QPs."""
    j = _jax()
    for seed, qp in ((1, 22), (2, 37)):
        y = bench_synth_clip(64, 48, 1, seed=seed)[0][0]
        kw = dict(width=64, height=48, qp=qp)
        want = j.ic.IntraEncoder(j.headers.HevcConfig(**kw)).decide_modes(y)
        got = tic.IntraEncoder(theaders.HevcConfig(**kw),
                               device="cpu").decide_modes(y)
        _same(got, want)
        assert len(set(got.reshape(-1).tolist())) > 3


@pytest.mark.parametrize("rdoq", ["lite", "full"])
def test_host_idr_equal(rdoq):
    """The IDR on the host CTB loop with SAO (HM's LD-P main tool set
    at 64x48): NAL bytes, the deblocked and SAO-filtered picture, and
    the port's IntraDecoder on the stream."""
    j = _jax()
    y, u, v = bench_synth_clip(64, 48, 1)[0]
    kw = dict(width=64, height=48, qp=32, sign_data_hiding=True, sao=True,
              rdoq=rdoq)
    jn, jr = j.ic.IntraEncoder(j.headers.HevcConfig(**kw)).encode_frame(
        y, u, v)
    tenc = tic.IntraEncoder(theaders.HevcConfig(**kw), device="cpu")
    calls = []
    host = tenc._encode_frame_host
    tenc._encode_frame_host = lambda *a: calls.append(1) or host(*a)
    tn, tr = tenc.encode_frame(y, u, v)
    assert calls == [1]
    assert tn == jn
    for c in range(3):
        _same(tr[c], jr[c])
    dec = tic.IntraDecoder()
    out = dec.decode(b"".join(b"\x00\x00\x00\x01" + n for n in
                              tenc.stream_headers() + tn))
    assert dec.hash_status == [True]
    for c in range(3):
        np.testing.assert_array_equal(out[0][c], tr[c])


# ---- the controllers that set QPs inside a picture ---------------------------

def test_urq_basic_unit_qp_sequence():
    """UrqBasicUnitControl driven as tests/test_ratectrl.py:70-90 drives
    it (5 units a frame, bits falling with the step, seeded noise): the
    same QP for every unit and the same state after every frame."""
    j = _jax()
    ctrls = [m.UrqBasicUnitControl(300_000, 30.0, 96, 80, units_per_frame=5)
             for m in (j.rc, trc)]
    rng = np.random.default_rng(0)
    qps = []
    for f in range(40):
        assert ctrls[0].start_frame() == ctrls[1].start_frame()
        for _ in range(5):
            q = ctrls[1].unit_qp()
            assert q == ctrls[0].unit_qp()
            qps.append(q)
            bits = 120000.0 / ctrls[1]._qstep(q) * rng.uniform(0.8, 1.25) / 5
            mad = rng.uniform(4, 12)
            for c in ctrls:
                c.update_unit(bits, mad=mad)
        for c in ctrls:
            c.end_frame()
        assert vars(ctrls[1]) == vars(ctrls[0])
    assert len(set(qps)) >= 4


def test_ctu_rate_control_qps():
    """CtuRateControl.ctu_qps (float64 log2/exp) on seeded SATD maps,
    frame QPs at the clip's ends too, and at the default and a wider
    clip."""
    j = _jax()
    rng = np.random.default_rng(4)
    for clip in (2, 4):
        jc, tc = j.rc.CtuRateControl(clip), trc.CtuRateControl(clip)
        for qp in (1, 22, 32, 50):
            for shape in ((3, 4), (30, 52)):
                satd = rng.gamma(1.5, 900.0, shape).round()
                satd[0, 0] = 0
                got, want = tc.ctu_qps(qp, satd), jc.ctu_qps(qp, satd)
                _same(got, want)
        assert got.min() < 32 or got.max() > 32


# ---- whole streams ----------------------------------------------------------

def _streams(monkeypatch, frames, cfg_kw, enc_kw=(), ctu_rc=False,
             rc=None, device_engine=False):
    """Encode `frames` with the JAX package's encoder (the spec AMVP list
    swapped in) and the port's on the CPU; require equal bytes, equal
    recons, and every hash OK with the encoder's pictures in both of the
    port's decoders.  rc: (target bps, fps) of a RateLambdaControl.
    Returns (the port's encoder, its per-picture BlockInfo grids)."""
    j = _jax()
    monkeypatch.setattr(j.motion, "amvp_candidates",
                        tmotion.amvp_candidates)
    enc_kw = dict(enc_kw)
    if device_engine:
        jenc = j.inter.DeviceLowDelayEncoder(
            j.headers.HevcConfig(**cfg_kw), **enc_kw)
        tenc = tinter.DeviceLowDelayEncoder(
            theaders.HevcConfig(**cfg_kw), device="cpu", **enc_kw)
    else:
        jenc = j.pc.LowDelayEncoder(j.headers.HevcConfig(**cfg_kw),
                                    **enc_kw)
        tenc = tpc.LowDelayEncoder(theaders.HevcConfig(**cfg_kw),
                                   device="cpu", **enc_kw)
    if ctu_rc:
        jenc.ctu_rc, tenc.ctu_rc = j.rc.CtuRateControl(), \
            trc.CtuRateControl()
    grids = []
    if not device_engine:
        raster = tenc._p_raster

        def rec(*a):
            out = raster(*a)
            grids.append(out[0])
            return out
        tenc._p_raster = rec
    ctrl = [None, None]
    if rc is not None:
        w, h = cfg_kw["width"], cfg_kw["height"]
        ctrl = [m.RateLambdaControl(rc[0], rc[1], w, h, base_qp=32)
                for m in (j.rc, trc)]
    js, jrec = jenc.encode_sequence_ldp(frames, ctrl[0])
    ts, trec = tenc.encode_sequence_ldp(frames, ctrl[1])
    assert tenc.frame_qps == jenc.frame_qps
    assert ts == js
    for k, (a, b) in enumerate(zip(trec, jrec)):
        for c in range(3):
            np.testing.assert_array_equal(a[c], np.asarray(b[c]),
                                          err_msg=f"picture {k} plane {c}")
    for cls in (tdec.GeneralDecoder, tpc.LowDelayDecoder):
        dec = cls()
        out = dec.decode(ts)
        assert dec.hash_status == [True] * len(frames), cls.__name__
        for k, (a, b) in enumerate(zip(trec, out)):
            for c in range(3):
                np.testing.assert_array_equal(
                    a[c], b[c], err_msg=f"{cls.__name__} picture {k}")
    return tenc, grids


def test_ldp_roundtrip_64x48(monkeypatch):
    """tests/test_inter_codec.py::test_ldp_roundtrip's configuration:
    64x48, QP 30, one reference, one merge candidate, the "auto" search
    at range 8, its translating clip (4 pictures)."""
    from test_inter_codec import moving_clip
    _, grids = _streams(monkeypatch, moving_clip(64, 48, 4),
                        dict(width=64, height=48, qp=30))
    assert any(b.pred_mode == tpc.MODE_INTER and not b.merge
               for g in grids for row in g for b in row)        # AMVP


def test_ldp_multiref_merge5_tmvp_80x48(monkeypatch):
    """test_ldp_multiref_merge5_tmvp_hm_conformance's: 80x48 crops of
    bench.py's 416x240 clip, 8 pictures, QP 30, 4 references, merge 5,
    TMVP, search range 8."""
    from bench import synth_clip
    clip = synth_clip(416, 240, 8)
    crop = [(f[0][:48, :80], f[1][:24, :40], f[2][:24, :40]) for f in clip]
    _, grids = _streams(monkeypatch, crop,
                        dict(width=80, height=48, qp=30, num_refs=4,
                             merge_cands=5, temporal_mvp=True),
                        dict(search_range=8))
    bl = [b for g in grids for row in g for b in row]
    assert any(b.merge and b.merge_idx > 0 for b in bl)
    assert any(b.ref_idx > 0 for b in bl)


def test_ctu_rate_control_cu_qp_delta_80x48(monkeypatch):
    """test_ctu_rate_control_cu_qp_delta_conformance's: 80x48, 6 pictures
    of the translating clip, QP 32, 2 references, merge 5, cu_qp_delta
    with the encoder's own per-block QP map; then the same pictures with
    a CtuRateControl under a RateLambdaControl (HM's LCU-level RC)."""
    from test_inter_codec import moving_clip
    frames = moving_clip(80, 48, 6)
    kw = dict(width=80, height=48, qp=32, num_refs=2, merge_cands=5,
              cu_qp_delta=True)
    for ctu_rc, rc in ((False, None), (True, (300_000.0, 30.0))):
        _, grids = _streams(monkeypatch, frames, kw, dict(search_range=8),
                            ctu_rc=ctu_rc, rc=rc)
        assert any(b.qp_delta for g in grids for row in g for b in row)
        assert len({b.qp for g in grids for row in g for b in row}) > 2


def test_ldp_weighted_prediction_fade_64x48(monkeypatch):
    """Explicit weighted prediction on a fade (tests/test_weighted_pred.py's
    gain 1 - 0.12 i on bench's clip at 64x48, 4 pictures), HM's LD-P main
    settings with the one reference WP takes; the weights move, and two
    references raise (the reference asserts one)."""
    frames = fade_clip(bench_synth_clip(64, 48, 4))
    cfg = host_ldp_cfg("wp")
    kw = dict(width=64, height=48, qp=32, sign_data_hiding=True,
              rdoq="full", merge_cands=5, temporal_mvp=True, num_refs=1,
              weighted_pred=True)
    assert all(getattr(cfg, k) == v for k, v in kw.items()
               if k not in ("width", "height"))
    seen = []
    est = tpc.estimate_wp_params
    monkeypatch.setattr(tpc, "estimate_wp_params",
                        lambda c, r: seen.append(est(c, r)) or seen[-1])
    _streams(monkeypatch, frames, kw, dict(search_range=64,
                                           me_method="tz"))
    assert len(seen) == 3 and all(w["w"] != (64, 64, 64) for w in seen)
    with pytest.raises(ValueError, match="references"):
        tpc.LowDelayEncoder(theaders.HevcConfig(**{**kw, "num_refs": 2}),
                            device="cpu").encode_sequence_ldp(frames[:3])


def test_device_ldp_sao_full_rdoq_64x48(monkeypatch):
    """The device LD-P engine with SAO and rdoq="full" (HM's LD-P main
    tool set) at test_device_ldp_roundtrip[4-True-True]'s settings, 3 of
    its pictures: its IDR goes through the host CTB loop with the host
    full RDOQ, as the reference's does, and its P pictures are the
    device engine's as before."""
    from test_inter_jax import clip
    calls = []
    host = tic.IntraEncoder._encode_frame_host
    monkeypatch.setattr(tic.IntraEncoder, "_encode_frame_host",
                        lambda self, *a: calls.append(1) or host(self, *a))
    _streams(monkeypatch, clip(64, 48, 3),
             dict(width=64, height=48, qp=30, num_refs=4, temporal_mvp=True,
                  sao=True, merge_cands=5, sign_data_hiding=True,
                  rdoq="full"),
             dict(search_range=16), device_engine=True)
    assert calls == [1]
    for opt in ("weighted_pred", "cu_qp_delta"):          # still refused
        with pytest.raises(ValueError):
            tinter.DeviceLowDelayEncoder(
                theaders.HevcConfig(width=64, height=48, **{opt: True}),
                device="cpu")


def test_low_delay_decoder_conceals_a_lost_picture():
    """LowDelayDecoder(conceal=True) copies the previous picture for a P
    slice it cannot parse, as the reference's does; without conceal the
    same stream raises."""
    j = _jax()
    frames = bench_synth_clip(64, 48, 3)
    cfg = dict(width=64, height=48, qp=32)
    stream, _ = tpc.LowDelayEncoder(theaders.HevcConfig(**cfg),
                                    device="cpu").encode_sequence_ldp(frames)
    from video_codecs_tpu_torch.entropy import bitstream as tbs
    nals = tbs.split_annexb(stream)
    p1 = next(i for i, n in enumerate(nals) if (n[0] >> 1) & 0x3F == 1)
    nals[p1] = nals[p1][:9]                         # cut inside the header
    broken = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
    outs = []
    for cls in (j.pc.LowDelayDecoder, tpc.LowDelayDecoder):
        dec = cls(conceal=True)
        outs.append((dec.decode(broken), dec.concealed))
    (jf, jc), (tf, tc) = outs
    assert tc == jc == [1]
    for a, b in zip(tf, jf):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
    np.testing.assert_array_equal(tf[1][0], tf[0][0])
    with pytest.raises(Exception):
        tpc.LowDelayDecoder().decode(broken)


# ---- the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_host_ldp_card_equals_cpu():
    """HM's LD-P main configuration (`host_ldp_cfg`) at 64x48, 3
    pictures: pass 1, the IDR's sweep, the deblocks and the SAO
    statistics on the card give the CPU's stream byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels, no interpret mode)")
    frames = bench_synth_clip(64, 48, 3)
    streams = []
    for dev in ("cuda", "cpu"):
        cfg = host_ldp_cfg()
        cfg.width, cfg.height = 64, 48
        enc = tpc.LowDelayEncoder(cfg, search_range=64, me_method="tz",
                                  device=dev)
        streams.append(enc.encode_sequence_ldp(frames)[0])
    assert streams[0] == streams[1]
    dec = tpc.LowDelayDecoder()
    dec.decode(streams[0])
    assert dec.hash_status == [True] * 3
