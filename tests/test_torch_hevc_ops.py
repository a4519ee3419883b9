"""The port's HEVC intra leaf ops against the JAX package's, on the CPU.

Seeded numpy inputs go through the JAX function (jitted, as the
reference's encoder runs it) and the port's counterpart on CPU tensors;
every integer stage is held at tolerance 0, and so are the float32
decisions and rates, which the port computes in the reference's order
(see video_codecs_tpu_torch/ops/rdoq_dev.py), the 4x4 rates included,
and XLA's own float32 log2 (`ops/quant.log_xla`), held at 0 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_codecs_tpu.entropy import ctx as jctx
from video_codecs_tpu.ops import cost as jcost
from video_codecs_tpu.ops import deblock as jdbk
from video_codecs_tpu.ops import intra as jintra
from video_codecs_tpu.ops import quant as jquant
from video_codecs_tpu.ops import rdoq as jrdoq
from video_codecs_tpu.ops import rdoq_jax as jrdoq_dev
from video_codecs_tpu.ops import transform as jtr
from video_codecs_tpu.utils import rom as jrom
from video_codecs_tpu_torch.entropy import ctx as tctx
from video_codecs_tpu_torch.ops import cost as tcost
from video_codecs_tpu_torch.ops import deblock as tdbk
from video_codecs_tpu_torch.ops import intra as tintra
from video_codecs_tpu_torch.ops import quant as tquant
from video_codecs_tpu_torch.ops import rdoq as trdoq
from video_codecs_tpu_torch.ops import rdoq_dev as trdoq_dev
from video_codecs_tpu_torch.ops import transform as ttr
from video_codecs_tpu_torch.utils import rom as trom

torch.set_grad_enabled(False)


def T(a):
    return torch.from_numpy(np.array(a))


def _coeffs(rng, log2, b, amp=60, dst=False):
    n = 1 << log2
    res = rng.integers(-amp, amp + 1, (b, n, n)).astype(np.int32)
    return np.stack([jtr.forward_transform_np(r, log2, dst=dst) for r in res])


# ---- constant tables (the codec's "weights") ---------------------------

def test_constant_tables_equal():
    for name in ("DST4", "QUANT_SCALES", "INV_QUANT_SCALES",
                 "CHROMA_QP_TABLE_420", "INTRA_PRED_ANGLES",
                 "INTRA_INV_ANGLES"):
        np.testing.assert_array_equal(getattr(trom, name),
                                      getattr(jrom, name), err_msg=name)
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(trom.dct_matrix(n), jrom.dct_matrix(n))
    for log2 in (2, 3, 4, 5):
        for st in range(3):
            np.testing.assert_array_equal(trom.scan_order(log2, st),
                                          jrom.scan_order(log2, st))
            np.testing.assert_array_equal(trom.cg_scan_order(log2, st),
                                          jrom.cg_scan_order(log2, st))
        for luma in (True, False):
            for a, b in zip(tintra._mode_weights(log2, luma),
                            jintra._mode_weights(log2, luma)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trdoq.ENTROPY_BITS, jrdoq.ENTROPY_BITS)
    for qp in (22, 30, 32, 37):
        for st in range(3):
            np.testing.assert_array_equal(tctx.init_states(st, qp),
                                          jctx.init_states(st, qp))
        for log2 in (2, 3, 4, 5):
            for luma in (True, False):
                a = trdoq_dev._tables_np(qp, log2, luma, 2, 0)
                b = jrdoq_dev._tables_np(qp, log2, luma, 2, 0)
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert trom.MAX_TR_DYNAMIC_RANGE == jrom.MAX_TR_DYNAMIC_RANGE


# ---- transform, quant ---------------------------------------------------

@pytest.mark.parametrize("log2,dst", [(2, False), (2, True), (3, False),
                                      (4, False), (5, False)])
def test_transform_equal(log2, dst):
    rng = np.random.default_rng(10 + log2 + 7 * dst)
    n = 1 << log2
    res = rng.integers(-255, 256, (48, n, n)).astype(np.int32)
    fwd = np.asarray(jtr.forward_transform(jnp.asarray(res), log2, dst=dst))
    np.testing.assert_array_equal(
        ttr.forward_transform(T(res), log2, dst=dst).numpy(), fwd)
    inv = np.asarray(jtr.inverse_transform(jnp.asarray(fwd), log2, dst=dst))
    np.testing.assert_array_equal(
        ttr.inverse_transform(T(fwd), log2, dst=dst).numpy(), inv)
    for i in range(3):
        np.testing.assert_array_equal(
            ttr.forward_transform_np(res[i], log2, dst=dst),
            jtr.forward_transform_np(res[i], log2, dst=dst))
        np.testing.assert_array_equal(
            ttr.inverse_transform_np(fwd[i], log2, dst=dst),
            jtr.inverse_transform_np(fwd[i], log2, dst=dst))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_quant_dequant_equal(log2, qp):
    co = _coeffs(np.random.default_rng(qp * 7 + log2), log2, 32, amp=200)
    lv = np.asarray(jquant.quantize(jnp.asarray(co), qp, log2))
    np.testing.assert_array_equal(tquant.quantize(T(co), qp, log2).numpy(),
                                  lv)
    np.testing.assert_array_equal(
        tquant.dequantize(T(lv), qp, log2).numpy(),
        np.asarray(jquant.dequantize(jnp.asarray(lv), qp, log2)))
    np.testing.assert_array_equal(tquant.quantize_np(co[0], qp, log2),
                                  jquant.quantize_np(co[0], qp, log2))
    np.testing.assert_array_equal(tquant.dequantize_np(lv[0], qp, log2),
                                  jquant.dequantize_np(lv[0], qp, log2))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_lite_decisions_counted(log2):
    """Levels equal the reference's at every decision: the rate term is
    XLA's log2 and the cost its two FMAs."""
    rng = np.random.default_rng(30 + log2)
    for qp in (22, 32, 37):
        co = _coeffs(rng, log2, 64, amp=120)
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        for scale in (1.0, 2.0):
            f = jax.jit(lambda c: jquant.rdoq_lite(c, qp, log2, lam=lam,
                                                   lam_scale=scale))
            want = np.asarray(f(jnp.asarray(co)))
            got = tquant.rdoq_lite(T(co), qp, log2, lam=lam,
                                   lam_scale=scale).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tquant.rdoq_lite_np(co[0], qp, log2, lam=lam,
                                    lam_scale=scale),
                jquant.rdoq_lite_np(co[0], qp, log2, lam=lam,
                                    lam_scale=scale))


def test_log2_xla_equals_jnp_log2():
    """jit(jnp.log2)(1 + a) at every level magnitude a = 0..32768, at
    0 ulp, and the tables of log(1 + a) and of the fused rate."""
    a = np.arange(0, (1 << 15) + 1, dtype=np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.log2(1.0 + v))(a))
    got = tquant.log2_xla(T(a) + 1.0).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    ln, rate = tquant.log_1p_tables()
    np.testing.assert_array_equal(
        ln, np.asarray(jax.jit(lambda v: jnp.log(1.0 + v))(a)))
    want_rate = np.asarray(jax.jit(lambda v: 2.0 + jnp.log2(1.0 + v))(a))
    np.testing.assert_array_equal(rate, want_rate)
    # the correctly rounded table the port read before is off in places
    cr = np.log2(a.astype(np.float64) + 1.0).astype(np.float32)
    assert (cr != want).sum() > 10000


def _rdoq_lite_correct_table(c, qp, log2, lam, scale):
    """rdoq_lite with a correctly rounded float32 log2 (the port's rate
    before it took XLA's log): the baseline the near-tie test counts."""
    per, rem = qp // 6, qp % 6
    q_bits = trom.QUANT_SHIFT + per + tquant.transform_shift(log2)
    c = T(c)
    mag = c.abs()
    lf = (mag * int(trom.QUANT_SCALES[rem])) >> q_bits
    lam_f = torch.tensor(scale * lam * 4.0 ** (7 - log2), dtype=torch.float32)
    tab = T(np.log2(np.arange(1, 32770, dtype=np.float64)).astype(np.float32))

    def cost(lv):
        d = (mag - tquant.dequantize(lv, qp, log2)).float()
        a = lv.abs()
        r = torch.where(a == 0, 0.0, 2.0 + tab[a.long()])
        return tquant.fma32(d, d, lam_f * r)

    l0, l1 = lf.clamp(0, 32767), (lf + 1).clamp(0, 32767)
    return (torch.sign(c) * torch.where(cost(l1) < cost(l0), l1, l0)).numpy()


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_lite_near_ties(log2):
    """Floor/ceil ties built on purpose: for a level pair the lambda is
    chosen so that the two costs are equal in exact arithmetic, and the
    float32 roundings decide.  The port equals the reference at every
    one; the correctly rounded log2 it read before splits at 37 of the
    128 (10, 7, 12 and 8 at log2 sizes 2 to 5)."""
    rng = np.random.default_rng(1 + log2)
    n = 1 << log2
    ties = split_before = 0
    for qp in (22, 27, 32, 37):
        per, rem = qp // 6, qp % 6
        q_bits = jrom.QUANT_SHIFT + per + jquant.transform_shift(log2)
        for scale in (1.0, 2.0):
            found = 0
            while found < 4:
                mag = int(rng.integers(1, 4000))
                lf = (mag * int(jrom.QUANT_SCALES[rem])) >> q_bits
                if lf < 1:
                    continue
                d0, d1 = (mag - int(jquant.dequantize_np(np.int32([lv]), qp,
                                                         log2)[0])
                          for lv in (lf, lf + 1))
                if d0 * d0 <= d1 * d1:
                    continue
                found += 1
                lam_td = (d0 * d0 - d1 * d1) / (np.log2(lf + 2.0) -
                                                np.log2(lf + 1.0))
                lam = lam_td / (scale * 4.0 ** (7 - log2))
                co = np.zeros((1, n, n), np.int32)
                co[0, 0, 0], co[0, 1, 0] = mag, -mag
                want = np.asarray(jax.jit(lambda c: jquant.rdoq_lite(
                    c, qp, log2, lam=lam, lam_scale=scale))(co))
                got = tquant.rdoq_lite(T(co), qp, log2, lam=lam,
                                       lam_scale=scale).numpy()
                np.testing.assert_array_equal(got, want)
                ties += 1
                split_before += int((_rdoq_lite_correct_table(
                    co, qp, log2, lam, scale) != want).any())
    print(f"rdoq_lite log2={log2}: {ties} constructed ties, the correctly "
          f"rounded log2 split {split_before}")
    assert split_before > 0


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_sign_data_hiding_equal(log2):
    rng = np.random.default_rng(50 + log2)
    for qp in (22, 32):
        co = _coeffs(rng, log2, 64, amp=150)
        lv = np.asarray(jquant.quantize(jnp.asarray(co), qp, log2))
        f = jax.jit(lambda l, c: jquant.apply_sbh(l, log2, c, qp))
        np.testing.assert_array_equal(
            tquant.apply_sbh(T(lv), log2, T(co), qp).numpy(),
            np.asarray(f(jnp.asarray(lv), jnp.asarray(co))))
        st = rng.integers(0, 3, 64).astype(np.int32)
        g = jax.jit(lambda l, s, c: jquant.apply_sbh_scan(l, log2, s, c, qp))
        np.testing.assert_array_equal(
            tquant.apply_sbh_scan(T(lv), log2, T(st), T(co), qp).numpy(),
            np.asarray(g(jnp.asarray(lv), jnp.asarray(st), jnp.asarray(co))))
        for i in range(4):
            for stype in range(3):
                np.testing.assert_array_equal(
                    tquant.apply_sbh_np(lv[i], log2, co[i], qp,
                                        scan_type=stype),
                    jquant.apply_sbh_np(lv[i], log2, co[i], qp,
                                        scan_type=stype))


# ---- intra prediction ---------------------------------------------------

@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("luma", [True, False])
def test_predict_intra_all_modes_equal(log2, luma):
    rng = np.random.default_rng(70 + log2 + 5 * luma)
    n = 1 << log2
    ref = rng.integers(0, 256, (24, 4 * n + 1)).astype(np.int32)
    ref[:4] = ref[:4, :1]                       # flat references too
    modes = np.broadcast_to(np.arange(35, dtype=np.int32), (24, 35)).copy()
    pred = jax.jit(lambda r, m: jintra.predict_intra(r, m, log2,
                                                     is_luma=luma))
    want = np.asarray(pred(ref, modes))
    got = tintra.predict_intra(T(ref), T(modes), log2, is_luma=luma)
    np.testing.assert_array_equal(got.numpy(), want)
    one = rng.integers(0, 35, (24, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        tintra.predict_intra(T(ref), T(one), log2, is_luma=luma).numpy(),
        np.asarray(pred(ref, one)))
    for m in (0, 1, 10, 26, 34):
        np.testing.assert_array_equal(
            tintra.predict_intra_np(ref[5], m, log2, is_luma=luma),
            jintra.predict_intra_np(ref[5], m, log2, is_luma=luma))
    modes_t = T(np.arange(35, dtype=np.int32))
    np.testing.assert_array_equal(
        tintra.use_filtered_ref(modes_t, log2, luma).numpy(),
        np.asarray(jintra.use_filtered_ref(jnp.arange(35), log2, luma)))


@pytest.mark.parametrize("r", [17, 33, 129])
def test_substitute_and_smooth_equal(r):
    rng = np.random.default_rng(r)
    samples = rng.integers(0, 256, (64, r)).astype(np.int32)
    avail = rng.random((64, r)) < 0.4
    avail[:4] = False
    avail[4:8] = True
    avail[8, :r // 2] = False
    want = np.asarray(jintra.substitute_unavailable(jnp.asarray(samples),
                                                    jnp.asarray(avail)))
    np.testing.assert_array_equal(
        tintra.substitute_unavailable(T(samples), T(avail)).numpy(), want)
    np.testing.assert_array_equal(
        tintra.smooth_reference(T(want)).numpy(),
        np.asarray(jintra.smooth_reference(jnp.asarray(want))))


@pytest.mark.parametrize("n", [16, 32])
def test_hadamard_satd_sweep_shapes_equal(n):
    """_mode_sweep calls SATD on [B, 1, n, n] against [B, 35, n, n]."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 256, (12, 1, n, n)).astype(np.int32)
    b = rng.integers(0, 256, (12, 35, n, n)).astype(np.int32)
    got = tcost.hadamard_satd_8x8(T(a), T(b))
    assert got.shape == (12, 35)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcost.hadamard_satd_8x8(jnp.asarray(a),
                                                        jnp.asarray(b))))


# ---- deblocking ----------------------------------------------------------

@pytest.mark.parametrize("w,h", [(96, 64), (80, 48)])
@pytest.mark.parametrize("qp", [22, 32, 40])
def test_deblock_bs_equal(w, h, qp):
    rng = np.random.default_rng(w + h + qp)
    y = np.clip(128 + rng.normal(0, 12, (h, w)).cumsum(1) / 4, 0,
                255).astype(np.int32)
    u = rng.integers(90, 170, (h // 2, w // 2)).astype(np.int32)
    v = rng.integers(90, 170, (h // 2, w // 2)).astype(np.int32)
    bs_ver = 2 * rng.integers(0, 2, (w // 8 - 1, h // 8)).astype(np.int32)
    bs_hor = 2 * rng.integers(0, 2, (h // 8 - 1, w // 8)).astype(np.int32)
    f = jax.jit(lambda *a: jdbk.deblock_420_bs(*a[:3], qp, *a[3:], block=8))
    want = f(y, u, v, bs_ver, bs_hor)
    got = tdbk.deblock_420_bs_np(y, u, v, qp, bs_ver, bs_hor, block=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    tens = tdbk.deblock_420_bs(T(y), T(u), T(v), qp, bs_ver, bs_hor, block=8)
    for a, b in zip(tens, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_deblock_cut_options_raise():
    """The per-block QP map (cu_qp_delta), cut before, now deblocks as
    the reference does, on tensors and through the numpy entry."""
    rng = np.random.default_rng(30)
    y = np.clip(128 + rng.normal(0, 9, (16, 16)).cumsum(1) / 3, 0,
                255).astype(np.int32)
    c = rng.integers(90, 170, (8, 8)).astype(np.int32)
    bs = np.full((1, 2), 2, np.int32)
    qm = np.array([[30, 38], [44, 27]], np.int32)
    want = jdbk.deblock_420_bs_np(y, c, c, 30, bs, bs, block=8, qp_map=qm)
    got = tdbk.deblock_420_bs(T(y), T(c), T(c), 30, bs, bs, block=8,
                              qp_map=qm)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert not np.array_equal(np.asarray(want[0]), y)


@pytest.mark.parametrize("qp", [27, 37])
def test_deblock_seg4_matches_reference(qp):
    # the general decoder's per-4-sample BS maps (seg4)
    rng = np.random.default_rng(qp)
    h, w = 48, 80
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    bs_ver = rng.integers(0, 3, (w // 8 - 1, h // 4)).astype(np.int32)
    bs_hor = rng.integers(0, 3, (h // 8 - 1, w // 4)).astype(np.int32)
    want = jdbk.deblock_420_bs_np(y, u, v, qp, bs_ver, bs_hor, block=8,
                                  seg4=True)
    got = tdbk.deblock_420_bs_np(y, u, v, qp, bs_ver, bs_hor, block=8,
                                 seg4=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---- device full RDOQ ------------------------------------------------------

_RDOQ_CASES = [(log2, luma, st) for log2 in (2, 3) for luma in (True, False)
               for st in range(3)] + [(log2, luma, 0) for log2 in (4, 5)
                                      for luma in (True, False)]


@pytest.mark.parametrize("log2,luma,scan_type", _RDOQ_CASES)
def test_rdoq_dev_levels_and_rate_equal(log2, luma, scan_type):
    rng = np.random.default_rng(90 + 8 * log2 + 2 * scan_type + luma)
    co = _coeffs(rng, log2, 24 if log2 < 5 else 8, amp=70)
    co[0] = 0                                   # an all-zero block
    qp = 32 if log2 % 2 else 27
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    f = jax.jit(lambda c: jrdoq_dev.rdoq_dev(
        c, qp, log2, lam=lam, scan_type=scan_type, is_luma=luma,
        return_rate=True))
    lv, bits = (np.asarray(a) for a in f(jnp.asarray(co)))
    tlv, tbits = trdoq_dev.rdoq_dev(T(co), qp, log2, lam=lam,
                                    scan_type=scan_type, is_luma=luma,
                                    return_rate=True)
    np.testing.assert_array_equal(tlv.numpy(), lv)
    np.testing.assert_array_equal(tbits.numpy(), bits)
    plain = trdoq_dev.rdoq_dev(T(co), qp, log2, lam=lam, scan_type=scan_type,
                               is_luma=luma)
    np.testing.assert_array_equal(plain.numpy(), lv)


def test_fma32_matches_xla_contraction():
    """XLA's CPU backend contracts a multiply feeding an add into one
    fused multiply-add; fma32 gives the same float32."""
    rng = np.random.default_rng(5)
    a = (rng.random(4096) * 1000).astype(np.float32)
    b = (rng.random(4096) * 3000).astype(np.float32)
    c = np.float32(0.37)
    want = np.asarray(jax.jit(lambda a, b: a * a + c * b)(a, b))
    got = tquant.fma32(T(a), T(a), torch.tensor(c) * T(b)).numpy()
    np.testing.assert_array_equal(got, want)
