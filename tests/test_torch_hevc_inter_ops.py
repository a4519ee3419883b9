"""The port's HEVC inter leaf ops against the JAX package's, on the CPU.

Seeded numpy inputs go through the JAX function (jitted where the
reference's encoder jits it) and the port's counterpart on CPU tensors:
motion compensation and its numpy twins, the pyramid motion search and
its SATD refinement, the per-list motion search of a B picture, the 16x16
intra mode decision, batched TB coding with the full RDOQ's rate, the MV
helpers and the float32 cost expressions of the B-picture decision.
Tolerance 0 everywhere: integers are exact and the float32 costs are
computed in the reference's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_codecs_tpu.models.hevc import encoder_jax as jenc
from video_codecs_tpu.models.hevc import inter_jax as jinter
from video_codecs_tpu.models.hevc import inter_qt as jqt
from video_codecs_tpu.ops import interp as jinterp
from video_codecs_tpu.ops import me as jme
from video_codecs_tpu_torch.models.h264 import inter_dev as th264
from video_codecs_tpu_torch.models.hevc import encoder_dev as tenc
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import inter_qt as tqt
from video_codecs_tpu_torch.ops import interp as tinterp
from video_codecs_tpu_torch.ops import me as tme
from video_codecs_tpu_torch.ops import quant as tquant
from video_codecs_tpu_torch.ops import sad_surface as tsad

torch.set_grad_enabled(False)


def T(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _plane(rng, h, w, smooth=True):
    p = rng.integers(0, 256, (h, w)).astype(np.int32)
    if smooth:     # textured but correlated, so searches find real minima
        p = (p + np.roll(p, 1, 0) + np.roll(p, 1, 1) +
             np.roll(p, (1, 1), (0, 1))) // 4
    return p


def _grid(w, h, n):
    x0 = np.tile(np.arange(w // n, dtype=np.int32) * n, h // n)
    y0 = np.repeat(np.arange(h // n, dtype=np.int32) * n, w // n)
    return x0, y0


# ---- motion compensation ---------------------------------------------------

@pytest.mark.parametrize("n", [32, 16, 8, 4])
def test_mc_multi_and_bi_average(n):
    rng = np.random.default_rng(n)
    h, w = 64, 96
    refs = np.stack([_plane(rng, h, w) for _ in range(2)])
    refc = np.stack([_plane(rng, h // 2, w // 2) for _ in range(2)])
    b = 40
    x0 = rng.integers(0, w - n + 1, b).astype(np.int32)
    y0 = rng.integers(0, h - n + 1, b).astype(np.int32)
    ridx = rng.integers(0, 2, b).astype(np.int32)
    # MVs reach past every picture edge (edge replication)
    mvx = rng.integers(-4 * w, 4 * w, b).astype(np.int32)
    mvy = rng.integers(-4 * h, 4 * h, b).astype(np.int32)
    args = (ridx, x0, y0, mvx, mvy)
    p14 = tinterp.mc_luma14_multi(T(refs), *map(T, args), n)
    _eq(p14, jinterp.mc_luma14_multi(jnp.asarray(refs), *args, n))
    q14 = tinterp.mc_luma14_multi(T(refs), *map(T, args[:3]),
                                  T(mvx[::-1].copy()), T(mvy), n)
    _eq(tinterp.bi_average(p14, q14),
        jinterp.bi_average(jinterp.mc_luma14_multi(jnp.asarray(refs),
                                                   *args, n),
                           jinterp.mc_luma14_multi(jnp.asarray(refs),
                                                   *args[:3],
                                                   mvx[::-1].copy(), mvy,
                                                   n)))
    _eq(tinterp.mc_luma_multi(T(refs), *map(T, args), n),
        jinterp.mc_luma_multi(jnp.asarray(refs), *args, n))
    cx, cy = x0 // 2, y0 // 2
    cargs = (ridx, cx, cy, mvx, mvy)
    _eq(tinterp.mc_chroma14_multi(T(refc), *map(T, cargs), n // 2),
        jinterp.mc_chroma14_multi(jnp.asarray(refc), *cargs, n // 2))
    _eq(tinterp.mc_luma(T(refs[0]), T(x0), T(y0), T(mvx), T(mvy), n),
        jinterp.mc_luma(jnp.asarray(refs[0]), x0, y0, mvx, mvy, n))
    _eq(tinterp.mc_chroma(T(refc[1]), T(cx), T(cy), T(mvx), T(mvy),
                          n // 2),
        jinterp.mc_chroma(jnp.asarray(refc[1]), cx, cy, mvx, mvy, n // 2))


def test_mc_numpy_twins():
    rng = np.random.default_rng(7)
    ref = _plane(rng, 40, 56)
    for _ in range(12):
        x, y = (int(v) for v in rng.integers(0, 40, 2))
        mvx, mvy = (int(v) for v in rng.integers(-90, 90, 2))
        pw, ph = (int(v) for v in rng.choice([4, 8, 12, 16], 2))
        _eq(tinterp.mc_luma14_rect_np(ref, x, y, mvx, mvy, pw, ph),
            jinterp.mc_luma14_rect_np(ref, x, y, mvx, mvy, pw, ph))
        _eq(tinterp.mc_chroma14_rect_np(ref, x, y, mvx, mvy, pw, ph),
            jinterp.mc_chroma14_rect_np(ref, x, y, mvx, mvy, pw, ph))


# ---- motion search ----------------------------------------------------------

def _shifted(rng, h, w, dx, dy):
    big = _plane(rng, h + 64, w + 64)
    ref = big[32:32 + h, 32:32 + w]
    cur = big[32 + dy:32 + dy + h, 32 + dx:32 + dx + w]
    return ref, cur


@pytest.mark.parametrize("n,sr", [(16, 16), (16, 64), (8, 16)])
def test_pyramid_search_and_refine(n, sr):
    rng = np.random.default_rng(n + sr)
    h, w = 64, 96
    ref, cur_plane = _shifted(rng, h, w, 5, -3)
    # local motion on top of the global shift, and flat blocks (ties)
    cur_plane = cur_plane.copy()
    cur_plane[16:32, 32:48] = np.roll(cur_plane[16:32, 32:48], 2, 1)
    cur_plane[48:64, 0:16] = 128
    x0, y0 = _grid(w, h, n)
    cur = cur_plane.reshape(h // n, n, w // n, n).transpose(
        0, 2, 1, 3).reshape(-1, n, n)
    before = tsad.sad_surface.launches
    got = tme.pyramid_search(T(ref), T(cur), T(x0), T(y0), n, sr)
    assert tsad.sad_surface.launches == before       # plain path on CPU
    want = jax.jit(jme.pyramid_search, static_argnums=(4, 5))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, n, sr)
    for a, b in zip(got, want):
        _eq(a, b)
    mvx, mvy = got[0] * 4, got[1] * 4
    for step in (2, 1):
        tr = tme._refine(T(ref), T(cur), T(x0), T(y0), mvx, mvy, n, step)
        jr = jme._refine(jnp.asarray(ref), jnp.asarray(cur), x0, y0,
                         np.asarray(mvx), np.asarray(mvy), n, step)
        for a, b in zip(tr, jr):
            _eq(a, b)
        mvx, mvy = tr[0], tr[1]


def test_sad_at_points_and_pool4():
    rng = np.random.default_rng(3)
    win = rng.integers(0, 256, (5, 16 + 6, 16 + 6)).astype(np.int32)
    cur = rng.integers(0, 256, (5, 16, 16)).astype(np.int32)
    pts = np.array([(-3, -3), (0, 0), (2, -1), (3, 3)], np.int32)
    _eq(tme._sad_at_points(T(win), T(cur), pts, 3, 16),
        jme._sad_at_points(jnp.asarray(win), jnp.asarray(cur), pts, 3, 16))
    _eq(tme._pool4(T(win[:, :20, :20])),
        jme._pool4(jnp.asarray(win[:, :20, :20])))


@pytest.mark.parametrize("n", [16, 8])
def test_b_me_one(n):
    rng = np.random.default_rng(21 + n)
    h, w = 64, 96
    ref, cur_plane = _shifted(rng, h, w, -6, 2)
    x0, y0 = _grid(w, h, n)
    cur = cur_plane.reshape(h // n, n, w // n, n).transpose(
        0, 2, 1, 3).reshape(-1, n, n)
    got = tinter.b_me_one(T(ref), T(cur), T(x0), T(y0), 64, "pyr", n=n)
    want = jax.jit(jinter.b_me_one, static_argnums=(4, 5, 6))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, 64, "pyr", n)
    for a, b in zip(got, want):
        _eq(a, b)
    # HM's TZSearch at search range 16 (range 64: test_torch_hevc_me.py)
    got = tinter.b_me_one(T(ref), T(cur), T(x0), T(y0), 16, "tz", n=n)
    want = jax.jit(jinter.b_me_one, static_argnums=(4, 5, 6))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, 16, "tz", n)
    for a, b in zip(got, want):
        _eq(a, b)


# ---- intra mode decision and TB coding ------------------------------------

@pytest.mark.parametrize("qp", [27, 32, 37])
def test_decide_modes_device(qp):
    rng = np.random.default_rng(qp)
    y = _plane(rng, 64, 96)
    y[:16, :48] = 100                     # flat area: MPM-biased ties
    got = tenc.decide_modes_device(T(y), qp, 6, 4)
    want = jax.jit(jenc.decide_modes_device, static_argnums=(1, 2, 3))(
        jnp.asarray(y), qp, 6, 4)
    _eq(got, want)


@pytest.mark.parametrize("log2,is_luma", [(4, True), (3, True), (3, False),
                                          (2, False), (2, True)])
@pytest.mark.parametrize("sbh", [True, False])
def test_code_blocks_rate(log2, is_luma, sbh):
    n = 1 << log2
    rng = np.random.default_rng(log2 * 10 + is_luma + 2 * sbh)
    b = 48
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    pred = np.clip(orig + rng.integers(-30, 31, (b, n, n)), 0,
                   255).astype(np.int32)
    pred[:4] = orig[:4]                   # zero residual: cbf 0
    qp, lam = 32, 40.7
    got = tenc._code_blocks_rate(T(orig), T(pred), qp, log2, sbh=sbh,
                                 is_luma=is_luma, rdoq="full", lam=lam)
    want = jax.jit(jenc._code_blocks_rate,
                   static_argnames=("qp", "log2", "sbh", "is_luma", "rdoq",
                                    "lam"))(
        jnp.asarray(orig), jnp.asarray(pred), qp=qp, log2=log2, sbh=sbh,
        is_luma=is_luma, rdoq="full", lam=lam)
    for a, b_ in zip(got, want):
        _eq(a, b_)
    # without the full RDOQ, the reference's proxy rate (held to the JAX
    # function in tests/test_torch_hevc_tiles.py) beside _code_blocks'
    # levels, recon and cbf
    got = tenc._code_blocks_rate(T(orig), T(pred), qp, log2, sbh=sbh,
                                 is_luma=is_luma, rdoq="lite", lam=lam)
    want = tenc._code_blocks(T(orig), T(pred), qp, log2, intra_slice=False,
                             sbh=sbh, rdoq="lite", is_luma=is_luma, lam=lam)
    for a, b_ in zip(got[:3], want):
        _eq(a, b_)
    assert got[3].shape == (b,) and bool((got[3] >= 0).all())


def test_code_blocks_all_quantizers():
    rng = np.random.default_rng(5)
    orig = rng.integers(0, 256, (24, 16, 16)).astype(np.int32)
    pred = np.clip(orig + rng.integers(-25, 26, orig.shape), 0,
                   255).astype(np.int32)
    for rdoq in (False, "lite", "full"):
        got = tenc._code_blocks(T(orig), T(pred), 30, 4, intra_slice=True,
                                sbh=True, rdoq=rdoq)
        want = jenc._code_blocks(jnp.asarray(orig), jnp.asarray(pred), 30,
                                 4, intra_slice=True, sbh=True, rdoq=rdoq)
        for a, b in zip(got, want):
            _eq(a, b)


# ---- MV helpers --------------------------------------------------------

def test_mvd_bits_over_the_sr64_range():
    # quarter-pel MVs at SR64 reach +-(256 + 3); their differences and
    # far beyond, where XLA's float32 log2 meets the powers of two
    d = np.arange(-70000, 70001, dtype=np.int32)
    other = np.roll(d, 12345)
    _eq(tinter.mvd_bits_dev(T(d), T(other)),
        jax.jit(jinter.mvd_bits_dev)(d, other))


def test_scale_mv_dev():
    rng = np.random.default_rng(11)
    mvx = rng.integers(-3000, 3000, 500).astype(np.int32)
    mvy = rng.integers(-3000, 3000, 500).astype(np.int32)
    td = rng.integers(-140, 140, 500).astype(np.int32)
    for tb in (-16, -3, 0, 1, 7, 130):
        got = tinter.scale_mv_dev(T(mvx), T(mvy), tb, T(td))
        want = jinter.scale_mv_dev(mvx, mvy, tb, td)
        for a, b in zip(got, want):
            _eq(a, b)


def test_shift_grid_and_scatter_blocks():
    rng = np.random.default_rng(2)
    f = rng.integers(-9, 9, (4, 6)).astype(np.int32)
    for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1), (1, 1)):
        _eq(tinter._shift_grid(T(f), dx, dy, 7),
            jinter._shift_grid(jnp.asarray(f), dx, dy, 7))
    plane = rng.integers(0, 256, (32, 48)).astype(np.int32)
    vals = rng.integers(0, 256, (6, 16, 16)).astype(np.int32)
    x0, y0 = _grid(48, 32, 16)
    sel = np.array([1, 0, 1, 1, 0, 0], bool)
    _eq(tinter._scatter_blocks(T(plane), T(vals), T(x0), T(y0), 16,
                               T(sel)),
        jinter._scatter_blocks(jnp.asarray(plane), jnp.asarray(vals),
                               x0, y0, 16, sel))


def test_gop_lambda_ladder():
    class Enc:
        pass
    from video_codecs_tpu.models.hevc import headers as jheaders
    from video_codecs_tpu.models.hevc import ra_codec as jra
    from video_codecs_tpu_torch.models.hevc import ra_codec as tra
    enc = Enc()
    enc.cfg = jheaders.HevcConfig(width=64, height=64, qp=33)
    enc.gop_size = 8
    for poc in range(1, 17):
        enc.gop = jra.GOP8_RA
        want = jinter._gop_lambda(enc, poc)
        enc.gop = tra.GOP8_RA
        assert tinter._gop_lambda(enc, poc) == want


# ---- the rate proxy's log2 and the float32 decision costs ------------------

def test_coef_bits_log2_table_is_xlas():
    """ceil(log2(1 + a)) in float32 with XLA's own log2, for every level
    magnitude the int16 coefficient planes hold."""
    a = np.arange(0, 32768, dtype=np.int32)
    want = np.asarray(jax.jit(lambda v: jnp.ceil(
        jnp.log2(1.0 + v.astype(jnp.float32))).astype(jnp.int32))(a))
    _eq(tqt.CEIL_LOG2_1P[:32768], want)
    rng = np.random.default_rng(4)
    coef = rng.integers(-600, 600, (32, 48)).astype(np.int32)
    coef[rng.random(coef.shape) < 0.6] = 0
    x0, y0 = _grid(48, 32, 16)
    _eq(tqt._coef_bits_blocks(T(coef), T(x0), T(y0), 16),
        jqt._coef_bits_blocks(jnp.asarray(coef), x0, y0, 16))


def _near_tie_inputs(rng, nb):
    """Costs d + lam * r with integer-valued d and fractional rates r,
    the two sides built to meet within a few ulps."""
    lam = np.float32(rng.uniform(20.0, 120.0))
    r16 = rng.uniform(10.0, 400.0, nb).astype(np.float32)
    r8 = rng.uniform(2.0, 100.0, (nb, 4)).astype(np.float32)
    d8 = rng.integers(0, 4000, (nb, 4)).astype(np.float32)
    j8 = d8 + lam * r8
    d16 = np.maximum(np.round(j8.sum(1) - lam * r16), 0).astype(np.float32)
    return lam, d16, r16, d8, r8


def test_rqt_and_cu8_costs_match_xla():
    """The RQT and CU8 split costs of encode_b_frame_dev (inter_jax.py
    :447-454 and :600-625) against the same float32 expressions compiled
    by XLA, on inputs built to nearly tie."""
    rng = np.random.default_rng(8)
    nb = 19200
    lam, d16, r16, d8, r8 = _near_tie_inputs(rng, nb)

    @jax.jit
    def ref(d16, r16, d8, r8, lamf):
        j16 = d16 + lamf * (r16 + 1.0)
        j8 = d8.reshape(-1) + lamf * (r8.reshape(-1) + 7.0)
        g = j8.reshape(nb // 6, 2, 6, 2)       # [bh, 2, bw, 2] children
        s = jnp.sum(j8.reshape(-1, 4), axis=1)
        return j16, j8, jnp.sum(g, axis=(1, 3)).reshape(-1), s

    lam_t = torch.tensor(lam)
    want = [np.asarray(v) for v in ref(d16, r16, d8, r8, lam)]
    j16 = tquant.fma32(T(r16) + 1.0, lam_t, T(d16))
    j8 = tquant.fma32(T(r8).reshape(-1) + 7.0, lam_t, T(d8).reshape(-1))
    _eq(j16, want[0])
    _eq(j8, want[1])
    _eq(tinter._sum2x2(j8.reshape(nb // 6, 2, 6, 2)).reshape(-1), want[2])
    _eq(tinter._persum(j8), want[3])
    # the residual CU32 cost of qt_merge_dev (inter_qt.py:257)
    jres = jax.jit(lambda d, b: (d.astype(jnp.float32) + 40.7 *
                                 (20.0 + b)).astype(jnp.int32))
    di = d16.astype(np.int32)
    _eq(tquant.fma32(20.0 + T(r16), torch.tensor(np.float32(40.7)),
                     T(di).float()).int(), jres(di, r16))


def test_h264_split_costs_match_xla():
    """The H.264 P_16x16 / P_8x8 costs of encode_p_dev (h264/inter_jax.py
    :141-145): XLA's CPU code fuses `d + lam * r` into one FMA, and the
    port's `_split_costs` must give the same float32 bits on inputs near
    the j8s < j16 tie."""
    rng = np.random.default_rng(12)
    mbh, mbw = 30, 40
    nmb = mbh * mbw
    lam, d16, r16, d8, r8 = _near_tie_inputs(rng, nmb)
    bits16 = rng.integers(2, 30, nmb).astype(np.int32)
    bits8 = rng.integers(2, 30, 4 * nmb).astype(np.int32)
    rb16 = (r16 - bits16 - 2).astype(np.float32)
    # per-8 children in the raster 8 grid, as encode_p_dev holds them
    rb8 = r8.reshape(mbh, mbw, 2, 2).transpose(0, 2, 1, 3).reshape(-1)
    d8g = d8.reshape(mbh, mbw, 2, 2).transpose(0, 2, 1, 3).reshape(-1)

    @jax.jit
    def ref(d16, rb16, bits16, d8, rb8, bits8):
        lamf = jnp.float32(lam)
        j16 = d16 + lamf * (rb16 + (bits16 + 2).astype(jnp.float32))
        g = (d8 + lamf * (rb8 + (bits8 + 3).astype(jnp.float32))).reshape(
            mbh, 2, mbw, 2)
        j8s = jnp.sum(g, axis=(1, 3)).reshape(nmb) + lamf * 4.0
        return j16, j8s, j8s < j16

    want = [np.asarray(v) for v in ref(d16, rb16, bits16, d8g, rb8, bits8)]
    got = th264._split_costs(T(d16), T(rb16), T(bits16), T(d8g), T(rb8),
                             T(bits8), float(lam), mbh, mbw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    _eq(got[0] > got[1], want[2])


def test_h264_lv_bits_match_xla():
    """The H.264 coefficient-rate proxy `_lv_bits` (h264/inter_jax.py:88)
    at 0 ulp: XLA's log, its FMAs and its order of the 4x4 sum (rows as
    vector lanes, columns chained, lanes in halves)."""
    from video_codecs_tpu.models.h264 import inter_jax as jh264
    rng = np.random.default_rng(31)
    lv = rng.integers(-40, 41, (3000, 4, 4)).astype(np.int32)
    lv[rng.random(lv.shape) < 0.6] = 0
    lv[:8] = rng.integers(-3000, 3000, (8, 4, 4))
    _eq(th264._lv_bits(T(lv)), jax.jit(jh264._lv_bits)(lv))
