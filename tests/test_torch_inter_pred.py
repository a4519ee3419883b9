"""The inter-prediction kernels (csrc/inter_pred.cu) and their plain
versions.

`ops/inter_pred` has three entries, each the plain version for CPU
tensors and one kernel launch for CUDA tensors: `mc_pred` (multi-reference
motion compensation with its uni/bi combine and optional SATD),
`refine_qpel` (the two quarter-pel SATD rounds) and `bi_refine_pass` (the
alternating bi refinement).  The CPU cases hold the plain entries to the
JAX package at tolerance 0 on seeded inputs (n = 4 to 32, MVs up to 70
samples outside a 64x48 plane, one reference in list 0 and two in list 1,
flat regions that force SATD ties), the kernels' table buffer to the JAX
package's tables, the routing of the device engines through the entries,
and the CUDA branch's host behaviour with a fake library.  The `cuda`
cases hold each kernel to its plain version on the same CUDA tensors at
the encoders' shapes; they skip where there is no card; on one:

    python -m pytest --noconftest -m cuda tests/test_torch_inter_pred.py

JAX is imported inside the CPU cases only, so the `cuda` cases run where
JAX is not installed.
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.ops import inter_pred as ip
from video_codecs_tpu_torch.ops import interp as tinterp
from video_codecs_tpu_torch.ops import me as tme

torch.set_grad_enabled(False)

H, W = 48, 64


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a)).int()


def _jax():
    """(jnp, the JAX package's interp, me and cost modules)."""
    import jax.numpy as jnp
    from video_codecs_tpu.ops import cost as jcost
    from video_codecs_tpu.ops import interp as jinterp
    from video_codecs_tpu.ops import me as jme
    return jnp, jinterp, jme, jcost


def _planes(rng, r, h, w):
    """[r, h, w] textured 8-bit planes, each with a flat patch (SATD ties
    among the candidates that read only it)."""
    p = rng.integers(0, 256, (r, h, w))
    p = (p + np.roll(p, 1, 1) + np.roll(p, 1, 2)) // 3
    p[:, h // 4:h // 2, w // 4:w // 2] = 90
    return p.astype(np.int32)


def _blocks(rng, b, n, h, w, reach=70):
    """Block origins on the n-grid of an h x w plane and quarter-pel MVs
    [4, b] reaching `reach` samples past every edge."""
    gx, gy = w // n, h // n
    k = rng.integers(0, gx * gy, b)
    x0 = (k % gx * n).astype(np.int32)
    y0 = (k // gx * n).astype(np.int32)
    mv = np.stack([rng.integers(-4 * (w + reach), 4 * (w + reach), b),
                   rng.integers(-4 * (h + reach), 4 * (h + reach), b),
                   rng.integers(-4 * (w + reach), 4 * (w + reach), b),
                   rng.integers(-4 * (h + reach), 4 * (h + reach), b)])
    return x0, y0, mv.astype(np.int32)


def _cur(rng, b, n):
    cur = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    cur[::3] = 90          # flat blocks: ties among flat candidates
    return cur


def _eq(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))


# ---- the tables -------------------------------------------------------------

def test_tables_are_the_references():
    """The kernels read the filters and `_OFFS8` from the port's copies;
    they equal the JAX package's, at the offsets csrc/inter_pred.cu
    names."""
    _, jinterp, jme, _ = _jax()
    np.testing.assert_array_equal(tinterp.LUMA_FILTERS, jinterp.LUMA_FILTERS)
    np.testing.assert_array_equal(tinterp.CHROMA_FILTERS,
                                  jinterp.CHROMA_FILTERS)
    np.testing.assert_array_equal(tme._OFFS8, jme._OFFS8)
    tab = ip.tables_np()
    assert tab.dtype == np.int32 and tab.size == ip.TAB_SIZE == 80
    np.testing.assert_array_equal(tab[ip.TAB_LUMA:ip.TAB_CHROMA].reshape(
        4, 8), jinterp.LUMA_FILTERS)
    np.testing.assert_array_equal(tab[ip.TAB_CHROMA:ip.TAB_OFFS].reshape(
        8, 4), jinterp.CHROMA_FILTERS)
    np.testing.assert_array_equal(tab[ip.TAB_OFFS:].reshape(8, 2),
                                  jme._OFFS8)
    src = ip._SRC.read_text()
    for name, off in (("kTabLuma", ip.TAB_LUMA),
                      ("kTabChroma", ip.TAB_CHROMA),
                      ("kTabOffs", ip.TAB_OFFS), ("kTabSize", ip.TAB_SIZE)):
        assert f"constexpr int {name} = {off};" in src


# ---- the plain entries against the JAX package -----------------------------

@pytest.mark.parametrize("n", [8, 16])
def test_refine_qpel_plain_matches_jax(n):
    """`refine_qpel` on CPU tensors is two JAX `me._refine` rounds, step
    2 then step 1, at integer and odd start MVs."""
    jnp, _, jme, _ = _jax()
    rng = np.random.default_rng(100 + n)
    ref = _planes(rng, 1, H, W)[0]
    b = 30
    x0, y0, mv = _blocks(rng, b, n, H, W)
    cur = _cur(rng, b, n)
    cur[1::3] = ref[10:10 + n, 20:20 + n]       # an exact match exists
    for mvx, mvy in ((mv[0] // 4 * 4, mv[1] // 4 * 4), (mv[2], mv[3])):
        got = ip.refine_qpel(T(ref), T(cur), T(x0), T(y0), T(mvx), T(mvy),
                             n)
        jx, jy = jnp.asarray(mvx), jnp.asarray(mvy)
        for step in (2, 1):
            jx, jy, js = jme._refine(jnp.asarray(ref), jnp.asarray(cur), x0,
                                     y0, jx, jy, n, step)
        _eq(got, (jx, jy, js))


def _jax_bi_pass(jnp, jinterp, jme, jcost, refs0, refs1, r0, r1, cur, x0,
                 y0, mv, n):
    """inter_jax.py:586-616, written as the reference writes it."""
    def bi_refine(fix14, refs_l, ridx_l, mvx, mvy):
        best = jcost.hadamard_satd_8x8(
            cur, jinterp.bi_average(fix14, jinterp.mc_luma14_multi(
                refs_l, ridx_l, x0, y0, mvx, mvy, n)))
        for k in range(8):
            cx_ = mvx + int(jme._OFFS8[k][0])
            cy_ = mvy + int(jme._OFFS8[k][1])
            satd = jcost.hadamard_satd_8x8(
                cur, jinterp.bi_average(fix14, jinterp.mc_luma14_multi(
                    refs_l, ridx_l, x0, y0, cx_, cy_, n)))
            better = satd < best
            best = jnp.where(better, satd, best)
            mvx = jnp.where(better, cx_, mvx)
            mvy = jnp.where(better, cy_, mvy)
        return mvx, mvy, best

    p0_14 = jinterp.mc_luma14_multi(refs0, r0, x0, y0, mv[0], mv[1], n)
    b1x, b1y, _ = bi_refine(p0_14, refs1, r1, mv[2], mv[3])
    p1r_14 = jinterp.mc_luma14_multi(refs1, r1, x0, y0, b1x, b1y, n)
    b0x, b0y, satd_bi = bi_refine(p1r_14, refs0, r0, mv[0], mv[1])
    return b0x, b0y, b1x, b1y, satd_bi


@pytest.mark.parametrize("n", [8, 16])
def test_bi_refine_pass_plain_matches_jax(n):
    """`bi_refine_pass` on CPU tensors against the JAX composition of
    `mc_luma14_multi`, `bi_average` and `hadamard_satd_8x8`, list 0 one
    reference, list 1 two."""
    jnp, jinterp, jme, jcost = _jax()
    rng = np.random.default_rng(200 + n)
    refs0 = _planes(rng, 1, H, W)
    refs1 = _planes(rng, 2, H, W)
    b = 30
    x0, y0, mv = _blocks(rng, b, n, H, W)
    r0 = np.zeros(b, np.int32)
    r1 = rng.integers(0, 2, b).astype(np.int32)
    cur = _cur(rng, b, n)
    got = ip.bi_refine_pass(T(refs0), T(refs1), T(r0), T(r1), T(cur),
                            T(x0), T(y0), *map(T, mv), n)
    want = _jax_bi_pass(jnp, jinterp, jme, jcost, jnp.asarray(refs0),
                        jnp.asarray(refs1), r0, r1, jnp.asarray(cur), x0,
                        y0, mv, n)
    _eq(got, want)


_MC_CASES = [(luma, n) for luma, sizes in ((True, (8, 16, 32)),
                                            (False, (4, 8, 16)))
             for n in sizes]


@pytest.mark.parametrize("luma,n", _MC_CASES)
def test_mc_pred_plain_matches_jax(luma, n):
    """`mc_pred` on CPU tensors against the JAX package's `mc_*14_multi`,
    `mc_*_multi` and `bi_average` combined as `mrg_pred` / `final_pred` /
    `_pred_cand` combine them, by direction 1 / 2 / 3 (and 0, which they
    send to list 1), with and without L1, and the SATD alone for n >= 8."""
    jnp, jinterp, _, jcost = _jax()
    rng = np.random.default_rng(300 + n + 100 * luma)
    h, w = (H, W) if luma else (H // 2, W // 2)
    refs0 = _planes(rng, 1, h, w)
    refs1 = _planes(rng, 2, h, w)
    b = 40
    x0, y0, mv = _blocks(rng, b, n, h, w)
    r0 = np.zeros(b, np.int32)
    r1 = rng.integers(0, 2, b).astype(np.int32)
    dirs = rng.integers(0, 4, b).astype(np.int32)
    mc14 = jinterp.mc_luma14_multi if luma else jinterp.mc_chroma14_multi
    q0 = mc14(jnp.asarray(refs0), r0, x0, y0, mv[0], mv[1], n)
    q1 = mc14(jnp.asarray(refs1), r1, x0, y0, mv[2], mv[3], n)

    def uni(q):
        return jnp.clip((q + 32) >> 6, 0, 255)

    d = dirs[:, None, None]
    want_bi = jnp.where(d == 3, jinterp.bi_average(q0, q1),
                        jnp.where(d == 1, uni(q0), uni(q1)))
    args = (T(refs0), T(r0), T(x0), T(y0), T(mv[0]), T(mv[1]), n)
    l1 = (T(refs1), T(r1), T(mv[2]), T(mv[3]))
    _eq(ip.mc_pred(*args, luma=luma, out14=True), q0)
    _eq(ip.mc_pred(*args, luma=luma), uni(q0))
    _eq(ip.mc_pred(*args, luma=luma, l1=l1, dirs=T(dirs)), want_bi)
    _eq(ip.mc_pred(*args, luma=luma, l1=l1, dirs=3),
        jinterp.bi_average(q0, q1))
    # the interp entries on CPU tensors are their plain versions
    multi = jinterp.mc_luma_multi if luma else jinterp.mc_chroma_multi
    tmulti = tinterp.mc_luma_multi if luma else tinterp.mc_chroma_multi
    _eq(tmulti(T(refs0), T(r0), T(x0), T(y0), T(mv[0]), T(mv[1]), n),
        multi(jnp.asarray(refs0), r0, x0, y0, mv[0], mv[1], n))
    if n % 8 == 0:
        cur = _cur(rng, b, n)
        satd = ip.mc_pred(*args, luma=luma, l1=l1, dirs=T(dirs),
                          cur=T(cur))
        _eq(satd, jcost.hadamard_satd_8x8(jnp.asarray(cur), want_bi))
        satd = ip.mc_pred(*args, luma=luma, cur=T(cur))
        _eq(satd, jcost.hadamard_satd_8x8(jnp.asarray(cur), uni(q0)))


# ---- routing ----------------------------------------------------------------

def _clip(w, h, nf, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    base = ((base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
            ).astype(np.uint8)
    frames = []
    for f in range(nf):
        y = np.ascontiguousarray(base[8 + f:8 + f + h, 8 + 2 * f:
                                      8 + 2 * f + w])
        frames.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                       (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return frames


@pytest.mark.parametrize("engine", ["qt-ra", "flat-ra", "ldp"])
def test_engines_reach_the_entries(engine, monkeypatch):
    """On CPU tensors `encode_b_frame_dev` (the qt and flat RA engines),
    `qt_merge_dev` and `encode_p_frame_dev` reach the three entries,
    whose plain versions run: the kernels' launch counts stay 0."""
    from video_codecs_tpu_torch.models.hevc import headers, inter_dev
    from video_codecs_tpu_torch.models.hevc import inter_qt
    calls = {}
    stages = {}

    def count(mod, name, into):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            into[name] = into.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    kernels = (ip.mc_pred, ip.refine_qpel, ip.bi_refine_pass)
    launches = [k.launches for k in kernels]
    for name in ("mc_pred", "refine_qpel", "bi_refine_pass", "mc_pred_ref",
                 "refine_qpel_ref", "bi_refine_pass_ref"):
        count(ip, name, calls)
    count(inter_dev, "encode_b_frame_dev", stages)
    count(inter_dev, "encode_p_frame_dev", stages)
    count(inter_qt, "qt_merge_dev", stages)
    w, h = 64, 32
    frames = _clip(w, h, 3)
    if engine == "qt-ra":
        cfg = headers.HevcConfig(width=w, height=h, qp=32, log2_ctb=5,
                                 log2_min_cb=3, log2_max_tb=5,
                                 reorder_pics=3, merge_cands=5)
        inter_qt.QtDeviceRandomAccessEncoder(
            cfg, search_range=16, device="cpu").encode_sequence_ra(frames)
        want_stages = {"encode_b_frame_dev", "qt_merge_dev"}
    elif engine == "flat-ra":
        cfg = headers.HevcConfig(width=w, height=h, qp=32, reorder_pics=3)
        inter_dev.DeviceRandomAccessEncoder(
            cfg, search_range=16, device="cpu").encode_sequence_ra(frames)
        want_stages = {"encode_b_frame_dev"}
    else:
        cfg = headers.HevcConfig(width=w, height=h, qp=32, num_refs=2)
        inter_dev.DeviceLowDelayEncoder(
            cfg, search_range=16, device="cpu").encode_sequence_ldp(frames)
        want_stages = {"encode_p_frame_dev"}
    assert set(stages) == want_stages, stages
    want = {"mc_pred", "refine_qpel", "mc_pred_ref", "refine_qpel_ref"}
    if engine != "ldp":
        want |= {"bi_refine_pass", "bi_refine_pass_ref"}
    assert set(calls) == want, calls
    for name in ("mc_pred", "refine_qpel", "bi_refine_pass"):
        assert calls.get(name, 0) == calls.get(name + "_ref", 0)
    assert [k.launches for k in kernels] == launches


def test_motion_search_reaches_refine_qpel(monkeypatch):
    """The host coders' pass 1 (`me.motion_search`) refines through
    `refine_qpel` for every integer method."""
    seen = []
    orig = ip.refine_qpel
    monkeypatch.setattr(ip, "refine_qpel",
                        lambda *a: seen.append(a[-1]) or orig(*a))
    rng = np.random.default_rng(9)
    ref = _planes(rng, 1, H, W)[0]
    x0 = np.tile(np.arange(W // 16, dtype=np.int32) * 16, H // 16)
    y0 = np.repeat(np.arange(H // 16, dtype=np.int32) * 16, W // 16)
    cur = np.stack([ref[y:y + 16, x:x + 16] for x, y in zip(x0, y0)])
    for method in ("full", "tz", "auto"):
        mvx, mvy, satd = tme.motion_search(T(ref), T(cur), T(x0), T(y0), 16,
                                           8, method)
        assert mvx.shape == satd.shape == (len(x0),)
    assert seen == [16, 16, 16]


# ---- the CUDA branch on the host ---------------------------------------------

class _FakeLib:
    """Stands in for the built library: checks each entry's argument
    count against the C signature `_load` declares and returns 0."""

    def __init__(self):
        self.calls = []
        self.nargs = {"vct_mc_pred": 24, "vct_mc_average": 5,
                      "vct_qpel_refine": 15, "vct_bi_refine": 22}

    def __getattr__(self, name):
        def fn(*args):
            assert len(args) == self.nargs[name], (name, len(args))
            self.calls.append((name, args))
            return 0
        return fn


def test_cuda_branch_launches_once_without_host_reads(monkeypatch):
    """Each entry's CUDA branch, run on CPU tensors with a fake library:
    one call of its C entry with the declared number of arguments, a
    launch counted, and no read back to the host (`item`, `tolist`,
    `numpy`, `__bool__` raise meanwhile); the argument counts equal the
    argtypes `_load` declares."""
    import ctypes
    fake = _FakeLib()
    real_load = ip._load
    monkeypatch.setattr(ip, "_load", lambda: fake)
    monkeypatch.setattr(ip, "_device", lambda t: t.device)
    monkeypatch.setattr(ip, "launch_stream", lambda dev: 0)
    rng = np.random.default_rng(4)
    b, n = 6, 16
    refs0, refs1 = T(_planes(rng, 1, H, W)), T(_planes(rng, 2, H, W))
    x0, y0, mv = _blocks(rng, b, n, H, W)
    cur = T(_cur(rng, b, n))
    r0, r1 = T(np.zeros(b, np.int32)), T(np.ones(b, np.int32))
    mvs = [T(m) for m in mv]
    ip._tab(torch.device("cpu"))          # the table uploads before

    def boom(*a, **k):
        raise AssertionError("host read in a CUDA branch")

    l0 = (ip.mc_pred.launches, ip.refine_qpel.launches,
          ip.bi_refine_pass.launches, ip.bi_average.launches)
    with monkeypatch.context() as m:
        for attr in ("item", "tolist", "numpy", "__bool__", "cpu"):
            m.setattr(torch.Tensor, attr, boom)
        ip._mc_pred_cuda(refs0, r0, T(x0), T(y0), mvs[0], mvs[1], n,
                         luma=True, out14=False, l1=(refs1, r1, mvs[2],
                                                     mvs[3]),
                         dirs=T(np.full(b, 3, np.int32)), cur=cur)
        ip._refine_qpel_cuda(refs0[0], cur, T(x0), T(y0), mvs[0], mvs[1], n)
        ip._bi_refine_pass_cuda(refs0, refs1, r0, r1, cur, T(x0), T(y0),
                                *mvs, n)
        ip.bi_average(cur, cur)
    assert [c[0] for c in fake.calls] == ["vct_mc_pred", "vct_qpel_refine",
                                         "vct_bi_refine", "vct_mc_average"]
    assert (ip.mc_pred.launches, ip.refine_qpel.launches,
            ip.bi_refine_pass.launches, ip.bi_average.launches) == tuple(
                v + 1 for v in l0)
    # the declared argtypes have the same lengths
    monkeypatch.setattr(ip, "_LIB", None)
    monkeypatch.setattr(ip, "build", lambda: (None, 0.0, ""))

    class _Decl:
        def __getattr__(self, name):
            f = type("F", (), {})()
            setattr(self, name, f)
            return f

    decl = _Decl()
    monkeypatch.setattr(ctypes, "CDLL", lambda path: decl)
    real_load()
    for name, k in fake.nargs.items():
        assert len(getattr(decl, name).argtypes) == k, name


def test_cuda_branch_refusals():
    """A tensor on no CPU and no card has no kernel; the kernels' block
    sizes are the paths' and other sizes raise."""
    with pytest.raises(ValueError, match="no kernel"):
        ip._device(torch.zeros(1))
    meta = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tinterp.mc_luma14_multi(meta, z, z, z, z, z, 8)
    with pytest.raises(ValueError, match="no kernel"):
        tinterp.bi_average(meta, meta)
    assert ip.MC_SIZES == {True: (8, 16, 32), False: (4, 8, 16)}
    assert ip.REFINE_SIZES == (8, 16)
    assert ip.BI_SIZES == (16,)


# ---- the kernels on the card -------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


def _card_inputs(seed, b, n, h, w, r0=1, r1=2, reach=70):
    rng = np.random.default_rng(seed)
    x0, y0, mv = _blocks(rng, b, n, h, w, reach)
    cuda = dict(device="cuda")
    return dict(
        refs0=T(_planes(rng, r0, h, w)).to(**cuda),
        refs1=T(_planes(rng, r1, h, w)).to(**cuda),
        x0=T(x0).to(**cuda), y0=T(y0).to(**cuda),
        mv=[T(m).to(**cuda) for m in mv],
        r0=T(rng.integers(0, r0, b)).to(**cuda),
        r1=T(rng.integers(0, r1, b)).to(**cuda),
        dirs=T(rng.integers(0, 4, b)).to(**cuda),
        cur=T(_cur(rng, b, n)).to(**cuda))


def _card_eq(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w_ in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w_.int()), int((g - w_).abs().max())


# (luma, n, B): the encoders' MC shapes -- the 1080p B picture's 16x16
# and CU8 blocks, the qt merge's CU32 candidates, the LD-P picture.
_CARD_MC = [(True, 16, 8040), (False, 8, 8040), (True, 8, 32160),
            (False, 4, 32160), (True, 32, 2010), (False, 16, 2010),
            (True, 16, 1560), (False, 8, 1560)]


@pytest.mark.cuda
@pytest.mark.parametrize("luma,n,b", _CARD_MC)
def test_mc_pred_kernel_matches_plain(luma, n, b):
    _need_card()
    h, w = (1088, 1920) if luma else (544, 960)
    a = _card_inputs(n + b, b, n, h, w)
    args = (a["refs0"], a["r0"], a["x0"], a["y0"], a["mv"][0], a["mv"][1], n)
    l1 = (a["refs1"], a["r1"], a["mv"][2], a["mv"][3])
    sparse = torch.where(a["dirs"] % 4 == 0, 3, 1).int()   # few bi blocks
    for kw in (dict(out14=True), dict(), dict(l1=l1, dirs=a["dirs"]),
               dict(l1=l1, dirs=3), dict(l1=l1, dirs=sparse)):
        if n % 8 == 0 and "out14" not in kw:
            kw["cur"] = a["cur"]
        l0 = ip.mc_pred.launches
        got = ip.mc_pred(*args, luma=luma, **kw)
        assert ip.mc_pred.launches == l0 + 1
        _card_eq(got, ip.mc_pred_ref(*args, luma=luma, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(16, 8040), (16, 1560), (8, 32160),
                                 (16, 2278), (8, 9112)])
def test_refine_qpel_kernel_matches_plain(n, b):
    _need_card()
    a = _card_inputs(7 * n + b, b, n, 1088, 1920)
    ref = a["refs0"][0]
    for mvx, mvy in ((a["mv"][0] // 4 * 4, a["mv"][1] // 4 * 4),
                     (a["mv"][2], a["mv"][3])):
        l0 = ip.refine_qpel.launches
        got = ip.refine_qpel(ref, a["cur"], a["x0"], a["y0"], mvx, mvy, n)
        assert ip.refine_qpel.launches == l0 + 1
        _card_eq(got, ip.refine_qpel_ref(ref, a["cur"], a["x0"], a["y0"],
                                         mvx, mvy, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,r1", [(16, 8040, 1), (16, 2278, 2),
                                    (16, 1000, 2)])
def test_bi_refine_kernel_matches_plain(n, b, r1):
    _need_card()
    a = _card_inputs(11 * n + b, b, n, 1088, 1920, r1=r1)
    args = (a["refs0"], a["refs1"], a["r0"], a["r1"], a["cur"], a["x0"],
            a["y0"], *a["mv"], n)
    l0 = ip.bi_refine_pass.launches
    got = ip.bi_refine_pass(*args)
    assert ip.bi_refine_pass.launches == l0 + 1
    _card_eq(got, ip.bi_refine_pass_ref(*args))


@pytest.mark.cuda
def test_bi_average_and_interp_entries_on_the_card():
    """interp's entries on CUDA tensors launch the kernels and equal their
    plain versions; ragged sizes and B = 1 too."""
    _need_card()
    a = _card_inputs(5, 33, 16, 1088, 1920)
    p0 = tinterp.mc_luma14_multi(a["refs0"], a["r0"], a["x0"], a["y0"],
                                 a["mv"][0], a["mv"][1], 16)
    p1 = tinterp.mc_luma14_multi(a["refs1"], a["r1"], a["x0"], a["y0"],
                                 a["mv"][2], a["mv"][3], 16)
    _card_eq(p0, tinterp.mc_luma14_multi_ref(a["refs0"], a["r0"], a["x0"],
                                             a["y0"], a["mv"][0],
                                             a["mv"][1], 16))
    l0 = ip.bi_average.launches
    _card_eq(tinterp.bi_average(p0, p1), tinterp.bi_average_ref(p0, p1))
    assert ip.bi_average.launches == l0 + 1
    for b in (1, 5):
        a = _card_inputs(b, b, 8, 544, 960)
        _card_eq(tinterp.mc_chroma_multi(a["refs1"], a["r1"], a["x0"],
                                         a["y0"], a["mv"][2], a["mv"][3], 8),
                 ip.mc_pred_ref(a["refs1"], a["r1"], a["x0"], a["y0"],
                                a["mv"][2], a["mv"][3], 8, luma=False))
