"""HM's integer motion searches in the port (ops/me.py: TZSearch, the full
search at search range 64, `motion_search`'s "full" / "tz" / "auto" and
the B picture's `b_me_one`) against the JAX package's, on the CPU.

Seeded numpy planes go through the JAX function (jitted, as its engines
run it) and the port's counterpart on CPU tensors, where every SAD
surface comes from the kernel's plain version `sad_surface_ref`.  The
planes hold a global shift of up to 35 pixels, local motion on top of it
and flat blocks (ties), so every TZ stage (rings, raster, refinement)
decides something.  Tolerance 0: motion vectors and SATDs are integers.

The `cuda` cases hold the Hopper kernel against its plain version at the
search range 64 shapes and check that TZ and the full search launch it.
They run where JAX is not installed, so JAX is imported only inside the
tests that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_hevc_me.py
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.ops import me as tme
from video_codecs_tpu_torch.ops import sad_surface as tsad

torch.set_grad_enabled(False)


def T(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax():
    """(jax, jax.numpy, the JAX package's ops/me and inter_jax)."""
    jax = pytest.importorskip("jax")
    from video_codecs_tpu.models.hevc import inter_jax
    from video_codecs_tpu.ops import me
    return jax, jax.numpy, me, inter_jax


def _scene(seed, h, w, n, dx, dy):
    """(ref [h, w], cur blocks [B, n, n], x0, y0) int32: a smooth texture
    whose current picture is the reference shifted by (dx, dy) (so the
    match of a block lies at the vector (-dx, -dy)), with a
    block moved again by (3, -2), a flat block, and a block of noise."""
    rng = np.random.default_rng(seed)
    m = 48
    big = rng.integers(0, 256, (h + 2 * m, w + 2 * m)).astype(np.int32)
    for ax in (0, 1, 0, 1):
        big = (big + np.roll(big, 1, ax) + np.roll(big, 2, ax)) // 3
    ref = big[m:m + h, m:m + w]
    cur = big[m - dy:m - dy + h, m - dx:m - dx + w].copy()
    cur[n:2 * n, n:2 * n] = big[m - dy + n + 2:m - dy + 2 * n + 2,
                                m - dx + n - 3:m - dx + 2 * n - 3]
    cur[-n:, :n] = 128
    cur[:n, -n:] = rng.integers(0, 256, (n, n))
    x0 = np.tile(np.arange(w // n, dtype=np.int32) * n, h // n)
    y0 = np.repeat(np.arange(h // n, dtype=np.int32) * n, w // n)
    blocks = cur.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3) \
        .reshape(-1, n, n)
    return ref, blocks, x0, y0


def test_tz_points():
    _, _, jme, _ = _jax()
    for r, count in ((8, 29), (64, 53), (12, 29), (1, 5)):
        got, want = tme._tz_points(r), jme._tz_points(r)
        assert len(got[0]) == count
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            _eq(a, b)


@pytest.mark.parametrize("r,n,h,w,shift", [
    (8, 16, 64, 96, (-5, 3)),
    (16, 16, 64, 96, (13, -9)),
    (16, 8, 48, 64, (-11, 7)),
    (64, 16, 64, 64, (-20, 13)),
    (64, 8, 32, 32, (-9, 6))])
def test_tz_search(r, n, h, w, shift):
    """The surface route against the reference's gathers; r = 64 at
    B = 16 blocks."""
    jax, jnp, jme, _ = _jax()
    ref, cur, x0, y0 = _scene(r + n, h, w, n, *shift)
    assert r < 64 or len(cur) <= 16
    before = tsad.sad_surface.launches
    got = tme.tz_search(T(ref), T(cur), T(x0), T(y0), n, r)
    assert tsad.sad_surface.launches == before        # plain path on CPU
    want = jax.jit(jme.tz_search, static_argnums=(4, 5))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, n, r)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        _eq(a, b)
    assert (got[0] != 0).any() and (got[1] != 0).any()


def test_tz_search_reads_the_plain_gather():
    """The values the TZ stages read out of the surface are the plain
    gather's `_sad_at_points` at the same candidates (stage 1's rings and
    stage 2's raster at r = 64)."""
    ref, cur, x0, y0 = _scene(7, 32, 32, 16, 30, -17)
    r, n = 64, 16
    span = 2 * r + 1
    win = tme.gather_window(T(ref), T(x0) - r, T(y0) - r, n + 2 * r,
                            n + 2 * r)
    surf = tsad.sad_surface(tme._u8(T(cur)), tme._u8(win), n, r)
    grid = np.arange(-r, r + 1, 5, dtype=np.int32)
    gx, gy = np.meshgrid(grid, grid, indexing="xy")
    for pts in (tme._tz_points(r)[0],
                np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)):
        flat = surf.reshape(-1, span * span)[
            :, torch.from_numpy((pts[:, 1] + r) * span + pts[:, 0] + r)
            .long()]
        _eq(flat, tme._sad_at_points(win, T(cur), pts, r, n))


@pytest.mark.parametrize("n", [16, 8])
def test_integer_search_r64(n):
    jax, jnp, jme, _ = _jax()
    ref, cur, x0, y0 = _scene(64 + n, 32, 64, 16, -21, 35)
    if n == 8:
        cur = cur.reshape(-1, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4) \
            .reshape(-1, 8, 8)[:16]
        x0 = (np.repeat(x0, 4) + np.tile([0, 8, 0, 8], len(x0)))[:16]
        y0 = (np.repeat(y0, 4) + np.tile([0, 0, 8, 8], len(y0)))[:16]
    got = tme.integer_search(T(ref), T(cur), T(x0), T(y0), n, 64)
    want = jax.jit(jme.integer_search, static_argnums=(4, 5))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, n, 64)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("method,sr", [("full", 8), ("tz", 16), ("tz", 64),
                                       ("auto", 12), ("auto", 13),
                                       ("full", 64)])
def test_motion_search(method, sr):
    """Integer search + the two SATD refinements; "auto" on both sides of
    its switch (full at 12, TZ at 13)."""
    jax, jnp, jme, _ = _jax()
    h, w = (32, 64) if sr == 64 else (64, 96)
    ref, cur, x0, y0 = _scene(sr, h, w, 16, 9, -6)
    got = tme.motion_search(T(ref), T(cur), T(x0), T(y0), 16, sr, method)
    want = jax.jit(jme.motion_search, static_argnums=(4, 5, 6))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, 16, sr, method)
    for a, b in zip(got, want):
        _eq(a, b)
    auto = "full" if sr <= 12 else "tz"
    if method == "auto":
        same = tme.motion_search(T(ref), T(cur), T(x0), T(y0), 16, sr, auto)
        for a, b in zip(got, same):
            _eq(a, b)


@pytest.mark.parametrize("n", [16, 8])
def test_b_me_one_tz(n):
    """The RA engine's per-list search with TZ at search range 64 (n = 8:
    the CU8 tree's blocks)."""
    jax, jnp, _, jinter = _jax()
    h, w = (32, 64) if n == 16 else (32, 32)
    ref, cur, x0, y0 = _scene(100 + n, h, w, n, -33, 18)
    got = tinter.b_me_one(T(ref), T(cur), T(x0), T(y0), 64, "tz", n=n)
    want = jax.jit(jinter.b_me_one, static_argnums=(4, 5, 6))(
        jnp.asarray(ref), jnp.asarray(cur), x0, y0, 64, "tz", n)
    for a, b in zip(got, want):
        _eq(a, b)


def test_encoders_take_hm_searches():
    from video_codecs_tpu_torch.models.hevc import headers, inter_qt
    for m in ("full", "tz", "auto", "pyr"):
        cfg = headers.HevcConfig(width=64, height=64, qp=32)
        assert tinter.DeviceLowDelayEncoder(
            cfg, me_method=m, device="cpu").me_method == m
        cfg = headers.HevcConfig(width=64, height=64, qp=32, log2_ctb=5,
                                 log2_min_cb=3, log2_max_tb=5)
        assert inter_qt.QtDeviceRandomAccessEncoder(
            cfg, me_method=m, device="cpu").me_method == m
    with pytest.raises(ValueError):
        tinter.DeviceLowDelayEncoder(
            headers.HevcConfig(width=64, height=64, qp=32), me_method="hex",
            device="cpu")


# ---- on the card -----------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(16, 1560), (8, 333), (16, 1)])
def test_sad_kernel_r64_on_card(n, b):
    """The kernel at search range 64: a 129 x 129 surface per block
    (66.6 KB of shared memory beside the window), 715 tiles of 2 x 12
    displacements over 256 threads."""
    _needs_card()
    rng = np.random.default_rng(n * 64 + b)
    cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                        dtype=np.uint8)).cuda()
    win = torch.from_numpy(rng.integers(0, 256, (b, n + 128, n + 128),
                                        dtype=np.uint8)).cuda()
    before = tsad.sad_surface.launches
    got = tsad.sad_surface(cur, win, n, 64)
    torch.cuda.synchronize()
    assert tsad.sad_surface.launches == before + 1
    assert (got - tsad.sad_surface_ref(cur, win, n, 64)).abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("method,n", [("tz", 16), ("tz", 8), ("full", 16)])
def test_searches_launch_the_kernel_on_card(method, n):
    """TZ and the full search take one surface from the kernel per call,
    and return what the same call returns on the CPU."""
    _needs_card()
    ref, cur, x0, y0 = _scene(5, 96, 128, n, 27, -14)
    args = [T(a) for a in (ref, cur, x0, y0)]
    before = tsad.sad_surface.launches
    got = tme.motion_search(*(a.cuda() for a in args), n, 64, method)
    torch.cuda.synchronize()
    assert tsad.sad_surface.launches == before + 1
    want = tme.motion_search(*args, n, 64, method)
    assert tsad.sad_surface.launches == before + 1
    for a, b in zip(got, want):
        _eq(a.cpu(), b)
