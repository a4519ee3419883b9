"""SAD surface of the PyTorch port (video_codecs_tpu_torch.ops.sad_surface)
against the Pallas kernel it replaces, run in interpret mode as
tests/test_pallas.py runs it.  Tolerance 0: integer surfaces.

The `cuda` cases hold the Hopper kernel against the plain version on the
card and skip where there is none.  They must also run where JAX is not
installed, so JAX is imported only inside the test that needs it, and
the repo's conftest (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_sad.py
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.ops import sad_surface as ss


def _inputs(seed, b, n, r, dtype=np.int32):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (b, n, n)).astype(dtype)
    win = rng.integers(0, 256, (b, n + 2 * r, n + 2 * r)).astype(dtype)
    return cur, win


@pytest.mark.parametrize("n,r", [(16, 8), (8, 16), (8, 8), (16, 16),
                                 (16, 32), (4, 16), (2, 16), (16, 3)])
def test_sad_ref_matches_pallas_interpret(n, r):
    jnp = pytest.importorskip("jax.numpy")
    from video_codecs_tpu.ops import pallas_sad
    cur, win = _inputs(n * 100 + r, 3, n, r)
    want = np.asarray(pallas_sad.sad_surface(
        jnp.asarray(cur), jnp.asarray(win), n, r, interpret=True))
    got = ss.sad_surface_ref(torch.from_numpy(cur), torch.from_numpy(win),
                             n, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's dtype: the same surface from the 8-bit samples
    got8 = ss.sad_surface_ref(torch.from_numpy(cur.astype(np.uint8)),
                              torch.from_numpy(win.astype(np.uint8)), n, r)
    assert got8.dtype == torch.int32
    np.testing.assert_array_equal(got8.numpy(), want)


@pytest.mark.parametrize("n,r", [(8, 4), (16, 16)])
def test_sad_surface_cpu_takes_uint8_and_int32(n, r):
    cur, win = _inputs(5, 4, n, r, np.uint8)
    c8, w8 = torch.from_numpy(cur), torch.from_numpy(win)
    np.testing.assert_array_equal(
        ss.sad_surface(c8, w8, n, r).numpy(),
        ss.sad_surface(c8.int(), w8.int(), n, r).numpy())


def test_sad_surface_cpu_runs_plain_version_in_chunks(monkeypatch):
    cur, win = _inputs(7, 5, 8, 4, np.uint8)
    c, w = torch.from_numpy(cur), torch.from_numpy(win)
    before = ss.sad_surface.launches
    whole = ss.sad_surface(c, w, 8, 4)
    assert ss.sad_surface.launches == before      # no kernel on the CPU
    # one block per chunk gives the same surface
    monkeypatch.setattr(ss, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(ss.sad_surface_ref(c, w, 8, 4).numpy(),
                                  whole.numpy())
    want = np.abs(win[:, 3:11, 5:13].astype(np.int32) - cur).sum((1, 2))
    np.testing.assert_array_equal(whole[:, 3, 5].numpy(), want)


def test_sad_surface_rejects_mismatched_shapes():
    cur, win = _inputs(8, 2, 8, 4, np.uint8)
    with pytest.raises(ValueError):
        ss.sad_surface(torch.from_numpy(cur), torch.from_numpy(win), 8, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(16, 8), (8, 16), (16, 16), (16, 32),
                                 (8, 8), (8, 5), (16, 3), (8, 3), (4, 16),
                                 (4, 3), (2, 16), (2, 5)])
@pytest.mark.parametrize("b", [97, 37, 1])
def test_sad_kernel_matches_plain_on_card(n, r, b):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    cur, win = _inputs(n * 1000 + r + b, b, n, r, np.uint8)
    c = torch.from_numpy(cur).cuda()
    w = torch.from_numpy(win).cuda()
    before = ss.sad_surface.launches
    got = ss.sad_surface(c, w, n, r)
    torch.cuda.synchronize()
    assert ss.sad_surface.launches == before + 1
    err = (got - ss.sad_surface_ref(c, w, n, r)).abs().max().item()
    assert err == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(4, 16), (16, 3)])
def test_sad_kernel_at_ldp_shapes(n, r):
    """The LD-P pyramid's surfaces at 832x480: B = 52 x 30 blocks, the
    4x4-pooled stage (n=4, r=16) and the +-3 full-resolution windows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    cur, win = _inputs(1560 + n + r, 1560, n, r, np.uint8)
    c = torch.from_numpy(cur).cuda()
    w = torch.from_numpy(win).cuda()
    got = ss.sad_surface(c, w, n, r)
    torch.cuda.synchronize()
    assert (got - ss.sad_surface_ref(c, w, n, r)).abs().max().item() == 0


@pytest.mark.cuda
def test_sad_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    cur, win = _inputs(9, 4, 8, 4)
    with pytest.raises(TypeError):          # int32: no silent conversion
        ss.sad_surface(torch.from_numpy(cur).cuda(),
                       torch.from_numpy(win).cuda(), 8, 4)
    cur, win = _inputs(9, 4, 12, 4, np.uint8)
    with pytest.raises(ValueError):         # n = 12: no instantiation
        ss.sad_surface(torch.from_numpy(cur).cuda(),
                       torch.from_numpy(win).cuda(), 12, 4)
    cur, win = _inputs(9, 2, 16, 200, np.uint8)
    with pytest.raises(RuntimeError):       # 416x416 window: no CTA holds it
        ss.sad_surface(torch.from_numpy(cur).cuda(),
                       torch.from_numpy(win).cuda(), 16, 200)
