"""The full-RDOQ kernel (csrc/rdoq.cu) against its plain version.

`ops/rdoq_dev.rdoq_dev` launches the hand-written Hopper kernel for a
CUDA tensor and runs `rdoq_dev_ref` for a CPU tensor.  The CPU cases
check that routing, the wrapper's checks and the layout of the packed
tables the kernel reads.  The `cuda` cases hold the kernel to
`rdoq_dev_ref` on the same CUDA tensors, levels exactly and the rates
bit for bit, at every configuration the plain version is held to the JAX
package at (tests/test_torch_hevc_ops.py), at both slice types, with and
without the rate and the whole-block zero, and at the encoders' batch
sizes with all-zero blocks and blocks at the coefficient clamp.  They
skip where there is no card; on one:

    python -m pytest --noconftest -m cuda tests/test_torch_rdoq_kernel.py

This file imports no JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.ops import rdoq_dev as trdoq
from video_codecs_tpu_torch.ops import transform as ttr

torch.set_grad_enabled(False)

# (log2, luma, scan type): the configurations of
# tests/test_torch_hevc_ops.py::_RDOQ_CASES.
_CASES = [(log2, luma, st) for log2 in (2, 3) for luma in (True, False)
          for st in range(3)] + [(log2, luma, 0) for log2 in (4, 5)
                                 for luma in (True, False)]


def _blocks(seed: int, log2: int, b: int, amp: int = 70) -> torch.Tensor:
    """[b, n, n] int32 coefficients: the port's forward transform of
    seeded residuals, then an all-zero block, a block at the positive
    clamp and one alternating the two clamps."""
    n = 1 << log2
    rng = np.random.default_rng(seed)
    res = torch.from_numpy(rng.integers(-amp, amp + 1, (b, n, n),
                                        dtype=np.int32))
    co = ttr.forward_transform(res, log2).contiguous()
    co[0] = 0
    if b > 2:
        co[1] = 32767
        co[2, ::2] = -32768
        co[2, 1::2] = 32767
    return co


def _lam(qp: int) -> float:
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


def _assert_same(got, want, return_rate):
    if return_rate:
        (g, gb), (w, wb) = got, want
        assert gb.dtype == torch.float32 and gb.shape == wb.shape
        assert torch.equal(gb.cpu().view(torch.int32),
                           wb.cpu().view(torch.int32)), "rates differ"
    else:
        g, w = got, want
    assert g.dtype == torch.int32 and g.shape == w.shape
    assert (g - w).abs().max().item() == 0


# ---- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("log2,luma,st", [(2, False, 1), (3, True, 2),
                                          (4, True, 0), (5, False, 0)])
def test_cpu_tensor_runs_the_plain_version(monkeypatch, log2, luma, st):
    co = _blocks(10 + log2, log2, 3 if log2 == 5 else 6)
    calls = []
    ref = trdoq.rdoq_dev_ref

    def counted(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(trdoq, "rdoq_dev_ref", counted)
    monkeypatch.setattr(trdoq.rdoq_dev, "launches", 0)
    kw = dict(lam=_lam(30), scan_type=st, is_luma=luma, slice_type=0,
              return_rate=True)
    lv, bits = trdoq.rdoq_dev(co, 30, log2, **kw)
    want_lv, want_bits = ref(co, 30, log2, **kw)
    assert calls == [1]
    assert trdoq.rdoq_dev.launches == 0
    assert torch.equal(lv, want_lv)
    assert torch.equal(bits.view(torch.int32), want_bits.view(torch.int32))
    assert lv.device.type == "cpu" and bits.device.type == "cpu"


def test_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="not \\[B, 8, 8\\]"):
        trdoq.rdoq_dev(torch.zeros((2, 4, 4), dtype=torch.int32), 30, 3,
                       lam=_lam(30))
    with pytest.raises(ValueError, match="no kernel"):
        trdoq.rdoq_dev(torch.zeros((2, 4, 4), dtype=torch.int32,
                                   device="meta"), 30, 2, lam=_lam(30))


@pytest.mark.parametrize("log2,luma,st", [(2, True, 2), (3, False, 1),
                                          (5, True, 0)])
def test_kernel_tables_layout(log2, luma, st):
    """The packed int32 buffer holds `_tables_np`'s tables at the offsets
    csrc/rdoq.cu reads them from, and the rates of the last position."""
    tab, rate_last = trdoq._kernel_tables(30, log2, luma, 0, st,
                                          torch.device("cpu"))
    t = trdoq._tables_np(30, log2, luma, 0, st)
    nn, ncg = 1 << (2 * log2), 1 << (2 * log2 - 4)
    tab = tab.numpy()
    assert tab.dtype == np.int32
    offs = {}
    o = 0
    for k, size in (("scan", nn), ("sig_cg_tab", ncg * 128),
                    ("gt1_flat", 32), ("gt2_tab", 8), ("cg_bits", 4),
                    ("cg_rev", ncg), ("ngr_rev", ncg), ("ngb_rev", ncg)):
        offs[k] = o
        np.testing.assert_array_equal(tab[o:o + size],
                                      np.asarray(t[k]).ravel(), err_msg=k)
        o += size
    assert o == tab.size
    # the kernel's reads: sig bits of step s, pattern, position j
    s, pattern, j = ncg - 1, 3, 5
    assert tab[offs["sig_cg_tab"] + (s * 4 + pattern) * 32 + 2 * j + 1] == \
        t["sig_cg_tab"][s, pattern, j, 1]
    np.testing.assert_array_equal(rate_last.numpy(), t["rate_last"])
    assert rate_last.dtype == torch.float32


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_kernel_scalars_equal_quant_params(log2):
    """The float32 scalars the wrapper caches for the kernel are, bit for
    bit, the ones `_quant_params` and `rdoq_dev_ref` form as tensors."""
    def bits(v):
        return np.float32(v).view(np.int32).item()

    for qp in range(52):
        for lam in (_lam(qp), _lam(qp) * 0.85, 1.0):
            for bit_depth in (8, 10):
                q_bits, scale, lam_bits, es = trdoq._quant_params(
                    qp, log2, lam, bit_depth, "cpu")
                inv = 1.0 / (lam_bits * (1 << 15))
                got = trdoq._kernel_scalars(qp, log2, lam, bit_depth)
                assert got[:2] == (q_bits, scale)
                assert all(isinstance(v, float) for v in got[2:])
                for g, w in zip(got[2:], (lam_bits, es, inv)):
                    assert w.dtype == torch.float32
                    assert bits(g) == w.view(torch.int32).item()
                    assert np.float32(g).item() == g   # exactly a float32


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("slice_type", [0, 2])
@pytest.mark.parametrize("log2,luma,st", _CASES)
def test_kernel_matches_plain_on_card(log2, luma, st, slice_type):
    _need_card()
    qp = 32 if log2 % 2 else 27
    co = _blocks(90 + 8 * log2 + 2 * st + luma, log2,
                 24 if log2 < 5 else 8).cuda()
    for return_rate in (True, False):
        for allow_all_zero in (True, False):
            kw = dict(lam=_lam(qp), scan_type=st, is_luma=luma,
                      slice_type=slice_type, allow_all_zero=allow_all_zero,
                      return_rate=return_rate)
            n0 = trdoq.rdoq_dev.launches
            got = trdoq.rdoq_dev(co, qp, log2, **kw)
            torch.cuda.synchronize()
            assert trdoq.rdoq_dev.launches == n0 + 1
            _assert_same(got, trdoq.rdoq_dev_ref(co, qp, log2, **kw),
                         return_rate)


@pytest.mark.cuda
@pytest.mark.parametrize("b,log2,luma,slice_type,return_rate", [
    (1560, 4, True, 0, False),     # the LD-P P picture's TU16
    (1560, 3, False, 0, False),    # its chroma TU8
    (8040, 4, True, 0, True),      # the 1080p B picture's TU16
    (8040, 3, False, 0, True),     # its chroma TU8
    (2010, 5, True, 2, True),      # the 1080p IDR's TU32 trial
])
def test_kernel_at_path_batch_sizes(b, log2, luma, slice_type, return_rate):
    _need_card()
    co = _blocks(b + log2, log2, b, amp=40)
    co[3:b:97] = 0
    co[4:b:89] = 32767
    co = co.cuda()
    for qp in (22, 34):
        kw = dict(lam=_lam(qp), is_luma=luma, slice_type=slice_type,
                  return_rate=return_rate)
        got = trdoq.rdoq_dev(co, qp, log2, **kw)
        torch.cuda.synchronize()
        _assert_same(got, trdoq.rdoq_dev_ref(co, qp, log2, **kw),
                     return_rate)


@pytest.mark.cuda
def test_kernel_takes_strided_blocks():
    _need_card()
    co = _blocks(7, 3, 40).cuda()
    strided = co.transpose(1, 2)
    assert not strided.is_contiguous()
    got = trdoq.rdoq_dev(strided, 30, 3, lam=_lam(30), return_rate=True)
    _assert_same(got, trdoq.rdoq_dev_ref(strided.contiguous(), 30, 3,
                                         lam=_lam(30), return_rate=True),
                 True)


@pytest.mark.cuda
def test_cuda_call_never_reaches_the_plain_version(monkeypatch):
    _need_card()
    co = _blocks(3, 4, 16).cuda()
    want = trdoq.rdoq_dev_ref(co, 30, 4, lam=_lam(30))

    def refuse(*a, **kw):
        raise AssertionError("rdoq_dev_ref ran for a CUDA tensor")

    monkeypatch.setattr(trdoq, "rdoq_dev_ref", refuse)
    got = trdoq.rdoq_dev(co, 30, 4, lam=_lam(30))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="int32"):
        trdoq.rdoq_dev(co.long(), 30, 4, lam=_lam(30))
    with pytest.raises(TypeError, match="int32"):
        trdoq.rdoq_dev(co.float(), 30, 4, lam=_lam(30))
    empty = trdoq.rdoq_dev(co[:0], 30, 4, lam=_lam(30), return_rate=True)
    assert empty[0].shape == (0, 16, 16) and empty[1].shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("b,log2,luma,slice_type", [
    (1, 4, True, 0), (31, 3, False, 0), (33, 2, False, 0),
    (33, 5, True, 2), (8045, 4, True, 0)])
def test_kernel_ragged_batches(b, log2, luma, slice_type):
    """Batches that are not a multiple of a warp's 32 TUs: the lanes past
    the end read and write nothing."""
    _need_card()
    co = _blocks(b * 7 + log2, log2, b, amp=50).cuda()
    for qp in (27, 37):
        for return_rate in (True, False):
            kw = dict(lam=_lam(qp), is_luma=luma, slice_type=slice_type,
                      return_rate=return_rate)
            got = trdoq.rdoq_dev(co, qp, log2, **kw)
            torch.cuda.synchronize()
            _assert_same(got, trdoq.rdoq_dev_ref(co, qp, log2, **kw),
                         return_rate)


def _lockstep_batch(log2: int, st: int, seed: int) -> torch.Tensor:
    """A batch in which neighbouring TUs end their chains at different
    places: TU k of each group of NN + 3 has its last significant
    coefficient at scan position k (random coefficients before it, zeros
    after), interleaved with all-zero TUs and TUs at the clamps
    (+32,767; alternating -32,768 and +32,767)."""
    n = 1 << log2
    nn = n * n
    scan = trdoq._tables_np(30, log2, True, 0, st)["scan"]
    rng = np.random.default_rng(seed)
    blocks = []
    for last in range(nn):
        flat = np.zeros(nn, np.int32)
        flat[scan[:last]] = rng.integers(-600, 601, last)
        flat[scan[last]] = rng.choice([-1, 1]) * rng.integers(400, 2001)
        blocks.append(flat.reshape(n, n))
        k = len(blocks) % 3
        if k == 0:
            blocks.append(np.zeros((n, n), np.int32))
        elif k == 1:
            blocks.append(np.full((n, n), 32767, np.int32))
        else:
            clamp = np.full((n, n), 32767, np.int32)
            clamp[::2] = -32768
            blocks.append(clamp)
    return torch.from_numpy(np.stack(blocks))


@pytest.mark.cuda
@pytest.mark.parametrize("log2,st", [(2, 0), (2, 1), (3, 2), (4, 0), (5, 0)])
def test_kernel_lanes_end_their_chains_apart(log2, st):
    """Every possible last position, all-zero blocks and blocks at the
    clamps side by side in one warp."""
    _need_card()
    co = _lockstep_batch(log2, st, 300 + log2).cuda()
    for qp in (22, 32, 42):
        for slice_type in (0, 2):
            for allow_all_zero in (True, False):
                kw = dict(lam=_lam(qp), scan_type=st, slice_type=slice_type,
                          allow_all_zero=allow_all_zero, return_rate=True)
                got = trdoq.rdoq_dev(co, qp, log2, **kw)
                torch.cuda.synchronize()
                _assert_same(got, trdoq.rdoq_dev_ref(co, qp, log2, **kw),
                             True)


@pytest.mark.cuda
def test_kernel_tu32_idr_batch_with_rate():
    """The 1080p IDR's TU32 trial: B = 2,040, slice type 2, with the rate
    (the largest shared-memory opt-in)."""
    _need_card()
    co = _blocks(2040, 5, 2040, amp=60)
    co[5::37] = 0
    co = co.cuda()
    for qp in (27, 32):
        kw = dict(lam=_lam(qp), slice_type=2, return_rate=True)
        got = trdoq.rdoq_dev(co, qp, 5, **kw)
        torch.cuda.synchronize()
        _assert_same(got, trdoq.rdoq_dev_ref(co, qp, 5, **kw), True)
