"""The HEVC inter-prediction device stages as hand-written Hopper kernels.

Three entries, each the plain version for CPU tensors and one launch of a
kernel of csrc/inter_pred.cu for CUDA tensors (there is no other path: a
CUDA tensor launches or raises):

  `mc_pred`          per-block motion compensation from reference stacks
                     [R, H, W] picked by a per-block index: the 14-bit
                     hypothesis, or the 8-bit prediction, uni or combined
                     by the block's direction, or only that prediction's
                     8x8 SATD against the originals (`mc_pred_kernel`; the
                     reference's video_codecs_tpu/ops/interp.py:103-170
                     and the combiners of inter_jax.py / inter_qt.py);
                     plain version `mc_pred_ref`;
  `refine_qpel`      the two quarter-pel SATD refinement rounds of
                     `me._refine` (ops/me.py:253), step 2 then step 1
                     (`qpel_refine_kernel`); plain version
                     `refine_qpel_ref`;
  `bi_refine_pass`   the alternating bi refinement pass of
                     inter_jax.py:586-616 (`bi_refine_kernel`); plain
                     version `bi_refine_pass_ref`.

`bi_average` is `interp.bi_average`'s CUDA branch: the same combine on two
given 14-bit planes (`mc_average_kernel`).  Each kernel's launches count
in `<entry>.launches` (`bi_average.launches` for the combine alone).

The kernels take int32 (the callers' dtype) and the block sizes of the
paths: `mc_pred` luma n = 8, 16, 32 and chroma n = 4, 8, 16,
`refine_qpel` n = 8, 16, `bi_refine_pass` n = 16.  Reference indices must
lie inside their stacks:
the kernel does not check them (a check would read them back to the
host).  The filter tables and `me._OFFS8` reach the kernels from the
port's own copies as one int32 buffer (`tables_np`).  The source is built
with nvcc at first use into build/torch_kernels/ as the other kernels are
(`sad_surface.build_library`: a plain-C shared library loaded with
ctypes, keyed by the source's hash).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops.sad_surface import (build_library,
                                                    launch_stream)
from video_codecs_tpu_torch.utils.device import const

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "inter_pred.cu"
_LIB = None

# Offsets of the int32 table buffer, as csrc/inter_pred.cu's kTab*.
TAB_LUMA = 0
TAB_CHROMA = TAB_LUMA + 32
TAB_OFFS = TAB_CHROMA + 32
TAB_SIZE = TAB_OFFS + 16

# Block sizes each kernel is instantiated for.
MC_SIZES = {True: (8, 16, 32), False: (4, 8, 16)}
REFINE_SIZES = (8, 16)
BI_SIZES = (16,)


def build() -> tuple[Path, float, str]:
    """Compile csrc/inter_pred.cu (`sad_surface.build_library`)."""
    return build_library(_SRC, "vct_inter_pred")


def _load() -> ctypes.CDLL:
    """The built library, with its entry points' C signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vct_mc_pred.argtypes = [p, p, i, i] + [p] * 9 + [i] * 6 + [
            p] * 5
        lib.vct_mc_average.argtypes = [p, p, p, ctypes.c_longlong, p]
        lib.vct_qpel_refine.argtypes = [p, i, i] + [p] * 8 + [i, i, p, p]
        lib.vct_bi_refine.argtypes = [p, p, i, i] + [p] * 14 + [i, i, p, p]
        for fn in (lib.vct_mc_pred, lib.vct_mc_average, lib.vct_qpel_refine,
                   lib.vct_bi_refine):
            fn.restype = i
        _LIB = lib
    return _LIB


def tables_np() -> np.ndarray:
    """The kernels' int32 table buffer: `interp.LUMA_FILTERS` (4 x 8),
    `interp.CHROMA_FILTERS` (8 x 4) and `me._OFFS8` (8 x (dx, dy))."""
    from video_codecs_tpu_torch.ops import me
    # qpel_refine_kernel files a candidate under column dx + 1 of three
    assert np.abs(me._OFFS8).max() <= 1
    out = np.concatenate([interp.LUMA_FILTERS.ravel(),
                          interp.CHROMA_FILTERS.ravel(),
                          me._OFFS8.ravel()]).astype(np.int32)
    assert out.size == TAB_SIZE
    return out


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"inter_pred kernel: no kernel for {t.device}")
    return t.device


def _i32(t: torch.Tensor, dev: torch.device, shape: tuple,
         name: str) -> torch.Tensor:
    """t as a contiguous int32 tensor on `dev` of `shape`, or raise."""
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"inter_pred: {name} must be a tensor on {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"inter_pred: {name} {tuple(t.shape)}, want {shape}")
    return t.int().contiguous()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def _tab(dev: torch.device) -> torch.Tensor:
    return const(tables_np(), dev)


def _uni(q14: torch.Tensor) -> torch.Tensor:
    return ((q14 + 32) >> 6).clamp(0, 255)


# ---- mc_pred ---------------------------------------------------------------

def mc_pred_ref(refs0, ridx0, x0, y0, mv0x, mv0y, n: int, *,
                luma: bool = True, out14: bool = False, l1=None, dirs=3,
                cur=None):
    """The plain version of `mc_pred`: the reference's multi-reference MC
    (`interp.mc_luma14_multi_ref` / `mc_chroma14_multi_ref`), its combine
    as `mrg_pred` / `final_pred` / `pred8` / `_pred_cand` write it
    (inter_jax.py:660, :814, :1004; inter_qt.py:83), and
    `cost.hadamard_satd_8x8`."""
    mc14 = (interp.mc_luma14_multi_ref if luma
            else interp.mc_chroma14_multi_ref)
    q0 = mc14(refs0, ridx0, x0, y0, mv0x, mv0y, n)
    if out14:
        pred = q0
    elif l1 is None:
        pred = _uni(q0).int()
    else:
        refs1, ridx1, mv1x, mv1y = l1
        q1 = mc14(refs1, ridx1, x0, y0, mv1x, mv1y, n)
        if not isinstance(dirs, torch.Tensor):
            dirs = torch.full((q0.shape[0],), int(dirs), dtype=torch.int32,
                              device=q0.device)
        pred = torch.where(
            (dirs == 3)[:, None, None], interp.bi_average_ref(q0, q1),
            torch.where((dirs == 1)[:, None, None], _uni(q0),
                        _uni(q1))).int()
    if cur is None:
        return pred
    return cost_ops.hadamard_satd_8x8(cur, pred)


def mc_pred(refs0, ridx0, x0, y0, mv0x, mv0y, n: int, *, luma: bool = True,
            out14: bool = False, l1=None, dirs=3, cur=None):
    """Motion compensation of B blocks of n x n at (x0, y0) [B] from the
    reference stack refs0 [R0, H, W] (plane ridx0 [B], quarter-pel luma MV
    (mv0x, mv0y) [B]; chroma reads it as eighth-pel in its own samples):

      out14          the 14-bit hypothesis [B, n, n] (`mc_*14_multi`);
      l1 None        the uni prediction (p + 32) >> 6, clipped;
      l1 = (refs1, ridx1, mv1x, mv1y)
                     by dirs ([B] or one int): 3 `bi_average` of both
                     hypotheses, 1 uni list 0, anything else uni list 1.

    With cur [B, n, n] (n a multiple of 8) returns only the 8x8 Hadamard
    SATD of pred against cur [B], the merge loops' cost (the kernel then
    stores no prediction); otherwise pred (int32).  CUDA tensors: one
    launch of `mc_pred_kernel`, counted in `mc_pred.launches`."""
    if refs0.device.type == "cpu":
        return mc_pred_ref(refs0, ridx0, x0, y0, mv0x, mv0y, n, luma=luma,
                           out14=out14, l1=l1, dirs=dirs, cur=cur)
    return _mc_pred_cuda(refs0, ridx0, x0, y0, mv0x, mv0y, n, luma=luma,
                         out14=out14, l1=l1, dirs=dirs, cur=cur)


def _mc_pred_cuda(refs0, ridx0, x0, y0, mv0x, mv0y, n: int, *, luma: bool,
                  out14: bool, l1, dirs, cur):
    dev = _device(refs0)
    if n not in MC_SIZES[bool(luma)]:
        raise ValueError(f"mc_pred kernel: {'luma' if luma else 'chroma'} "
                         f"n in {MC_SIZES[bool(luma)]}, got {n}")
    if out14 and (l1 is not None or cur is not None):
        raise ValueError("mc_pred: out14 is one hypothesis, without l1 or "
                         "cur")
    if cur is not None and n % 8:
        raise ValueError(f"mc_pred: the SATD needs n a multiple of 8, got {n}")
    if refs0.dim() != 3:
        raise ValueError(f"mc_pred: refs0 {tuple(refs0.shape)} is not "
                         "[R, H, W]")
    hh, ww = refs0.shape[1:]
    b = x0.shape[0]
    blk = (b,)
    r0 = _i32(refs0, dev, tuple(refs0.shape), "refs0")
    ins = [_i32(t, dev, blk, k) for t, k in ((x0, "x0"), (y0, "y0"),
                                              (ridx0, "ridx0"),
                                              (mv0x, "mv0x"), (mv0y, "mv0y"))]
    r1 = l1_args = None
    dir_t, dir_const = None, 0
    if l1 is not None:
        refs1, ridx1, mv1x, mv1y = l1
        if refs1.dim() != 3 or tuple(refs1.shape[1:]) != (hh, ww):
            raise ValueError(f"mc_pred: refs1 {tuple(refs1.shape)} against "
                             f"refs0 {tuple(refs0.shape)}")
        r1 = _i32(refs1, dev, tuple(refs1.shape), "refs1")
        l1_args = [_i32(t, dev, blk, k) for t, k in ((ridx1, "ridx1"),
                                                      (mv1x, "mv1x"),
                                                      (mv1y, "mv1y"))]
        if isinstance(dirs, torch.Tensor):
            dir_t = _i32(dirs, dev, blk, "dirs")
        else:
            dir_const = int(dirs)
    cur_t = None if cur is None else _i32(cur, dev, (b, n, n), "cur")
    if cur is None:
        out, satd = torch.empty((b, n, n), dtype=torch.int32, device=dev), None
    else:
        out, satd = None, torch.empty(b, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _check(_load().vct_mc_pred(
        r0.data_ptr(), ptr(r1), hh, ww, *(t.data_ptr() for t in ins),
        *(ptr(t) for t in (l1_args or [None] * 3)), ptr(dir_t), dir_const,
        int(l1 is not None), int(bool(out14)), b, n, int(bool(luma)),
        ptr(cur_t), ptr(out), ptr(satd), _tab(dev).data_ptr(),
        launch_stream(dev)), "mc_pred")
    mc_pred.launches += 1
    return out if cur is None else satd


mc_pred.launches = 0


def bi_average(p0_14: torch.Tensor, p1_14: torch.Tensor) -> torch.Tensor:
    """`interp.bi_average` on CUDA tensors: (p0 + p1 + 64) >> 7 clipped to
    8 bits, one launch of `mc_average_kernel`, counted in
    `bi_average.launches`."""
    dev = _device(p0_14)
    p0 = _i32(p0_14, dev, tuple(p0_14.shape), "p0_14")
    p1 = _i32(p1_14, dev, tuple(p0_14.shape), "p1_14")
    out = torch.empty(p0.shape, dtype=torch.int32, device=dev)
    _check(_load().vct_mc_average(p0.data_ptr(), p1.data_ptr(),
                                  out.data_ptr(), p0.numel(),
                                  launch_stream(dev)), "bi_average")
    bi_average.launches += 1
    return out


bi_average.launches = 0


# ---- refine_qpel -----------------------------------------------------------

def refine_qpel_ref(ref, cur, x0, y0, mvx, mvy, n: int):
    """The plain version of `refine_qpel`: `me._refine` at step 2, then at
    step 1 (ops/me.py:296-297)."""
    from video_codecs_tpu_torch.ops import me
    mvx, mvy, _ = me._refine(ref, cur, x0, y0, mvx, mvy, n, 2)
    return me._refine(ref, cur, x0, y0, mvx, mvy, n, 1)


def refine_qpel(ref, cur, x0, y0, mvx, mvy, n: int):
    """The half- and quarter-pel SATD refinement of B blocks: ref [H, W],
    cur [B, n, n], block origins (x0, y0) and quarter-pel MVs (mvx, mvy)
    [B] -> the refined (mvx, mvy) and the last round's SATD, each [B]
    int32.  CUDA tensors: one launch of `qpel_refine_kernel` for both
    rounds, counted in `refine_qpel.launches`."""
    if ref.device.type == "cpu":
        return refine_qpel_ref(ref, cur, x0, y0, mvx, mvy, n)
    return _refine_qpel_cuda(ref, cur, x0, y0, mvx, mvy, n)


def _refine_qpel_cuda(ref, cur, x0, y0, mvx, mvy, n: int):
    dev = _device(ref)
    if n not in REFINE_SIZES:
        raise ValueError(f"refine_qpel kernel: n in {REFINE_SIZES}, got {n}")
    if ref.dim() != 2:
        raise ValueError(f"refine_qpel: ref {tuple(ref.shape)} is not [H, W]")
    b = cur.shape[0]
    ref_t = _i32(ref, dev, tuple(ref.shape), "ref")
    cur_t = _i32(cur, dev, (b, n, n), "cur")
    ins = [_i32(t, dev, (b,), k) for t, k in ((x0, "x0"), (y0, "y0"),
                                               (mvx, "mvx"), (mvy, "mvy"))]
    outs = torch.empty((3, b), dtype=torch.int32, device=dev)
    _check(_load().vct_qpel_refine(
        ref_t.data_ptr(), ref.shape[0], ref.shape[1], cur_t.data_ptr(),
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), b, n,
        _tab(dev).data_ptr(), launch_stream(dev)), "refine_qpel")
    refine_qpel.launches += 1
    return outs[0], outs[1], outs[2]


refine_qpel.launches = 0


# ---- bi_refine_pass --------------------------------------------------------

def _bi_refine_ref(cur, fix14, refs_l, ridx_l, x0, y0, mvx, mvy, n):
    """One list's refinement against the fixed hypothesis fix14, as
    inter_jax.py:591-606 writes it: each of `_OFFS8` from the running
    best MV, kept where the SATD of the bi average is strictly lower."""
    from video_codecs_tpu_torch.ops import me
    best = cost_ops.hadamard_satd_8x8(
        cur, interp.bi_average_ref(
            fix14, interp.mc_luma14_multi_ref(refs_l, ridx_l, x0, y0, mvx,
                                              mvy, n)))
    for k in range(8):
        cx_ = mvx + int(me._OFFS8[k][0])
        cy_ = mvy + int(me._OFFS8[k][1])
        satd = cost_ops.hadamard_satd_8x8(
            cur, interp.bi_average_ref(
                fix14, interp.mc_luma14_multi_ref(refs_l, ridx_l, x0, y0,
                                                  cx_, cy_, n)))
        better = satd < best
        best = torch.where(better, satd, best)
        mvx = torch.where(better, cx_, mvx)
        mvy = torch.where(better, cy_, mvy)
    return mvx, mvy, best


def bi_refine_pass_ref(refs0, refs1, ridx0, ridx1, cur, x0, y0, mv0x, mv0y,
                       mv1x, mv1y, n: int):
    """The plain version of `bi_refine_pass`: the eager composition of
    inter_jax.py:586-616."""
    p0_14 = interp.mc_luma14_multi_ref(refs0, ridx0, x0, y0, mv0x, mv0y, n)
    b1x, b1y, _ = _bi_refine_ref(cur, p0_14, refs1, ridx1, x0, y0, mv1x,
                                 mv1y, n)
    p1r_14 = interp.mc_luma14_multi_ref(refs1, ridx1, x0, y0, b1x, b1y, n)
    b0x, b0y, satd_bi = _bi_refine_ref(cur, p1r_14, refs0, ridx0, x0, y0,
                                       mv0x, mv0y, n)
    return b0x, b0y, b1x, b1y, satd_bi


def bi_refine_pass(refs0, refs1, ridx0, ridx1, cur, x0, y0, mv0x, mv0y,
                   mv1x, mv1y, n: int):
    """The one alternating bi refinement pass of a B picture's blocks
    (TEncSearch.cpp:3567 collapsed to one pass): list 0's 14-bit
    hypothesis at (mv0x, mv0y) from refs0 [R0, H, W] plane ridx0, list 1
    refined against it from (mv1x, mv1y), list 1's winner's hypothesis,
    list 0 refined against that.  Returns (b0x, b0y, b1x, b1y, the last
    refinement's SATD), each [B] int32.  CUDA tensors: one launch of
    `bi_refine_kernel`, counted in `bi_refine_pass.launches`."""
    if refs0.device.type == "cpu":
        return bi_refine_pass_ref(refs0, refs1, ridx0, ridx1, cur, x0, y0,
                                  mv0x, mv0y, mv1x, mv1y, n)
    return _bi_refine_pass_cuda(refs0, refs1, ridx0, ridx1, cur, x0, y0,
                                mv0x, mv0y, mv1x, mv1y, n)


def _bi_refine_pass_cuda(refs0, refs1, ridx0, ridx1, cur, x0, y0, mv0x,
                         mv0y, mv1x, mv1y, n: int):
    dev = _device(refs0)
    if n not in BI_SIZES:
        raise ValueError(f"bi_refine_pass kernel: n in {BI_SIZES}, got {n}")
    if refs0.dim() != 3 or refs1.dim() != 3 or \
            refs0.shape[1:] != refs1.shape[1:]:
        raise ValueError(f"bi_refine_pass: refs {tuple(refs0.shape)} / "
                         f"{tuple(refs1.shape)} are not [R, H, W] stacks of "
                         "one size")
    hh, ww = refs0.shape[1:]
    b = cur.shape[0]
    r0 = _i32(refs0, dev, tuple(refs0.shape), "refs0")
    r1 = _i32(refs1, dev, tuple(refs1.shape), "refs1")
    cur_t = _i32(cur, dev, (b, n, n), "cur")
    ins = [_i32(t, dev, (b,), k) for t, k in (
        (x0, "x0"), (y0, "y0"), (ridx0, "ridx0"), (ridx1, "ridx1"),
        (mv0x, "mv0x"), (mv0y, "mv0y"), (mv1x, "mv1x"), (mv1y, "mv1y"))]
    outs = torch.empty((5, b), dtype=torch.int32, device=dev)
    _check(_load().vct_bi_refine(
        r0.data_ptr(), r1.data_ptr(), hh, ww, cur_t.data_ptr(),
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), b, n,
        _tab(dev).data_ptr(), launch_stream(dev)), "bi_refine_pass")
    bi_refine_pass.launches += 1
    return tuple(outs)


bi_refine_pass.launches = 0
