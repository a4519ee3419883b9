"""Sample Adaptive Offset: statistics, decision, application (spec 8.7.3).

Counterpart of video_codecs_tpu/ops/sao.py, whole.  The numpy functions
(`eo_category_map`, `ctu_stats`, `decide_ctu`, the decisions from
statistics, `apply_frame`, `apply_ctu`) are the port's copies, each
keeping its name and a comment giving the original's line; the decisions
stay Python float64 as in the reference.  `apply_ctus` is the port's:
`apply_ctu` over every CTB of a plane with each EO class's category map
computed once (the general decoder's SAO apply).

The reference's device statistics `sao_stats_dev` become two functions:
`sao_stats_ref`, the plain PyTorch version (a translation of the JAX
body), and `sao_stats`, which launches the hand-written Hopper kernel
csrc/sao_stats.cu for a CUDA tensor and runs `sao_stats_ref` for a CPU
tensor.  There is no other path: a CUDA tensor goes through the kernel
or raises.  The kernel is built with nvcc at first use into
build/torch_kernels/ as ops/sad_surface.py builds its own (a plain-C
shared library loaded with ctypes, keyed by the source's hash).
Every sum is of integer differences below 2^24 in magnitude, so the
float32 sums are exact in any order and all three versions agree bit for
bit.

Parity references: hm-16.5rc1/source/Lib/TLibCommon/
TComSampleAdaptiveOffset.cpp — offsetBlock :313 (EO 4 classes + BO apply),
TLibEncoder/TEncSampleAdaptiveOffset.cpp — getStatistics :285 (per-CTU
per-class diff sums), decideBlkParams / deriveModeNewRDO :566.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from video_codecs_tpu_torch.ops.sad_surface import (build_library,
                                                    launch_stream)

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2

# EO class -> (neighbor offset a, neighbor offset b) as (dy, dx)
EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),     # horizontal
    1: ((-1, 0), (1, 0)),     # vertical
    2: ((-1, -1), (1, 1)),    # 135 degrees
    3: ((-1, 1), (1, -1)),    # 45 degrees
}

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "sao_stats.cu"
# CTB sizes the kernel is instantiated for: the CTB32 quadtree's luma and
# its chroma 16, the flat CTB16 engines' luma 16 and their chroma 8.
KERNEL_CTBS = (8, 16, 32)

_LIB = None


# video_codecs_tpu/ops/sao.py:30
@dataclasses.dataclass
class SaoParam:
    """Per-CTU per-component SAO parameters."""
    type_idx: int = SAO_OFF
    eo_class: int = 0
    band_position: int = 0
    offsets: tuple[int, int, int, int] = (0, 0, 0, 0)

    # video_codecs_tpu/ops/sao.py:38
    def key(self):
        return (self.type_idx, self.eo_class, self.band_position,
                self.offsets)


# video_codecs_tpu/ops/sao.py:43
def eo_category_map(rec: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-sample EO category 0..4 (0 = no offset / invalid border)."""
    h, w = rec.shape
    (ady, adx), (bdy, bdx) = EO_NEIGHBORS[eo_class]
    cat = np.zeros((h, w), np.int32)
    ys = slice(max(0, -ady, -bdy), h - max(0, ady, bdy))
    xs = slice(max(0, -adx, -bdx), w - max(0, adx, bdx))
    c = rec[ys, xs].astype(np.int32)
    a = rec[ys.start + ady:ys.stop + ady, xs.start + adx:xs.stop + adx]
    b = rec[ys.start + bdy:ys.stop + bdy, xs.start + bdx:xs.stop + bdx]
    s = np.sign(c - a) + np.sign(c - b)
    # spec edgeIdx mapping: -2 -> cat1, -1 -> cat2, 1 -> cat3, 2 -> cat4
    m = np.zeros_like(s)
    m[s == -2] = 1
    m[s == -1] = 2
    m[s == 1] = 3
    m[s == 2] = 4
    cat[ys, xs] = m
    return cat


# video_codecs_tpu/ops/sao.py:64
def ctu_stats(orig: np.ndarray, rec: np.ndarray, x0: int, y0: int,
              size: int, eo_class: int):
    """(count[5], diff_sum[5]) for one CTU region and EO class."""
    cat = eo_category_map(rec, eo_class)[y0:y0 + size, x0:x0 + size]
    diff = (orig.astype(np.int64) - rec)[y0:y0 + size, x0:x0 + size]
    count = np.bincount(cat.reshape(-1), minlength=5)
    sums = np.bincount(cat.reshape(-1), weights=diff.reshape(-1), minlength=5)
    return count, sums


# video_codecs_tpu/ops/sao.py:74
def _best_offset(e: float, n: int, positive: bool, lam: float) -> tuple[int, float]:
    """argmin over |o| in 0..7 of N*o^2 - 2*o*E + lam*bits (HM estIterOffset)."""
    best_o, best_c = 0, 0.0
    sign = 1 if positive else -1
    for mag in range(8):
        o = sign * mag
        cost = n * o * o - 2 * o * e + lam * (mag + (1 if mag else 0))
        if cost < best_c:
            best_o, best_c = o, cost
    return best_o, best_c


# video_codecs_tpu/ops/sao.py:86
def decide_ctu(orig: np.ndarray, rec: np.ndarray, x0: int, y0: int,
               size: int, lam: float) -> SaoParam:
    """Pick off / BO / best-EO for one CTU region of one component."""
    best = SaoParam()
    best_cost = 0.0  # cost of OFF
    for eo in range(4):
        count, sums = ctu_stats(orig, rec, x0, y0, size, eo)
        offs = [0, 0, 0, 0]
        cost = lam * 3  # type + class bits
        for cat in (1, 2, 3, 4):
            o, c = _best_offset(sums[cat], int(count[cat]), cat <= 2, lam)
            offs[cat - 1] = o
            cost += c
        if cost < best_cost:
            best = SaoParam(SAO_EO, eo, 0,
                            (abs(offs[0]), abs(offs[1]),
                             abs(offs[2]), abs(offs[3])))
            best_cost = cost
    # band offset: 4 consecutive bands with best total gain
    region_r = rec[y0:y0 + size, x0:x0 + size].astype(np.int32)
    region_d = (orig.astype(np.int64) - rec)[y0:y0 + size, x0:x0 + size]
    band = region_r >> 3
    counts = np.bincount(band.reshape(-1), minlength=32)
    sums = np.bincount(band.reshape(-1), weights=region_d.reshape(-1),
                       minlength=32)
    band_offs = np.zeros(32, np.int64)
    band_costs = np.zeros(32)
    for bnd in range(32):
        # BO offsets are signed (sign coded); search both signs
        op, cp = _best_offset(sums[bnd], int(counts[bnd]), True, lam)
        on, cn = _best_offset(sums[bnd], int(counts[bnd]), False, lam)
        band_offs[bnd], band_costs[bnd] = (op, cp) if cp <= cn else (on, cn)
    for pos in range(29):
        cost = band_costs[pos:pos + 4].sum() + lam * 7  # type + 5-bit pos
        if cost < best_cost:
            best = SaoParam(SAO_BO, 0, pos,
                            tuple(int(o) for o in band_offs[pos:pos + 4]))
            best_cost = cost
    return best


def build() -> tuple[Path, float, str]:
    """Compile csrc/sao_stats.cu (`sad_surface.build_library`)."""
    return build_library(_SRC, "vct_sao_stats")


def _load() -> ctypes.CDLL:
    """The built library, with its entry point's C signature declared:
    vct_sao_stats_u8(orig, rec, eo_count, eo_sum, bo_count, bo_sum, h, w,
    ctb, stream)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        fn = lib.vct_sao_stats_u8
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        _LIB = lib
    return _LIB


# video_codecs_tpu/ops/sao.py:127
def sao_stats_ref(orig: torch.Tensor, rec: torch.Tensor, ctb: int):
    """Plain PyTorch per-CTU SAO statistics of one plane: the reference's
    `sao_stats_dev` on tensors of any device.  Plane dims must be CTB
    multiples (callers pad, inter_qt._pad_to).

    Returns (eo_count [4,5,cy,cx] i32, eo_sum [4,5,cy,cx] f32,
             bo_count [32,cy,cx] i32, bo_sum [32,cy,cx] f32)."""
    h, w = rec.shape
    cy, cx = h // ctb, w // ctb
    reci = rec.to(torch.int32)
    diff = orig.to(torch.float32) - reci.to(torch.float32)

    def box(a):
        return a.reshape(cy, ctb, cx, ctb).sum(dim=(1, 3), dtype=a.dtype)

    eo_counts, eo_sums = [], []
    ys = torch.arange(h, device=rec.device)[:, None]
    xs = torch.arange(w, device=rec.device)[None, :]
    # edge pad by 1 (jnp.pad mode="edge")
    pad = reci[(torch.arange(-1, h + 1, device=rec.device)
                .clamp(0, h - 1))[:, None],
               torch.arange(-1, w + 1, device=rec.device).clamp(0, w - 1)]
    table = torch.tensor([1, 2, 0, 3, 4], dtype=torch.int32,
                         device=rec.device)
    for eo in range(4):
        (ady, adx), (bdy, bdx) = EO_NEIGHBORS[eo]
        c = pad[1:-1, 1:-1]
        a = pad[1 + ady:h + 1 + ady, 1 + adx:w + 1 + adx]
        b = pad[1 + bdy:h + 1 + bdy, 1 + bdx:w + 1 + bdx]
        s = torch.sign(c - a) + torch.sign(c - b)
        valid = ((ys + min(0, ady, bdy) >= 0) &
                 (ys + max(0, ady, bdy) < h) &
                 (xs + min(0, adx, bdx) >= 0) &
                 (xs + max(0, adx, bdx) < w))
        cat = torch.where(valid, table[(s + 2).long()], 0)
        cnts = [box((cat == k).to(torch.int32)) for k in range(5)]
        sums = [box(torch.where(cat == k, diff, 0.0)) for k in range(5)]
        eo_counts.append(torch.stack(cnts))
        eo_sums.append(torch.stack(sums))
    band = reci >> 3
    bo_count = torch.stack([box((band == b).to(torch.int32))
                            for b in range(32)])
    bo_sum = torch.stack([box(torch.where(band == b, diff, 0.0))
                          for b in range(32)])
    return (torch.stack(eo_counts), torch.stack(eo_sums), bo_count, bo_sum)


def sao_stats(orig: torch.Tensor, rec: torch.Tensor, ctb: int):
    """Per-CTU SAO statistics of one plane (orig, rec [h, w], multiples of
    ctb): (eo_count [4,5,cy,cx] i32, eo_sum [4,5,cy,cx] f32, bo_count
    [32,cy,cx] i32, bo_sum [32,cy,cx] f32).

    CUDA tensors (uint8, contiguous, ctb in KERNEL_CTBS, orig 4-byte
    aligned) go through the Hopper kernel csrc/sao_stats.cu, counted in
    `sao_stats.launches`; CPU tensors through `sao_stats_ref`.  The four
    outputs are views of one allocation."""
    if orig.shape != rec.shape or orig.dim() != 2:
        raise ValueError(f"sao_stats: orig {tuple(orig.shape)} / rec "
                         f"{tuple(rec.shape)} are not one plane's")
    h, w = rec.shape
    if h % ctb or w % ctb:
        raise ValueError(f"sao_stats: plane {h}x{w} is not a multiple of "
                         f"the CTB size {ctb}")
    if orig.device != rec.device:
        raise ValueError("sao_stats: orig and rec on different devices")
    if rec.device.type == "cpu":
        return sao_stats_ref(orig, rec, ctb)
    if rec.device.type != "cuda":
        raise ValueError(f"sao_stats: no kernel for {rec.device}")
    if orig.dtype != torch.uint8 or rec.dtype != torch.uint8:
        raise TypeError("sao_stats kernel takes uint8 planes, got "
                        f"{orig.dtype} / {rec.dtype}")
    if ctb not in KERNEL_CTBS:
        raise ValueError(f"sao_stats kernel takes ctb in {KERNEL_CTBS}, "
                         f"got {ctb}")
    if not (orig.is_contiguous() and rec.is_contiguous()):
        raise ValueError("sao_stats kernel takes contiguous tensors")
    cy, cx = h // ctb, w // ctb
    dev = rec.device
    # the four outputs are views of one allocation: EO counts, EO sums,
    # band counts, band sums, each contiguous
    m = cy * cx
    buf = torch.empty(104 * m, dtype=torch.int32, device=dev)
    eo_count = buf[:20 * m].view(4, 5, cy, cx)
    eo_sum = buf[20 * m:40 * m].view(torch.float32).view(4, 5, cy, cx)
    bo_count = buf[40 * m:72 * m].view(32, cy, cx)
    bo_sum = buf[72 * m:].view(torch.float32).view(32, cy, cx)
    if h and w:
        err = _load().vct_sao_stats_u8(
            orig.data_ptr(), rec.data_ptr(), eo_count.data_ptr(),
            eo_sum.data_ptr(), bo_count.data_ptr(), bo_sum.data_ptr(), h, w,
            ctb, launch_stream(dev))
        if err != 0:
            raise RuntimeError(f"sao_stats kernel launch failed: cudaError "
                               f"{err}")
        sao_stats.launches += 1
    return eo_count, eo_sum, bo_count, bo_sum


sao_stats.launches = 0


# video_codecs_tpu/ops/sao.py:177
def decide_from_stats(eo_count, eo_sum, bo_count, bo_sum,
                      lam: float) -> SaoParam:
    """decide_ctu twin consuming precomputed per-CTU stats (host side;
    the heavy classification ran on device via sao_stats_dev)."""
    best = SaoParam()
    best_cost = 0.0
    for eo in range(4):
        offs = [0, 0, 0, 0]
        cost = lam * 3
        for cat in (1, 2, 3, 4):
            o, c = _best_offset(float(eo_sum[eo, cat]),
                                int(eo_count[eo, cat]), cat <= 2, lam)
            offs[cat - 1] = o
            cost += c
        if cost < best_cost:
            best = SaoParam(SAO_EO, eo, 0,
                            (abs(offs[0]), abs(offs[1]),
                             abs(offs[2]), abs(offs[3])))
            best_cost = cost
    band_offs = np.zeros(32, np.int64)
    band_costs = np.zeros(32)
    for bnd in range(32):
        op, cp = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              True, lam)
        on, cn = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              False, lam)
        band_offs[bnd], band_costs[bnd] = (op, cp) if cp <= cn else (on, cn)
    for pos in range(29):
        cost = band_costs[pos:pos + 4].sum() + lam * 7
        if cost < best_cost:
            best = SaoParam(SAO_BO, 0, pos,
                            tuple(int(o) for o in band_offs[pos:pos + 4]))
            best_cost = cost
    return best


# video_codecs_tpu/ops/sao.py:213
def decide_eo_from_stats(eo_count, eo_sum, eo_class: int,
                         lam: float) -> SaoParam:
    """EO decision with a FORCED class (cr follows cb's type/class)."""
    offs = []
    for cat in (1, 2, 3, 4):
        o, _ = _best_offset(float(eo_sum[eo_class, cat]),
                            int(eo_count[eo_class, cat]), cat <= 2, lam)
        offs.append(abs(o))
    return SaoParam(SAO_EO, eo_class, 0, tuple(offs))


# video_codecs_tpu/ops/sao.py:224
def decide_bo_from_stats(bo_count, bo_sum, lam: float) -> SaoParam:
    """BO decision with forced type (cr follows cb's BO type; own
    band position)."""
    band_offs = np.zeros(32, np.int64)
    band_costs = np.zeros(32)
    for bnd in range(32):
        op, cp = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              True, lam)
        on, cn = _best_offset(float(bo_sum[bnd]), int(bo_count[bnd]),
                              False, lam)
        band_offs[bnd], band_costs[bnd] = (op, cp) if cp <= cn else (on, cn)
    best_pos, best_cost = 0, 1e30
    for pos in range(29):
        cost = band_costs[pos:pos + 4].sum()
        if cost < best_cost:
            best_pos, best_cost = pos, cost
    return SaoParam(SAO_BO, 0, best_pos,
                    tuple(int(o) for o in band_offs[best_pos:best_pos + 4]))


# video_codecs_tpu/ops/sao.py:244
def apply_frame(pre: np.ndarray, params: list, ctb: int,
                comp_idx: int) -> np.ndarray:
    """Whole-plane SAO apply: category maps computed once per class,
    then per-CTU offset gathers (fast twin of per-CTU apply_ctu)."""
    h, w = pre.shape
    cx = (w + ctb - 1) // ctb      # params grid is ceil-w CTBs wide
    out = pre.copy()
    cat_maps = {}
    band = pre.astype(np.int32) >> 3
    for i, p3 in enumerate(params):
        p = p3[comp_idx]
        if p is None or p.type_idx == SAO_OFF:
            continue
        by, bx = divmod(i, cx)
        y0, x0 = by * ctb, bx * ctb
        region = pre[y0:y0 + ctb, x0:x0 + ctb].astype(np.int32)
        if p.type_idx == SAO_BO:
            lut = np.zeros(32, np.int32)
            for k in range(4):
                lut[(p.band_position + k) & 31] = p.offsets[k]
            res = region + lut[band[y0:y0 + ctb, x0:x0 + ctb]]
        else:
            if p.eo_class not in cat_maps:
                cat_maps[p.eo_class] = eo_category_map(pre, p.eo_class)
            cat = cat_maps[p.eo_class][y0:y0 + ctb, x0:x0 + ctb]
            lut = np.array([0, p.offsets[0], p.offsets[1],
                            -p.offsets[2], -p.offsets[3]], np.int32)
            res = region + lut[cat]
        out[y0:y0 + ctb, x0:x0 + ctb] = np.clip(res, 0, 255)
    return out


# video_codecs_tpu/ops/sao.py:276
def apply_ctu(pre: np.ndarray, out: np.ndarray, x0: int, y0: int,
              size: int, p: SaoParam, bit_depth: int = 8) -> None:
    """Apply one CTU's SAO params; reads `pre` (deblocked), writes `out`."""
    if p.type_idx == SAO_OFF:
        return
    region = pre[y0:y0 + size, x0:x0 + size].astype(np.int32)
    if p.type_idx == SAO_BO:
        lut = np.zeros(32, np.int32)
        for k in range(4):
            lut[(p.band_position + k) & 31] = p.offsets[k]
        res = region + lut[region >> (bit_depth - 5)]
    else:
        cat = eo_category_map(pre, p.eo_class)[y0:y0 + size, x0:x0 + size]
        # categories 1,2 add +|o|; 3,4 add -|o| (signs implicit, spec 7.4.9.3)
        lut = np.array([0, p.offsets[0], p.offsets[1],
                        -p.offsets[2], -p.offsets[3]], np.int32)
        res = region + lut[cat]
    out[y0:y0 + size, x0:x0 + size] = np.clip(res, 0,
                                              (1 << bit_depth) - 1)


def apply_ctus(pre: np.ndarray, params: list, size: int, cw: int,
               bit_depth: int = 8) -> np.ndarray:
    """`apply_ctu` over every CTB of one plane: params[i] is CTB i's
    SaoParam in raster order, cw CTBs a row.  Each EO class's category map
    is computed once for the plane, as `apply_frame` does, where a loop of
    `apply_ctu` recomputes it for every CTB; the output is the loop's."""
    out = pre.copy()
    cat_maps = {}
    for i, p in enumerate(params):
        if p.type_idx == SAO_OFF:
            continue
        by, bx = divmod(i, cw)
        y0, x0 = by * size, bx * size
        region = pre[y0:y0 + size, x0:x0 + size].astype(np.int32)
        if p.type_idx == SAO_BO:
            lut = np.zeros(32, np.int32)
            for k in range(4):
                lut[(p.band_position + k) & 31] = p.offsets[k]
            res = region + lut[region >> (bit_depth - 5)]
        else:
            if p.eo_class not in cat_maps:
                cat_maps[p.eo_class] = eo_category_map(pre, p.eo_class)
            cat = cat_maps[p.eo_class][y0:y0 + size, x0:x0 + size]
            lut = np.array([0, p.offsets[0], p.offsets[1],
                            -p.offsets[2], -p.offsets[3]], np.int32)
            res = region + lut[cat]
        out[y0:y0 + size, x0:x0 + size] = np.clip(res, 0,
                                                  (1 << bit_depth) - 1)
    return out
