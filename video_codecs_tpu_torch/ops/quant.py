"""HEVC scalar quantization / dequantization, RDOQ-lite and sign-data hiding.

Counterpart of video_codecs_tpu/ops/quant.py.  The numpy twins are the
port's copies of the originals (each function keeps its name and a
comment gives the original's line); the device functions are the same
integer arithmetic on int32 tensors of any device (`>>` on int32 is the
arithmetic shift, as in jnp).

Float32 on the decision path.  `rdoq_lite` and `_sbh_fix_cgs` compare
float32 costs, so they are written as the reference's elementwise ops in
the reference's order, one torch op per jnp op, which is the same on the
CPU and the card.  Where the reference adds the result of a multiply in
the same fused XLA loop, XLA's CPU backend emits a fused multiply-add
(LLVM contracts `a * b + c`, taking the left operand of the add when
both are products); `fma32` gives that single rounding on any device, and
the port calls it exactly there.  The reference's float32 `log2` is
XLA's: `log(x) * 1.44269502f`, where `log` is the Cephes `logf`
polynomial that XLA's CPU backend inlines, its multiply-adds contracted
to FMAs.  `log_xla` evaluates that polynomial step for step (read from
the object code XLA emits for `jnp.log2`), and the rate tables of the
level magnitudes are built from it once on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add: the
    product of two float32 values is exact in float64, and the float64
    sum rounded to float32 is the fused result (a double rounding would
    need the float64 sum to land exactly on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


# Cephes logf coefficients, as XLA's CPU backend rounds them to float32
# (xla/service/cpu polynomial_approximations: GenerateVF32Log).
_LOG_P = [np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
INV_LN2 = np.float32(1.44269502)   # 1 / log(2): jnp.log2's divide, folded


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of finite normal x > 0 as XLA's CPU backend
    computes it: frexp-style split x = m * 2^e with m in [0.5, 1), the
    shift to [sqrt(1/2), sqrt(2)), the degree-8 polynomial in FMAs and
    the two-part e * log(2), in the object code's order."""
    f32 = torch.float32
    dev = x.device

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    bits = x.float().view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(f32)
    e = ((bits >> 23) - 127).float() + 1.0
    mask = m < c(0.707106781186547524)
    x = (m - 1.0) + torch.where(mask, m, c(0.0))
    e = e - torch.where(mask, c(1.0), c(0.0))
    x2 = x * x
    x3 = x2 * x
    p = [c(v) for v in _LOG_P]
    y = fma32(x, p[0], p[1])
    y1 = fma32(x, p[3], p[4])
    y = fma32(y, x, p[2])
    y1 = fma32(y1, x, p[5])
    y = fma32(y, x3, y1)
    y2 = fma32(fma32(x, p[6], p[7]), x, p[8])
    y = fma32(y, x3, y2)
    y = fma32(y, x3, e * c(_LOG_Q1))
    t = fma32(x2, c(-0.5), x) + y
    return fma32(e, c(_LOG_Q2), t)


def log2_xla(x: torch.Tensor) -> torch.Tensor:
    """jnp.log2 as XLA's CPU backend computes it: log_xla(x) * 1/ln 2."""
    return log_xla(x) * torch.tensor(INV_LN2, device=x.device)


@functools.lru_cache(maxsize=None)
def log_1p_tables() -> tuple[np.ndarray, np.ndarray]:
    """float32 tables over every level magnitude a = 0..32768 (levels are
    16-bit): log(1 + a), and the rate 2 + log2(1 + a) where XLA fuses the
    multiply by 1/ln 2 into the add (one FMA)."""
    ln = log_xla(torch.arange(1, (1 << 15) + 2, dtype=torch.float32))
    rate = fma32(ln, torch.tensor(INV_LN2),
                 torch.tensor(2.0, dtype=torch.float32))
    return ln.numpy(), rate.numpy()


# video_codecs_tpu/ops/quant.py:26
def transform_shift(log2_size: int, bit_depth: int = 8) -> int:
    return rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size


# video_codecs_tpu/ops/quant.py:30
def quantize(coeff: torch.Tensor, qp: int, log2_size: int, *,
             intra_slice: bool = True, bit_depth: int = 8) -> torch.Tensor:
    """Quantize coefficient blocks [..., N, N] int32 -> levels int32."""
    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + transform_shift(log2_size, bit_depth)
    add = (171 if intra_slice else 85) << (q_bits - 9)
    scale = int(rom.QUANT_SCALES[rem])
    # int32 suffices: |c| <= 32767, scale <= 26214, add < 2^26 (< 2^30)
    c = coeff.int()
    mag = (c.abs() * scale + add) >> q_bits
    lim = 1 << rom.MAX_TR_DYNAMIC_RANGE
    return (torch.sign(c) * mag).clamp(-lim, lim - 1).int()


# video_codecs_tpu/ops/quant.py:46
def dequantize(level: torch.Tensor, qp: int, log2_size: int, *,
               bit_depth: int = 8) -> torch.Tensor:
    """Dequantize levels [..., N, N] int32 -> coefficients int32."""
    per, rem = qp // 6, qp % 6
    right_shift = rom.IQUANT_SHIFT - (transform_shift(log2_size, bit_depth) + per)
    scale = int(rom.INV_QUANT_SCALES[rem])
    lim = 1 << rom.MAX_TR_DYNAMIC_RANGE
    q = level.int().clamp(-32768, 32767)
    if right_shift > 0:
        add = 1 << (right_shift - 1)
        c = (q * scale + add) >> right_shift
    else:
        c = (q * scale) << (-right_shift)
    return c.clamp(-lim, lim - 1).int()


# video_codecs_tpu/ops/quant.py:62
def _rate_bits(levels):
    """Crude per-level rate model (bits x 8 fixed point): sig+sign+Golomb."""
    import numpy as _n
    a = _n.abs(levels.astype(_n.float64))
    return _n.where(a == 0, 0.0, 2.0 + _n.log2(a + 1.0))


# video_codecs_tpu/ops/quant.py:69
def rdoq_lite(coeff: torch.Tensor, qp: int, log2_size: int, *,
              lam: float, bit_depth: int = 8,
              lam_scale: float = 2.0) -> torch.Tensor:
    """Device twin of rdoq_lite_np: per-coefficient floor/ceil/zero
    choice by J = D_td + lambda_td * R, fully elementwise, in float32 as
    the reference: the rate 2 + log2(1 + a) is one FMA of XLA's log, and
    the cost d * d + lam_td * r another."""
    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + transform_shift(log2_size, bit_depth)
    scale = int(rom.QUANT_SCALES[rem])
    c = coeff.int()
    mag = c.abs()
    l_floor = (mag * scale) >> q_bits
    lam_td = float(lam_scale) * float(lam) * float(
        4 ** (15 - bit_depth - log2_size))
    lam_f = torch.tensor(lam_td, dtype=torch.float32, device=c.device)
    rate = const(log_1p_tables()[1], c.device, torch.float32)

    def cost(lv):
        dq = dequantize(lv, qp, log2_size, bit_depth=bit_depth)
        d = (mag - dq).float()
        a = lv.abs()
        r = torch.where(a == 0, 0.0, rate[a.long()])
        return fma32(d, d, lam_f * r)             # d ** 2 + lam_td * r

    l0 = l_floor.clamp(0, (1 << 15) - 1)
    l1 = (l_floor + 1).clamp(0, (1 << 15) - 1)
    best = torch.where(cost(l1) < cost(l0), l1, l0)
    return (torch.sign(c) * best).int()


# video_codecs_tpu/ops/quant.py:102
def rdoq_lite_np(coeff: np.ndarray, qp: int, log2_size: int, *,
                 lam: float, bit_depth: int = 8,
                 lam_scale: float = 1.0) -> np.ndarray:
    """Soft-decision quantization (RDOQ-lite).

    Parity reference (behavioral): HM xRateDistOptQuant TComTrQuant.cpp:2129.
    Per coefficient, choose between floor and ceil levels (and zero) by
    J = D_td + lambda_td * R with exact dequant distortion in the transform
    domain; lambda scaled by the transform gain 4^(15-bd-log2). Skips the
    CG/last-position optimization of full RDOQ (roadmap), which keeps it a
    pure elementwise op.
    """
    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + transform_shift(log2_size, bit_depth)
    scale = int(rom.QUANT_SCALES[rem])
    c = coeff.astype(np.int64)
    mag = np.abs(c)
    l_floor = (mag * scale) >> q_bits
    lam_td = lam_scale * lam * float(4 ** (15 - bit_depth - log2_size))

    best_l = np.zeros_like(l_floor)
    best_j = None
    for delta in (0, 1):
        l = np.clip(l_floor + delta, 0, (1 << 15) - 1)
        dq = dequantize_np(l.astype(np.int32), qp, log2_size,
                           bit_depth=bit_depth)
        d = (mag - dq.astype(np.int64)) ** 2
        j = d.astype(np.float64) + lam_td * _rate_bits(l)
        if best_j is None:
            best_l, best_j = l, j
        else:
            take = j < best_j
            best_l = np.where(take, l, best_l)
            best_j = np.where(take, j, best_j)
    return (np.sign(c) * best_l).astype(np.int32)


# video_codecs_tpu/ops/quant.py:139
def apply_sbh_np(levels: np.ndarray, log2_size: int,
                 coeff: np.ndarray | None = None, qp: int | None = None,
                 scan_type: int | None = None,
                 bit_depth: int = 8) -> np.ndarray:
    """Sign-data-hiding parity fix (encoder side, host twin).

    Per 4x4 coefficient group with lastSig-firstSig >= 4 in scan order, the
    sign of the first significant coefficient is inferred from the parity
    of the absolute-level sum (spec 7.3.8.11).  With the original
    coefficients `coeff` + `qp` given, the parity-fixing +-1 move is chosen
    by minimum transform-domain distortion delta (HM signBitHidingHDQ,
    TComTrQuant.cpp:991); otherwise a cheap heuristic is used.
    """
    n = 1 << log2_size
    if scan_type is None:
        scan_type = rom.SCAN_DIAG
    scan = rom.scan_order(log2_size, scan_type)
    flat = levels.reshape(-1).copy()
    coeffs = flat[scan]
    orig = coeff.reshape(-1)[scan] if coeff is not None else None
    for cg in range(0, n * n, 16):
        c = coeffs[cg:cg + 16]
        nz = np.nonzero(c)[0]
        if nz.size == 0 or nz[-1] - nz[0] < 4:
            continue
        sum_abs = int(np.abs(c).sum())
        neg = c[nz[0]] < 0
        if (sum_abs & 1) == (1 if neg else 0):
            continue
        if orig is None:
            big = nz[np.abs(c[nz]) >= 2]
            if big.size:
                pos = big[-1]
                c[pos] -= np.sign(c[pos])
            else:
                c[nz[0]] += -1 if neg else 1
            continue
        o = orig[cg:cg + 16]
        first, last = int(nz[0]), int(nz[-1])
        lmag = np.abs(c).astype(np.int64)
        cmag = np.abs(o).astype(np.float64)

        def dq(lv):
            return dequantize_np(lv.astype(np.int32), qp, log2_size,
                                 bit_depth=bit_depth).astype(np.float64)

        err0 = (cmag - dq(lmag)) ** 2
        cost_inc = (cmag - dq(lmag + 1)) ** 2 - err0
        cost_dec = (cmag - dq(np.maximum(lmag - 1, 0))) ** 2 - err0
        pos_r = np.arange(16)
        in_span = (pos_r >= first) & (pos_r <= last)
        interior = (pos_r > first) & (pos_r < last)
        inc_ok = in_span
        dec_ok = (lmag >= 2) | ((lmag == 1) & interior)
        big = 1e30
        cand = np.concatenate([np.where(inc_ok, cost_inc, big),
                               np.where(dec_ok, cost_dec, big)])
        best = int(np.argmin(cand))
        is_dec = best >= 16
        p = best - 16 if is_dec else best
        if c[p] != 0:
            c[p] += (-1 if is_dec else 1) * np.sign(c[p])
        else:
            c[p] = -1 if o[p] < 0 else 1
    out = np.zeros_like(flat)
    out[scan] = coeffs
    return out.reshape(n, n)


# video_codecs_tpu/ops/quant.py:210
def _sbh_fix_cgs(coeffs: torch.Tensor, orig: torch.Tensor, qp: int,
                 log2_size: int, bit_depth: int = 8) -> torch.Tensor:
    """SBH parity fix over scan-ordered coefficient groups [..., G, 16].

    HM signBitHidingHDQ semantics (TComTrQuant.cpp:991): when the parity
    of the CG's absolute-level sum disagrees with the sign to hide, apply
    the single +-1 level change with the smallest transform-domain
    distortion delta against the original coefficients `orig` (scan
    order, same shape), keeping the CG's first/last significant positions.
    """
    sig = coeffs != 0
    pos = torch.arange(16, dtype=torch.int32, device=coeffs.device)
    first = torch.where(sig, pos, 16).amin(-1)
    last = torch.where(sig, pos, -1).amax(-1)
    hidden = (last - first) >= 4
    sum_abs = coeffs.abs().sum(-1, dtype=torch.int32)
    first_c = first.clamp(max=15)
    first_val = torch.gather(coeffs, -1, first_c[..., None].long())[..., 0]
    neg = first_val < 0
    mismatch = hidden & ((sum_abs & 1) != neg.int())

    lmag = coeffs.abs()
    cmag = orig.abs().float()

    def dq(lv):
        return dequantize(lv, qp, log2_size, bit_depth=bit_depth).float()

    e0 = cmag - dq(lmag)
    err0 = e0 * e0
    e_inc = cmag - dq(lmag + 1)
    e_dec = cmag - dq((lmag - 1).clamp(min=0))
    cost_inc = fma32(e_inc, e_inc, -err0)         # e_inc ** 2 - err0
    cost_dec = fma32(e_dec, e_dec, -err0)

    interior = (pos > first[..., None]) & (pos < last[..., None])
    in_span = (pos >= first[..., None]) & (pos <= last[..., None])
    inc_ok = in_span
    dec_ok = (lmag >= 2) | ((lmag == 1) & interior)

    big = 1e30
    cand = torch.cat([torch.where(inc_ok, cost_inc, big),
                      torch.where(dec_ok, cost_dec, big)], dim=-1)
    best = torch.argmin(cand, dim=-1)
    is_dec = best >= 16
    bpos = torch.where(is_dec, best - 16, best)

    cur = torch.gather(coeffs, -1, bpos[..., None])[..., 0]
    cur_o = torch.gather(orig, -1, bpos[..., None])[..., 0]
    step = torch.where(is_dec, -1, 1).int()
    new_sign = torch.where(cur != 0, torch.sign(cur),
                           torch.where(cur_o < 0, -1, 1).int())
    delta = step * new_sign
    newval = torch.where(cur != 0, cur + step * torch.sign(cur), delta)
    adj = torch.where(mismatch, newval - cur, 0)
    return coeffs + adj[..., None] * (pos == bpos[..., None])


# video_codecs_tpu/ops/quant.py:266
def apply_sbh(levels: torch.Tensor, log2_size: int, coeff: torch.Tensor,
              qp: int, bit_depth: int = 8) -> torch.Tensor:
    """Vectorized SBH parity fix over [..., N, N] level blocks, diagonal
    scan.  `coeff` = original transform coefficients (same shape)."""
    n = 1 << log2_size
    scan = const(rom.scan_order(log2_size, rom.SCAN_DIAG), levels.device,
                 torch.int64)
    shp = levels.shape[:-2]
    flat = levels.reshape(shp + (n * n,)).int()
    cflat = coeff.reshape(shp + (n * n,)).int()
    cgs = flat[..., scan].reshape(shp + (-1, 16))
    ocgs = cflat[..., scan].reshape(shp + (-1, 16))
    cgs = _sbh_fix_cgs(cgs, ocgs, qp, log2_size, bit_depth)
    out = torch.zeros_like(flat)
    out[..., scan] = cgs.reshape(shp + (n * n,))
    return out.reshape(levels.shape)


# video_codecs_tpu/ops/quant.py:287
def apply_sbh_scan(levels: torch.Tensor, log2_size: int,
                   scan_type: torch.Tensor, coeff: torch.Tensor,
                   qp: int, bit_depth: int = 8) -> torch.Tensor:
    """SBH parity fix with a per-block coefficient scan.

    levels: [B, N, N]; scan_type: [B] int in {SCAN_DIAG, SCAN_HOR,
    SCAN_VER} (the mode-dependent scan of 8x8 luma / 4x4 chroma intra
    TBs decides the CG grouping the parity is computed over)."""
    n = 1 << log2_size
    scans = np.stack([rom.scan_order(log2_size, t) for t in range(3)])
    invs = np.argsort(scans, axis=-1)                  # raster -> scan pos
    shp = levels.shape[:-2]
    dev = levels.device
    flat = levels.reshape(shp + (n * n,)).int()
    cflat = coeff.reshape(shp + (n * n,)).int()
    st = scan_type.long()
    perm = const(scans, dev, torch.int64)[st]          # [B, n*n]
    cgs = torch.gather(flat, -1, perm).reshape(shp + (-1, 16))
    ocgs = torch.gather(cflat, -1, perm).reshape(shp + (-1, 16))
    cgs = _sbh_fix_cgs(cgs, ocgs, qp, log2_size, bit_depth)
    out_scan = cgs.reshape(shp + (n * n,))
    inv = const(invs, dev, torch.int64)[st]
    return torch.gather(out_scan, -1, inv).reshape(levels.shape)


# video_codecs_tpu/ops/quant.py:315
def quantize_np(coeff: np.ndarray, qp: int, log2_size: int, *,
                intra_slice: bool = True, bit_depth: int = 8) -> np.ndarray:
    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + transform_shift(log2_size, bit_depth)
    add = (171 if intra_slice else 85) << (q_bits - 9)
    scale = int(rom.QUANT_SCALES[rem])
    c = coeff.astype(np.int64)
    mag = (np.abs(c) * scale + add) >> q_bits
    lim = 1 << rom.MAX_TR_DYNAMIC_RANGE
    return np.clip(np.sign(c) * mag, -lim, lim - 1).astype(np.int32)


# video_codecs_tpu/ops/quant.py:327
def dequantize_np(level: np.ndarray, qp: int, log2_size: int, *,
                  bit_depth: int = 8) -> np.ndarray:
    per, rem = qp // 6, qp % 6
    right_shift = rom.IQUANT_SHIFT - (transform_shift(log2_size, bit_depth) + per)
    scale = int(rom.INV_QUANT_SCALES[rem])
    lim = 1 << rom.MAX_TR_DYNAMIC_RANGE
    q = np.clip(level.astype(np.int64), -32768, 32767)
    if right_shift > 0:
        add = 1 << (right_shift - 1)
        c = (q * scale + add) >> right_shift
    else:
        c = (q * scale) << (-right_shift)
    return np.clip(c, -lim, lim - 1).astype(np.int32)
