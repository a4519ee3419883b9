"""Device (batched) full RDOQ: the counterpart of video_codecs_tpu/ops/rdoq_jax.py.

HM xRateDistOptQuant (TComTrQuant.cpp:2129) with a static per-TU context
snapshot for the rates (HM's estBits), over [B, N, N] coefficient blocks:

  1. per-coefficient {0, maxAbs-1, maxAbs} level choice with fractional-
     bit CABAC rates, in reverse scan order: an outer loop over the
     coefficient groups (carrying the decided CG-significance map and
     prev_c1) and an inner loop over the 16 positions of a CG (carrying
     c1/c1_idx/c2_idx and the Rice parameter), every carried state a [B]
     tensor, so all TUs take the same 16 x num_cg steps in lockstep;
  2. CG zero-out against the coded_sub_block_flag rate;
  3. last-significant-position optimization and whole-block zero as a
     prefix-sum argmin over scan positions.

The rate tables (`_tables`, `_tables_np`) are the port's copies of the
reference's host functions (each keeps its name and a comment gives the
original's line).  The reference's device loop becomes two functions:
`rdoq_dev_ref`, the plain PyTorch version (the loop as torch ops on any
device, about 40 launches a position), and `rdoq_dev`, which launches
the hand-written Hopper kernel csrc/rdoq.cu for a CUDA tensor (one
launch a call) and runs `rdoq_dev_ref` for a CPU tensor.  There is no
other path: a CUDA tensor goes through the kernel or raises.  The kernel
is built with nvcc at first use into build/torch_kernels/ as
ops/sad_surface.py builds its own (a plain-C shared library loaded with
ctypes, keyed by the source's hash), and computes what `rdoq_dev_ref`
computes, bit for bit.

Float32 in the reference's order.  The costs are float32, and the
decisions compare them, so every float32 operation is the reference's,
one torch op per jnp op (no fused multiply-add), and no reduction uses
`torch.sum`/`torch.cumsum`, whose order differs between devices and from
XLA's.  The reductions are written out as elementwise adds in the order
XLA's CPU backend uses for them (measured against the JAX package in
tests/test_torch_hevc_ops.py): a 16-entry sum left to right; a row sum
of more than 32 entries as left-to-right sums of 32-entry chunks, then of
the chunk sums (XLA's tree-reduction rewrite); and a cumulative sum as
left-to-right scans of 16-entry tiles plus the exclusive scan of the
tile totals (XLA's reduce-window rewrite); the 16-entry distortion sum
of a 4x4 block's rate as XLA's CPU code fuses and vectorizes it (see the
end of `rdoq_dev`).  So the CPU and the card give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import ctx as ctx_mod
from video_codecs_tpu_torch.entropy import residual
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops.quant import fma32
from video_codecs_tpu_torch.ops.rdoq import ENTROPY_BITS, _SCALE_BITS
from video_codecs_tpu_torch.ops.sad_surface import (build_library,
                                                    launch_stream)
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const, to_device

_BYPASS = 1 << _SCALE_BITS
_INF = 1e30

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "rdoq.cu"
# Transform sizes the kernel is instantiated for (log2 of N).
KERNEL_LOG2 = (2, 3, 4, 5)

_LIB = None

# video_codecs_tpu/ops/rdoq_jax.py:50
@functools.lru_cache(maxsize=None)
def _tables(qp: int, log2_size: int, is_luma: bool, slice_type: int,
            scan_type: int):
    """Host-side per-config rate tables (all numpy, hashable inputs)."""
    n = 1 << log2_size
    nn = n * n
    states = ctx_mod.init_states(slice_type, qp)
    ent = ENTROPY_BITS

    def fb(c):
        s = int(states[c])
        return (int(ent[s]), int(ent[s ^ 1]))

    scan = rom.scan_order(log2_size, scan_type)           # scan -> raster
    cg_scan = rom.cg_scan_order(log2_size, scan_type)
    inner = rom.scan_order(2, scan_type)
    cg_w = max(n >> 2, 1)
    num_cg = nn >> 4

    first_ctx = residual.first_sig_map_ctx(log2_size, scan_type, is_luma)
    single = first_ctx == residual._SIG_START[is_luma]["single"]
    sig_base = ctx_mod.off("sig_flag", 0 if is_luma else 28)

    # sig-flag (bits0, bits1) per (neighbor CG pattern, scan position)
    sig_bits = np.zeros((4, nn, 2), np.int32)
    for i in range(nn):
        cg_i = i >> 4
        cg_raster = int(cg_scan[cg_i])
        cg_y, cg_x = divmod(cg_raster, cg_w)
        r_in = int(inner[i & 15])
        py, px = divmod(r_in, 4)
        pos_x, pos_y = (cg_x << 2) + px, (cg_y << 2) + py
        for pattern in range(4):
            if single:
                sc = first_ctx
            elif pos_x + pos_y == 0:
                sc = 0
            elif log2_size == 2:
                sc = first_ctx + int(
                    residual.CTX_IND_MAP_4x4[4 * pos_y + pos_x])
            else:
                sc = residual.sig_ctx_inc(pattern, pos_x, pos_y,
                                          log2_size, is_luma, first_ctx)
            sig_bits[pattern, i] = fb(sig_base + sc)

    one_base = ctx_mod.off("one_flag", 0 if is_luma else 16)
    abs_base = ctx_mod.off("abs_flag", 0 if is_luma else 4)
    gt1_bits = np.zeros((4, 4, 2), np.int32)   # [ctx_set, c1, (b0,b1)]
    gt2_bits = np.zeros((4, 2), np.int32)
    for cs in range(4):
        for c1 in range(4):
            gt1_bits[cs, c1] = fb(one_base + cs * 4 + c1)
        gt2_bits[cs] = fb(abs_base + cs)

    cg_base = ctx_mod.off("sig_cg", 0 if is_luma else 2)
    cg_bits = np.array([fb(cg_base), fb(cg_base + 1)], np.int32)  # [ctx,2]

    # last-position rate per scan position (static)
    loff, lshift = residual._last_ctx_params(log2_size, is_luma)
    bx, by = ctx_mod.off("last_x"), ctx_mod.off("last_y")
    max_group = (log2_size << 1) - 1
    lx_bits = [fb(bx + loff + (i >> lshift)) for i in range(max_group)]
    ly_bits = [fb(by + loff + (i >> lshift)) for i in range(max_group)]

    def rate_last(pos_x, pos_y):
        gx = int(residual.GROUP_IDX[pos_x])
        gy = int(residual.GROUP_IDX[pos_y])
        rate = 0
        for i in range(gx):
            rate += lx_bits[i][1]
        if gx < max_group:
            rate += lx_bits[gx][0]
        for i in range(gy):
            rate += ly_bits[i][1]
        if gy < max_group:
            rate += ly_bits[gy][0]
        if gx > 3:
            rate += ((gx >> 1) - 1) << _SCALE_BITS
        if gy > 3:
            rate += ((gy >> 1) - 1) << _SCALE_BITS
        return rate

    rate_last_tab = np.zeros(nn, np.int32)
    for p in range(nn):
        raster = int(scan[p])
        ly_, lx_ = divmod(raster, n)
        if scan_type == rom.SCAN_VER:
            lx_, ly_ = ly_, lx_
        rate_last_tab[p] = rate_last(lx_, ly_)

    # CG raster neighbors (right / below) for the sig pattern + cg ctx
    ngh_right = np.full(num_cg, -1, np.int32)
    ngh_below = np.full(num_cg, -1, np.int32)
    for cg_raster in range(num_cg):
        cg_y, cg_x = divmod(cg_raster, cg_w)
        if cg_x + 1 < cg_w:
            ngh_right[cg_raster] = cg_raster + 1
        if cg_y + 1 < cg_w:
            ngh_below[cg_raster] = cg_raster + cg_w

    return dict(scan=scan, cg_scan=np.asarray(cg_scan, np.int32),
                sig_bits=sig_bits, gt1_bits=gt1_bits, gt2_bits=gt2_bits,
                cg_bits=cg_bits, rate_last_tab=rate_last_tab,
                ngh_right=ngh_right, ngh_below=ngh_below)


# video_codecs_tpu/ops/rdoq_jax.py:156
@functools.lru_cache(maxsize=None)
def _tables_np(qp: int, log2_size: int, is_luma: bool, slice_type: int,
               scan_type: int):
    """Numpy views of the rate tables in the layouts the scan wants."""
    t = _tables(qp, log2_size, is_luma, slice_type, scan_type)
    num_cg = (1 << (2 * log2_size)) >> 4
    cis_np = np.arange(num_cg - 1, -1, -1, dtype=np.int32)
    cg_np = t["cg_scan"]
    return dict(
        scan=np.asarray(t["scan"], np.int32),
        sig_cg_tab=np.ascontiguousarray(
            t["sig_bits"].reshape(4, num_cg, 16, 2)
            .transpose(1, 0, 2, 3)[cis_np]),
        gt1_flat=np.ascontiguousarray(t["gt1_bits"].reshape(16, 2)),
        gt2_tab=t["gt2_bits"],
        cg_bits=t["cg_bits"],
        rate_last=t["rate_last_tab"].astype(np.float32),
        cis=cis_np,
        cg_rev=np.ascontiguousarray(cg_np[cis_np]),
        ngr_rev=np.ascontiguousarray(t["ngh_right"][cg_np[cis_np]]),
        ngb_rev=np.ascontiguousarray(t["ngh_below"][cg_np[cis_np]]),
        js_rev=np.arange(15, -1, -1, dtype=np.int32),
        cis_np=cis_np)


# video_codecs_tpu/ops/rdoq_jax.py:181
@functools.lru_cache(maxsize=None)
def _tables_dev(qp: int, log2_size: int, is_luma: bool, slice_type: int,
                scan_type: int, device: torch.device):
    """The tables the device loop gathers from, on `device` (the loop
    reads its per-step indices from `_tables_np` on the host)."""
    t = _tables_np(qp, log2_size, is_luma, slice_type, scan_type)
    out = {k: const(t[k], device, torch.int32)
           for k in ("sig_cg_tab", "gt1_flat", "gt2_tab", "cg_bits")}
    out["scan"] = const(t["scan"], device, torch.int64)
    out["rate_last"] = const(t["rate_last"], device, torch.float32)
    return out


# video_codecs_tpu/ops/rdoq_jax.py:191
def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 1: the binary exponent of x, exact
    (x is an integer, so its float64 value is exact)."""
    _, e = torch.frexp(x.double())
    return (e - 1).int()


# video_codecs_tpu/ops/rdoq_jax.py:199
def _rate_level_dev(level, one_b, abs_b, rice, c1_idx, c2_idx):
    """Vector xGetICRate: frac bits for abs level >= 1 ([B] int32).

    one_b/abs_b: [B, 2] live gt1/gt2 context bits; rice/c1_idx/c2_idx [B].
    """
    base = torch.where(c1_idx < 8, torch.where(c2_idx == 0, 3, 2), 1).int()
    rate = torch.full(level.shape, _BYPASS, dtype=torch.int32,
                      device=level.device)                # sign bypass

    symbol = level - base
    short = symbol < (3 << rice)
    len_short = (symbol >> rice) + 1 + rice
    value = (symbol - (3 << rice)).clamp(min=0)
    # escape: k = floor(log2(value + 2^rice)); len = 4 + 2k - rice
    k = _floor_log2((value + (1 << rice)).clamp(min=1))
    len_esc = 4 + 2 * k - rice
    esc_len = torch.where(short, len_short, len_esc)
    ge_base = level >= base
    rate = rate + torch.where(ge_base, esc_len << _SCALE_BITS, 0)
    in_c1 = c1_idx < 8
    rate = rate + torch.where(ge_base & in_c1, one_b[:, 1], 0)
    rate = rate + torch.where(ge_base & in_c1 & (c2_idx == 0), abs_b[:, 1], 0)
    # the ==1/==2 special cases only apply below base_level (host order)
    rate = torch.where(~ge_base & (level == 1), _BYPASS + one_b[:, 0], rate)
    rate = torch.where(~ge_base & (level == 2),
                       _BYPASS + one_b[:, 1] + abs_b[:, 0], rate)
    return rate.int()


def _quant_scalars(qp: int, log2_size: int, lam: float, bit_depth: int):
    """(q_bits, scale, lam_td, err_scale): the quantiser's shift and
    scale, and lambda per fractional bit and the distortion scale as
    Python (float64) numbers, before their rounding to float32."""
    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + quant_ops.transform_shift(
        log2_size, bit_depth)
    scale = int(rom.QUANT_SCALES[rem])
    lam_td = float(lam) * float(4 ** (15 - bit_depth - log2_size))
    err_scale = 1.0 / (float(scale) * float(scale))
    return q_bits, scale, lam_td / (1 << _SCALE_BITS), err_scale


def _quant_params(qp: int, log2_size: int, lam: float, bit_depth: int,
                  device):
    """(q_bits, scale, lam_bits, es): the quantiser's shift and scale and
    the float32 lambda per fractional bit and distortion scale, as 0-d
    tensors on `device`."""
    q_bits, scale, lam_bits, es = _quant_scalars(qp, log2_size, lam,
                                                 bit_depth)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return q_bits, scale, f32(lam_bits), f32(es)


@functools.lru_cache(maxsize=None)
def _kernel_scalars(qp: int, log2_size: int, lam: float, bit_depth: int):
    """(q_bits, scale, lam_bits, es, inv) as the kernel takes them: the
    float32 values `_quant_params` and `rdoq_dev_ref` form, held as Python
    floats (exact: each is a float32), so that a call builds no tensor
    and reads none back.  inv = 1 / (lam_bits * 2^15) in float32."""
    q_bits, scale, lam_bits, es = _quant_scalars(qp, log2_size, lam,
                                                 bit_depth)
    lam32 = np.float32(lam_bits)
    inv = np.float32(1.0) / (lam32 * np.float32(1 << _SCALE_BITS))
    return q_bits, scale, float(lam32), float(np.float32(es)), float(inv)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (float32 as it comes)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """[B, n] -> [B]: XLA CPU's order for a row sum (more than 32 entries:
    left-to-right sums of 32-entry chunks, then of the chunk sums)."""
    n = x.shape[-1]
    if n <= 32:
        return _seq_sum(x)
    if n % 32:
        raise ValueError("row sums of more than 32 entries need a multiple of 32")
    return _row_sum(_seq_sum(x.reshape(x.shape[0], n // 32, 32)))


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """[B, n] inclusive prefix sums in XLA CPU's order for a cumulative
    sum: sequential within 16-entry tiles, plus the exclusive prefix of
    the tile totals (recursively)."""
    b, n = x.shape
    if n <= 16:
        outs = [x[:, 0]]
        for i in range(1, n):
            outs.append(outs[-1] + x[:, i])
        return torch.stack(outs, dim=1)
    if n % 16:
        raise ValueError("prefix sums of more than 16 entries need a multiple of 16")
    tiles = x.reshape(b * (n // 16), 16)
    inner = _cumsum(tiles).reshape(b, n // 16, 16)
    outer = _cumsum(inner[:, :, -1].contiguous())
    excl = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], dim=1)
    return (inner + excl[:, :, None]).reshape(b, n)


# video_codecs_tpu/ops/rdoq_jax.py:227
def rdoq_dev_ref(coeff: torch.Tensor, qp: int, log2_size: int, *,
                 lam: float, scan_type: int = rom.SCAN_DIAG,
                 is_luma: bool = True, slice_type: int = 2,
                 bit_depth: int = 8, allow_all_zero: bool = True,
                 return_rate: bool = False):
    """Plain PyTorch full RDOQ of [B, N, N] integer coefficient blocks ->
    levels, on tensors of any device (the reference's `rdoq_dev` written
    out as torch ops).

    With return_rate=True also returns the estimated CABAC rate of the
    emitted levels per block ([B] float32 bits), the rate the quadtree
    decision charges."""
    n = 1 << log2_size
    nn = n * n
    num_cg = nn >> 4
    dev = coeff.device
    td = _tables_dev(qp, log2_size, bool(is_luma), slice_type, scan_type,
                     dev)
    tn = _tables_np(qp, log2_size, bool(is_luma), slice_type, scan_type)
    q_bits, scale, lam_bits, es = _quant_params(qp, log2_size, lam,
                                                bit_depth, dev)

    b = coeff.shape[0]
    flat = coeff.reshape(b, nn)
    c_scan = flat[:, td["scan"]].int()
    sign = torch.sign(c_scan)
    ld = c_scan.abs() * scale                             # level_double
    max_abs = ((ld + (1 << (q_bits - 1))) >> q_bits).clamp(max=32767)
    pos_r = torch.arange(nn, dtype=torch.int32, device=dev)
    any_nz = (max_abs > 0).any(dim=1)
    last_pos = torch.where(max_abs > 0, pos_r[None], -1).amax(dim=1)
    last_cg = last_pos >> 4

    ldf = ld.float()
    d0 = ldf * ldf * es                                   # [B, nn]

    gt2_tab = td["gt2_tab"]
    cg_bits = td["cg_bits"]
    gt1_flat = td["gt1_flat"]
    base_set = 0 if not is_luma else 2
    zero_b = torch.zeros(b, dtype=torch.int32, device=dev)

    cg_sig_map = torch.zeros((b, num_cg), dtype=torch.int32, device=dev)
    prev_c1 = torch.ones(b, dtype=torch.int32, device=dev)
    lv_out = [None] * num_cg
    cc_out = [None] * num_cg
    cs_out = [None] * num_cg
    for s, cg_i in enumerate(tn["cis"].tolist()):
        cg_raster = int(tn["cg_rev"][s])
        ngr, ngb = int(tn["ngr_rev"][s]), int(tn["ngb_rev"][s])
        sl = slice(cg_i * 16, cg_i * 16 + 16)
        ma_c, ld_c, d0_c = max_abs[:, sl], ldf[:, sl], d0[:, sl]
        right = cg_sig_map[:, ngr] if ngr >= 0 else zero_b
        below = cg_sig_map[:, ngb] if ngb >= 0 else zero_b
        pattern = (right + 2 * below).long()              # [B]
        # sig-flag bits of this CG per position for each block's pattern
        sig_pb = td["sig_cg_tab"][s].permute(1, 0, 2)[:, pattern]  # [16,B,2]

        ctx_set = (0 if cg_i == 0 else base_set) + (prev_c1 == 0).int()
        abs_b = gt2_tab[ctx_set.long()]                   # [B, 2]

        c1 = torch.ones(b, dtype=torch.int32, device=dev)
        c1_idx, c2_idx, rice = zero_b, zero_b, zero_b
        lv_j, cc_j, cs_j = [None] * 16, [None] * 16, [None] * 16
        for j in range(15, -1, -1):
            ma_p, ld_p, d0_p = ma_c[:, j], ld_c[:, j], d0_c[:, j]
            p = cg_i * 16 + j
            active = p <= last_pos
            is_last = p == last_pos
            sb = sig_pb[j]
            sb0 = torch.where(is_last, 0, sb[:, 0])
            sb1 = torch.where(is_last, 0, sb[:, 1])

            one_b = gt1_flat[(ctx_set * 4 + c1.clamp(max=3)).long()]

            j0 = fma32(lam_bits, sb0.float(), d0_p)

            def cost(lvl, rate):      # d * d * es + lam_bits * (sb1 + rate)
                d = ld_p - (lvl << q_bits).float()
                return fma32(d * d, es, lam_bits * (sb1 + rate).float())

            l_lo = (ma_p - 1).clamp(min=1)
            l_hi = ma_p
            r_lo = _rate_level_dev(l_lo, one_b, abs_b, rice, c1_idx, c2_idx)
            r_hi = _rate_level_dev(l_hi, one_b, abs_b, rice, c1_idx, c2_idx)
            j_lo = cost(l_lo, r_lo)
            j_hi = cost(l_hi, r_hi)

            has = ma_p > 0
            best_l = torch.zeros_like(ma_p)
            best_j = j0
            take_lo = has & (j_lo < best_j)
            best_l = torch.where(take_lo, l_lo, best_l)
            best_j = torch.where(take_lo, j_lo, best_j)
            take_hi = has & (l_hi != l_lo) & (j_hi < best_j)
            best_l = torch.where(take_hi, l_hi, best_l)
            best_j = torch.where(take_hi, j_hi, best_j)

            best_l = torch.where(active, best_l, 0)
            lv_j[j] = best_l
            cc_j[j] = torch.where(active, best_j, 0.0)
            cs_j[j] = torch.where(
                active, lam_bits * torch.where(best_l > 0, sb1, sb0).float(),
                0.0)

            # context-state evolution (mirrors rdoq_np exactly)
            nz = best_l > 0
            in_c1 = c1_idx < 8
            gt1 = best_l > 1
            c2_n = torch.where(nz & in_c1 & gt1, 1, c2_idx)
            c1_n = torch.where(nz & in_c1 & gt1, 0,
                               torch.where(nz & in_c1 & (c1 > 0) & (c1 < 3),
                                           c1 + 1, c1))
            c1i_n = torch.where(nz & in_c1, c1_idx + 1, c1_idx)
            rice_n = torch.where(nz & (best_l > (3 << rice)),
                                 (rice + 1).clamp(max=4), rice)
            c1, c1_idx, c2_idx, rice = (c1_n.int(), c1i_n.int(), c2_n.int(),
                                        rice_n.int())
        lv_cg = torch.stack(lv_j, dim=1)                  # [B, 16]
        cc_cg = torch.stack(cc_j, dim=1)
        cs_cg = torch.stack(cs_j, dim=1)
        cg_has = (lv_cg > 0).any(dim=1)

        # CG zero-out (only 0 < cg_i < last_cg)
        cg_ctx = ((right + below) > 0).long()
        bits_pair = cg_bits[cg_ctx]                       # [B, 2]
        j_keep = fma32(lam_bits, bits_pair[:, 1].float(), _seq_sum(cc_cg))
        j_zero = fma32(lam_bits, bits_pair[:, 0].float(), _seq_sum(d0_c))
        in_range = (cg_i > 0) & (cg_i < last_cg)
        zero_out = in_range & cg_has & (j_zero < j_keep)
        lv_out[cg_i] = torch.where(zero_out[:, None], 0, lv_cg)
        cc_out[cg_i] = torch.where(zero_out[:, None], d0_c, cc_cg)
        cs_out[cg_i] = torch.where(zero_out[:, None], 0.0, cs_cg)
        cg_sig = torch.where(zero_out, 0, cg_has.int())
        cg_sig_map[:, cg_raster] = cg_sig
        prev_c1 = c1
    levels = torch.cat(lv_out, dim=1)                     # scan order
    cost_coeff = torch.cat(cc_out, dim=1)
    cost_sig = torch.cat(cs_out, dim=1)

    # ---- last-position optimization ----
    zcol = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    prefix = torch.cat([zcol, _cumsum(cost_coeff)], dim=1)
    suffix_zero = torch.cat([_cumsum(d0.flip(1)).flip(1), zcol], dim=1)
    rate_last = td["rate_last"]
    # lam_bits * rate_last is a constant: the reference folds it, so no
    # fused multiply-add here
    totals = (prefix[:, :nn] + (cost_coeff - cost_sig) +
              lam_bits * rate_last[None] + suffix_zero[:, 1:])
    totals = torch.where(levels > 0, totals, _INF)
    # host iterates high->low with strict '<': ties keep the higher p
    best_last = nn - 1 - torch.argmin(totals.flip(1), dim=1)
    best_total = totals.amin(dim=1)

    keep = pos_r[None] <= best_last[:, None]
    levels = torch.where(keep, levels, 0)
    chosen_total = best_total
    if allow_all_zero:
        total_zero = suffix_zero[:, 0]
        all_zero = total_zero < best_total
        levels = torch.where(all_zero[:, None], 0, levels)
        chosen_total = torch.where(all_zero, total_zero, chosen_total)
    levels = torch.where(any_nz[:, None], levels, 0)
    chosen_total = torch.where(any_nz, chosen_total, 0.0)

    out = torch.zeros((b, nn), dtype=torch.int32, device=dev)
    out[:, td["scan"]] = (levels * sign).int()
    out = out.reshape(b, n, n)
    if not return_rate:
        return out
    # estimated CABAC rate of the chosen levels (fractional bits):
    # chosen_total = dist + lam_bits * rate  =>  rate = (J - D) / lam
    dqf = (levels << q_bits).float()
    e = ldf - dqf
    dist_fin = torch.where(levels > 0, e * e * es, d0)
    inv = 1.0 / (lam_bits * (1 << _SCALE_BITS))
    if nn == 16:
        # 4x4: XLA's CPU code fuses this 16-entry sum with the products
        # (sq * es, sq the squared error) and unswitches it on the
        # all-zero decision: where the block was zeroed, left to right
        # with each product fused into the add; else as an 8-lane vector
        # reduction, entry i + 8 fused onto the rounded entry i, then
        # halves (4, 2, 1)
        sq = torch.where(levels > 0, e * e, ldf * ldf)
        vec = fma32(sq[:, 8:], es, sq[:, :8] * es)
        while vec.shape[1] > 1:
            h = vec.shape[1] // 2
            vec = vec[:, :h] + vec[:, h:]
        dist_sum = vec[:, 0]
        if allow_all_zero:
            acc = sq[:, 0] * es
            for i in range(1, nn):
                acc = fma32(sq[:, i], es, acc)
            dist_sum = torch.where(all_zero, acc, dist_sum)
    else:
        dist_sum = _row_sum(dist_fin)
    bits = (chosen_total - dist_sum) * inv
    return out, bits.clamp(min=0.0)


def build() -> tuple[Path, float, str]:
    """Compile csrc/rdoq.cu (`sad_surface.build_library`)."""
    return build_library(_SRC, "vct_rdoq")


def _load() -> ctypes.CDLL:
    """The built library, with its entry point's C signature declared:
    vct_rdoq(coeff, s_b, s_y, s_x, out, bits, num_blocks, log2_size, tab,
    rate_last, q_bits, scale, lam_bits, es, inv, is_luma, allow_all_zero,
    stream)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        fn = lib.vct_rdoq
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 +
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
                       [ctypes.c_float] * 3 + [ctypes.c_int] * 2 +
                       [ctypes.c_void_p])
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _kernel_tables(qp: int, log2_size: int, is_luma: bool, slice_type: int,
                   scan_type: int, device: torch.device):
    """The kernel's tables on `device`: one int32 buffer holding `scan`,
    `sig_cg_tab`, `gt1_flat`, `gt2_tab`, `cg_bits`, `cg_rev`, `ngr_rev` and
    `ngb_rev` of `_tables_np`, flattened in that order (csrc/rdoq.cu reads
    them at those offsets), and the float32 last-position rates."""
    t = _tables_np(qp, log2_size, is_luma, slice_type, scan_type)
    tab = np.concatenate([np.asarray(t[k], np.int32).ravel() for k in (
        "scan", "sig_cg_tab", "gt1_flat", "gt2_tab", "cg_bits", "cg_rev",
        "ngr_rev", "ngb_rev")])
    return (to_device(tab, device, torch.int32),
            to_device(t["rate_last"], device, torch.float32))


# video_codecs_tpu/ops/rdoq_jax.py:227
def rdoq_dev(coeff: torch.Tensor, qp: int, log2_size: int, *, lam: float,
             scan_type: int = rom.SCAN_DIAG, is_luma: bool = True,
             slice_type: int = 2, bit_depth: int = 8,
             allow_all_zero: bool = True, return_rate: bool = False):
    """Full RDOQ of [B, N, N] int32 coefficient blocks -> levels.

    With return_rate=True also returns the estimated CABAC rate of the
    emitted levels per block ([B] float32 bits), the rate the quadtree
    decision charges.

    CUDA tensors (int32, any strides, log2_size in KERNEL_LOG2) go through
    the Hopper kernel csrc/rdoq.cu, one launch counted in
    `rdoq_dev.launches`; CPU tensors through `rdoq_dev_ref`."""
    n = 1 << log2_size
    if coeff.dim() != 3 or tuple(coeff.shape[1:]) != (n, n):
        raise ValueError(f"rdoq_dev: coefficients {tuple(coeff.shape)} are "
                         f"not [B, {n}, {n}] blocks")
    if coeff.device.type == "cpu":
        return rdoq_dev_ref(coeff, qp, log2_size, lam=lam,
                            scan_type=scan_type, is_luma=is_luma,
                            slice_type=slice_type, bit_depth=bit_depth,
                            allow_all_zero=allow_all_zero,
                            return_rate=return_rate)
    if coeff.device.type != "cuda":
        raise ValueError(f"rdoq_dev: no kernel for {coeff.device}")
    if coeff.dtype != torch.int32:
        raise TypeError(f"rdoq_dev kernel takes int32 coefficients, got "
                        f"{coeff.dtype}")
    if log2_size not in KERNEL_LOG2:
        raise ValueError(f"rdoq_dev kernel takes log2_size in "
                         f"{KERNEL_LOG2}, got {log2_size}")
    dev = coeff.device
    b = coeff.shape[0]
    out = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    bits = (torch.empty(b, dtype=torch.float32, device=dev) if return_rate
            else None)
    if b:
        tab, rate_last = _kernel_tables(qp, log2_size, bool(is_luma),
                                        slice_type, scan_type, dev)
        q_bits, scale, lam_bits, es, inv = _kernel_scalars(
            qp, log2_size, lam, bit_depth)
        err = _load().vct_rdoq(
            coeff.data_ptr(), *coeff.stride(), out.data_ptr(),
            None if bits is None else bits.data_ptr(), b, log2_size,
            tab.data_ptr(), rate_last.data_ptr(), q_bits, scale, lam_bits,
            es, inv, int(bool(is_luma)), int(bool(allow_all_zero)),
            launch_stream(dev))
        if err != 0:
            raise RuntimeError(f"rdoq_dev kernel launch failed: cudaError "
                               f"{err}")
        rdoq_dev.launches += 1
    return (out, bits) if return_rate else out


rdoq_dev.launches = 0
