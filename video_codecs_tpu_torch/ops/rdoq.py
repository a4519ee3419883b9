"""CABAC fractional-bit tables and the host full RDOQ.

The port's copy of video_codecs_tpu/ops/rdoq.py: the fractional-bit
table of the 64-state CABAC probability model, pLPS(i) = 0.5 * alpha^i
with alpha = (0.01875/0.5)^(1/63) (HM ContextModel::sm_entropyBits), in
2^15 units, which the device RDOQ (ops/rdoq_dev.py) reads too, and
`rdoq_np`, the host twin of HM's xRateDistOptQuant (TComTrQuant.cpp:2129):
per-coefficient level search in reverse scan with the live CABAC
contexts adapted as it decides, the coefficient-group zero-out, the
last-position search and the whole-block zero, in float64 numpy.  The
host CTB loop of `IntraEncoder.encode_frame` quantizes with it at
rdoq="full".  Each function keeps its name and text, and a comment gives
the original's line.  It is a different function from the device RDOQ
(float32, the frozen slice-initial contexts): their levels can differ.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import ctx as ctx_mod
from video_codecs_tpu_torch.entropy import residual
from video_codecs_tpu_torch.entropy.cabac import NEXT_STATE_LPS, NEXT_STATE_MPS
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.utils import rom

_SCALE_BITS = 15  # fractional-bit fixed point, 32768 = one bit


# video_codecs_tpu/ops/rdoq.py:44
def _entropy_bits_table() -> np.ndarray:
    """fracBits[packed_state ^ bin] in 2^15 units (see module docstring)."""
    alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
    tab = np.zeros(128, np.int64)
    for s in range(128):
        pstate, mps = s >> 1, s & 1
        p_lps = 0.5 * alpha ** pstate
        # index convention: state ^ bin has LSB 0 when bin == MPS
        tab[s] = round(-np.log2((1.0 - p_lps) if mps == 0 else p_lps)
                       * (1 << _SCALE_BITS))
    return tab


ENTROPY_BITS = _entropy_bits_table()
_BYPASS = 1 << _SCALE_BITS


# video_codecs_tpu/ops/rdoq.py:61
def frac_bits(states: np.ndarray, ctx: int, bin_val: int) -> int:
    """Estimated fractional bits (2^15 scale) to code bin_val in ctx."""
    return int(ENTROPY_BITS[int(states[ctx]) ^ bin_val])


# video_codecs_tpu/ops/rdoq.py:66
def _rate_level(level: int, one_bits, abs_bits, rice: int,
                c1_idx: int, c2_idx: int) -> int:
    """xGetICRate: frac bits for abs level (>0) given live context bits.

    one_bits/abs_bits are (bits0, bits1) pairs for the live greater1 /
    greater2 contexts.
    """
    rate = _BYPASS  # sign bypass bin
    base_level = (2 + (1 if c2_idx == 0 else 0)) if c1_idx < 8 else 1
    if level >= base_level:
        symbol = level - base_level
        if symbol < (3 << rice):
            # short Golomb-Rice codeword (residual._encode_remainder)
            length = (symbol >> rice) + 1 + rice
        else:
            # unary-exp-Golomb escape
            value = symbol - (3 << rice)
            k = rice
            while value >= (1 << k):
                value -= 1 << k
                k += 1
            length = (3 + k + 1 - rice) + k
        rate += length << _SCALE_BITS
        if c1_idx < 8:
            rate += one_bits[1]
            if c2_idx == 0:
                rate += abs_bits[1]
    elif level == 1:
        rate += one_bits[0]
    elif level == 2:
        rate += one_bits[1] + abs_bits[0]
    return rate


# video_codecs_tpu/ops/rdoq.py:100
def rdoq_np(coeff: np.ndarray, qp: int, log2_size: int, *, lam: float,
            scan_type: int = rom.SCAN_DIAG, is_luma: bool = True,
            states: np.ndarray | None = None, slice_type: int = 2,
            bit_depth: int = 8, allow_all_zero: bool = True,
            adapt_ctx: bool = True) -> np.ndarray:
    """Full RDOQ of one TU's transform coefficients [N, N] -> levels [N, N].

    states: CABAC context snapshot for rate estimation (defaults to the
    slice-initial states for slice_type at this QP).  A local copy is
    adapted during the search; the caller's array is never mutated.
    Estimates affect only encoder decisions, never stream validity.
    """
    n = 1 << log2_size
    if states is None:
        states = ctx_mod.init_states(slice_type, qp)
    st = states.copy()
    ent = ENTROPY_BITS

    def fb(ctx_idx):
        s = int(st[ctx_idx])
        return int(ent[s]), int(ent[s ^ 1])

    def adapt(ctx_idx, bin_val):
        # adapt_ctx=False freezes the snapshot (HM's estBits behavior;
        # the device twin rdoq_jax matches this mode bit-for-bit)
        if not adapt_ctx:
            return
        s = int(st[ctx_idx])
        if bin_val == (s & 1):
            st[ctx_idx] = NEXT_STATE_MPS[s]
        else:
            st[ctx_idx] = NEXT_STATE_LPS[s]

    per, rem = qp // 6, qp % 6
    q_bits = rom.QUANT_SHIFT + per + quant_ops.transform_shift(
        log2_size, bit_depth)
    scale = int(rom.QUANT_SCALES[rem])
    lam_td = lam * float(4 ** (15 - bit_depth - log2_size))
    # distortion is computed on levelDouble = |c|*scale (one level step is
    # 2^q_bits); rescale into the transform domain: D_td = dErr^2 / scale^2.
    err_scale = 1.0 / (float(scale) * float(scale))
    lam_bits = lam_td / (1 << _SCALE_BITS)  # cost per 2^-15 bit

    scan = rom.scan_order(log2_size, scan_type)
    flat = coeff.reshape(-1)
    c_scan = flat[scan].astype(np.int64)
    sign = np.sign(c_scan)
    level_double = np.abs(c_scan) * scale
    max_abs = ((level_double + (1 << (q_bits - 1))) >> q_bits).astype(np.int64)
    max_abs = np.minimum(max_abs, 32767)

    nn = n * n
    num_cg = nn >> 4
    cg_w = max(n >> 2, 1)
    cg_scan = rom.cg_scan_order(log2_size, scan_type)
    inner = rom.scan_order(2, scan_type)

    nzs = np.nonzero(max_abs)[0]
    if nzs.size == 0:
        return np.zeros((n, n), np.int32)
    last_scan_pos = int(nzs[-1])
    last_cg = last_scan_pos >> 4

    def dist0(i):
        d = float(level_double[i])
        return d * d * err_scale

    def dist(i, level):
        d = float(level_double[i] - (level << q_bits))
        return d * d * err_scale

    first_ctx = residual.first_sig_map_ctx(log2_size, scan_type, is_luma)
    single = first_ctx == residual._SIG_START[is_luma]["single"]
    sig_base = ctx_mod.off("sig_flag", 0 if is_luma else 28)
    one_base0 = ctx_mod.off("one_flag", 0 if is_luma else 16)
    abs_base0 = ctx_mod.off("abs_flag", 0 if is_luma else 4)
    cg_base = ctx_mod.off("sig_cg", 0 if is_luma else 2)
    # last-position prefix bins (coded once; static estimate is exact here)
    loff, lshift = residual._last_ctx_params(log2_size, is_luma)
    bx, by = ctx_mod.off("last_x"), ctx_mod.off("last_y")
    max_group = (log2_size << 1) - 1
    last_x_bits = [fb(bx + loff + (i >> lshift)) for i in range(max_group)]
    last_y_bits = [fb(by + loff + (i >> lshift)) for i in range(max_group)]

    def rate_last(pos_x, pos_y):
        gx = int(residual.GROUP_IDX[pos_x])
        gy = int(residual.GROUP_IDX[pos_y])
        rate = 0
        for i in range(gx):
            rate += last_x_bits[i][1]
        if gx < max_group:
            rate += last_x_bits[gx][0]
        for i in range(gy):
            rate += last_y_bits[i][1]
        if gy < max_group:
            rate += last_y_bits[gy][0]
        if gx > 3:
            rate += ((gx >> 1) - 1) << _SCALE_BITS
        if gy > 3:
            rate += ((gy >> 1) - 1) << _SCALE_BITS
        return rate

    def sig_ctx(i):
        """Context index for sig_coeff_flag at scan position i."""
        cg_i = i >> 4
        cg_raster = int(cg_scan[cg_i])
        cg_y, cg_x = divmod(cg_raster, cg_w)
        right = int(cg_sig[cg_raster + 1]) if cg_x + 1 < cg_w else 0
        below = int(cg_sig[cg_raster + cg_w]) if cg_y + 1 < cg_w else 0
        pattern = right + 2 * below
        r_in = int(inner[i & 15])
        py, px = divmod(r_in, 4)
        pos_x, pos_y = (cg_x << 2) + px, (cg_y << 2) + py
        if single:
            sc = first_ctx
        else:
            sc = residual.sig_ctx_inc(pattern, pos_x, pos_y, log2_size,
                                      is_luma, first_ctx)
        return sig_base + sc

    levels = np.zeros(nn, np.int64)
    cost_coeff = np.zeros(nn)   # chosen-level cost incl. its sig bit
    cost_sig = np.zeros(nn)     # sig-bit part of cost_coeff
    cost_zero = np.zeros(nn)    # cost if this coeff is zeroed (dist only)
    for i in range(nn):
        cost_zero[i] = dist0(i)

    cg_sig = np.zeros(num_cg, np.int64)  # raster-indexed, decided high->low
    prev_c1 = 1

    for cg_i in range(last_cg, -1, -1):
        cg_raster = int(cg_scan[cg_i])
        base = cg_i * 16
        # context-set selection mirrors residual.encode_residual
        ctx_set = (0 if (cg_i == 0 or not is_luma) else 2)
        if prev_c1 == 0:
            ctx_set += 1
        c1 = 1
        c1_idx = 0
        c2_idx = 0
        rice = 0
        cg_has_coef = False

        top = min(last_scan_pos, base + 15)
        for i in range(top, base - 1, -1):
            is_last = (i == last_scan_pos)
            sc = None if is_last else sig_ctx(i)
            sb = (0, 0) if is_last else fb(sc)
            ma = int(max_abs[i])
            # candidate levels: 0, ma, ma-1 (HM xGetCodedLevel)
            best_l = 0
            best_j = dist0(i) + lam_bits * sb[0]
            one_ctx_idx = one_base0 + ctx_set * 4 + c1
            abs_ctx_idx = abs_base0 + ctx_set
            if ma > 0:
                one_bits = fb(one_ctx_idx)
                abs_bits = fb(abs_ctx_idx)
                for lvl in range(max(1, ma - 1), ma + 1):
                    j = (dist(i, lvl) + lam_bits *
                         (sb[1] + _rate_level(lvl, one_bits, abs_bits,
                                              rice, c1_idx, c2_idx)))
                    if j < best_j:
                        best_l, best_j = lvl, j
            levels[i] = best_l
            cost_coeff[i] = best_j
            cost_sig[i] = lam_bits * (sb[1] if best_l else sb[0])
            # adapt the local contexts exactly as the coder will
            if sc is not None:
                adapt(sc, 1 if best_l else 0)
            if best_l:
                cg_has_coef = True
                if c1_idx < 8:
                    adapt(one_ctx_idx, 1 if best_l > 1 else 0)
                    if best_l > 1:
                        if c2_idx == 0:
                            adapt(abs_ctx_idx, 1 if best_l > 2 else 0)
                            c2_idx = 1
                        c1 = 0
                    elif 0 < c1 < 3:
                        c1 += 1
                    c1_idx += 1
                if best_l > (3 << rice):
                    rice = min(rice + 1, 4)

        cg_sig[cg_raster] = 1 if cg_has_coef else 0
        prev_c1 = c1

        # CG zero-out decision (not for CG 0 / the last CG: flags inferred)
        if 0 < cg_i < last_cg:
            cg_y, cg_x = divmod(cg_raster, cg_w)
            right = int(cg_sig[cg_raster + 1]) if cg_x + 1 < cg_w else 0
            below = int(cg_sig[cg_raster + cg_w]) if cg_y + 1 < cg_w else 0
            cg_ctx = cg_base + (1 if (right or below) else 0)
            bits = fb(cg_ctx)
            if cg_has_coef:
                j_keep = cost_coeff[base:base + 16].sum() + lam_bits * bits[1]
                j_zero = cost_zero[base:base + 16].sum() + lam_bits * bits[0]
                if j_zero < j_keep:
                    levels[base:base + 16] = 0
                    cost_coeff[base:base + 16] = cost_zero[base:base + 16]
                    cost_sig[base:base + 16] = 0
                    cg_sig[cg_raster] = 0
                    adapt(cg_ctx, 0)
                else:
                    adapt(cg_ctx, 1)
            else:
                adapt(cg_ctx, 0)

    # ---- last-position optimization ----
    coded = np.nonzero(levels)[0]
    if coded.size == 0:
        return np.zeros((n, n), np.int32)

    total_zero = cost_zero.sum()  # cbf=0 alternative
    prefix = np.concatenate(([0.0], np.cumsum(cost_coeff)))
    suffix_zero = np.concatenate((np.cumsum(cost_zero[::-1])[::-1], [0.0]))

    best_total = None
    best_last = None
    for p in coded[::-1]:
        p = int(p)
        raster = int(scan[p])
        ly, lx = divmod(raster, n)
        if scan_type == rom.SCAN_VER:
            lx, ly = ly, lx
        # choosing p as last: positions < p keep their decided cost;
        # position p pays its level cost without a sig bit; > p all zero.
        total = (prefix[p] + (cost_coeff[p] - cost_sig[p]) +
                 lam_bits * rate_last(lx, ly) + suffix_zero[p + 1])
        if best_total is None or total < best_total:
            best_total, best_last = total, p

    if allow_all_zero and total_zero < best_total:
        return np.zeros((n, n), np.int32)

    levels[best_last + 1:] = 0
    out = np.zeros(nn, np.int64)
    out[scan] = levels * sign
    return out.reshape(n, n).astype(np.int32)
