"""HEVC intra prediction, batched over (blocks, modes).

Counterpart of video_codecs_tpu/ops/intra.py.  The host functions
(`filter_flag`, `_lin`, `_mode_weights`, `predict_intra_np`) are the
port's copies of the originals (each keeps its name and a comment gives
the original's line); the device functions take int32 tensors on any
device.

Reference sample layout: one 1-D array of 4N+1 samples per block,
    k = 0 .. 2N-1   left column bottom-to-top  (p[-1][2N-1] .. p[-1][0])
    k = 2N          top-left corner            (p[-1][-1])
    k = 2N+1 .. 4N  top row left-to-right      (p[0][-1] .. p[2N-1][-1])

Every HEVC intra mode is an integer linear map of [ref, smoothed ref]
followed by a rounding shift, so `predict_intra` evaluates all 35 modes of
a batch as one float32 matmul with the static weights of `_mode_weights`.
Weights and samples are integers and every accumulator stays below 2^24
(at most 16,352 for 32x32, 8,176 below), so the float32 product is exact
in any summation order, on the CPU and on the card (TF32 is off at the
package's import).  DC boundary filtering and the pure H/V edge filter
(luma, N <= 16) are elementwise fixups afterwards.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const

PLANAR, DC = 0, 1

# Per-mode angle/inverse-angle lookup (index = mode 0..34; 0 for planar/DC).
_ANGLES = np.zeros(35, np.int32)
_ANGLES[2:] = rom.INTRA_PRED_ANGLES
_INV_ABS = np.zeros(35, np.int32)
_INV_ABS[11:26] = -rom.INTRA_INV_ANGLES  # stored positive


# video_codecs_tpu/ops/intra.py:49
def substitute_unavailable(samples: torch.Tensor, avail: torch.Tensor,
                           bit_depth: int = 8) -> torch.Tensor:
    """Spec 8.4.4.2.2 reference substitution, vectorized.

    samples: [..., R] int32 raw neighbour samples (garbage where unavailable)
    avail:   [..., R] bool
    Each unavailable sample takes the nearest available predecessor; an
    unavailable prefix takes the first available sample; no sample
    available -> 1 << (bit_depth - 1)."""
    ar = torch.arange(samples.shape[-1], dtype=torch.int64,
                      device=samples.device)
    idx = torch.where(avail, ar, -1)
    last = torch.cummax(idx, dim=-1).values
    any_avail = avail.any(dim=-1, keepdim=True)
    first_idx = torch.argmax(avail.int(), dim=-1, keepdim=True)
    src = torch.where(last >= 0, last, first_idx)
    filled = torch.gather(samples.int(), -1, src)
    return torch.where(any_avail, filled, 1 << (bit_depth - 1)).int()


# video_codecs_tpu/ops/intra.py:69
def smooth_reference(ref: torch.Tensor) -> torch.Tensor:
    """1-2-1 intra smoothing over the linear reference array, ends kept."""
    mid = (ref[..., :-2] + 2 * ref[..., 1:-1] + ref[..., 2:] + 2) >> 2
    return torch.cat([ref[..., :1], mid, ref[..., -1:]], dim=-1)


# video_codecs_tpu/ops/intra.py:75
def filter_flag(mode: int, log2_size: int, is_luma: bool) -> bool:
    """Spec 8.4.4.2.3 reference-smoothing decision (static)."""
    if not is_luma or log2_size == 2 or mode == DC:
        return False
    thresh = {3: 7, 4: 1, 5: 0}[log2_size]
    dist = min(abs(mode - 26), abs(mode - 10))
    return dist > thresh


# video_codecs_tpu/ops/intra.py:84
def _lin(main_is_top: bool, n: int, *, main_t: int | None = None,
         side_t: int | None = None) -> int:
    """Linear ref index of main[t] / side[t] for a vertical- or
    horizontal-family mode (main = top row for vertical modes)."""
    t = main_t if main_t is not None else side_t
    on_top = main_is_top == (main_t is not None)
    if t == 0:
        return 2 * n  # corner
    return (2 * n + t) if on_top else (2 * n - t)


# video_codecs_tpu/ops/intra.py:95
@functools.lru_cache(maxsize=None)
def _mode_weights(log2_size: int, is_luma: bool):
    """Static weight tensor: W[35, N*N, 2R] over [ref, smoothed_ref];
    plus bias[35] and the common shift S."""
    n = 1 << log2_size
    r = 4 * n + 1
    s_common = max(5, log2_size + 1)
    w = np.zeros((35, n * n, 2 * r), np.float32)
    bias = np.zeros(35, np.int32)

    for mode in range(35):
        half = r if filter_flag(mode, log2_size, is_luma) else 0

        def put(p, lin_idx, weight, scale):
            w[mode, p, half + lin_idx] += weight * scale

        if mode == PLANAR:
            s_m = log2_size + 1
            scale = 1 << (s_common - s_m)
            bias[mode] = n * scale
            for y in range(n):
                for x in range(n):
                    p = y * n + x
                    put(p, 2 * n - 1 - y, n - 1 - x, scale)   # left[y]
                    put(p, 3 * n + 1, x + 1, scale)           # top[n]
                    put(p, 2 * n + 1 + x, n - 1 - y, scale)   # top[x]
                    put(p, n - 1, y + 1, scale)               # left[n]
        elif mode == DC:
            s_m = log2_size + 1
            scale = 1 << (s_common - s_m)
            bias[mode] = n * scale
            for p in range(n * n):
                for i in range(n):
                    put(p, 2 * n + 1 + i, 1, scale)           # top[i]
                    put(p, 2 * n - 1 - i, 1, scale)           # left[i]
        else:
            angle = int(_ANGLES[mode])
            inv = int(_INV_ABS[mode])
            ver = mode >= 18
            scale = 1 << (s_common - 5)
            bias[mode] = 16 * scale

            def ext_lin(k):  # ext[k] = refMain[k - n] -> linear ref index
                if k >= n:
                    return _lin(ver, n, main_t=min(k - n, 2 * n))
                m_ = n - k
                s_idx = min((m_ * inv + 128) >> 8, 2 * n)
                return _lin(ver, n, side_t=s_idx)

            for y in range(n):
                pos = (y + 1) * angle
                iidx = pos >> 5
                fact = pos & 31
                for x in range(n):
                    p = (y * n + x) if ver else (x * n + y)
                    k0 = n + 1 + x + iidx
                    if fact:
                        put(p, ext_lin(k0), 32 - fact, scale)
                        put(p, ext_lin(k0 + 1), fact, scale)
                    else:
                        put(p, ext_lin(k0), 32, scale)
    return w, bias.astype(np.int32), s_common  # numpy: safe across traces


@functools.lru_cache(maxsize=None)
def _weights_dev(log2_size: int, is_luma: bool, device: torch.device):
    """`_mode_weights` on `device`: W as [35 * N*N, 2R] float32 and the
    bias, uploaded once per device."""
    w, bias, s_common = _mode_weights(log2_size, is_luma)
    return (const(w.reshape(w.shape[0] * w.shape[1], w.shape[2]), device,
                  torch.float32),
            const(bias, device, torch.int32), s_common)


# video_codecs_tpu/ops/intra.py:159
def predict_intra(ref: torch.Tensor, modes: torch.Tensor, log2_size: int, *,
                  is_luma: bool = True, bit_depth: int = 8) -> torch.Tensor:
    """Predict blocks for (batch, mode) pairs.

    ref:   [B, 4N+1] int32 substituted (unfiltered) reference samples
    modes: [B, M] int in 0..34
    returns [B, M, N, N] int32 predictions (row y, col x)."""
    n = 1 << log2_size
    nn = n * n
    maxval = (1 << bit_depth) - 1
    dev = ref.device
    w, bias, s_common = _weights_dev(log2_size, bool(is_luma), dev)

    ref = ref.int()
    ref_f = smooth_reference(ref)
    ref2 = torch.cat([ref, ref_f], dim=-1).float()
    # All 35 modes at once: [B, 2R] x [35*N*N, 2R]^T -> [B, 35, N*N].
    acc = torch.matmul(ref2, w.T).view(ref.shape[0], 35, nn)
    pred_all = (acc.int() + bias[None, :, None]) >> s_common
    del acc

    modes = modes.long()
    pred = torch.gather(pred_all, 1,
                        modes[..., None].expand(modes.shape + (nn,)))
    pred = pred.reshape(modes.shape + (n, n))

    # ---- elementwise fixups (luma, N <= 16) ----
    if is_luma and log2_size <= 4:
        corner = ref[:, 2 * n]
        left = ref[:, n:2 * n].flip(-1)         # left[0..n-1]
        top = ref[:, 2 * n + 1:3 * n + 1]       # top[0..n-1]
        ys = torch.arange(n, dtype=torch.int32, device=dev)
        xg = ys[None, None, None, :]
        yg = ys[None, None, :, None]

        dc = (top.sum(-1, dtype=torch.int32) + left.sum(-1, dtype=torch.int32)
              + n) >> (log2_size + 1)
        dcb = dc[:, None, None, None]
        row0 = (top[:, None, None, :] + 3 * dcb + 2) >> 2
        col0 = (left[:, None, :, None] + 3 * dcb + 2) >> 2
        corn = (left[:, 0, None, None, None] + 2 * dcb +
                top[:, 0, None, None, None] + 2) >> 2
        is_dc = (modes == DC)[..., None, None]
        pred = torch.where(is_dc & (yg == 0), row0, pred)
        pred = torch.where(is_dc & (xg == 0) & (yg != 0), col0, pred)
        pred = torch.where(is_dc & (xg == 0) & (yg == 0), corn, pred)

        # Pure vertical (26): column 0 gets top[0] + (left[y]-corner)>>1.
        vfix = (top[:, 0, None, None, None] +
                ((left[:, None, :, None] - corner[:, None, None, None]) >> 1)
                ).clamp(0, maxval)
        pred = torch.where((modes == 26)[..., None, None] & (xg == 0),
                           vfix, pred)
        # Pure horizontal (10): row 0 gets left[0] + (top[x]-corner)>>1.
        hfix = (left[:, 0, None, None, None] +
                ((top[:, None, None, :] - corner[:, None, None, None]) >> 1)
                ).clamp(0, maxval)
        pred = torch.where((modes == 10)[..., None, None] & (yg == 0),
                           hfix, pred)

    return pred.clamp(0, maxval).int()


# video_codecs_tpu/ops/intra.py:219
def predict_intra_np(ref: np.ndarray, mode: int, log2_size: int, *,
                     is_luma: bool = True, bit_depth: int = 8) -> np.ndarray:
    """Host twin: predict ONE block/mode with the same static weights.

    Used by the sequential host reference encoder/decoder paths where a
    per-block numpy matvec beats a device dispatch.
    """
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    w, bias, s_common = _mode_weights(log2_size, is_luma)
    w = w[mode]                          # [N*N, 2R]
    ref = np.asarray(ref, np.int64)
    mid = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
    ref_f = np.concatenate([ref[:1], mid, ref[-1:]])
    ref2 = np.concatenate([ref, ref_f])
    pred = ((w.astype(np.int64) @ ref2 + int(bias[mode])) >> s_common)
    pred = pred.reshape(n, n)

    if is_luma and log2_size <= 4:
        corner = int(ref[2 * n])
        left = ref[2 * n - 1:n - 1:-1]
        top = ref[2 * n + 1:3 * n + 1]
        if mode == DC:
            dc = int((top.sum() + left.sum() + n) >> (log2_size + 1))
            pred[0, 1:] = (top[1:] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:] + 3 * dc + 2) >> 2
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
        elif mode == 26:
            pred[:, 0] = np.clip(top[0] + ((left - corner) >> 1), 0, maxval)
        elif mode == 10:
            pred[0, :] = np.clip(left[0] + ((top - corner) >> 1), 0, maxval)
    return np.clip(pred, 0, maxval).astype(np.int32)


# video_codecs_tpu/ops/intra.py:253
def use_filtered_ref(modes: torch.Tensor, log2_size: int,
                     is_luma: bool) -> torch.Tensor:
    """Spec 8.4.4.2.3 filterFlag per mode (bool, broadcast over modes)."""
    if not is_luma or log2_size == 2:
        return torch.zeros_like(modes, dtype=torch.bool)
    thresh = {3: 7, 4: 1, 5: 0}[log2_size]
    dist = torch.minimum((modes - 26).abs(), (modes - 10).abs())
    return (modes != DC) & (dist > thresh)
