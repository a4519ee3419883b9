"""Quality metrics: SSIM, MS-SSIM, SSIM3D, STVSSIM and the visual
attention model that drives the H.264 coder's perceptual RDO.

The port's copy of video_codecs_tpu/ops/metrics.py in PyTorch: each
function keeps its name and a comment gives the original's line.  The
reference's XLA convolutions (not Pallas kernels) are
`torch.nn.functional.conv2d` / `conv3d` in float32 on an explicit
`device`, TF32 off (the package's import turns it off); inputs are numpy arrays or tensors, and maps come
back as float32 tensors on that device.  Summation orders differ from
XLA's, so values agree to a few float32 ulps, not bit for bit.

Parity references: jm18.5/lencod/src/img_dist_ssim.c / img_dist_ms_ssim.c
(8x8 uniform-window SSIM, 5-scale MS-SSIM), stvssim_src/stvssimrdo2_att/
lencod/src/stvssim.c — compute_SSIM :491 (sliding window), compute_SSIM3D
:1093 (temporal-volume SSIM over a frame window), compute_stVSSIM :587
(motion-oriented spatio-temporal kernels), per-MB distortions used in the
perceptual RDO hook (rdopt.c:469-481).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1 = (0.01 * 255) ** 2
C2 = (0.03 * 255) ** 2


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


# video_codecs_tpu/ops/metrics.py:24
def _box_moments(x: torch.Tensor, win: int):
    """Mean/e2 maps via a uniform win x win window (valid positions)."""
    k = torch.ones((1, 1, win, win), dtype=torch.float32,
                   device=x.device) / (win * win)

    def conv(a):
        return F.conv2d(a[None, None], k)[0, 0]
    m = conv(x)
    m2 = conv(x * x)
    return m, m2


# video_codecs_tpu/ops/metrics.py:37
def ssim_map(a, b, win: int = 8, device="cuda") -> torch.Tensor:
    """SSIM index map (uniform window, JM img_dist_ssim.c style)."""
    a = _f32(a, device)
    b = _f32(b, device)
    ma, maa = _box_moments(a, win)
    mb, mbb = _box_moments(b, win)
    k = torch.ones((1, 1, win, win), dtype=torch.float32,
                   device=a.device) / (win * win)
    mab = F.conv2d((a * b)[None, None], k)[0, 0]
    va = maa - ma * ma
    vb = mbb - mb * mb
    cov = mab - ma * mb
    return ((2 * ma * mb + C1) * (2 * cov + C2) /
            ((ma * ma + mb * mb + C1) * (va + vb + C2)))


# video_codecs_tpu/ops/metrics.py:55
def ssim(a, b, win: int = 8, device="cuda") -> float:
    return float(torch.mean(ssim_map(a, b, win, device)))


# video_codecs_tpu/ops/metrics.py:59
def ms_ssim(a, b, win: int = 8, device="cuda") -> float:
    """5-scale MS-SSIM (img_dist_ms_ssim.c weights)."""
    weights = [0.0448, 0.2856, 0.3001, 0.2363, 0.1333]
    a = _f32(a, device)
    b = _f32(b, device)
    vals = []
    for lvl in range(5):
        wn = min(win, a.shape[0], a.shape[1])
        vals.append(float(torch.mean(ssim_map(a, b, wn, device))))
        if lvl < 4:
            h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
            a, b = a[:h2, :w2], b[:h2, :w2]
            a = (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] +
                 a[1::2, 1::2]) / 4
            b = (b[0::2, 0::2] + b[1::2, 0::2] + b[0::2, 1::2] +
                 b[1::2, 1::2]) / 4
            if min(a.shape) < 2:
                break
    out = 1.0
    for w, v in zip(weights[:len(vals)], vals):
        out *= max(v, 1e-6) ** w
    return out


# video_codecs_tpu/ops/metrics.py:83
def ssim3d(ref_stack, enc_stack, win: int = 8, device="cuda") -> float:
    """Volume SSIM over a temporal window (stvssim.c compute_SSIM3D :1093):
    moments pooled over (t, y, x) boxes."""
    a = _f32(ref_stack, device)
    b = _f32(enc_stack, device)
    t = a.shape[0]
    k = torch.ones((1, 1, t, win, win), dtype=torch.float32,
                   device=a.device) / (t * win * win)

    def conv(x):
        return F.conv3d(x[None, None], k)[0, 0]
    ma, mb = conv(a), conv(b)
    va = conv(a * a) - ma * ma
    vb = conv(b * b) - mb * mb
    cov = conv(a * b) - ma * mb
    m = ((2 * ma * mb + C1) * (2 * cov + C2) /
         ((ma * ma + mb * mb + C1) * (va + vb + C2)))
    return float(torch.mean(m))


# video_codecs_tpu/ops/metrics.py:104
def _oriented_kernels(length: int = 9) -> np.ndarray:
    """Four oriented line kernels (v/h/diag) like stvssim.c :116-334."""
    k = np.zeros((4, length, length), np.float32)
    c = length // 2
    for i in range(length):
        k[0, i, c] = 1.0          # vertical
        k[1, c, i] = 1.0          # horizontal
        k[2, i, i] = 1.0          # diagonal \
        k[3, i, length - 1 - i] = 1.0  # diagonal /
    return k / length


# video_codecs_tpu/ops/metrics.py:116
def stvssim(ref_stack, enc_stack, mvs=None, win: int = 8,
            device="cuda") -> float:
    """Spatio-temporal-view SSIM (stvssim.c compute_stVSSIM :587).

    Combines spatial SSIM of the current frame with SSIM along oriented
    spatio-temporal trajectories; mvs (optional [F, H, W, 2]) selects the
    dominant motion direction per region — without them the four fixed
    orientations are averaged (the reference's fallback when motion
    estimation confidence is low).
    """
    a = _f32(ref_stack, device)
    b = _f32(enc_stack, device)
    s_spatial = ssim(a[-1], b[-1], win, device)
    kerns = torch.as_tensor(_oriented_kernels(), device=a.device)
    # Filter each frame with each oriented kernel, then temporal SSIM of
    # the filtered trajectories.  XLA's "SAME" for a 9-tap kernel is a
    # padding of 4 on every side.

    def fil(x):
        return F.conv2d(x[:, None], kerns[:, None], padding=4)  # [F,4,H,W]
    fa, fb = fil(a), fil(b)
    ma = torch.mean(fa, dim=0)
    mb = torch.mean(fb, dim=0)
    va = torch.mean(fa * fa, dim=0) - ma * ma
    vb = torch.mean(fb * fb, dim=0) - mb * mb
    cov = torch.mean(fa * fb, dim=0) - ma * mb
    st = ((2 * ma * mb + C1) * (2 * cov + C2) /
          ((ma * ma + mb * mb + C1) * (va + vb + C2)))
    s_temporal = float(torch.mean(st))
    return 0.5 * (s_spatial + s_temporal)


# ---------------------------------------------------------------------------
# Visual attention / saliency (cAttention + attention.c parity)
# ---------------------------------------------------------------------------

# video_codecs_tpu/ops/metrics.py:149
def _gabor_bank(size: int = 9, orientations: int = 4) -> np.ndarray:
    """Gabor kernels (gabor.c parity) for orientation-contrast saliency."""
    ks = np.zeros((orientations, size, size), np.float32)
    c = size // 2
    yy, xx = np.mgrid[-c:c + 1, -c:c + 1].astype(np.float32)
    for o in range(orientations):
        th = np.pi * o / orientations
        xr = xx * np.cos(th) + yy * np.sin(th)
        yr = -xx * np.sin(th) + yy * np.cos(th)
        g = np.exp(-(xr ** 2 + 0.25 * yr ** 2) / (2 * 2.5 ** 2)) * \
            np.cos(2 * np.pi * xr / 4.0)
        g -= g.mean()
        ks[o] = g
    return ks


# video_codecs_tpu/ops/metrics.py:167
def saliency_map(y, prev_y=None, device="cuda") -> torch.Tensor:
    """Itti-style static (+ motion) saliency (attention.c:450 semantics):
    intensity center-surround + Gabor orientation energy + |frame diff|."""
    x = _f32(y, device)
    # intensity center-surround: |x - blur(x)|
    k = torch.ones((1, 1, 9, 9), dtype=torch.float32,
                   device=x.device) / 81.0
    blur = F.conv2d(x[None, None], k, padding=4)[0, 0]
    intensity = torch.abs(x - blur)
    gab = torch.as_tensor(_gabor_bank(), device=x.device)
    orient = F.conv2d(x[None, None], gab[:, None], padding=4)[0]
    orientation = torch.mean(torch.abs(orient), dim=0)
    sal = intensity / (intensity.max() + 1e-6) + \
        orientation / (orientation.max() + 1e-6)
    if prev_y is not None:
        motion = torch.abs(x - _f32(prev_y, device))
        sal = sal + motion / (motion.max() + 1e-6)
    return sal / sal.max()


# video_codecs_tpu/ops/metrics.py:188
def attention_lambda_weights(sal: torch.Tensor, block: int = 16,
                             strength: float = 0.5) -> torch.Tensor:
    """Per-block lambda modulation eta (mode_decision.c:140-151 semantics):
    salient blocks get lambda scaled down (more bits), background up."""
    h, w = sal.shape
    blocks = sal[:h - h % block, :w - w % block].reshape(
        h // block, block, w // block, block).permute(0, 2, 1, 3).reshape(
        h // block, w // block, block * block)
    # XLA sums each block in float32 one pixel after another, in raster
    # order; so does this loop (the float32 sums, then the division)
    acc = torch.zeros(blocks.shape[:2], dtype=torch.float32,
                      device=sal.device)
    for i in range(block * block):
        acc = acc + blocks[..., i]
    bs = acc / (block * block)
    # jnp.std is the population deviation (ddof 0)
    eta = 1.0 + strength * (bs.mean() - bs) / (bs.std(correction=0) + 1e-6)
    return torch.clamp(eta, 0.5, 2.0)
