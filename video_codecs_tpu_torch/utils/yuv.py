"""Planar YUV 4:2:0 8-bit file I/O (the TVideoIOYuv analog).

The port's copy of video_codecs_tpu/utils/yuv.py, which the encoder and
decoder CLIs (tools/encoder_app.py, tools/decoder_app.py) read and
write their files with; each function keeps its name and a comment
gives the original's line.

Parity reference: hm-16.5rc1/source/Lib/TLibVideoIO/TVideoIOYuv.cpp.
"""

from __future__ import annotations

import numpy as np


# video_codecs_tpu/utils/yuv.py:11
def frame_size_bytes(width: int, height: int) -> int:
    return width * height * 3 // 2


# video_codecs_tpu/utils/yuv.py:15
def read_frames(path: str, width: int, height: int,
                num_frames: int | None = None, skip: int = 0) -> np.ndarray:
    """Returns (Y, U, V) stacked as a list of per-frame tuples.

    Output: object-free structure — tuple of arrays
    (y [F, H, W], u [F, H/2, W/2], v [F, H/2, W/2]) uint8.
    """
    fsz = frame_size_bytes(width, height)
    data = np.fromfile(path, dtype=np.uint8)
    total = data.size // fsz
    if num_frames is None:
        num_frames = total - skip
    num_frames = min(num_frames, total - skip)
    ys, us, vs = [], [], []
    cw, ch = width // 2, height // 2
    for f in range(skip, skip + num_frames):
        base = f * fsz
        y = data[base:base + width * height].reshape(height, width)
        u = data[base + width * height:base + width * height + cw * ch].reshape(ch, cw)
        v = data[base + width * height + cw * ch:base + fsz].reshape(ch, cw)
        ys.append(y)
        us.append(u)
        vs.append(v)
    return np.stack(ys), np.stack(us), np.stack(vs)


# video_codecs_tpu/utils/yuv.py:41
def write_frames(path: str, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
    with open(path, "wb") as f:
        for i in range(y.shape[0]):
            f.write(y[i].astype(np.uint8).tobytes())
            f.write(u[i].astype(np.uint8).tobytes())
            f.write(v[i].astype(np.uint8).tobytes())


# video_codecs_tpu/utils/yuv.py:49
def psnr(a: np.ndarray, b: np.ndarray, max_val: int = 255) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val * max_val / mse)
