"""JM miscellaneous tools: leaky-bucket analysis, level conformance, YUV->RGB.

The port's copy of video_codecs_tpu/tools/misc.py, whole: each function
as it is under its own name with a comment giving the original's line.

Parity references (behavior only, re-implemented vectorized):
  - jm18.5/lencod/src/leaky_bucket.c (calc_buffer/write_buffer): per-bucket
    minimum decoder buffer size and initial fullness from the per-frame bit
    trace, written as big-endian u32 triples.
  - jm18.5/lencod/src/conformance.c + spec Annex A Table A-1: level limit
    checks (MaxMBPS/MaxFS/MaxDpbMbs/MaxBR/MaxCPB/MinCR).
  - jm18.5/lencod/src/cconv_yuv2rgb.c (YUVtoRGB): ITU-R BT.601 integer
    conversion with the studio-swing Y offset, chroma upsampled by repetition.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# Leaky bucket (leaky_bucket.c)
# ---------------------------------------------------------------------------


# video_codecs_tpu/tools/misc.py:24
def leaky_bucket_params(bits_per_frame, frame_rate: float,
                        rates=None, n_buckets: int = 8):
    """Per-bucket (R, B, F): channel rate bits/s, min buffer bits, min
    initial fullness bits, for a recorded per-frame bit trace.

    Default rates follow calc_buffer: bucket 0 = average rate, each further
    bucket +avg/4 per second.  For each rate, simulate the decoder buffer
    (drain one frame's bits per tick, refill at R/fps, cap at the running
    maximum) to find the deepest underflow => required buffer, then replay
    from fullness = first-frame bits to find the minimum startup fullness.
    """
    bits = np.asarray(bits_per_frame, dtype=np.int64)
    if bits.size == 0:
        raise ValueError("empty bit trace")
    avg = int(bits.mean())
    if rates is None:
        rates = [int((avg + i * (avg // 4)) * frame_rate)
                 for i in range(n_buckets)]
    rates = sorted(int(r) for r in rates)

    out = []
    cap = avg * 20  # analysis ceiling, as in calc_buffer
    for rate in rates:
        per_tick = int(rate / frame_rate)
        # Pass 1: find required buffer depth starting full at the ceiling.
        level = cap
        min_level, min_at = cap, 0
        for i, b in enumerate(bits):
            level -= int(b)
            if level < min_level:
                min_level, min_at = level, i
            level = min(level + per_tick, cap)
        need = cap - min_level
        # Pass 2: smallest initial fullness that survives until the
        # deepest-underflow frame (deficits before it add to the startup).
        fullness = int(bits[0])
        level = fullness
        for i in range(min_at + 1):
            level -= int(bits[i])
            if level < 0:
                fullness -= level
                level = 0
            level += per_tick
            if level > need:
                break
        out.append((rate, need, fullness))
    return out


# video_codecs_tpu/tools/misc.py:73
def write_leaky_bucket_file(path, params) -> None:
    """Serialize (R, B, F) triples in the JM param-file layout:
    big-endian u32 count, then u32 R/B/F per bucket (write_buffer)."""
    with open(path, "wb") as f:
        f.write(struct.pack(">I", len(params)))
        for r, b, fl in params:
            f.write(struct.pack(">III", r & 0xFFFFFFFF, b & 0xFFFFFFFF,
                                fl & 0xFFFFFFFF))


# video_codecs_tpu/tools/misc.py:83
def read_leaky_bucket_file(path):
    with open(path, "rb") as f:
        (n,) = struct.unpack(">I", f.read(4))
        return [struct.unpack(">III", f.read(12)) for _ in range(n)]


# ---------------------------------------------------------------------------
# Level conformance (conformance.c / spec Annex A Table A-1)
# ---------------------------------------------------------------------------

# level_idc -> (MaxMBPS MB/s, MaxFS MBs, MaxDpbMbs, MaxBR kbit/s units,
#               MaxCPB kbit units, MinCR).  Spec Table A-1; level 9 is the
#   "1b" row (level_idc 9, or 11 + constraint_set3_flag).
_TABLE_A1 = {
    9:  (1485, 99, 396, 128, 350, 2),
    10: (1485, 99, 396, 64, 175, 2),
    11: (3000, 396, 900, 192, 500, 2),
    12: (6000, 396, 2376, 384, 1000, 2),
    13: (11880, 396, 2376, 768, 2000, 2),
    20: (11880, 396, 2376, 2000, 2000, 2),
    21: (19800, 792, 4752, 4000, 4000, 2),
    22: (20250, 1620, 8100, 4000, 4000, 2),
    30: (40500, 1620, 8100, 10000, 10000, 2),
    31: (108000, 3600, 18000, 14000, 14000, 4),
    32: (216000, 5120, 20480, 20000, 20000, 4),
    40: (245760, 8192, 32768, 20000, 25000, 4),
    41: (245760, 8192, 32768, 50000, 62500, 2),
    42: (522240, 8704, 34816, 50000, 62500, 2),
    50: (589824, 22080, 110400, 135000, 135000, 2),
    51: (983040, 36864, 184320, 240000, 240000, 2),
    52: (2073600, 36864, 184320, 240000, 240000, 2),
}

# cpbBrVclFactor for Baseline/Main/Extended (Table A-1 note): bits = x * 1200.
_VCL_FACTOR = 1200


# video_codecs_tpu/tools/misc.py:120
def level_limits(level_idc: int) -> dict:
    if level_idc not in _TABLE_A1:
        raise ValueError(f"unknown level_idc {level_idc}")
    mbps, fs, dpb_mbs, br, cpb, mincr = _TABLE_A1[level_idc]
    return {"MaxMBPS": mbps, "MaxFS": fs, "MaxDpbMbs": dpb_mbs,
            "MaxBR": br * _VCL_FACTOR, "MaxCPB": cpb * _VCL_FACTOR,
            "MinCR": mincr}


# video_codecs_tpu/tools/misc.py:129
def check_level_conformance(width: int, height: int, frame_rate: float,
                            level_idc: int, bitrate_bps: float = 0,
                            dpb_frames: int = 0, cpb_bits: int = 0) -> list:
    """Return a list of human-readable violations of Annex-A level limits
    (empty list == conformant).  Mirrors the lencod LevelCheck gates:
    frame size in MBs, MB processing rate, DPB size, bit rate, CPB size.
    """
    lim = level_limits(level_idc)
    mbs = ((width + 15) // 16) * ((height + 15) // 16)
    bad = []
    if mbs > lim["MaxFS"]:
        bad.append(f"frame size {mbs} MBs > MaxFS {lim['MaxFS']}")
    # A.3.1: frame width/height each <= sqrt(MaxFS*8) MBs
    side = int((lim["MaxFS"] * 8) ** 0.5)
    if (width + 15) // 16 > side:
        bad.append(f"width {(width + 15) // 16} MBs > sqrt(8*MaxFS) {side}")
    if (height + 15) // 16 > side:
        bad.append(f"height {(height + 15) // 16} MBs > sqrt(8*MaxFS) {side}")
    if mbs * frame_rate > lim["MaxMBPS"]:
        bad.append(f"MB rate {mbs * frame_rate:.0f}/s > "
                   f"MaxMBPS {lim['MaxMBPS']}")
    if dpb_frames and dpb_frames * mbs > lim["MaxDpbMbs"]:
        bad.append(f"DPB {dpb_frames} frames = {dpb_frames * mbs} MBs > "
                   f"MaxDpbMbs {lim['MaxDpbMbs']}")
    if bitrate_bps and bitrate_bps > lim["MaxBR"]:
        bad.append(f"bitrate {bitrate_bps:.0f} > MaxBR {lim['MaxBR']}")
    if cpb_bits and cpb_bits > lim["MaxCPB"]:
        bad.append(f"CPB {cpb_bits} bits > MaxCPB {lim['MaxCPB']}")
    return bad


# video_codecs_tpu/tools/misc.py:160
def minimum_level(width: int, height: int, frame_rate: float,
                  dpb_frames: int = 0) -> int:
    """Smallest level_idc whose limits admit the given stream geometry."""
    for idc in sorted(k for k in _TABLE_A1 if k != 9):
        if not check_level_conformance(width, height, frame_rate, idc,
                                       dpb_frames=dpb_frames):
            return idc
    raise ValueError("stream exceeds level 5.2 limits")


# ---------------------------------------------------------------------------
# YUV -> RGB (cconv_yuv2rgb.c, BT.601 studio swing)
# ---------------------------------------------------------------------------


# video_codecs_tpu/tools/misc.py:175
def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               bit_depth: int = 8) -> np.ndarray:
    """BT.601 integer conversion with the 16-offset studio-swing Y path,
    chroma upsampled by sample repetition (4:2:0/4:2:2 -> 4:4:4).

    Returns an (H, W, 3) array of the source dtype, R/G/B order.
    16.16 fixed-point weights match init_YUVtoRGB (K0..K4 * 65536).
    """
    y = np.asarray(y)
    h, w = y.shape
    # chroma repetition upsample to luma geometry
    ry = h // u.shape[0]
    rx = w // u.shape[1]
    uu = np.repeat(np.repeat(np.asarray(u), ry, 0), rx, 1)[:h, :w]
    vv = np.repeat(np.repeat(np.asarray(v), ry, 0), rx, 1)[:h, :w]

    scale = 65536.0
    wk = [int(round(scale * k)) for k in (1.164, 1.596, 0.391, 0.813, 2.018)]
    off_y = 16 << (bit_depth - 8)
    off_c = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1

    sy = wk[0] * (y.astype(np.int64) - off_y)
    su = uu.astype(np.int64) - off_c
    sv = vv.astype(np.int64) - off_c
    rnd = 1 << 15

    def clip(x):
        return np.clip((x + rnd) >> 16, 0, maxv)

    r = clip(sy + wk[1] * sv)
    g = clip(sy - wk[2] * su - wk[3] * sv)
    b = clip(sy + wk[4] * su)
    return np.stack([r, g, b], axis=-1).astype(y.dtype)
