"""H.264 level conformance (conformance.c / spec Annex A Table A-1).

The port's copy of the level half of video_codecs_tpu/tools/misc.py: the
Table A-1 limits, `level_limits`, `check_level_conformance` and
`minimum_level`, each as it is under its own name with a comment giving
the original's line.  The leaky-bucket and YUV->RGB tools are not
carried: the JM encoder CLI (tools/jm_encoder_app.py) reads only these.
"""

from __future__ import annotations

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
