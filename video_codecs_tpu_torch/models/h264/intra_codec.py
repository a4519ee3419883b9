"""H.264/AVC intra encoder + decoder: I_16x16, I_4x4 and I_8x8, CAVLC
and CABAC.

The port's copy of video_codecs_tpu/models/h264/intra_codec.py.  Each
function and class kept is carried as it is under its own name, with a
comment giving the original's line; the branches behind options the
port rejects are cut: perceptual RDO ("att", "ssim") and the
VCT_FORCE_I4 / VCT_FORCE_I8 debug flags (fixed off, no environment
variable is read).  The constructor raises on perceptual RDO, and the
decoder on weighted-prediction streams.  Kept: CAVLC and CABAC (Main
and High profile: the 8x8 transform and I_8x8), hard, trellis and
adaptive-rounding quantization, the intra MB of a B slice.

Toolset: baseline, Main and High profile, 4:2:0 8-bit, I slices of
I_16x16, I_4x4 and I_8x8 macroblocks, in-loop deblocking.

Parity references: SURVEY.md §2.6/3.3; jm18.5/lencod/src/intra16x16.c
(prediction modes), intra_chroma.c, vlc.c / cavlc tables (entropy/cavlc.py),
cabac.c (entropy/h264_cabac.py), lcommon transform.c + spec 8.5.10-12
(ops/h264_transform.py), parset.c (SPS/PPS), slice/MB syntax spec
7.3.3-7.3.5.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import cavlc
from video_codecs_tpu_torch.entropy import h264_cabac as hc
from video_codecs_tpu_torch.entropy.bitstream import (
    BitReader, BitWriter, insert_emulation_prevention, split_annexb,
    strip_emulation_prevention)
from video_codecs_tpu_torch.ops import h264_rdoq
from video_codecs_tpu_torch.ops import h264_transform as ht
from video_codecs_tpu_torch.ops.h264_deblock import deblock_frame_intra

NAL_SLICE_IDR = 5
NAL_SPS = 7
NAL_PPS = 8

# luma4x4BlkIdx -> (x4, y4) within the MB (spec 6.4.3).
_BLK_X = [2 * ((i8 & 1)) + (i4 & 1) for i8 in range(4) for i4 in range(4)]
_BLK_Y = [2 * ((i8 >> 1)) + (i4 >> 1) for i8 in range(4) for i4 in range(4)]


# video_codecs_tpu/models/h264/intra_codec.py:32
def nal_unit(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    header = bytes([(ref_idc << 5) | nal_type])
    return header + insert_emulation_prevention(rbsp)


# video_codecs_tpu/models/h264/intra_codec.py:37
def annexb(nals: list[bytes]) -> bytes:
    out = bytearray()
    for nal in nals:
        out += b"\x00\x00\x00\x01" + nal
    return bytes(out)


# video_codecs_tpu/models/h264/intra_codec.py:44
def write_sps(width_mbs: int, height_mbs: int, profile: int = 66,
              num_ref_frames: int = 1, poc_type: int = 2) -> bytes:
    w = BitWriter()
    w.write(profile, 8)  # 66 baseline (CAVLC), 77 main (CABAC), 100 high
    w.flag(1 if profile == 66 else 0)   # constraint_set0
    w.flag(1 if profile < 100 else 0)   # constraint_set1 (main-compatible)
    w.write(0, 6)    # other constraint flags + reserved
    w.write(30, 8)   # level_idc 3.0
    w.ue(0)          # sps_id
    if profile >= 100:   # High-profile SPS extension (spec 7.3.2.1.1)
        w.ue(1)          # chroma_format_idc 4:2:0
        w.ue(0)          # bit_depth_luma_minus8
        w.ue(0)          # bit_depth_chroma_minus8
        w.flag(0)        # qpprime_y_zero_transform_bypass
        w.flag(0)        # seq_scaling_matrix_present
    w.ue(4)          # log2_max_frame_num_minus4 -> 8 bits
    w.ue(poc_type)   # pic_order_cnt_type (0 for reordered/B streams)
    if poc_type == 0:
        w.ue(12)     # log2_max_pic_order_cnt_lsb_minus4 -> 16 bits
    w.ue(num_ref_frames)  # max_num_ref_frames
    w.flag(0)        # gaps_in_frame_num_value_allowed
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    w.flag(1)        # frame_mbs_only_flag
    w.flag(1)        # direct_8x8_inference_flag
    w.flag(0)        # frame_cropping_flag
    w.flag(0)        # vui_parameters_present_flag
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/h264/intra_codec.py:75
def write_pps(cabac: bool = False, weighted_pred: bool = False,
              transform8x8: bool = False) -> bytes:
    w = BitWriter()
    w.ue(0)          # pps_id
    w.ue(0)          # sps_id
    w.flag(1 if cabac else 0)  # entropy_coding_mode
    w.flag(0)        # bottom_field_pic_order_in_frame_present
    w.ue(0)          # num_slice_groups_minus1
    w.ue(0)          # num_ref_idx_l0_default_active_minus1
    w.ue(0)          # num_ref_idx_l1_default_active_minus1
    w.flag(1 if weighted_pred else 0)  # weighted_pred_flag
    w.write(0, 2)    # weighted_bipred_idc
    w.se(0)          # pic_init_qp_minus26
    w.se(0)          # pic_init_qs_minus26
    w.se(0)          # chroma_qp_index_offset
    w.flag(1)        # deblocking_filter_control_present_flag
    w.flag(0)        # constrained_intra_pred_flag
    w.flag(0)        # redundant_pic_cnt_present_flag
    if transform8x8:     # High-profile PPS tail (spec 7.3.2.2)
        w.flag(1)        # transform_8x8_mode_flag
        w.flag(0)        # pic_scaling_matrix_present
        w.se(0)          # second_chroma_qp_index_offset
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/h264/intra_codec.py:101
def parse_sps(rbsp: bytes, full: bool = False):
    r = BitReader(rbsp)
    profile = r.read(8)
    r.read(8)        # constraint flags
    r.read(8)        # level
    assert r.ue() == 0
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        assert r.ue() == 1, "chroma 4:2:0 only"  # chroma_format_idc
        assert r.ue() == 0 and r.ue() == 0       # 8-bit
        r.flag()                                 # qpprime_y_zero_transform
        assert r.flag() == 0, "scaling lists unsupported"
    log2_max_frame_num = r.ue() + 4
    poc_type = r.ue()
    log2_max_poc_lsb = 0
    if poc_type == 0:
        log2_max_poc_lsb = r.ue() + 4
    else:
        assert poc_type == 2, "pic_order_cnt_type 1 unsupported"
    num_ref_frames = r.ue()
    r.flag()
    wmb = r.ue() + 1
    hmb = r.ue() + 1
    assert r.flag() == 1, "frame_mbs_only required"
    r.flag()
    assert r.flag() == 0, "cropping unsupported"
    if full:
        return wmb, hmb, {"poc_type": poc_type,
                          "log2_max_frame_num": log2_max_frame_num,
                          "log2_max_poc_lsb": log2_max_poc_lsb,
                          "num_ref_frames": num_ref_frames,
                          "profile": profile}
    return wmb, hmb


# video_codecs_tpu/models/h264/intra_codec.py:135
def more_rbsp_data(r: BitReader) -> bool:
    """Spec 7.2: data remains before the rbsp_stop_one_bit."""
    data = r._data
    i = len(data) - 1
    while i >= 0 and data[i] == 0:
        i -= 1
    if i < 0:
        return False
    b = data[i]
    tz = (b & -b).bit_length() - 1        # trailing zeros
    stop_pos = i * 8 + (7 - tz)
    return r.bit_pos() < stop_pos


# video_codecs_tpu/models/h264/intra_codec.py:149
def parse_pps(rbsp: bytes, full: bool = False):
    """Returns (deblocking_filter_control_present, entropy_coding_mode),
    plus {num_ref_idx_l0_default_active, weighted_pred,
    transform_8x8_mode} when full=True."""
    r = BitReader(rbsp)
    assert r.ue() == 0 and r.ue() == 0
    cabac = bool(r.flag())
    r.flag()
    assert r.ue() == 0, "FMO unsupported"
    l0_default = r.ue() + 1
    r.ue()
    weighted_pred = bool(r.flag())
    weighted_bipred_idc = r.read(2)
    init_qp = 26 + r.se()
    r.se()
    assert r.se() == 0, "chroma qp offset unsupported"
    dbf_present = bool(r.flag())
    assert r.flag() == 0
    r.flag()
    assert init_qp == 26
    trans8 = False
    if more_rbsp_data(r):                 # High-profile PPS tail
        trans8 = bool(r.flag())           # transform_8x8_mode_flag
        assert r.flag() == 0, "pic scaling matrix unsupported"
        r.se()                            # second_chroma_qp_index_offset
    if full:
        return dbf_present, cabac, {"num_ref_idx_l0_default_active":
                                    l0_default,
                                    "weighted_pred": weighted_pred,
                                    "weighted_bipred_idc":
                                    weighted_bipred_idc,
                                    "transform_8x8_mode": trans8}
    return dbf_present, cabac


def _checked_pps(rbsp: bytes):
    """parse_pps(full=True) for the streams this decoder reads: raises
    NotImplementedError on weighted prediction.
    Returns (deblocking_filter_control_present, cabac, info)."""
    dbf_present, cabac, info = parse_pps(rbsp, full=True)
    if info["weighted_pred"] or info["weighted_bipred_idc"]:
        raise NotImplementedError("weighted prediction is not decoded")
    return dbf_present, cabac, info


# ---------------------------------------------------------------------------
# Intra prediction (spec 8.3.3 / 8.3.4)
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/h264/intra_codec.py:188
def pred_luma16(rec: np.ndarray, x: int, y: int, mode: int) -> np.ndarray:
    top = rec[y - 1, x:x + 16].astype(np.int32) if y > 0 else None
    left = rec[y:y + 16, x - 1].astype(np.int32) if x > 0 else None
    if mode == 0:    # vertical
        return np.tile(top, (16, 1))
    if mode == 1:    # horizontal
        return np.tile(left[:, None], (1, 16))
    if mode == 2:    # DC
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif top is not None:
            dc = (int(top.sum()) + 8) >> 4
        elif left is not None:
            dc = (int(left.sum()) + 8) >> 4
        else:
            dc = 128
        return np.full((16, 16), dc, np.int32)
    # plane
    corner = int(rec[y - 1, x - 1])
    hh = sum((i + 1) * (int(top[8 + i]) -
                        (int(top[6 - i]) if i < 7 else corner))
             for i in range(8))
    vv = sum((i + 1) * (int(left[8 + i]) -
                        (int(left[6 - i]) if i < 7 else corner))
             for i in range(8))
    a = 16 * (int(left[15]) + int(top[15]))
    b = (5 * hh + 32) >> 6
    c = (5 * vv + 32) >> 6
    xs = np.arange(16)
    out = (a + b * (xs[None, :] - 7) + c * (xs[:, None] - 7) + 16) >> 5
    return np.clip(out, 0, 255).astype(np.int32)


# video_codecs_tpu/models/h264/intra_codec.py:221
def pred_chroma8(rec: np.ndarray, x: int, y: int, mode: int) -> np.ndarray:
    top = rec[y - 1, x:x + 8].astype(np.int32) if y > 0 else None
    left = rec[y:y + 8, x - 1].astype(np.int32) if x > 0 else None
    if mode == 0:    # DC, per 4x4 quadrant (spec 8.3.4.1)
        out = np.zeros((8, 8), np.int32)
        for qy in (0, 4):
            for qx in (0, 4):
                t = top[qx:qx + 4] if top is not None else None
                l = left[qy:qy + 4] if left is not None else None
                if qx == qy:         # corner quadrants use both if avail
                    if t is not None and l is not None:
                        dc = (int(t.sum()) + int(l.sum()) + 4) >> 3
                    elif t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    else:
                        dc = 128
                elif qx == 4:        # top-right prefers top
                    if t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    else:
                        dc = 128
                else:                # bottom-left prefers left
                    if l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    elif t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    else:
                        dc = 128
                out[qy:qy + 4, qx:qx + 4] = dc
        return out
    if mode == 1:    # horizontal
        return np.tile(left[:, None], (1, 8))
    if mode == 2:    # vertical
        return np.tile(top, (8, 1))
    # plane
    corner = int(rec[y - 1, x - 1])
    hh = sum((i + 1) * (int(top[4 + i]) -
                        (int(top[2 - i]) if i < 3 else corner))
             for i in range(4))
    vv = sum((i + 1) * (int(left[4 + i]) -
                        (int(left[2 - i]) if i < 3 else corner))
             for i in range(4))
    a = 16 * (int(left[7]) + int(top[7]))
    b = (17 * hh + 16) >> 5
    c = (17 * vv + 16) >> 5
    xs = np.arange(8)
    out = (a + b * (xs[None, :] - 3) + c * (xs[:, None] - 3) + 16) >> 5
    return np.clip(out, 0, 255).astype(np.int32)



# CBP <-> codeNum mapping for 4:2:0 intra (JM vlc.c:32 NCBP[1][cbp][0]).
_NCBP_INTRA_420 = [3, 29, 30, 17, 31, 18, 37, 8, 32, 38, 19, 9,
                   20, 10, 11, 2, 16, 33, 34, 21, 35, 22, 39, 4,
                   36, 40, 23, 5, 24, 6, 7, 1, 41, 42, 43, 25,
                   44, 26, 46, 12, 45, 47, 27, 13, 28, 14, 15, 0]
_CBP_FROM_CODE_INTRA_420 = [0] * 48
for _cbp, _cn in enumerate(_NCBP_INTRA_420):
    _CBP_FROM_CODE_INTRA_420[_cn] = _cbp

# inverse of the 4x4 block order (x4, y4) -> luma4x4BlkIdx
_BLK_IDX = {}
for _i in range(16):
    _BLK_IDX[(_BLK_X[_i], _BLK_Y[_i])] = _i


# video_codecs_tpu/models/h264/intra_codec.py:291
def _decoded_before(gx4, gy4, cur_gx4, cur_gy4, mb_w):
    """Is 4x4 block (gx4, gy4) decoded before (cur_gx4, cur_gy4)?
    (MB raster order, _BLK order within the MB — spec 6.4.8/6.4.10.4.)"""
    mb_a = (gy4 // 4) * mb_w + (gx4 // 4)
    mb_b = (cur_gy4 // 4) * mb_w + (cur_gx4 // 4)
    if mb_a != mb_b:
        return mb_a < mb_b
    return _BLK_IDX[(gx4 % 4, gy4 % 4)] < _BLK_IDX[(cur_gx4 % 4,
                                                    cur_gy4 % 4)]


# video_codecs_tpu/models/h264/intra_codec.py:302
def gather_ref4(rec, x, y, mb_w):
    """Neighbor samples for a 4x4 intra block (spec 8.3.1.2): returns
    (l[4], t[8], c, avail dict).  Unavailable top-right replicated from
    t[3] when the top itself is available."""
    h, w = rec.shape
    gx4, gy4 = x // 4, y // 4

    def blk_ok(sx, sy):
        if sx < 0 or sy < 0 or sx >= w or sy >= h:
            return False
        return _decoded_before(sx // 4, sy // 4, gx4, gy4, mb_w)

    avail = {
        "l": blk_ok(x - 1, y),
        "t": blk_ok(x, y - 1),
        "tl": blk_ok(x - 1, y - 1),
        "tr": blk_ok(x + 4, y - 1),
    }
    l = np.array([rec[min(y + i, h - 1), x - 1] if avail["l"] else 0
                  for i in range(4)], np.int32)
    t = np.zeros(8, np.int32)
    if avail["t"]:
        t[:4] = rec[y - 1, x:x + 4]
        if avail["tr"]:
            t[4:] = rec[y - 1, x + 4:x + 8]
        else:
            t[4:] = t[3]
    c = rec[y - 1, x - 1] if avail["tl"] else 0
    return l, t, int(c), avail


# video_codecs_tpu/models/h264/intra_codec.py:333
def pred_luma4(l, t, c, avail, mode):
    """9-mode 4x4 intra prediction (spec 8.3.1.2.1-9)."""
    out = np.zeros((4, 4), np.int64)
    tt = np.zeros(9, np.int64)       # tt[0] = corner, tt[1+i] = t[i]
    tt[0] = c
    tt[1:] = t
    ll = np.zeros(5, np.int64)
    ll[0] = c
    ll[1:] = l
    if mode == 0:                    # vertical
        out[:, :] = t[:4]
    elif mode == 1:                  # horizontal
        out[:, :] = l[:, None]
    elif mode == 2:                  # DC
        if avail["t"] and avail["l"]:
            dc = (int(t[:4].sum()) + int(l.sum()) + 4) >> 3
        elif avail["t"]:
            dc = (int(t[:4].sum()) + 2) >> 2
        elif avail["l"]:
            dc = (int(l.sum()) + 2) >> 2
        else:
            dc = 128
        out[:, :] = dc
    elif mode == 3:                  # diagonal down-left
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    out[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    out[y, x] = (t[x + y] + 2 * t[x + y + 1] +
                                 t[x + y + 2] + 2) >> 2
    elif mode == 4:                  # diagonal down-right
        for y in range(4):
            for x in range(4):
                if x > y:
                    out[y, x] = (tt[x - y - 1] + 2 * tt[x - y] +
                                 tt[x - y + 1] + 2) >> 2
                elif x < y:
                    out[y, x] = (ll[y - x - 1] + 2 * ll[y - x] +
                                 ll[y - x + 1] + 2) >> 2
                else:
                    out[y, x] = (t[0] + 2 * c + l[0] + 2) >> 2
    elif mode == 5:                  # vertical-right
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    i = x - (y >> 1)
                    out[y, x] = (tt[i] + tt[i + 1] + 1) >> 1
                elif z >= 0:
                    i = x - (y >> 1)
                    out[y, x] = (tt[i - 1] + 2 * tt[i] + tt[i + 1] + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * c + t[0] + 2) >> 2
                else:
                    out[y, x] = (ll[y] + 2 * ll[y - 1] + ll[y - 2] + 2) >> 2
    elif mode == 6:                  # horizontal-down
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    out[y, x] = (ll[i] + ll[i + 1] + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    out[y, x] = (ll[i - 1] + 2 * ll[i] + ll[i + 1] + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * c + t[0] + 2) >> 2
                else:
                    out[y, x] = (tt[x] + 2 * tt[x - 1] + tt[x - 2] + 2) >> 2
    elif mode == 7:                  # vertical-left
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    out[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    out[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
    else:                            # 8: horizontal-up (spec 8.3.1.2.9)
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z in (0, 2, 4):
                    i = y + (x >> 1)
                    out[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z in (1, 3):
                    i = y + (x >> 1)
                    out[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 5:
                    out[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    out[y, x] = l[3]
    return np.clip(out, 0, 255)


# video_codecs_tpu/models/h264/intra_codec.py:428
def allowed_modes4(avail):
    modes = [2]
    if avail["t"]:
        modes += [0, 3, 7]
    if avail["l"]:
        modes += [1, 8]
    if avail["t"] and avail["l"] and avail["tl"]:
        modes += [4, 5, 6]
    return modes

# ---------------------------------------------------------------------------
# nC bookkeeping
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/h264/intra_codec.py:442
class NcGrid:
    """Per-4x4-block TotalCoeff storage with spec 9.2.1 nC derivation."""

    # video_codecs_tpu/models/h264/intra_codec.py:445
    def __init__(self, blocks_w: int, blocks_h: int) -> None:
        self.tc = np.zeros((blocks_h, blocks_w), np.int32)

    # video_codecs_tpu/models/h264/intra_codec.py:448
    def nc(self, bx: int, by: int) -> int:
        a = int(self.tc[by, bx - 1]) if bx > 0 else None
        b = int(self.tc[by - 1, bx]) if by > 0 else None
        if a is not None and b is not None:
            return (a + b + 1) >> 1
        if a is not None:
            return a
        if b is not None:
            return b
        return 0

    # video_codecs_tpu/models/h264/intra_codec.py:459
    def set(self, bx: int, by: int, total: int) -> None:
        self.tc[by, bx] = total


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/h264/intra_codec.py:479
class H264IntraEncoder:
    # video_codecs_tpu/models/h264/intra_codec.py:480
    def __init__(self, width: int, height: int, qp: int = 28,
                 deblock: bool = True, entropy: str = "cavlc",
                 perceptual: str = "", quant: str = "normal",
                 transform8x8: bool = False) -> None:
        assert width % 16 == 0 and height % 16 == 0
        assert entropy in ("cavlc", "cabac")
        assert quant in ("normal", "trellis", "around")
        self.transform8x8 = transform8x8   # High profile: I_8x8 + T8x8
        if perceptual:
            raise NotImplementedError(
                f"perceptual={perceptual!r}: no perceptual RDO")
        if quant == "around":
            self._around = h264_rdoq.AdaptiveRounding()
        self.w, self.h, self.qp = width, height, qp
        self.deblock = deblock
        self.entropy = entropy
        self.quant = quant   # "trellis" = soft-decision (rdoq.c analog)

    # video_codecs_tpu/models/h264/intra_codec.py:512
    def _quant_ac(self, wt, qp, intra: bool = True) -> np.ndarray:
        """Luma AC quantization: hard (quant4x4_normal.c) or trellis
        (quant4x4_trellis.c/rdoq.c) per the `quant` option."""
        if self.quant == "trellis":
            lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
            return h264_rdoq.trellis_quant_ac(wt, qp, lam, intra)
        if self.quant == "around":
            return self._around.quant_ac(wt, qp, intra)
        return ht.quant_ac(wt, qp, intra)

    # video_codecs_tpu/models/h264/intra_codec.py:532
    def encode_sequence(self, frames) -> tuple[bytes, list]:
        cabac = self.entropy == "cabac"
        profile = 100 if self.transform8x8 else (77 if cabac else 66)
        nals = [nal_unit(NAL_SPS, write_sps(self.w // 16, self.h // 16,
                                            profile=profile)),
                nal_unit(NAL_PPS, write_pps(
                    cabac=cabac, transform8x8=self.transform8x8))]
        recons = []
        for idx, (y, u, v) in enumerate(frames):
            rbsp, rec = self.encode_frame(y, u, v, idx)
            nals.append(nal_unit(NAL_SLICE_IDR, rbsp))
            recons.append(rec)
        return annexb(nals), recons

    # video_codecs_tpu/models/h264/intra_codec.py:546
    def encode_frame(self, y, u, v, idr_id: int = 0, poc: int | None = None):
        qp = self.qp
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
        mbw, mbh = self.w // 16, self.h // 16
        yv, uv, vv = (p.astype(np.int32) for p in (y, u, v))
        rec_y = np.zeros_like(yv)
        rec_u = np.zeros_like(uv)
        rec_v = np.zeros_like(vv)
        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        self._mode4 = np.full((mbh * 4, mbw * 4), 2, np.int32)
        self._is_i4 = np.zeros((mbh, mbw), bool)
        self._trans8 = np.zeros((mbh, mbw), bool)

        w = BitWriter()
        # slice header (IDR, I slice)
        w.ue(0)              # first_mb_in_slice
        w.ue(7)              # slice_type = I (all slices)
        w.ue(0)              # pps_id
        w.write(0, 8)        # frame_num
        w.ue(idr_id & 1)     # idr_pic_id (toggle to separate IDRs)
        if poc is not None:  # pic_order_cnt_lsb (poc_type 0 streams)
            w.write(poc & 0xFFFF, 16)
        w.flag(0)            # dec_ref_pic_marking: no_output_of_prior_pics
        w.flag(0)            # long_term_reference_flag
        w.se(qp - 26)        # slice_qp_delta
        if self.deblock:
            w.ue(0)          # disable_deblocking_filter_idc = 0 (on)
            w.se(0)          # slice_alpha_c0_offset_div2
            w.se(0)          # slice_beta_offset_div2
        else:
            w.ue(1)          # disable_deblocking_filter_idc = 1 (off)

        ce = None
        if self.entropy == "cabac":
            ce = hc.H264CabacEncoder(w, "I", qp)
            self._cbf = hc.CbfState(mbw, mbh)
            self._cbp_arr = np.zeros((mbh, mbw), np.int32)
            self._cipred = np.zeros((mbh, mbw), np.int32)
        for mby in range(mbh):
            for mbx in range(mbw):
                self._encode_mb(w, yv, uv, vv, rec_y, rec_u, rec_v,
                                nc_y, nc_u, nc_v, mbx, mby, qp, qpc, ce=ce)
                if ce is not None:
                    last = (mby == mbh - 1 and mbx == mbw - 1)
                    ce.final(1 if last else 0)
        if ce is not None:
            ce.finish()   # flush wrote the rbsp stop bit already
        else:
            w.rbsp_trailing_bits()
        if self.deblock:
            # intra pred above used the unfiltered recon (spec 8.3); the
            # output picture is the deblocked one (spec 8.7).
            rec_y, rec_u, rec_v = deblock_frame_intra(
                rec_y, rec_u, rec_v, qp, qpc,
                trans8=self._trans8 if self._trans8.any() else None)
        return w.data(), (rec_y, rec_u, rec_v)

    # video_codecs_tpu/models/h264/intra_codec.py:616
    def _encode_mb(self, w, yv, uv, vv, rec_y, rec_u, rec_v,
                   nc_y, nc_u, nc_v, mbx, mby, qp, qpc,
                   mb_type_offset=0, ce=None, p_slice=False, b_ctx=None):
        # mb_type_offset=5 encodes this intra MB inside a P slice
        # (spec Table 7-13: intra mb_types follow the 5 inter ones)
        x, y = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        mbw = self.w // 16
        avail_t, avail_l = mby > 0, mbx > 0
        lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
        orig = yv[y:y + 16, x:x + 16]

        # ---- I_16x16 candidate ----
        modes16 = [2] + ([0] if avail_t else []) + ([1] if avail_l else []) + \
                  ([3] if (avail_t and avail_l) else [])
        best16 = None
        for m in modes16:
            p = pred_luma16(rec_y, x, y, m)
            sad = int(np.abs(orig - p).sum())
            if best16 is None or sad < best16[0]:
                best16 = (sad, m, p)
        _, mode16, pred16 = best16
        res = orig - pred16
        blk = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
        wt = ht.forward4x4(blk)
        dc = wt[:, :, 0, 0].copy()
        dc_q = ht.quant_luma_dc(ht.fwd_hadamard4x4_dc(dc), qp)
        ac_q = self._quant_ac(wt, qp)
        ac_q[:, :, 0, 0] = 0
        cbp_luma16 = 15 if ac_q.any() else 0
        dc_deq = ht.dequant_luma_dc(dc_q, qp)
        d = ht.dequant_ac(ac_q if cbp_luma16 else np.zeros_like(ac_q), qp)
        d[:, :, 0, 0] = dc_deq
        rec16 = np.clip(pred16 + ht.inverse4x4(d)
                        .transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
        cost16 = int(np.abs(rec16 - orig).sum()) + round(lam * 8)

        # ---- I_4x4 candidate (trial recon on a scratch copy) ----
        rec_trial = rec_y.copy()
        modes4 = []
        levels4 = []
        cost4_bits = 4
        for idx in range(16):
            x4, y4 = _BLK_X[idx], _BLK_Y[idx]
            px, py = x + x4 * 4, y + y4 * 4
            l, t, c, av = gather_ref4(rec_trial, px, py, mbw)
            pm = self._pred_mode4(mbx * 4 + x4, mby * 4 + y4)
            ob = yv[py:py + 4, px:px + 4]
            bestb = None
            for m in allowed_modes4(av):
                pb = pred_luma4(l, t, c, av, m)
                sad = int(np.abs(ob - pb).sum()) + \
                    round(lam * (1 if m == pm else 4))
                if bestb is None or sad < bestb[0]:
                    bestb = (sad, m, pb)
            _, m4, pb = bestb
            wt4 = ht.forward4x4(ob - pb)
            lv4 = self._quant_ac(wt4, qp)
            d4 = ht.dequant_ac(lv4, qp)
            recb = np.clip(pb + ht.inverse4x4(d4), 0, 255)
            rec_trial[py:py + 4, px:px + 4] = recb
            modes4.append(int(m4))
            levels4.append(lv4)
            self._mode4[mby * 4 + y4, mbx * 4 + x4] = m4  # trial; fixed below
            cost4_bits += 1 if m4 == pm else 4
        cost4 = int(np.abs(rec_trial[y:y + 16, x:x + 16] - orig).sum()) + \
            round(lam * cost4_bits)
        # ---- I_8x8 candidate (High profile; trial recon like I_4x4) ----
        modes4_cells = self._mode4[mby * 4:mby * 4 + 4,
                                   mbx * 4:mbx * 4 + 4].copy()
        cost8 = None
        if self.transform8x8 and not getattr(self, 'force_i4', False):
            from video_codecs_tpu_torch.models.h264 import intra8
            rec_t8 = rec_y.copy()
            modes8, levels8 = [], []
            cost8_bits = 5          # mb_type + transform_size_8x8_flag
            for b8 in range(4):
                ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
                px, py = x + ox, y + oy
                bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                pm = self._pred_mode4(mbx * 4 + bx4, mby * 4 + by4,
                                      upto=4 * b8, mbx=mbx, mby=mby)
                l8, t8, c8, av8 = intra8.gather_ref8(rec_t8, px, py, mbw)
                lf, tf, cf = intra8.filter_ref8(l8, t8, c8, av8)
                ob = yv[py:py + 8, px:px + 8]
                bestb = None
                for m in intra8.allowed_modes8(av8):
                    pb = intra8.pred_luma8(lf, tf, cf, av8, m)
                    sad = int(np.abs(ob - pb).sum()) + \
                        round(lam * (1 if m == pm else 4))
                    if bestb is None or sad < bestb[0]:
                        bestb = (sad, m, pb)
                _, m8, pb = bestb
                lv8 = ht.quant8x8(ht.forward8x8(ob - pb), qp, intra=True)
                recb = np.clip(pb + ht.inverse8x8(ht.dequant8x8(lv8, qp)),
                               0, 255)
                rec_t8[py:py + 8, px:px + 8] = recb
                modes8.append(int(m8))
                levels8.append(lv8)
                self._mode4[mby * 4 + by4:mby * 4 + by4 + 2,
                            mbx * 4 + bx4:mbx * 4 + bx4 + 2] = m8
                cost8_bits += 1 if m8 == pm else 4
            cost8 = int(np.abs(rec_t8[y:y + 16, x:x + 16] - orig).sum()) + \
                round(lam * cost8_bits)

        use_i8 = (cost8 is not None and
                  ((cost8 < cost16 and cost8 <= cost4) or
                   getattr(self, 'force_i8', False)))
        use_i4 = (not use_i8) and (cost4 < cost16 or
                                   getattr(self, 'force_i4', False))
        self._is_i4[mby, mbx] = use_i4 or use_i8   # I_NxN
        self._trans8[mby, mbx] = use_i8
        # finalize the MB's mode grid per the winner
        if use_i8:
            for b8 in range(4):
                bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                self._mode4[mby * 4 + by4:mby * 4 + by4 + 2,
                            mbx * 4 + bx4:mbx * 4 + bx4 + 2] = modes8[b8]
        elif use_i4:
            self._mode4[mby * 4:mby * 4 + 4,
                        mbx * 4:mbx * 4 + 4] = modes4_cells
        else:
            self._mode4[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        cbp_luma4 = 0
        if use_i4:
            for i8 in range(4):
                if any(levels4[4 * i8 + k].any() for k in range(4)):
                    cbp_luma4 |= 1 << i8
        cbp_luma8 = 0
        if use_i8:
            for b8 in range(4):
                if levels8[b8].any():
                    cbp_luma8 |= 1 << b8

        # ---- chroma (shared) ----
        cmodes = [0] + ([1] if avail_l else []) + ([2] if avail_t else []) + \
                 ([3] if (avail_t and avail_l) else [])
        co = {0: uv[cy:cy + 8, cx:cx + 8], 1: vv[cy:cy + 8, cx:cx + 8]}
        best_cm, best_csad, best_cpred = None, None, None
        for m in cmodes:
            pu = pred_chroma8(rec_u, cx, cy, m)
            pv = pred_chroma8(rec_v, cx, cy, m)
            sad = int(np.abs(co[0] - pu).sum()) + int(np.abs(co[1] - pv).sum())
            if best_csad is None or sad < best_csad:
                best_cm, best_csad, best_cpred = m, sad, (pu, pv)
        c_dc_q, c_ac_q = [], []
        for comp in (0, 1):
            cres = co[comp] - best_cpred[comp]
            cblk = cres.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
            cwt = ht.forward4x4(cblk)
            cdc = cwt[:, :, 0, 0].copy()
            c_dc_q.append(ht.quant_chroma_dc(ht.hadamard2x2(cdc), qpc))
            acq = ht.quant_ac(cwt, qpc)
            acq[:, :, 0, 0] = 0
            c_ac_q.append(acq)
        any_cdc = any(q.any() for q in c_dc_q)
        any_cac = any(q.any() for q in c_ac_q)
        cbp_chroma = 2 if any_cac else (1 if any_cdc else 0)

        zz = cavlc.ZIGZAG_4x4
        if ce is not None:
            self._write_mb_cabac(ce, mbx, mby, use_i4, modes4, mode16,
                                 best_cm, cbp_luma4, cbp_luma16, cbp_chroma,
                                 levels4, dc_q, ac_q, c_dc_q, c_ac_q,
                                 p_slice=p_slice, b_ctx=b_ctx,
                                 use_i8=use_i8,
                                 modes8=modes8 if use_i8 else None,
                                 levels8=levels8 if use_i8 else None,
                                 cbp_luma8=cbp_luma8)
            rec_y[y:y + 16, x:x + 16] = (
                rec_t8[y:y + 16, x:x + 16] if use_i8 else
                rec_trial[y:y + 16, x:x + 16] if use_i4 else rec16)
        elif use_i8:
            # ---- I_8x8 syntax (spec 7.3.5, transform_size_8x8_flag) ----
            cbp = cbp_luma8 | (cbp_chroma << 4)
            w.ue(0 + mb_type_offset)     # mb_type I_NxN
            w.flag(1)                    # transform_size_8x8_flag
            for b8 in range(4):
                bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                pm = self._pred_mode4(mbx * 4 + bx4, mby * 4 + by4,
                                      upto=4 * b8, mbx=mbx, mby=mby)
                m = modes8[b8]
                if m == pm:
                    w.flag(1)
                else:
                    w.flag(0)
                    w.write(m if m < pm else m - 1, 3)
            w.ue(best_cm)
            w.ue(_NCBP_INTRA_420[cbp])   # coded_block_pattern me(v)
            if cbp:
                w.se(0)              # mb_qp_delta
            for b8 in range(4):
                lv64 = np.zeros(64, np.int64)
                lv64[:] = levels8[b8].reshape(64)[ht.ZIGZAG_8x8]
                for k in range(4):
                    idx = 4 * b8 + k
                    x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                    gx, gy = mbx * 4 + x4, mby * 4 + y4
                    if cbp_luma8 & (1 << b8):
                        coeffs = lv64[4 * np.arange(16) + k]
                        total = cavlc.encode_block(
                            w, [int(cc) for cc in coeffs],
                            nc_y.nc(gx, gy), 16)
                    else:
                        total = 0
                    nc_y.set(gx, gy, total)
            rec_y[y:y + 16, x:x + 16] = rec_t8[y:y + 16, x:x + 16]
        elif use_i4:
            # ---- I_4x4 syntax (spec 7.3.5.1) ----
            cbp = cbp_luma4 | (cbp_chroma << 4)
            w.ue(0 + mb_type_offset)     # mb_type I_4x4
            if self.transform8x8:
                w.flag(0)                # transform_size_8x8_flag
            for idx in range(16):
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                pm = self._pred_mode4(mbx * 4 + x4, mby * 4 + y4,
                                      upto=idx, mbx=mbx, mby=mby)
                m = modes4[idx]
                if m == pm:
                    w.flag(1)
                else:
                    w.flag(0)
                    w.write(m if m < pm else m - 1, 3)
            w.ue(best_cm)
            w.ue(_NCBP_INTRA_420[cbp])   # coded_block_pattern me(v)
            if cbp:
                w.se(0)              # mb_qp_delta
            for i8 in range(4):
                for k in range(4):
                    idx = 4 * i8 + k
                    x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                    gx, gy = mbx * 4 + x4, mby * 4 + y4
                    if cbp_luma4 & (1 << i8):
                        coeffs = levels4[idx].reshape(16)[zz]
                        total = cavlc.encode_block(
                            w, [int(cc) for cc in coeffs], nc_y.nc(gx, gy), 16)
                    else:
                        total = 0
                    nc_y.set(gx, gy, total)
            rec_y[y:y + 16, x:x + 16] = rec_trial[y:y + 16, x:x + 16]
        else:
            mb_type = 1 + mode16 + 4 * cbp_chroma + \
                12 * (1 if cbp_luma16 else 0)
            w.ue(mb_type + mb_type_offset)
            w.ue(best_cm)
            w.se(0)
            dc_list = [int(dc_q.reshape(16)[zz[i]]) for i in range(16)]
            cavlc.encode_block(w, dc_list, nc_y.nc(mbx * 4, mby * 4), 16)
            for idx in range(16):
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                gx, gy = mbx * 4 + x4, mby * 4 + y4
                if cbp_luma16:
                    coeffs = ac_q[y4, x4].reshape(16)[zz][1:]
                    total = cavlc.encode_block(w, [int(cc) for cc in coeffs],
                                               nc_y.nc(gx, gy), 15)
                else:
                    total = 0
                nc_y.set(gx, gy, total)
            rec_y[y:y + 16, x:x + 16] = rec16
        if ce is None:
            # chroma DC / AC syntax (CAVLC; CABAC path wrote it above)
            if cbp_chroma:
                for comp in (0, 1):
                    dcs = c_dc_q[comp]
                    lst = [int(dcs[0, 0]), int(dcs[0, 1]),
                           int(dcs[1, 0]), int(dcs[1, 1])]
                    cavlc.encode_block(w, lst, -1, 4)
            for comp, grid in ((0, nc_u), (1, nc_v)):
                for idx in range(4):
                    x4, y4 = idx & 1, idx >> 1
                    gx, gy = mbx * 2 + x4, mby * 2 + y4
                    if cbp_chroma == 2:
                        coeffs = c_ac_q[comp][y4, x4].reshape(16)[zz][1:]
                        total = cavlc.encode_block(
                            w, [int(cc) for cc in coeffs],
                            grid.nc(gx, gy), 15)
                    else:
                        total = 0
                    grid.set(gx, gy, total)

        # ---- chroma reconstruction ----
        for comp, (plane, pred) in enumerate((
                (rec_u, best_cpred[0]), (rec_v, best_cpred[1]))):
            if cbp_chroma:
                cdc_deq = ht.dequant_chroma_dc(c_dc_q[comp], qpc)
            else:
                cdc_deq = np.zeros((2, 2), np.int64)
            cd = ht.dequant_ac(
                c_ac_q[comp] if cbp_chroma == 2 else np.zeros_like(c_ac_q[comp]),
                qpc)
            cd[:, :, 0, 0] = cdc_deq
            cr = ht.inverse4x4(cd)
            crec = np.clip(pred + cr.transpose(0, 2, 1, 3).reshape(8, 8),
                           0, 255)
            plane[cy:cy + 8, cx:cx + 8] = crec

    # video_codecs_tpu/models/h264/intra_codec.py:924
    def _write_mb_cabac(self, ce, mbx, mby, use_i4, modes4, mode16, best_cm,
                        cbp_luma4, cbp_luma16, cbp_chroma, levels4, dc_q,
                        ac_q, c_dc_q, c_ac_q, p_slice=False,
                        b_ctx=None, use_i8=False, modes8=None, levels8=None,
                        cbp_luma8=0):
        """CABAC syntax for one intra MB (I slice, or intra MB in P slice).

        Parity: jm18.5/lencod/src/cabac.c writeMB_I_typeInfo_CABAC,
        writeIntraPredMode, writeCIPredMode, writeCBP, writeDquant,
        writeRunLevel (via entropy/h264_cabac.py).
        """
        zz = cavlc.ZIGZAG_4x4
        cbf = self._cbf
        mbw, mbh = self.w // 16, self.h // 16

        i_nxn = use_i4 or use_i8
        cbp = ((cbp_luma8 if use_i8 else cbp_luma4) | (cbp_chroma << 4)) \
            if i_nxn else \
            ((15 if cbp_luma16 else 0) | (cbp_chroma << 4))
        if b_ctx is not None:
            # intra MB inside a B slice (writeMB_B_typeInfo :626)
            if i_nxn:
                ce.mb_type_b(23, b_ctx)
            else:
                i16 = mode16 + 4 * cbp_chroma + 12 * (1 if cbp_luma16 else 0)
                ce.mb_type_b(24, b_ctx, i16)
        elif p_slice:
            # intra suffix inside a P slice (writeMB_P_typeInfo :566-612)
            if i_nxn:
                ce.mb_type_p(6)
            else:
                i16 = mode16 + 4 * cbp_chroma + 12 * (1 if cbp_luma16 else 0)
                ce.mb_type_p(7, i16)
        else:
            # mb_type: ctx term = neighbor present and not I_4x4
            a = 1 if (mbx > 0 and not self._is_i4[mby, mbx - 1]) else 0
            b = 1 if (mby > 0 and not self._is_i4[mby - 1, mbx]) else 0
            act = 0 if i_nxn else \
                1 + mode16 + 4 * cbp_chroma + 12 * (1 if cbp_luma16 else 0)
            ce.mb_type_i(act, a + b)
        if i_nxn and self.transform8x8:
            ta = 1 if (mbx > 0 and self._trans8[mby, mbx - 1]) else 0
            tb = 1 if (mby > 0 and self._trans8[mby - 1, mbx]) else 0
            ce.transform_size_8x8_flag(1 if use_i8 else 0, ta + tb)
        if use_i8:
            for b8 in range(4):
                bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                pm = self._pred_mode4(mbx * 4 + bx4, mby * 4 + by4,
                                      upto=4 * b8, mbx=mbx, mby=mby)
                ce.intra4x4_pred_mode(modes8[b8], pm)
        elif use_i4:
            for idx in range(16):
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                pm = self._pred_mode4(mbx * 4 + x4, mby * 4 + y4,
                                      upto=idx, mbx=mbx, mby=mby)
                ce.intra4x4_pred_mode(modes4[idx], pm)
        # chroma pred mode: ctx from neighbors' nonzero chroma mode
        ca = 1 if (mbx > 0 and self._cipred[mby, mbx - 1] != 0) else 0
        cb = 1 if (mby > 0 and self._cipred[mby - 1, mbx] != 0) else 0
        ce.intra_chroma_pred_mode(best_cm, ca + cb)
        self._cipred[mby, mbx] = best_cm

        def nbr(dx, dy):
            nx, ny = mbx + dx, mby + dy
            if nx < 0 or ny < 0:
                return None
            return {"cbp": int(self._cbp_arr[ny, nx]), "ipcm": False}

        if i_nxn:
            ce.cbp(cbp, nbr(0, -1), nbr(-1, 0))
        self._cbp_arr[mby, mbx] = cbp
        if (not i_nxn) or cbp:
            ce.mb_qp_delta(0, False)

        cur_bits = 0
        if not i_nxn:
            # I_16x16: luma DC always coded (with cbf)
            dc_list = [int(dc_q.reshape(16)[zz[i]]) for i in range(16)]
            ctx = cbf.ctx_dc(mbx, mby, hc.CbfState.LUMA_DC_BIT, True)
            ce.residual_block(hc.LUMA_16DC, dc_list, ctx)
            if any(dc_list):
                cur_bits |= 1 << hc.CbfState.LUMA_DC_BIT
                cbf.set_bit(mbx, mby, hc.CbfState.LUMA_DC_BIT)
        if use_i8:
            for b8 in range(4):
                if not (cbp_luma8 & (1 << b8)):
                    continue
                coeffs = [int(c) for c in
                          levels8[b8].reshape(64)[ht.ZIGZAG_8x8]]
                ce.residual_block(hc.LUMA_8x8, coeffs, 0, code_cbf=False)
                if any(coeffs):
                    for k in range(4):
                        idx = 4 * b8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        cur_bits |= 1 << (1 + 4 * y4 + x4)
                        cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
        for i8 in range(4):
            if use_i8:
                break
            for k in range(4):
                idx = 4 * i8 + k
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                if use_i4:
                    if not (cbp_luma4 & (1 << i8)):
                        continue
                    coeffs = [int(c) for c in levels4[idx].reshape(16)[zz]]
                    btype = hc.LUMA_4x4
                else:
                    if not cbp_luma16:
                        continue
                    coeffs = [int(c) for c in ac_q[y4, x4].reshape(16)[zz][1:]]
                    btype = hc.LUMA_16AC
                ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4, cur_bits, True)
                ce.residual_block(btype, coeffs, ctx)
                if any(coeffs):
                    cur_bits |= 1 << (1 + 4 * y4 + x4)
                    cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
        if cbp_chroma:
            for comp, bit in ((0, hc.CbfState.U_DC_BIT),
                              (1, hc.CbfState.V_DC_BIT)):
                dcs = c_dc_q[comp]
                lst = [int(dcs[0, 0]), int(dcs[0, 1]),
                       int(dcs[1, 0]), int(dcs[1, 1])]
                ctx = cbf.ctx_dc(mbx, mby, bit, True)
                ce.residual_block(hc.CHROMA_DC, lst, ctx)
                if any(lst):
                    cbf.set_bit(mbx, mby, bit)
        if cbp_chroma == 2:
            for comp, base in ((0, hc.CbfState.U_AC_BASE),
                               (1, hc.CbfState.V_AC_BASE)):
                for idx in range(4):
                    x4, y4 = idx & 1, idx >> 1
                    coeffs = [int(c) for c in
                              c_ac_q[comp][y4, x4].reshape(16)[zz][1:]]
                    ctx = cbf.ctx_ac(mbx, mby, x4, y4, base, 2,
                                     cur_bits, True)
                    ce.residual_block(hc.CHROMA_AC, coeffs, ctx)
                    if any(coeffs):
                        cur_bits |= 1 << (base + 4 * y4 + x4)
                        cbf.set_bit(mbx, mby, base + 4 * y4 + x4)
        cbf.mark(mbx, mby)

    # video_codecs_tpu/models/h264/intra_codec.py:1067
    def _pred_mode4(self, gx4, gy4, upto=None, mbx=None, mby=None):
        """predIntra4x4PredMode = min(modeA, modeB) (spec 8.3.1.1)."""
        mbw = self.w // 16

        def nbr(sx4, sy4):
            if sx4 < 0 or sy4 < 0 or sx4 >= mbw * 4 or \
                    sy4 >= (self.h // 16) * 4:
                return None
            if not _decoded_before(sx4, sy4, gx4, gy4, mbw):
                return None
            nmbx, nmby = sx4 // 4, sy4 // 4
            same_mb = (mbx is not None and nmbx == mbx and nmby == mby)
            if same_mb and upto is not None:
                # within the current (partially coded) MB the mode grid is
                # being filled in block order; earlier blocks are valid
                pass
            if not same_mb and not self._is_i4[nmby, nmbx]:
                return 2
            return int(self._mode4[sy4, sx4])

        a = nbr(gx4 - 1, gy4)
        b = nbr(gx4, gy4 - 1)
        if a is None or b is None:
            return 2
        return min(a, b)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/h264/intra_codec.py:1098
class H264IntraDecoder:
    # video_codecs_tpu/models/h264/intra_codec.py:1099
    def __init__(self) -> None:
        self.size = None

    # video_codecs_tpu/models/h264/intra_codec.py:1102
    def decode(self, stream: bytes) -> list:
        frames = []
        for nal in split_annexb(stream):
            nal_type = nal[0] & 0x1F
            rbsp = strip_emulation_prevention(nal[1:])
            if nal_type == NAL_SPS:
                wmb, hmb, self.sps_info = parse_sps(rbsp, full=True)
                self.size = (wmb, hmb)
            elif nal_type == NAL_PPS:
                self.dbf_present, self.cabac, ppsi = _checked_pps(rbsp)
                self.trans8_enabled = ppsi["transform_8x8_mode"]
            elif nal_type in (NAL_SLICE_IDR, 1):
                frames.append(self._decode_slice(rbsp))
        return frames

    # video_codecs_tpu/models/h264/intra_codec.py:1119
    def _decode_slice(self, rbsp: bytes):
        mbw, mbh = self.size
        r = BitReader(rbsp)
        assert r.ue() == 0
        st = r.ue()
        assert st in (2, 7), "only I slices supported"
        assert r.ue() == 0
        info = getattr(self, "sps_info",
                       {"poc_type": 2, "log2_max_frame_num": 8,
                        "log2_max_poc_lsb": 0})
        r.read(info["log2_max_frame_num"])   # frame_num
        r.ue()               # idr_pic_id
        if info["poc_type"] == 0:
            r.read(info["log2_max_poc_lsb"])  # pic_order_cnt_lsb
        r.flag(), r.flag()   # dec_ref_pic_marking (IDR)
        qp = 26 + r.se()
        # when deblocking_filter_control_present_flag is 0 the filter is
        # implicitly enabled with zero offsets (spec 7.4.3 inference)
        dbf_idc, aoff, boff = 0, 0, 0
        if self.dbf_present:
            dbf_idc = r.ue()
            if dbf_idc != 1:
                aoff = 2 * r.se()    # FilterOffsetA
                boff = 2 * r.se()    # FilterOffsetB
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])

        rec_y = np.zeros((mbh * 16, mbw * 16), np.int32)
        rec_u = np.zeros((mbh * 8, mbw * 8), np.int32)
        rec_v = np.zeros_like(rec_u)
        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        zz = cavlc.ZIGZAG_4x4

        mode4 = np.full((mbh * 4, mbw * 4), 2, np.int32)
        is_i4 = np.zeros((mbh, mbw), bool)
        trans8 = np.zeros((mbh, mbw), bool)

        def pred_mode4(gx4, gy4):
            def nbr(sx4, sy4):
                if sx4 < 0 or sy4 < 0 or sx4 >= mbw * 4 or sy4 >= mbh * 4:
                    return None
                if not _decoded_before(sx4, sy4, gx4, gy4, mbw):
                    return None
                if not is_i4[sy4 // 4, sx4 // 4]:
                    return 2
                return int(mode4[sy4, sx4])
            a = nbr(gx4 - 1, gy4)
            b = nbr(gx4, gy4 - 1)
            if a is None or b is None:
                return 2
            return min(a, b)

        if getattr(self, "cabac", False):
            self._decode_slice_mbs_cabac(r, qp, qpc, rec_y, rec_u, rec_v,
                                         mode4, is_i4, pred_mode4,
                                         trans8=trans8)
        else:
            for mby in range(mbh):
                for mbx in range(mbw):
                    mb_type = r.ue()
                    assert 0 <= mb_type <= 24, \
                        f"unsupported mb_type {mb_type}"
                    if mb_type == 0:
                        if getattr(self, "trans8_enabled", False) and \
                                r.flag():    # transform_size_8x8_flag
                            trans8[mby, mbx] = True
                            self._decode_i8_mb(r, rec_y, rec_u, rec_v,
                                               nc_y, nc_u, nc_v, mbx, mby,
                                               qp, qpc, mode4, is_i4,
                                               pred_mode4)
                        else:
                            self._decode_i4_mb(r, None, rec_y, rec_u,
                                               rec_v, nc_y, nc_u, nc_v,
                                               mbx, mby, qp, qpc, mode4,
                                               is_i4, pred_mode4)
                        continue
                    self._decode_i16_mb(r, mb_type - 1, rec_y, rec_u, rec_v,
                                        nc_y, nc_u, nc_v, mbx, mby, qp, qpc)
        if dbf_idc != 1:
            rec_y, rec_u, rec_v = deblock_frame_intra(
                rec_y, rec_u, rec_v, qp, qpc, aoff, boff,
                trans8=trans8 if trans8.any() else None)
        return rec_y, rec_u, rec_v

    # video_codecs_tpu/models/h264/intra_codec.py:1205
    def _decode_slice_mbs_cabac(self, r, qp, qpc, rec_y, rec_u, rec_v,
                                mode4, is_i4, pred_mode4, trans8=None):
        """CABAC I-slice MB loop (mirror of _write_mb_cabac)."""
        from video_codecs_tpu_torch.models.h264 import intra8
        mbw, mbh = self.size
        if trans8 is None:
            trans8 = np.zeros((mbh, mbw), bool)
        zz = cavlc.ZIGZAG_4x4
        cd = hc.H264CabacDecoder(r, "I", qp)
        cbf = hc.CbfState(mbw, mbh)
        cbp_arr = np.zeros((mbh, mbw), np.int32)
        cipred = np.zeros((mbh, mbw), np.int32)
        i16 = np.zeros((mbh, mbw), bool)

        for mby in range(mbh):
            for mbx in range(mbw):
                x, y = mbx * 16, mby * 16
                cx, cy = mbx * 8, mby * 8
                a = 1 if (mbx > 0 and i16[mby, mbx - 1]) else 0
                b = 1 if (mby > 0 and i16[mby - 1, mbx]) else 0
                act = cd.mb_type_i(a + b)
                assert act != 25, "IPCM decode unsupported"
                use_i4 = act == 0
                i16[mby, mbx] = not use_i4
                is_i4[mby, mbx] = use_i4
                use_i8 = False
                if use_i4 and getattr(self, "trans8_enabled", False):
                    ta = 1 if (mbx > 0 and trans8[mby, mbx - 1]) else 0
                    tb = 1 if (mby > 0 and trans8[mby - 1, mbx]) else 0
                    use_i8 = bool(cd.transform_size_8x8_flag(ta + tb))
                    trans8[mby, mbx] = use_i8
                modes = []
                if use_i8:
                    for b8 in range(4):
                        bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                        pm = pred_mode4(mbx * 4 + bx4, mby * 4 + by4)
                        m = cd.intra4x4_pred_mode(pm)
                        modes.append(m)
                        mode4[mby * 4 + by4:mby * 4 + by4 + 2,
                              mbx * 4 + bx4:mbx * 4 + bx4 + 2] = m
                elif use_i4:
                    for idx in range(16):
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        pm = pred_mode4(mbx * 4 + x4, mby * 4 + y4)
                        m = cd.intra4x4_pred_mode(pm)
                        modes.append(m)
                        mode4[mby * 4 + y4, mbx * 4 + x4] = m
                else:
                    code = act - 1
                    lmode = code % 4
                    cbp_chroma = (code // 4) % 3
                    cbp_luma = 15 if code >= 12 else 0
                ca = 1 if (mbx > 0 and cipred[mby, mbx - 1] != 0) else 0
                cb = 1 if (mby > 0 and cipred[mby - 1, mbx] != 0) else 0
                cmode = cd.intra_chroma_pred_mode(ca + cb)
                cipred[mby, mbx] = cmode

                def nbr(dx, dy):
                    nx, ny = mbx + dx, mby + dy
                    if nx < 0 or ny < 0:
                        return None
                    return {"cbp": int(cbp_arr[ny, nx]), "ipcm": False}

                if use_i4:
                    cbp = cd.cbp(nbr(0, -1), nbr(-1, 0))
                    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                else:
                    cbp = cbp_luma | (cbp_chroma << 4)
                cbp_arr[mby, mbx] = cbp
                if (not use_i4) or cbp:
                    dqp = cd.mb_qp_delta(False)
                    assert dqp == 0, "dqp unsupported"

                cur_bits = 0
                dc_q = np.zeros((4, 4), np.int64)
                if not use_i4:
                    ctx = cbf.ctx_dc(mbx, mby, hc.CbfState.LUMA_DC_BIT, True)
                    dc_list = cd.residual_block(hc.LUMA_16DC, 16, ctx)
                    flat = np.zeros(16, np.int64)
                    flat[zz] = dc_list
                    dc_q = flat.reshape(4, 4)
                    if any(dc_list):
                        cur_bits |= 1 << hc.CbfState.LUMA_DC_BIT
                        cbf.set_bit(mbx, mby, hc.CbfState.LUMA_DC_BIT)
                levels4 = [np.zeros((4, 4), np.int64) for _ in range(16)]
                levels8 = [np.zeros((8, 8), np.int64) for _ in range(4)]
                ac_q = np.zeros((4, 4, 4, 4), np.int64)
                if use_i8:
                    for b8 in range(4):
                        if not (cbp_luma & (1 << b8)):
                            continue
                        coeffs = cd.residual_block(hc.LUMA_8x8, 64, 0,
                                                   code_cbf=False)
                        lv = np.zeros(64, np.int64)
                        lv[ht.ZIGZAG_8x8] = coeffs
                        levels8[b8] = lv.reshape(8, 8)
                        if any(coeffs):
                            for k in range(4):
                                idx = 4 * b8 + k
                                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                                cur_bits |= 1 << (1 + 4 * y4 + x4)
                                cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
                for i8 in range(4):
                    if use_i8:
                        break
                    for k in range(4):
                        idx = 4 * i8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        if use_i4:
                            if not (cbp_luma & (1 << i8)):
                                continue
                            ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4,
                                             cur_bits, True)
                            coeffs = cd.residual_block(hc.LUMA_4x4, 16, ctx)
                            flat = np.zeros(16, np.int64)
                            flat[zz] = coeffs
                            levels4[idx] = flat.reshape(4, 4)
                        else:
                            if not cbp_luma:
                                continue
                            ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4,
                                             cur_bits, True)
                            coeffs = cd.residual_block(hc.LUMA_16AC, 15, ctx)
                            flat = np.zeros(16, np.int64)
                            flat[zz[1:]] = coeffs
                            ac_q[y4, x4] = flat.reshape(4, 4)
                        if any(coeffs):
                            cur_bits |= 1 << (1 + 4 * y4 + x4)
                            cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
                c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
                c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
                if cbp_chroma:
                    for comp, bit in ((0, hc.CbfState.U_DC_BIT),
                                      (1, hc.CbfState.V_DC_BIT)):
                        ctx = cbf.ctx_dc(mbx, mby, bit, True)
                        lst = cd.residual_block(hc.CHROMA_DC, 4, ctx)
                        c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = \
                            lst[0], lst[1]
                        c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = \
                            lst[2], lst[3]
                        if any(lst):
                            cbf.set_bit(mbx, mby, bit)
                if cbp_chroma == 2:
                    for comp, base in ((0, hc.CbfState.U_AC_BASE),
                                       (1, hc.CbfState.V_AC_BASE)):
                        for idx in range(4):
                            x4, y4 = idx & 1, idx >> 1
                            ctx = cbf.ctx_ac(mbx, mby, x4, y4, base, 2,
                                             cur_bits, True)
                            coeffs = cd.residual_block(hc.CHROMA_AC, 15, ctx)
                            flat = np.zeros(16, np.int64)
                            flat[zz[1:]] = coeffs
                            c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                            if any(coeffs):
                                cur_bits |= 1 << (base + 4 * y4 + x4)
                                cbf.set_bit(mbx, mby, base + 4 * y4 + x4)
                cbf.mark(mbx, mby)

                # ---- reconstruction ----
                if use_i8:
                    for b8 in range(4):
                        ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
                        pb = intra8.predict8(rec_y, x + ox, y + oy, mbw,
                                             modes[b8])
                        d8 = ht.inverse8x8(ht.dequant8x8(levels8[b8], qp))
                        rec_y[y + oy:y + oy + 8, x + ox:x + ox + 8] = \
                            np.clip(pb + d8, 0, 255)
                elif use_i4:
                    for idx in range(16):
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        px, py = x + x4 * 4, y + y4 * 4
                        l, t, c, av = gather_ref4(rec_y, px, py, mbw)
                        pb = pred_luma4(l, t, c, av, modes[idx])
                        d4 = ht.dequant_ac(levels4[idx], qp)
                        rec_y[py:py + 4, px:px + 4] = np.clip(
                            pb + ht.inverse4x4(d4), 0, 255)
                else:
                    pred = pred_luma16(rec_y, x, y, lmode)
                    dc_deq = ht.dequant_luma_dc(dc_q, qp)
                    d = ht.dequant_ac(ac_q, qp)
                    d[:, :, 0, 0] = dc_deq
                    rr = ht.inverse4x4(d)
                    rec_y[y:y + 16, x:x + 16] = np.clip(
                        pred + rr.transpose(0, 2, 1, 3).reshape(16, 16),
                        0, 255)
                for comp, plane in ((0, rec_u), (1, rec_v)):
                    cpred = pred_chroma8(plane, cx, cy, cmode)
                    cdc_deq = ht.dequant_chroma_dc(c_dc_q[comp], qpc)
                    cdq = ht.dequant_ac(c_ac_q[comp], qpc)
                    cdq[:, :, 0, 0] = cdc_deq
                    cr2 = ht.inverse4x4(cdq)
                    plane[cy:cy + 8, cx:cx + 8] = np.clip(
                        cpred + cr2.transpose(0, 2, 1, 3).reshape(8, 8),
                        0, 255)

                last = (mby == mbh - 1 and mbx == mbw - 1)
                eos = cd.final()
                assert eos == (1 if last else 0), "end_of_slice mismatch"

    # video_codecs_tpu/models/h264/intra_codec.py:1409
    def _decode_i16_mb(self, r, code, rec_y, rec_u, rec_v, nc_y, nc_u,
                       nc_v, mbx, mby, qp, qpc):
        """Parse + recon one I_16x16 MB; code = mb_type - 1 (I-slice
        numbering, spec Table 7-11)."""
        x, y = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        zz = cavlc.ZIGZAG_4x4
        lmode = code % 4
        cbp_chroma = (code // 4) % 3
        cbp_luma = 15 if code >= 12 else 0
        cmode = r.ue()
        dqp = r.se()
        assert dqp == 0
        # luma DC
        dc_list = cavlc.decode_block(r, nc_y.nc(mbx * 4, mby * 4), 16)
        dc_q = np.zeros(16, np.int64)
        dc_q[zz] = dc_list
        dc_q = dc_q.reshape(4, 4)
        ac_q = np.zeros((4, 4, 4, 4), np.int64)
        for idx in range(16):
            x4, y4 = _BLK_X[idx], _BLK_Y[idx]
            gx, gy = mbx * 4 + x4, mby * 4 + y4
            if cbp_luma:
                coeffs = cavlc.decode_block(r, nc_y.nc(gx, gy), 15)
                flat = np.zeros(16, np.int64)
                flat[zz[1:]] = coeffs
                ac_q[y4, x4] = flat.reshape(4, 4)
                nc_y.set(gx, gy, sum(1 for c in coeffs if c))
            else:
                nc_y.set(gx, gy, 0)
        c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
        c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
        if cbp_chroma:
            for comp in (0, 1):
                lst = cavlc.decode_block(r, -1, 4)
                c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = lst[0], lst[1]
                c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = lst[2], lst[3]
        for comp, grid in ((0, nc_u), (1, nc_v)):
            for idx in range(4):
                x4, y4 = idx & 1, idx >> 1
                gx, gy = mbx * 2 + x4, mby * 2 + y4
                if cbp_chroma == 2:
                    coeffs = cavlc.decode_block(r, grid.nc(gx, gy), 15)
                    flat = np.zeros(16, np.int64)
                    flat[zz[1:]] = coeffs
                    c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                    grid.set(gx, gy, sum(1 for c in coeffs if c))
                else:
                    grid.set(gx, gy, 0)

        # recon
        pred = pred_luma16(rec_y, x, y, lmode)
        dc_deq = ht.dequant_luma_dc(dc_q, qp)
        d = ht.dequant_ac(ac_q, qp)
        d[:, :, 0, 0] = dc_deq
        rr = ht.inverse4x4(d)
        rec_y[y:y + 16, x:x + 16] = np.clip(
            pred + rr.transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
        for comp, plane in ((0, rec_u), (1, rec_v)):
            cpred = pred_chroma8(plane, cx, cy, cmode)
            cdc_deq = ht.dequant_chroma_dc(c_dc_q[comp], qpc)
            cd = ht.dequant_ac(c_ac_q[comp], qpc)
            cd[:, :, 0, 0] = cdc_deq
            cr = ht.inverse4x4(cd)
            plane[cy:cy + 8, cx:cx + 8] = np.clip(
                cpred + cr.transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)

    # video_codecs_tpu/models/h264/intra_codec.py:1563
    def _decode_i4_mb(self, r, _unused, rec_y, rec_u, rec_v, nc_y, nc_u,
                      nc_v, mbx, mby, qp, qpc, mode4, is_i4, pred_mode4):
        import numpy as np
        mbw = rec_y.shape[1] // 16
        x, y = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        zz = cavlc.ZIGZAG_4x4
        is_i4[mby, mbx] = True
        modes = []
        for idx in range(16):
            x4, y4 = _BLK_X[idx], _BLK_Y[idx]
            pm = pred_mode4(mbx * 4 + x4, mby * 4 + y4)
            if r.flag():
                m = pm
            else:
                rem = r.read(3)
                m = rem if rem < pm else rem + 1
            modes.append(m)
            mode4[mby * 4 + y4, mbx * 4 + x4] = m
        cmode = r.ue()
        cbp = _CBP_FROM_CODE_INTRA_420[r.ue()]
        if cbp:
            dqp = r.se()
            assert dqp == 0
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        # luma blocks: parse + recon sequentially
        for i8 in range(4):
            for k in range(4):
                idx = 4 * i8 + k
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                gx, gy = mbx * 4 + x4, mby * 4 + y4
                px, py = x + x4 * 4, y + y4 * 4
                lv = np.zeros((4, 4), np.int64)
                if cbp_luma & (1 << i8):
                    coeffs = cavlc.decode_block(r, nc_y.nc(gx, gy), 16)
                    flat = np.zeros(16, np.int64)
                    flat[zz] = coeffs
                    lv = flat.reshape(4, 4)
                    nc_y.set(gx, gy, sum(1 for cc in coeffs if cc))
                else:
                    nc_y.set(gx, gy, 0)
                l, t, c, av = gather_ref4(rec_y, px, py, mbw)
                pb = pred_luma4(l, t, c, av, modes[idx])
                d4 = ht.dequant_ac(lv, qp)
                rec_y[py:py + 4, px:px + 4] = np.clip(
                    pb + ht.inverse4x4(d4), 0, 255)
        # chroma (same structure as I_16x16 path)
        c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
        c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
        if cbp_chroma:
            for comp in (0, 1):
                lst = cavlc.decode_block(r, -1, 4)
                c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = lst[0], lst[1]
                c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = lst[2], lst[3]
        for comp, grid in ((0, nc_u), (1, nc_v)):
            for idx in range(4):
                x4, y4 = idx & 1, idx >> 1
                gx, gy = mbx * 2 + x4, mby * 2 + y4
                if cbp_chroma == 2:
                    coeffs = cavlc.decode_block(r, grid.nc(gx, gy), 15)
                    flat = np.zeros(16, np.int64)
                    flat[zz[1:]] = coeffs
                    c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                    grid.set(gx, gy, sum(1 for cc in coeffs if cc))
                else:
                    grid.set(gx, gy, 0)
        for comp, plane in ((0, rec_u), (1, rec_v)):
            cpred = pred_chroma8(plane, cx, cy, cmode)
            cdc_deq = ht.dequant_chroma_dc(c_dc_q[comp], qpc)
            cd = ht.dequant_ac(c_ac_q[comp], qpc)
            cd[:, :, 0, 0] = cdc_deq
            cr2 = ht.inverse4x4(cd)
            plane[cy:cy + 8, cx:cx + 8] = np.clip(
                cpred + cr2.transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)

    # video_codecs_tpu/models/h264/intra_codec.py:1477
    def _decode_i8_mb(self, r, rec_y, rec_u, rec_v, nc_y, nc_u,
                      nc_v, mbx, mby, qp, qpc, mode4, is_i4, pred_mode4):
        """I_8x8 MB, CAVLC residuals (each 8x8 block read as four
        de-interleaved 4x4 scans: sub-block k holds 8x8-scan positions
        4*i + k — jm18.5/ldecod read_comp_cavlc.c:1009)."""
        import numpy as np
        from video_codecs_tpu_torch.models.h264 import intra8
        mbw = rec_y.shape[1] // 16
        x, y = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        zz = cavlc.ZIGZAG_4x4
        is_i4[mby, mbx] = True          # I_NxN for mode prediction
        modes = []
        for b8 in range(4):
            bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
            pm = pred_mode4(mbx * 4 + bx4, mby * 4 + by4)
            if r.flag():
                m = pm
            else:
                rem = r.read(3)
                m = rem if rem < pm else rem + 1
            modes.append(m)
            mode4[mby * 4 + by4:mby * 4 + by4 + 2,
                  mbx * 4 + bx4:mbx * 4 + bx4 + 2] = m
        cmode = r.ue()
        cbp = _CBP_FROM_CODE_INTRA_420[r.ue()]
        if cbp:
            dqp = r.se()
            assert dqp == 0
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        for b8 in range(4):
            ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
            lv64 = np.zeros(64, np.int64)
            for k in range(4):
                idx = 4 * b8 + k
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                gx, gy = mbx * 4 + x4, mby * 4 + y4
                if cbp_luma & (1 << b8):
                    coeffs = cavlc.decode_block(r, nc_y.nc(gx, gy), 16)
                    lv64[4 * np.arange(16) + k] = coeffs
                    nc_y.set(gx, gy, sum(1 for cc in coeffs if cc))
                else:
                    nc_y.set(gx, gy, 0)
            lv = np.zeros(64, np.int64)
            lv[ht.ZIGZAG_8x8] = lv64
            pb = intra8.predict8(rec_y, x + ox, y + oy, mbw, modes[b8])
            d8 = ht.inverse8x8(ht.dequant8x8(lv.reshape(8, 8), qp))
            rec_y[y + oy:y + oy + 8, x + ox:x + ox + 8] = np.clip(
                pb + d8, 0, 255)
        self._decode_chroma_cavlc(r, rec_u, rec_v, nc_u, nc_v, mbx, mby,
                                  qpc, cmode, cbp_chroma)

    # video_codecs_tpu/models/h264/intra_codec.py:1529
    def _decode_chroma_cavlc(self, r, rec_u, rec_v, nc_u, nc_v, mbx, mby,
                             qpc, cmode, cbp_chroma):
        """Shared 4:2:0 chroma residual decode (DC + AC CAVLC)."""
        import numpy as np
        cx, cy = mbx * 8, mby * 8
        zz = cavlc.ZIGZAG_4x4
        c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
        c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
        if cbp_chroma:
            for comp in (0, 1):
                lst = cavlc.decode_block(r, -1, 4)
                c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = lst[0], lst[1]
                c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = lst[2], lst[3]
        for comp, grid in ((0, nc_u), (1, nc_v)):
            for idx in range(4):
                x4, y4 = idx & 1, idx >> 1
                gx, gy = mbx * 2 + x4, mby * 2 + y4
                if cbp_chroma == 2:
                    coeffs = cavlc.decode_block(r, grid.nc(gx, gy), 15)
                    flat = np.zeros(16, np.int64)
                    flat[zz[1:]] = coeffs
                    c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                    grid.set(gx, gy, sum(1 for cc in coeffs if cc))
                else:
                    grid.set(gx, gy, 0)
        for comp, plane in ((0, rec_u), (1, rec_v)):
            cpred = pred_chroma8(plane, cx, cy, cmode)
            cdc_deq = ht.dequant_chroma_dc(c_dc_q[comp], qpc)
            cd = ht.dequant_ac(c_ac_q[comp], qpc)
            cd[:, :, 0, 0] = cdc_deq
            cr2 = ht.inverse4x4(cd)
            plane[cy:cy + 8, cx:cx + 8] = np.clip(
                cpred + cr2.transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)
