"""HEVC SEI messages: write + parse for the common payload types.

Parity targets (reference: hm-16.5rc1/source/Lib/TLibCommon/SEI.h:99-521,
writers TLibEncoder/SEIwrite.cpp, parsers TLibDecoder/SEIread.cpp):
buffering period (:157), picture timing (:187), user data unregistered,
recovery point (:235), active parameter sets, frame packing arrangement,
tone mapping info, mastering display colour volume, content light level.
The decoded-picture-hash SEI (:118) lives with the encoders
(intra_codec._hash_sei) since it is computed from the recon.

Simplifications vs the reference (documented, parse-compatible with our
writer): buffering period assumes the default 24-bit HRD delay lengths
(initial_cpb_removal_delay_length_minus1 = 23, TComHRD defaults) and a
single NAL-HRD schedule; picture timing carries only the frame-field
info fields (the no-HRD variant HM emits when frame_field_info_present
and CPB params are absent).

The port's copy of video_codecs_tpu/models/hevc/sei.py, whole and host
only: every message class, the writer and the parser, each function
keeping its name and a comment giving the original's line, so that the
port's parser reads what its writer writes.  The low-delay P encoder
(models/hevc/inter_codec.LowDelayEncoder.encode_frames) writes the
buffering-period and picture-timing messages with `cfg.timing_sei`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy.bitstream import BitReader, BitWriter

# payload types (spec D.2.1 / SEI.h PayloadType enum)
BUFFERING_PERIOD = 0
PICTURE_TIMING = 1
USER_DATA_UNREGISTERED = 5
RECOVERY_POINT = 6
TONE_MAPPING_INFO = 23
FRAME_PACKING = 45
ACTIVE_PARAMETER_SETS = 129
DECODED_PICTURE_HASH = 132
SCALABLE_NESTING = 133
REGION_REFRESH_INFO = 134
NO_DISPLAY = 135
TIME_CODE = 136
MASTERING_DISPLAY = 137
SEGM_RECT_FRAME_PACKING = 138
TEMP_MOTION_CONSTRAINED_TILE_SETS = 139
KNEE_FUNCTION_INFO = 141
CONTENT_LIGHT_LEVEL = 144


@dataclass
class BufferingPeriod:
    """SEI.h:157 SEIBufferingPeriod (single NAL-HRD CPB, 24-bit delays)."""
    sps_id: int = 0
    initial_cpb_removal_delay: int = 90000
    initial_cpb_removal_offset: int = 0

    # video_codecs_tpu/models/hevc/sei.py:53
    def write(self, w: BitWriter) -> None:
        w.ue(self.sps_id)
        w.flag(0)                     # irap_cpb_params_present_flag
        w.flag(0)                     # concatenation_flag
        w.write(0, 24)                # au_cpb_removal_delay_delta_minus1
        w.write(self.initial_cpb_removal_delay, 24)
        w.write(self.initial_cpb_removal_offset, 24)

    # video_codecs_tpu/models/hevc/sei.py:61
    @classmethod
    def parse(cls, r: BitReader) -> "BufferingPeriod":
        sps_id = r.ue()
        assert r.flag() == 0 and r.flag() == 0
        r.read(24)
        return cls(sps_id, r.read(24), r.read(24))


@dataclass
class PictureTiming:
    """SEI.h:187 SEIPictureTiming: frame-field info plus, when the SPS HRD
    signals CpbDpbDelaysPresent, the 24-bit AU CPB removal / DPB output
    delays (the write_vui HRD twin uses 24-bit delay lengths)."""
    pic_struct: int = 0               # 0 = progressive frame
    source_scan_type: int = 1         # 1 = progressive
    duplicate_flag: int = 0
    au_cpb_removal_delay_minus1: int | None = None
    pic_dpb_output_delay: int = 0

    # video_codecs_tpu/models/hevc/sei.py:80
    def write(self, w: BitWriter) -> None:
        w.write(self.pic_struct, 4)
        w.write(self.source_scan_type, 2)
        w.flag(self.duplicate_flag)
        if self.au_cpb_removal_delay_minus1 is not None:
            w.write(self.au_cpb_removal_delay_minus1, 24)
            w.write(self.pic_dpb_output_delay, 24)

    # video_codecs_tpu/models/hevc/sei.py:88
    @classmethod
    def parse(cls, r: BitReader) -> "PictureTiming":
        out = cls(r.read(4), r.read(2), r.flag())
        if r.bits_left() >= 48:       # CPB/DPB delays present (24+24)
            out.au_cpb_removal_delay_minus1 = r.read(24)
            out.pic_dpb_output_delay = r.read(24)
        return out


@dataclass
class UserDataUnregistered:
    """SEI.h user data unregistered: 16-byte UUID + payload bytes."""
    uuid: bytes = b"\x00" * 16
    data: bytes = b""

    # video_codecs_tpu/models/hevc/sei.py:103
    def write(self, w: BitWriter) -> None:
        assert len(self.uuid) == 16
        for b_ in self.uuid + self.data:
            w.write(b_, 8)

    # video_codecs_tpu/models/hevc/sei.py:108
    @classmethod
    def parse(cls, r: BitReader, size: int) -> "UserDataUnregistered":
        uuid = bytes(r.read(8) for _ in range(16))
        data = bytes(r.read(8) for _ in range(size - 16))
        return cls(uuid, data)


@dataclass
class RecoveryPoint:
    """SEI.h:235 SEIRecoveryPoint — decoder may join at this AU and be
    fully refreshed recovery_poc_cnt pictures later."""
    recovery_poc_cnt: int = 0
    exact_match: bool = True
    broken_link: bool = False

    # video_codecs_tpu/models/hevc/sei.py:123
    def write(self, w: BitWriter) -> None:
        w.se(self.recovery_poc_cnt)
        w.flag(1 if self.exact_match else 0)
        w.flag(1 if self.broken_link else 0)

    # video_codecs_tpu/models/hevc/sei.py:128
    @classmethod
    def parse(cls, r: BitReader) -> "RecoveryPoint":
        return cls(r.se(), bool(r.flag()), bool(r.flag()))


@dataclass
class ToneMappingInfo:
    """SEI.h tone mapping info, models 0-3 (linear/sigmoid/user map)."""
    tone_map_id: int = 0
    cancel: bool = False
    persistence: bool = True
    coded_bit_depth: int = 8
    target_bit_depth: int = 8
    model_id: int = 0
    min_value: int = 0                # model 0
    max_value: int = 255
    sigmoid_midpoint: int = 128       # model 1
    sigmoid_width: int = 64
    start_of_coded_interval: list = field(default_factory=list)  # model 2
    coded_pivot: list = field(default_factory=list)              # model 3
    target_pivot: list = field(default_factory=list)

    # video_codecs_tpu/models/hevc/sei.py:150
    def write(self, w: BitWriter) -> None:
        w.ue(self.tone_map_id)
        w.flag(1 if self.cancel else 0)
        if self.cancel:
            return
        w.flag(1 if self.persistence else 0)
        w.ue(self.coded_bit_depth)
        w.ue(self.target_bit_depth)
        w.ue(self.model_id)
        if self.model_id == 0:
            w.write(self.min_value, 32)
            w.write(self.max_value, 32)
        elif self.model_id == 1:
            w.write(self.sigmoid_midpoint, 32)
            w.write(self.sigmoid_width, 32)
        elif self.model_id == 2:
            for v in self.start_of_coded_interval:
                w.write(v, (self.coded_bit_depth + 7) & ~7)
        elif self.model_id == 3:
            w.write(len(self.coded_pivot), 16)
            nb = (self.coded_bit_depth + 7) & ~7
            tb = (self.target_bit_depth + 7) & ~7
            for c, t in zip(self.coded_pivot, self.target_pivot):
                w.write(c, nb)
                w.write(t, tb)

    # video_codecs_tpu/models/hevc/sei.py:176
    @classmethod
    def parse(cls, r: BitReader) -> "ToneMappingInfo":
        m = cls(tone_map_id=r.ue(), cancel=bool(r.flag()))
        if m.cancel:
            return m
        m.persistence = bool(r.flag())
        m.coded_bit_depth = r.ue()
        m.target_bit_depth = r.ue()
        m.model_id = r.ue()
        if m.model_id == 0:
            m.min_value, m.max_value = r.read(32), r.read(32)
        elif m.model_id == 1:
            m.sigmoid_midpoint, m.sigmoid_width = r.read(32), r.read(32)
        elif m.model_id == 2:
            nb = (m.coded_bit_depth + 7) & ~7
            n = (1 << m.target_bit_depth)
            m.start_of_coded_interval = [r.read(nb) for _ in range(n)]
        elif m.model_id == 3:
            n = r.read(16)
            nb = (m.coded_bit_depth + 7) & ~7
            tb = (m.target_bit_depth + 7) & ~7
            for _ in range(n):
                m.coded_pivot.append(r.read(nb))
                m.target_pivot.append(r.read(tb))
        return m


@dataclass
class FramePacking:
    """SEI.h frame packing arrangement (stereo 3D signalling)."""
    arrangement_id: int = 0
    cancel: bool = False
    arrangement_type: int = 3         # 3 = side-by-side, 4 = top-bottom
    quincunx: bool = False
    content_interpretation: int = 1   # 1 = left first

    # video_codecs_tpu/models/hevc/sei.py:212
    def write(self, w: BitWriter) -> None:
        w.ue(self.arrangement_id)
        w.flag(1 if self.cancel else 0)
        if self.cancel:
            return
        w.write(self.arrangement_type, 7)
        w.flag(1 if self.quincunx else 0)
        w.write(self.content_interpretation, 6)
        for _ in range(6):            # spatial flipping/grid flags off
            w.flag(0)
        w.write(0, 8)                 # frame0_grid_position / reserved
        w.flag(0)                     # persistence
        w.flag(0)                     # upsampled_aspect_ratio

    # video_codecs_tpu/models/hevc/sei.py:226
    @classmethod
    def parse(cls, r: BitReader) -> "FramePacking":
        m = cls(arrangement_id=r.ue(), cancel=bool(r.flag()))
        if m.cancel:
            return m
        m.arrangement_type = r.read(7)
        m.quincunx = bool(r.flag())
        m.content_interpretation = r.read(6)
        for _ in range(6):
            r.flag()
        r.read(8)
        r.flag()
        r.flag()
        return m


@dataclass
class ActiveParameterSets:
    """SEI.h active parameter sets."""
    vps_id: int = 0
    full_random_access: bool = True
    no_param_set_update: bool = True
    sps_ids: list = field(default_factory=lambda: [0])

    # video_codecs_tpu/models/hevc/sei.py:250
    def write(self, w: BitWriter) -> None:
        w.write(self.vps_id, 4)
        w.flag(1 if self.full_random_access else 0)
        w.flag(1 if self.no_param_set_update else 0)
        w.ue(len(self.sps_ids) - 1)
        for s in self.sps_ids:
            w.ue(s)

    # video_codecs_tpu/models/hevc/sei.py:258
    @classmethod
    def parse(cls, r: BitReader) -> "ActiveParameterSets":
        m = cls(vps_id=r.read(4), full_random_access=bool(r.flag()),
                no_param_set_update=bool(r.flag()), sps_ids=[])
        n = r.ue() + 1
        m.sps_ids = [r.ue() for _ in range(n)]
        return m


@dataclass
class MasteringDisplay:
    """SEI.h:~ mastering display colour volume (SMPTE ST 2086)."""
    primaries: tuple = ((35400, 14600), (8500, 39850), (6550, 2300))
    white_point: tuple = (15635, 16450)
    max_luminance: int = 10000000
    min_luminance: int = 50

    # video_codecs_tpu/models/hevc/sei.py:275
    def write(self, w: BitWriter) -> None:
        for gx, gy in self.primaries:
            w.write(gx, 16)
            w.write(gy, 16)
        w.write(self.white_point[0], 16)
        w.write(self.white_point[1], 16)
        w.write(self.max_luminance, 32)
        w.write(self.min_luminance, 32)

    # video_codecs_tpu/models/hevc/sei.py:284
    @classmethod
    def parse(cls, r: BitReader) -> "MasteringDisplay":
        prim = tuple((r.read(16), r.read(16)) for _ in range(3))
        wp = (r.read(16), r.read(16))
        return cls(prim, wp, r.read(32), r.read(32))


@dataclass
class ContentLightLevel:
    """Content light level info (max content / max frame-average)."""
    max_content: int = 1000
    max_pic_average: int = 400

    # video_codecs_tpu/models/hevc/sei.py:297
    def write(self, w: BitWriter) -> None:
        w.write(self.max_content, 16)
        w.write(self.max_pic_average, 16)

    # video_codecs_tpu/models/hevc/sei.py:301
    @classmethod
    def parse(cls, r: BitReader) -> "ContentLightLevel":
        return cls(r.read(16), r.read(16))


@dataclass
class KneeFunctionInfo:
    """Knee-function SEI (spec D.2.24; SEIwrite.cpp:743
    xWriteSEIKneeFunctionInfo)."""
    knee_id: int = 0
    cancel: bool = False
    persistence: bool = True
    input_d_range: int = 4000
    input_disp_luminance: int = 100
    output_d_range: int = 10000
    output_disp_luminance: int = 4000
    points: tuple = ((0, 0), (512, 512), (1023, 1023))  # 10-bit in/out pairs

    # video_codecs_tpu/models/hevc/sei.py:319
    def write(self, w: BitWriter) -> None:
        w.ue(self.knee_id)
        w.flag(1 if self.cancel else 0)
        if self.cancel:
            return
        w.flag(1 if self.persistence else 0)
        w.write(self.input_d_range, 32)
        w.write(self.input_disp_luminance, 32)
        w.write(self.output_d_range, 32)
        w.write(self.output_disp_luminance, 32)
        w.ue(len(self.points) - 1)
        for ip, op in self.points:
            w.write(ip, 10)
            w.write(op, 10)

    # video_codecs_tpu/models/hevc/sei.py:334
    @classmethod
    def parse(cls, r: BitReader) -> "KneeFunctionInfo":
        m = cls(knee_id=r.ue(), cancel=bool(r.flag()))
        if m.cancel:
            return m
        m.persistence = bool(r.flag())
        m.input_d_range = r.read(32)
        m.input_disp_luminance = r.read(32)
        m.output_d_range = r.read(32)
        m.output_disp_luminance = r.read(32)
        n = r.ue() + 1
        m.points = tuple((r.read(10), r.read(10)) for _ in range(n))
        return m


@dataclass
class RegionRefreshInfo:
    """Gradual-decoding-refresh region SEI (spec D.2.22)."""
    refreshed: bool = True

    # video_codecs_tpu/models/hevc/sei.py:354
    def write(self, w: BitWriter) -> None:
        w.flag(1 if self.refreshed else 0)

    # video_codecs_tpu/models/hevc/sei.py:357
    @classmethod
    def parse(cls, r: BitReader) -> "RegionRefreshInfo":
        return cls(bool(r.flag()))


@dataclass
class NoDisplay:
    """No-display SEI (spec D.2.23) — empty payload."""

    # video_codecs_tpu/models/hevc/sei.py:366
    def write(self, w: BitWriter) -> None:
        pass

    # video_codecs_tpu/models/hevc/sei.py:369
    @classmethod
    def parse(cls, r: BitReader) -> "NoDisplay":
        return cls()


@dataclass
class TimeCode:
    """Time-code SEI (spec D.2.26; SEIwrite.cpp xWriteSEITimeCode),
    full-timestamp clock sets only."""
    clock_ts: tuple = ((0, 0, 0, 0),)   # (n_frames, s, m, h) per set
    counting_type: int = 0

    # video_codecs_tpu/models/hevc/sei.py:381
    def write(self, w: BitWriter) -> None:
        assert len(self.clock_ts) <= 3, \
            "num_clock_ts is a 2-bit field: at most 3 clock sets"
        w.write(len(self.clock_ts), 2)
        for nf, s, m, h in self.clock_ts:
            w.flag(1)                   # clock_time_stamp_flag
            w.flag(0)                   # units_field_based_flag
            w.write(self.counting_type, 5)
            w.flag(1)                   # full_timestamp_flag
            w.flag(0)                   # discontinuity_flag
            w.flag(0)                   # cnt_dropped_flag
            w.write(nf, 9)
            w.write(s, 6)
            w.write(m, 6)
            w.write(h, 5)
            w.write(0, 5)               # time_offset_length

    # video_codecs_tpu/models/hevc/sei.py:398
    @classmethod
    def parse(cls, r: BitReader) -> "TimeCode":
        # Sets with clock_time_stamp_flag=0 carry no timestamp and are
        # skipped (not stored as None) so parse output is always writable.
        n = r.read(2)
        sets = []
        ct = 0
        for _ in range(n):
            if not r.flag():
                continue
            assert r.flag() == 0
            ct = r.read(5)
            full = r.flag()
            r.flag()
            r.flag()
            nf = r.read(9)
            if full:
                s, m, h = r.read(6), r.read(6), r.read(5)
            else:                        # optional cascaded fields
                s = m = h = 0
                if r.flag():
                    s = r.read(6)
                    if r.flag():
                        m = r.read(6)
                        if r.flag():
                            h = r.read(5)
            tol = r.read(5)
            if tol:
                r.read(tol)
            sets.append((nf, s, m, h))
        return cls(tuple(sets), ct)


@dataclass
class SegmRectFramePacking:
    """Segmented rectangular frame packing SEI (spec D.2.16)."""
    cancel: bool = False
    content_interpretation: int = 1
    persistence: bool = False

    # video_codecs_tpu/models/hevc/sei.py:438
    def write(self, w: BitWriter) -> None:
        w.flag(1 if self.cancel else 0)
        if self.cancel:
            return
        w.write(self.content_interpretation, 2)
        w.flag(1 if self.persistence else 0)

    # video_codecs_tpu/models/hevc/sei.py:445
    @classmethod
    def parse(cls, r: BitReader) -> "SegmRectFramePacking":
        m = cls(cancel=bool(r.flag()))
        if m.cancel:
            return m
        m.content_interpretation = r.read(2)
        m.persistence = bool(r.flag())
        return m


@dataclass
class TempMotionConstrainedTileSets:
    """Temporal MCTS SEI (spec D.2.29; SEIwrite.cpp:546; SEI.h:521).

    tile_sets: tuple of (mcts_id, ((top_left, bottom_right), ...)[, exact])
    tile rectangles in tile-index units; the optional third element is the
    per-set exact_sample_value_match_flag (only coded when all_exact_match
    is false; defaults to True).  The independently-decodable-tiles promise
    is what the TPU tile sharding relies on."""
    all_exact_match: bool = True
    each_tile_one_set: bool = False
    tile_sets: tuple = ((0, ((0, 0),)),)

    # video_codecs_tpu/models/hevc/sei.py:468
    @staticmethod
    def _unpack(entry):
        mcts_id, rects = entry[0], entry[1]
        exact = entry[2] if len(entry) > 2 else True
        return mcts_id, rects, exact

    # video_codecs_tpu/models/hevc/sei.py:474
    def write(self, w: BitWriter) -> None:
        w.flag(1 if self.all_exact_match else 0)
        w.flag(1 if self.each_tile_one_set else 0)
        if self.each_tile_one_set:
            w.flag(0)                   # max_mcs_tier_level_idc_present
            return
        w.flag(0)                       # limited_tile_set_display_flag
        w.ue(len(self.tile_sets) - 1)
        for entry in self.tile_sets:
            mcts_id, rects, exact = self._unpack(entry)
            w.ue(mcts_id)
            w.ue(len(rects) - 1)
            for tl, br in rects:
                w.ue(tl)
                w.ue(br)
            if not self.all_exact_match:
                w.flag(1 if exact else 0)  # exact_sample_value_match_flag
            w.flag(0)                   # mcts_tier_level_idc_present_flag

    # video_codecs_tpu/models/hevc/sei.py:493
    @classmethod
    def parse(cls, r: BitReader) -> "TempMotionConstrainedTileSets":
        m = cls(all_exact_match=bool(r.flag()),
                each_tile_one_set=bool(r.flag()))
        if m.each_tile_one_set:
            if r.flag():
                r.flag()
                r.read(8)
            m.tile_sets = ()
            return m
        assert r.flag() == 0
        n = r.ue() + 1
        sets = []
        for _ in range(n):
            mcts_id = r.ue()
            nr = r.ue() + 1
            rects = tuple((r.ue(), r.ue()) for _ in range(nr))
            if m.all_exact_match:
                entry = (mcts_id, rects)
            else:
                entry = (mcts_id, rects, bool(r.flag()))
            if r.flag():
                r.flag()
                r.read(8)
            sets.append(entry)
        m.tile_sets = tuple(sets)
        return m


@dataclass
class ScalableNesting:
    """Scalable-nesting SEI (spec D.2.28): carries nested SEI messages
    scoped to layers/sub-layers.  Simple-path only (no ops list,
    all-layers), which is what HM's encoder emits."""
    all_layers: bool = True
    messages: list = field(default_factory=list)

    # video_codecs_tpu/models/hevc/sei.py:530
    def write(self, w: BitWriter) -> None:
        w.flag(0)                       # bitstream_subset_flag
        w.flag(0)                       # nesting_op_flag
        w.flag(1 if self.all_layers else 0)
        if not self.all_layers:
            w.write(7, 3)               # nesting_no_op_max_temporal_id_plus1
            w.ue(0)                     # nesting_num_layers_minus1
            w.write(0, 6)               # nesting_layer_id[0]
        while not w.byte_aligned():
            w.flag(0)                   # nesting_zero_bit
        for b_ in _frame_messages(self.messages):
            w.write(b_, 8)

    # video_codecs_tpu/models/hevc/sei.py:543
    @classmethod
    def parse(cls, r: BitReader, size: int) -> "ScalableNesting":
        # r is positioned at payload start; re-parse from raw bytes so the
        # nested sei_message() framing can be walked bytewise.
        assert r.flag() == 0
        assert r.flag() == 0
        m = cls(all_layers=bool(r.flag()))
        if not m.all_layers:
            r.read(3)
            n = r.ue() + 1
            for _ in range(n):
                r.read(6)
        r.byte_align()
        m.messages = _parse_messages(r.remaining_bytes())
        return m


_TYPES = {
    BUFFERING_PERIOD: BufferingPeriod,
    PICTURE_TIMING: PictureTiming,
    USER_DATA_UNREGISTERED: UserDataUnregistered,
    RECOVERY_POINT: RecoveryPoint,
    TONE_MAPPING_INFO: ToneMappingInfo,
    FRAME_PACKING: FramePacking,
    ACTIVE_PARAMETER_SETS: ActiveParameterSets,
    SCALABLE_NESTING: ScalableNesting,
    REGION_REFRESH_INFO: RegionRefreshInfo,
    NO_DISPLAY: NoDisplay,
    TIME_CODE: TimeCode,
    MASTERING_DISPLAY: MasteringDisplay,
    SEGM_RECT_FRAME_PACKING: SegmRectFramePacking,
    TEMP_MOTION_CONSTRAINED_TILE_SETS: TempMotionConstrainedTileSets,
    KNEE_FUNCTION_INFO: KneeFunctionInfo,
    CONTENT_LIGHT_LEVEL: ContentLightLevel,
}
_TYPE_OF = {v: k for k, v in _TYPES.items()}


# video_codecs_tpu/models/hevc/sei.py:581
def _payload_bytes(msg) -> bytes:
    w = BitWriter()
    msg.write(w)
    if not w.byte_aligned():
        w.flag(1)                     # payload_bit_equal_to_one
        while not w.byte_aligned():
            w.flag(0)
        return w.data()
    return w.data()


# video_codecs_tpu/models/hevc/sei.py:592
def _frame_messages(messages: list) -> bytes:
    """ff-escaped type/size framing of a message list (sei_message())."""
    w = BitWriter()
    for msg in messages:
        ptype = _TYPE_OF[type(msg)]
        payload = _payload_bytes(msg)
        t, s = ptype, len(payload)
        while t >= 255:
            w.write(255, 8)
            t -= 255
        w.write(t, 8)
        while s >= 255:
            w.write(255, 8)
            s -= 255
        w.write(s, 8)
        for b_ in payload:
            w.write(b_, 8)
    return w.data()


# video_codecs_tpu/models/hevc/sei.py:612
def write_sei_rbsp(messages: list) -> bytes:
    """SEI RBSP: ff-escaped type/size per message + trailing bits
    (spec 7.3.5; SEIwrite.cpp writeSEImessages)."""
    w = BitWriter()
    for b_ in _frame_messages(messages):
        w.write(b_, 8)
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/hevc/sei.py:622
def sei_nal(messages: list, prefix: bool = True) -> bytes:
    return bs.nal_unit(bs.NAL_PREFIX_SEI if prefix else bs.NAL_SUFFIX_SEI,
                       write_sei_rbsp(messages))


# video_codecs_tpu/models/hevc/sei.py:627
def _parse_messages(data: bytes, top_level: bool = False) -> list:
    """Walk sei_message() framing to the end of `data`.

    Only a top-level SEI RBSP carries rbsp_trailing_bits; there the final
    0x80 byte (followed only by cabac_zero_word padding, if any) is the
    stop marker.  Nested message lists (ScalableNesting) have no stop
    byte, and a leading 0x80 there is a legitimate payload type (128, SOP
    description) — never treat it as a terminator.
    """
    out = []
    pos = 0

    def at_stop(p: int) -> bool:
        return (top_level and data[p] == 0x80 and
                all(b == 0 for b in data[p + 1:]))

    while pos < len(data) and not at_stop(pos):
        ptype = 0
        while data[pos] == 255:
            ptype += 255
            pos += 1
        ptype += data[pos]
        pos += 1
        size = 0
        while data[pos] == 255:
            size += 255
            pos += 1
        size += data[pos]
        pos += 1
        payload = data[pos:pos + size]
        pos += size
        cls = _TYPES.get(ptype)
        if cls is None:
            out.append((ptype, payload))
            continue
        r = BitReader(payload)
        if cls in (UserDataUnregistered, ScalableNesting):
            out.append(cls.parse(r, size))
        else:
            out.append(cls.parse(r))
    return out


# video_codecs_tpu/models/hevc/sei.py:670
def parse_sei_rbsp(rbsp: bytes) -> list:
    """Parse an SEI RBSP into message objects; unknown payload types are
    returned as (ptype, raw_bytes) tuples (SEIread.cpp behavior of
    skipping unrecognized payloads, but kept for inspection)."""
    return _parse_messages(rbsp, top_level=True)
