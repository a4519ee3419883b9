"""H.264 SEI messages: write + parse (spec 7.3.2.3 / Annex D).

The port's copy of video_codecs_tpu/models/h264/sei.py, whole: each
function and class under its own name, with a comment giving the
original's line.  Buffering period and picture timing parse with the
fixed layout the writers use (24-bit delays, one CPB), whatever the
active SPS's HRD says, as the original does.

Parity reference: jm18.5/lencod/src/sei.c (20+ writers) and
ldecod/src/sei.c (InterpretSEIMessage).  This implements the commonly
exercised payload types with full roundtrip; unknown types parse to
(type, payload) tuples.  Framing (ff-escaped type/size, trailing bits)
follows the same rules as HEVC SEI.

NAL type 6 (SEI), always non-VCL; insertable before any slice NAL —
JM's decoder skips unknown payloads, verified in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from video_codecs_tpu_torch.entropy.bitstream import BitReader, BitWriter

NAL_SEI = 6

BUFFERING_PERIOD = 0
PIC_TIMING = 1
USER_DATA_REGISTERED = 4
USER_DATA_UNREGISTERED = 5
RECOVERY_POINT = 6
DEC_REF_PIC_MARKING_REPETITION = 7
SCENE_INFO = 9
FULL_FRAME_FREEZE = 13
FULL_FRAME_FREEZE_RELEASE = 14
FRAME_PACKING = 45


# video_codecs_tpu/models/h264/sei.py:33
@dataclass
class BufferingPeriod:
    """sei.c buffering period (spec D.1.1), single NAL-HRD CPB with the
    24-bit delay lengths this package's HRD writers use."""
    sps_id: int = 0
    initial_cpb_removal_delay: int = 90000
    initial_cpb_removal_delay_offset: int = 0

    # video_codecs_tpu/models/h264/sei.py:41
    def write(self, w: BitWriter) -> None:
        w.ue(self.sps_id)
        w.write(self.initial_cpb_removal_delay, 24)
        w.write(self.initial_cpb_removal_delay_offset, 24)

    # video_codecs_tpu/models/h264/sei.py:46
    @classmethod
    def parse(cls, r: BitReader, size: int = 0) -> "BufferingPeriod":
        return cls(r.ue(), r.read(24), r.read(24))


# video_codecs_tpu/models/h264/sei.py:51
@dataclass
class PicTiming:
    """sei.c picture timing (spec D.1.2): 24-bit CPB removal / DPB output
    delays + pic_struct with no clock timestamps."""
    cpb_removal_delay: int = 0
    dpb_output_delay: int = 0
    pic_struct: int = 0               # 0 = progressive frame

    # video_codecs_tpu/models/h264/sei.py:59
    def write(self, w: BitWriter) -> None:
        w.write(self.cpb_removal_delay, 24)
        w.write(self.dpb_output_delay, 24)
        w.write(self.pic_struct, 4)
        w.flag(0)                     # clock_timestamp_flag[0]

    # video_codecs_tpu/models/h264/sei.py:65
    @classmethod
    def parse(cls, r: BitReader, size: int = 0) -> "PicTiming":
        out = cls(r.read(24), r.read(24), r.read(4))
        r.flag()
        return out


# video_codecs_tpu/models/h264/sei.py:72
@dataclass
class UserDataUnregistered:
    """sei.c UpdateUser_data_unregistered."""
    uuid: bytes = bytes(16)
    data: bytes = b""

    # video_codecs_tpu/models/h264/sei.py:78
    def write(self, w: BitWriter) -> None:
        for b in self.uuid:
            w.write(b, 8)
        for b in self.data:
            w.write(b, 8)

    # video_codecs_tpu/models/h264/sei.py:84
    @classmethod
    def parse(cls, r: BitReader, size: int) -> "UserDataUnregistered":
        uuid = bytes(r.read(8) for _ in range(16))
        data = bytes(r.read(8) for _ in range(size - 16))
        return cls(uuid, data)


# video_codecs_tpu/models/h264/sei.py:91
@dataclass
class UserDataRegistered:
    """itu_t_t35 user data (sei.c UpdateUser_data_registered_itu_t_t35)."""
    country_code: int = 0xB5       # US
    data: bytes = b""

    # video_codecs_tpu/models/h264/sei.py:97
    def write(self, w: BitWriter) -> None:
        w.write(self.country_code, 8)
        if self.country_code == 0xFF:
            w.write(0, 8)          # extension byte (simplified)
        for b in self.data:
            w.write(b, 8)

    # video_codecs_tpu/models/h264/sei.py:104
    @classmethod
    def parse(cls, r: BitReader, size: int) -> "UserDataRegistered":
        cc = r.read(8)
        n = size - 1
        if cc == 0xFF:
            r.read(8)
            n -= 1
        return cls(cc, bytes(r.read(8) for _ in range(n)))


# video_codecs_tpu/models/h264/sei.py:114
@dataclass
class RecoveryPoint:
    """sei.c UpdateRandomAccess / spec D.2.8."""
    recovery_frame_cnt: int = 0
    exact_match: bool = True
    broken_link: bool = False
    changing_slice_group_idc: int = 0

    # video_codecs_tpu/models/h264/sei.py:122
    def write(self, w: BitWriter) -> None:
        w.ue(self.recovery_frame_cnt)
        w.flag(1 if self.exact_match else 0)
        w.flag(1 if self.broken_link else 0)
        w.write(self.changing_slice_group_idc, 2)

    # video_codecs_tpu/models/h264/sei.py:128
    @classmethod
    def parse(cls, r: BitReader, size: int = 0) -> "RecoveryPoint":
        return cls(r.ue(), bool(r.flag()), bool(r.flag()), r.read(2))


# video_codecs_tpu/models/h264/sei.py:133
@dataclass
class SceneInfo:
    """spec D.2.10 (sei.c UpdateSceneInformation)."""
    scene_info_present: bool = True
    scene_id: int = 0
    scene_transition_type: int = 0
    second_scene_id: int = 0

    # video_codecs_tpu/models/h264/sei.py:141
    def write(self, w: BitWriter) -> None:
        w.flag(1 if self.scene_info_present else 0)
        if self.scene_info_present:
            w.ue(self.scene_id)
            w.ue(self.scene_transition_type)
            if self.scene_transition_type > 3:
                w.ue(self.second_scene_id)

    # video_codecs_tpu/models/h264/sei.py:149
    @classmethod
    def parse(cls, r: BitReader, size: int = 0) -> "SceneInfo":
        m = cls(bool(r.flag()))
        if m.scene_info_present:
            m.scene_id = r.ue()
            m.scene_transition_type = r.ue()
            if m.scene_transition_type > 3:
                m.second_scene_id = r.ue()
        return m


# video_codecs_tpu/models/h264/sei.py:160
@dataclass
class FullFrameFreeze:
    """spec D.2.14."""
    full_frame_freeze_repetition_period: int = 0

    # video_codecs_tpu/models/h264/sei.py:165
    def write(self, w: BitWriter) -> None:
        w.ue(self.full_frame_freeze_repetition_period)

    # video_codecs_tpu/models/h264/sei.py:168
    @classmethod
    def parse(cls, r: BitReader, size: int = 0) -> "FullFrameFreeze":
        return cls(r.ue())


# video_codecs_tpu/models/h264/sei.py:173
@dataclass
class FramePacking:
    """frame_packing_arrangement (spec D.2.25; stereo/3D signalling —
    the JM MVC/stereo toolchain's companion message)."""
    arrangement_id: int = 0
    cancel: bool = False
    arrangement_type: int = 3      # side-by-side
    quincunx: bool = False
    content_interpretation: int = 1
    repetition_period: int = 0

    # video_codecs_tpu/models/h264/sei.py:184
    def write(self, w: BitWriter) -> None:
        w.ue(self.arrangement_id)
        w.flag(1 if self.cancel else 0)
        if not self.cancel:
            w.write(self.arrangement_type, 7)
            w.flag(1 if self.quincunx else 0)
            w.write(self.content_interpretation, 6)
            w.flag(0)              # spatial_flipping
            w.flag(0)              # frame0_flipped
            w.flag(0)              # field_views
            w.flag(0)              # current_frame_is_frame0
            w.flag(0)              # frame0_self_contained
            w.flag(0)              # frame1_self_contained
            for _ in range(4):
                w.write(0, 4)      # grid positions
            w.write(0, 8)          # reserved
            w.ue(self.repetition_period)
        w.flag(0)                  # extension flag

    # video_codecs_tpu/models/h264/sei.py:203
    @classmethod
    def parse(cls, r: BitReader, size: int = 0) -> "FramePacking":
        m = cls(arrangement_id=r.ue(), cancel=bool(r.flag()))
        if not m.cancel:
            m.arrangement_type = r.read(7)
            m.quincunx = bool(r.flag())
            m.content_interpretation = r.read(6)
            for _ in range(6):
                r.flag()
            for _ in range(4):
                r.read(4)
            r.read(8)
            m.repetition_period = r.ue()
        r.flag()
        return m


_TYPES = {
    BUFFERING_PERIOD: BufferingPeriod,
    PIC_TIMING: PicTiming,
    USER_DATA_REGISTERED: UserDataRegistered,
    USER_DATA_UNREGISTERED: UserDataUnregistered,
    RECOVERY_POINT: RecoveryPoint,
    SCENE_INFO: SceneInfo,
    FULL_FRAME_FREEZE: FullFrameFreeze,
    FRAME_PACKING: FramePacking,
}
_TYPE_OF = {v: k for k, v in _TYPES.items()}
_SIZED_PARSE = {UserDataRegistered, UserDataUnregistered}


# video_codecs_tpu/models/h264/sei.py:234
def _payload_bytes(msg) -> bytes:
    w = BitWriter()
    msg.write(w)
    if not w.byte_aligned():
        w.flag(1)                  # bit_equal_to_one + alignment zeros
        while not w.byte_aligned():
            w.flag(0)
    return w.data()


# video_codecs_tpu/models/h264/sei.py:244
def write_sei_rbsp(messages: list) -> bytes:
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
        for b in payload:
            w.write(b, 8)
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/h264/sei.py:264
def sei_nal(messages: list) -> bytes:
    from video_codecs_tpu_torch.models.h264.intra_codec import nal_unit
    return nal_unit(NAL_SEI, write_sei_rbsp(messages))


# video_codecs_tpu/models/h264/sei.py:269
def parse_sei_rbsp(rbsp: bytes) -> list:
    out = []
    pos = 0
    while pos < len(rbsp):
        if rbsp[pos] == 0x80 and all(b == 0 for b in rbsp[pos + 1:]):
            break                  # rbsp_trailing_bits
        ptype = 0
        while rbsp[pos] == 255:
            ptype += 255
            pos += 1
        ptype += rbsp[pos]
        pos += 1
        size = 0
        while rbsp[pos] == 255:
            size += 255
            pos += 1
        size += rbsp[pos]
        pos += 1
        payload = rbsp[pos:pos + size]
        pos += size
        cls = _TYPES.get(ptype)
        if cls is None:
            out.append((ptype, payload))
            continue
        r = BitReader(payload)
        out.append(cls.parse(r, size) if cls in _SIZED_PARSE
                   else cls.parse(r))
    return out
