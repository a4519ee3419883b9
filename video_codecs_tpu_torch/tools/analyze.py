"""Codec sniffing for the decoder CLI.

The port's copy of the part of video_codecs_tpu/tools/analyze.py that
tools/decoder_app.py runs: `sniff_codec`, which tells an H.264 stream
from an HEVC one by its first NAL header, with the H.264 NAL type
names it reads.  Each keeps its name and a comment gives the original's
line.  Cut: the analyzer itself (`analyze`, the per-NAL field dumps and
its CLI).
"""

from __future__ import annotations

from video_codecs_tpu_torch.entropy import bitstream as bs

# video_codecs_tpu/tools/analyze.py:34
H264_NAL_NAMES = {
    1: "SLICE_NON_IDR", 2: "DPA", 3: "DPB", 4: "DPC", 5: "SLICE_IDR",
    6: "SEI", 7: "SPS", 8: "PPS", 9: "AUD", 10: "EOSEQ", 11: "EOSTREAM",
    12: "FILLER",
}


# video_codecs_tpu/tools/analyze.py:41
def sniff_codec(stream: bytes) -> str:
    """Guess codec from the first NAL header."""
    nals = bs.split_annexb(stream)
    if not nals:
        return "unknown"
    b0 = nals[0][0]
    # HEVC: forbidden_zero(1) + type(6) + layer(6) + tid(3) => 2-byte header,
    # H.264: forbidden_zero(1) + ref_idc(2) + type(5) => 1 byte.
    h264_type = b0 & 0x1F
    hevc_type = (b0 >> 1) & 0x3F
    if h264_type in (7,) and (b0 >> 5) != 0:
        return "h264"
    if hevc_type in (32, 33, 34, 19, 20, 21, 1, 0, 39, 40):
        return "hevc"
    return "h264" if h264_type in H264_NAL_NAMES else "hevc"
