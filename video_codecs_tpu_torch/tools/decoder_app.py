"""Decoder CLI — the TAppDecoder / ldecod analog.

Usage:  python -m video_codecs_tpu_torch.tools.decoder_app -b in.bin
                [-o out.yuv] [--stats]

The port's copy of video_codecs_tpu/tools/decoder_app.py; `main` keeps
its name and a comment gives the original's line.  It prints per-picture
hash-SEI status like HM's decoder and auto-detects H.264 vs HEVC
streams.  The decoders run on the host, as the reference's do.
--stats prints the per-syntax-class bin/bit table (the
TAppDecoderAnalyser build; utils/coding_stats.py).

HEVC routing, repaired: the reference tries `LowDelayDecoder(conceal=
True)` first and takes the general decoder only if that raises, but that
decoder skips TRAIL_N pictures without a word and conceals, by frame
copy, every picture it cannot parse, so on a random-access stream it
never raises and returns wrong pictures (on the reference's own encoder
CLI's random-access streams too).  Here a stream with a VCL NAL unit type
`LowDelayDecoder` does not take, or with a B slice, goes to the general
decoder (`_needs_general`); low-delay P and all-intra streams still
take `LowDelayDecoder` with its concealment.
"""

from __future__ import annotations

import sys

import numpy as np


def _needs_general(stream: bytes) -> bool:
    """Whether an HEVC stream holds a VCL NAL unit type that
    `LowDelayDecoder` does not decode (anything but IDR, CRA and
    TRAIL_R), or a B slice."""
    from video_codecs_tpu_torch.entropy import bitstream as bs
    from video_codecs_tpu_torch.models.hevc import decoder as gdec
    from video_codecs_tpu_torch.models.hevc.inter_codec import NAL_TRAIL_R

    pps = None
    for nal in bs.split_annexb(stream):
        nal_type = (nal[0] >> 1) & 0x3F
        rbsp = bs.strip_emulation_prevention(nal[2:])
        if nal_type == bs.NAL_PPS:
            pps = gdec.parse_pps(rbsp)
        elif nal_type <= 21 and nal_type not in (
                bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP, bs.NAL_CRA, NAL_TRAIL_R):
            return True
        elif nal_type == NAL_TRAIL_R and pps is not None:
            r = bs.BitReader(rbsp)
            if not r.flag():              # first_slice_segment_in_pic_flag
                continue
            r.ue()                        # slice_pic_parameter_set_id
            for _ in range(pps.num_extra_bits):
                r.flag()                  # slice_reserved_flag
            if r.ue() == 0:               # slice_type B
                return True
    return False


# video_codecs_tpu/tools/decoder_app.py:17
def main(argv=None) -> None:
    from video_codecs_tpu_torch.tools import analyze
    from video_codecs_tpu_torch.utils import coding_stats, yuv

    argv = sys.argv[1:] if argv is None else argv
    stats = "--stats" in argv
    argv = [a for a in argv if a != "--stats"]
    args = dict(zip(argv[::2], argv[1::2]))
    stream = open(args["-b"], "rb").read()
    codec = analyze.sniff_codec(stream)
    if stats:
        coding_stats.start()

    if codec == "h264":
        from video_codecs_tpu_torch.models.h264 import inter_codec as h264
        dec = h264.H264Decoder()
        frames = dec.decode(stream)
        status = ["(no hash SEI)"] * len(frames)
    else:
        from video_codecs_tpu_torch.models.hevc import decoder as gdec
        from video_codecs_tpu_torch.models.hevc import inter_codec
        dec = None
        if not _needs_general(stream):
            try:
                dec = inter_codec.LowDelayDecoder(conceal=True)
                frames = dec.decode(stream)
            except Exception:
                dec = None
        if dec is None:
            # general conformant decoder (random access, HM-encoder
            # streams etc.)
            dec = gdec.GeneralIntraDecoder()
            frames = dec.decode(stream)
        status = ["(OK)" if ok else "***ERROR***" for ok in dec.hash_status]
        status += ["(no hash SEI)"] * (len(frames) - len(status))

    if stats:
        print(coding_stats.stop().report())
    for i, st in enumerate(status):
        print(f"POC {i:4d} [{st}]")
    if "-o" in args and frames:
        yuv.write_frames(args["-o"],
                         np.stack([f[0] for f in frames]).astype(np.uint8),
                         np.stack([f[1] for f in frames]).astype(np.uint8),
                         np.stack([f[2] for f in frames]).astype(np.uint8))
    print(f"{len(frames)} pictures decoded ({codec}).")


if __name__ == "__main__":
    main()
