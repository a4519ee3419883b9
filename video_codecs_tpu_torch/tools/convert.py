"""YUV bit-depth converter + Annex-B byte accounting.

Parity: hm-16.5rc1/source/App/utils/convert_NtoMbit_YCbCr.cpp (planar
YUV N-bit -> M-bit with rounding on narrowing) and annexBbytecount.cpp
(payload byte count per NAL type, excluding start codes).

The port's copy of video_codecs_tpu/tools/convert.py, whole; each
function keeps its name and a comment gives the original's line.

CLI:
  python -m video_codecs_tpu_torch.tools.convert in.yuv out.yuv \
      --from-bits 8 --to-bits 10
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs


# video_codecs_tpu/tools/convert.py:19
def convert_bitdepth(data: bytes, from_bits: int, to_bits: int) -> bytes:
    """Convert a raw planar YUV byte blob between bit depths.

    Widening shifts left (value * 2^(M-N)); narrowing rounds to nearest
    (convert_NtoMbit_YCbCr.cpp semantics). 8-bit samples are single
    bytes, 9..16-bit samples little-endian uint16 (the HM convention).
    """
    if from_bits == to_bits:
        return data
    src = (np.frombuffer(data, np.uint8).astype(np.int32)
           if from_bits <= 8
           else np.frombuffer(data, "<u2").astype(np.int32))
    if to_bits > from_bits:
        out = src << (to_bits - from_bits)
    else:
        sh = from_bits - to_bits
        out = np.minimum((src + (1 << (sh - 1))) >> sh, (1 << to_bits) - 1)
    return (out.astype(np.uint8).tobytes() if to_bits <= 8
            else out.astype("<u2").tobytes())


# video_codecs_tpu/tools/convert.py:40
def annexb_byte_count(stream: bytes, hevc: bool | None = None) -> dict:
    """Per-NAL-type payload byte totals (annexBbytecount.cpp).

    Counts NAL bytes (header + EBSP payload), excluding start codes.
    Returns {"total": n, "by_type": {nal_type: bytes}, "start_code": n}.
    """
    if hevc is None:
        from video_codecs_tpu_torch.tools.analyze import sniff_codec
        hevc = sniff_codec(stream) == "hevc"
    nals = bs.split_annexb(stream)
    by_type: dict[int, int] = {}
    total = 0
    for nal in nals:
        t = ((nal[0] >> 1) & 0x3F) if hevc else (nal[0] & 0x1F)
        by_type[t] = by_type.get(t, 0) + len(nal)
        total += len(nal)
    return {"total": total, "by_type": by_type,
            "start_code": len(stream) - total}


# video_codecs_tpu/tools/convert.py:60
def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--from-bits", type=int, default=8)
    ap.add_argument("--to-bits", type=int, default=10)
    a = ap.parse_args(argv)
    with open(a.infile, "rb") as f:
        data = f.read()
    with open(a.outfile, "wb") as f:
        f.write(convert_bitdepth(data, a.from_bits, a.to_bits))


if __name__ == "__main__":
    main()
