"""RTP packetization, dump, and deterministic loss injection.

The port's copy of video_codecs_tpu/tools/rtp.py, whole: each function
and class under its own name, with a comment giving the original's
line.

Parity reference: jm18.5/rtpdump/rtpdump.cpp (packet dump),
jm18.5/rtp_loss/rtp_loss.cpp (un-seeded rand -> identical loss pattern per
run; usage `rtp_loss infile outfile losspercent [keep_leading]`,
rtp_loss/ReadMe.txt:1-14), jm18.5/lencod/src/rtp.c (RFC 3984-style single
NAL unit packets).

File format mirrors JM's RTP dump files: each packet is a 4-byte
little-endian length followed by the RTP header + payload.

CLI:  python -m video_codecs_tpu_torch.tools.rtp dump|loss|packetize ...
"""

from __future__ import annotations

import struct


# video_codecs_tpu/tools/rtp.py:18
def packetize(stream: bytes, ssrc: int = 0x12345678) -> list[bytes]:
    """One NAL unit per RTP packet (single NAL unit mode)."""
    from video_codecs_tpu_torch.entropy import bitstream as bs
    packets = []
    ts = 0
    for seq, nal in enumerate(bs.split_annexb(stream)):
        header = struct.pack(
            ">BBHII",
            0x80,                 # V=2, no padding/extension/CSRC
            96 | (0x80 if seq == 0 else 0),  # PT 96, marker on first
            seq & 0xFFFF, ts, ssrc)
        packets.append(header + nal)
        ts += 3000
    return packets


# video_codecs_tpu/tools/rtp.py:34
def write_dump(path: str, packets: list[bytes]) -> None:
    with open(path, "wb") as f:
        for p in packets:
            f.write(struct.pack("<I", len(p)))
            f.write(p)


# video_codecs_tpu/tools/rtp.py:41
def read_dump(path: str) -> list[bytes]:
    packets = []
    data = open(path, "rb").read()
    i = 0
    while i + 4 <= len(data):
        (n,) = struct.unpack_from("<I", data, i)
        i += 4
        packets.append(data[i:i + n])
        i += n
    return packets


# video_codecs_tpu/tools/rtp.py:53
def depacketize(packets: list[bytes]) -> bytes:
    out = bytearray()
    for p in packets:
        out += b"\x00\x00\x00\x01" + p[12:]
    return bytes(out)


# video_codecs_tpu/tools/rtp.py:60
class _LcgRand:
    """Deterministic libc-style rand() so loss patterns reproduce exactly
    (rtp_loss uses un-seeded rand(): identical pattern per run)."""

    # video_codecs_tpu/tools/rtp.py:64
    def __init__(self, seed: int = 1) -> None:
        self.state = seed

    # video_codecs_tpu/tools/rtp.py:67
    def rand(self) -> int:
        self.state = (self.state * 1103515245 + 12345) & 0x7FFFFFFF
        return self.state


# video_codecs_tpu/tools/rtp.py:72
def inject_loss(packets: list[bytes], loss_percent: int,
                keep_leading: int = 0) -> list[bytes]:
    """Drop ~loss_percent of packets after the first keep_leading ones."""
    rng = _LcgRand()
    out = []
    for i, p in enumerate(packets):
        if i < keep_leading or (rng.rand() % 100) >= loss_percent:
            out.append(p)
    return out


# video_codecs_tpu/tools/rtp.py:83
def dump_table(packets: list[bytes]) -> list[dict]:
    """rtpdump-style per-packet table."""
    rows = []
    for p in packets:
        v_p_x_cc, m_pt, seq, ts, ssrc = struct.unpack(">BBHII", p[:12])
        rows.append({
            "seq": seq, "ts": ts, "ssrc": hex(ssrc),
            "marker": bool(m_pt & 0x80), "pt": m_pt & 0x7F,
            "payload_bytes": len(p) - 12,
        })
    return rows


# video_codecs_tpu/tools/rtp.py:96
def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description="RTP dump / loss tool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("rtpfile")
    lo = sub.add_parser("loss")
    lo.add_argument("infile")
    lo.add_argument("outfile")
    lo.add_argument("losspercent", type=int)
    lo.add_argument("keep_leading", type=int, nargs="?", default=0)
    pk = sub.add_parser("packetize")
    pk.add_argument("annexb")
    pk.add_argument("rtpfile")
    args = ap.parse_args()
    if args.cmd == "dump":
        for row in dump_table(read_dump(args.rtpfile)):
            print(row)
    elif args.cmd == "loss":
        pkts = read_dump(args.infile)
        kept = inject_loss(pkts, args.losspercent, args.keep_leading)
        write_dump(args.outfile, kept)
        print(f"kept {len(kept)}/{len(pkts)} packets")
    else:
        write_dump(args.rtpfile, packetize(open(args.annexb, "rb").read()))


if __name__ == "__main__":
    main()
