"""JM-style H.264 encoder CLI — the lencod analog, on the card.

Parity: jm18.5/lencod/src/configfile.c (`Key = Value` cfg files with
`#` comments, quoted strings, CLI `-d config.cfg` + `-p Key=Value`
overrides applied in order) mapped onto this build's H264Encoder.
The stock JM cfg files (jm18.5/bin/encoder_*.cfg) parse unchanged;
unimplemented tools are warned about, not silently dropped.

Usage:
  python -m video_codecs_tpu_torch.tools.jm_encoder_app -d encoder.cfg \
      -p InputFile=in.yuv -p FramesToBeEncoded=3 [-p Key=Value ...] \
      [--device=cpu]

The port's copy of video_codecs_tpu/tools/jm_encoder_app.py; each
function keeps its name and a comment gives the original's line.  It
builds the host IPPP coder `models/h264/inter_codec.H264Encoder` (CAVLC
or CABAC, full, EPZS or UMHex search, hard, trellis or adaptive-rounding
quantization, several references) with its card stage (the integer SAD
surfaces through the SAD kernel, the sub-pel phase planes) on the card;
without a card the CLI raises.  --device=cpu, stripped before the JM
options are parsed, runs the coder on the CPU with the kernel's plain
version.  It prints the reference's warnings, level report and
report.c-style summary and writes the same files.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

# the JM parameters this build maps (configfile.h Mapping table subset)
_SUPPORTED = {
    "InputFile", "SourceWidth", "SourceHeight", "OutputWidth",
    "OutputHeight", "FramesToBeEncoded", "FrameRate", "OutputFile",
    "ReconFile", "QPISlice", "QPPSlice", "IntraPeriod", "IDRPeriod",
    "NumberReferenceFrames", "SearchRange", "SymbolMode", "SearchMode",
    "UseRDOQuant", "UseAdaptiveRounding", "ProfileIDC", "LevelIDC",
    "StartFrame",
}


# video_codecs_tpu/tools/jm_encoder_app.py:32
def parse_jm_cfg(path: str) -> dict[str, str]:
    opts: dict[str, str] = {}
    for raw in open(path, encoding="utf-8", errors="replace"):
        line = raw.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        name, value = line.split("=", 1)
        value = value.strip().strip('"')
        opts[name.strip()] = value
    return opts


# video_codecs_tpu/tools/jm_encoder_app.py:44
def main(argv=None) -> None:
    from video_codecs_tpu_torch.models.h264.inter_codec import H264Encoder
    from video_codecs_tpu_torch.tools.misc import (check_level_conformance,
                                                   minimum_level)
    from video_codecs_tpu_torch.utils import yuv

    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    if "--device=cpu" in argv:
        argv = [a for a in argv if a != "--device=cpu"]
        device = "cpu"
    elif not torch.cuda.is_available():
        raise RuntimeError("jm_encoder_app runs its encoder's card stage on "
                           "a CUDA card and finds none (--device=cpu runs "
                           "it on the CPU)")
    opts: dict[str, str] = {}
    i = 0
    while i < len(argv):
        if argv[i] == "-d":
            opts.update(parse_jm_cfg(argv[i + 1]))
            i += 2
        elif argv[i] == "-p":
            k, v = argv[i + 1].split("=", 1)
            opts[k.strip()] = v.strip().strip('"')
            i += 2
        else:
            raise SystemExit(f"unknown option {argv[i]} (use -d cfg, -p K=V)")

    g = opts.get
    for name, value in sorted(opts.items()):
        if name not in _SUPPORTED and value not in ("", "0"):
            print(f"** warning: JM option {name}={value} not implemented "
                  f"in this build — ignored", file=sys.stderr)

    w, h = int(g("SourceWidth", 176)), int(g("SourceHeight", 144))
    n = int(g("FramesToBeEncoded", 1))
    intra_period = int(g("IntraPeriod", 0))
    qp = int(g("QPPSlice", g("QPISlice", 28))) if intra_period != 1 \
        else int(g("QPISlice", 28))
    enc = H264Encoder(
        w, h, qp=qp,
        search_range=int(g("SearchRange", 16)),
        gop=0 if intra_period in (0, 1) else intra_period,
        entropy="cabac" if g("SymbolMode", "0") == "1" else "cavlc",
        n_refs=max(int(g("NumberReferenceFrames", 1)), 1),
        quant=("trellis" if g("UseRDOQuant", "0") == "1" else
               "around" if g("UseAdaptiveRounding", "0") == "1" else
               "normal"),
        # jm18.5/lcommon/inc/types.h:128-132: -1 full, 0 fast-full,
        # 1 UMHex, 2 UMHexSimple, 3 EPZS
        me={"1": "umhex", "2": "umhex", "3": "epzs"}.get(
            g("SearchMode", "0"), "full"),
        device=device)
    if intra_period == 1:
        enc.gop = 1   # all-intra

    ys, us, vs = yuv.read_frames(g("InputFile"), w, h, n,
                                 int(g("StartFrame", 0)))
    frames = [(ys[i], us[i], vs[i]) for i in range(ys.shape[0])]
    t0 = time.time()
    stream, recons = enc.encode_sequence(frames)
    dt = time.time() - t0

    out = g("OutputFile", "test.264")
    with open(out, "wb") as f:
        f.write(stream)
    if g("ReconFile"):
        yuv.write_frames(g("ReconFile"),
                         np.stack([r[0] for r in recons]).astype(np.uint8),
                         np.stack([r[1] for r in recons]).astype(np.uint8),
                         np.stack([r[2] for r in recons]).astype(np.uint8))

    fps = float(g("FrameRate", 30.0))
    kbps = len(stream) * 8 * fps / max(len(frames), 1) / 1000.0
    # conformance.c LevelCheck: validate the coded geometry/rate against
    # the signalled level (or report the minimum conforming one)
    level = int(g("LevelIDC", 0))
    if level:
        for msg in check_level_conformance(
                w, h, fps, level, bitrate_bps=kbps * 1000.0,
                dpb_frames=max(int(g("NumberReferenceFrames", 1)), 1)):
            print(f"** level {level / 10:.1f} conformance: {msg}",
                  file=sys.stderr)
    else:
        level = minimum_level(w, h, fps,
                              max(int(g("NumberReferenceFrames", 1)), 1))
        print(f" Minimum conforming level: {level / 10:.1f}")
    psnr = yuv.psnr(np.stack([r[0] for r in recons]).astype(np.float64),
                    np.stack([f[0] for f in frames]).astype(np.float64))
    # report.c-style one-line summary
    print(f" Total encoding time    : {dt:8.3f} sec "
          f"({len(frames) / dt:6.2f} fps)")
    print(f" Bit rate (kbit/s) @ {fps:.2f} Hz : {kbps:10.2f}")
    print(f" SNR Y(dB)              : {psnr:8.3f}")
    print(f"{len(frames)} frames encoded -> {out}")


if __name__ == "__main__":
    main()
