"""Encoder CLI — the TAppEncoder / lencod analog, on the card.

Usage (HM conventions, HM's cfg files parse as-is):
  python -m video_codecs_tpu_torch.tools.encoder_app \
      -c encoder_randomaccess_main.cfg -c per-sequence/Foo.cfg \
      -i in.yuv -b out.bin -o rec.yuv --QP=32 [--fast=1] [--device=cpu]

The port's copy of video_codecs_tpu/tools/encoder_app.py; `main` keeps
its name and a comment gives the original's line.  It builds what the
reference builds from the cfg's coding structure: IntraPeriod 1 = all
intra (--fast=1 picks the CU-quadtree encoder, otherwise the 16x16 CTB
loop); GOPEntry tables with future references (HM's stock
encoder_randomaccess_main.cfg) = the GOP-driven host B coder
(ra_codec.RandomAccessEncoder); anything else = the host low-delay P
coder with the cfg's MaxNumMergeCand/TMVPMode and GOPEntry-derived
reference count.  It prints the reference's warnings and its HM-style
summary (TEncAnalyze.h:139 printOut) and writes the same files.

The encoders run on the card (their device phases: the motion searches
through the SAD kernel, the intra sweeps, the deblocks and the SAO
statistics); without a card the CLI raises.  --device=cpu, stripped
before the HM options are parsed as --fast=1 is, runs every encoder on
the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


# video_codecs_tpu/tools/encoder_app.py:25
def main(argv=None) -> None:
    from video_codecs_tpu_torch.models.hevc import headers, inter_codec
    from video_codecs_tpu_torch.models.hevc import intra_codec, ratectrl
    from video_codecs_tpu_torch.utils import config, yuv

    argv = sys.argv[1:] if argv is None else argv
    fast = False
    if "--fast=1" in argv:
        argv = [a for a in argv if a != "--fast=1"]
        fast = True
    device = "cuda"
    if "--device=cpu" in argv:
        argv = [a for a in argv if a != "--device=cpu"]
        device = "cpu"
    elif not torch.cuda.is_available():
        raise RuntimeError("encoder_app runs its encoders on a CUDA card "
                           "and finds none (--device=cpu runs them on "
                           "the CPU)")
    cfgs, overrides = config.parse_cli(argv)
    s = config.to_encoder_settings(config.load_config(cfgs, overrides))
    for name, value in sorted(s.unsupported.items()):
        print(f"** warning: option {name}={value} not implemented "
              f"in this build — ignored", file=sys.stderr)

    y, u, v = yuv.read_frames(s.input_file, s.width, s.height,
                              s.frames, s.frame_skip)
    frames = [(y[i], u[i], v[i]) for i in range(y.shape[0])]

    ra = any(d > 0 for e in s.gop_entries for d in e.ref_pics)
    cfg = headers.HevcConfig(
        width=s.width, height=s.height, qp=s.qp,
        sign_data_hiding=s.sign_data_hiding,
        deblocking_disabled=s.deblocking_disabled,
        tile_columns=s.tile_columns, sao=s.sao, rdoq=s.rdoq,
        merge_cands=max(1, min(5, s.merge_cands)),
        temporal_mvp=s.temporal_mvp,
        num_refs=max(1, min(4, s.num_refs)),
        reorder_pics=3 if ra else 0)

    if ra and cfg.sao:
        print("** warning: SAO on the hierarchical-B build not implemented "
              "yet — disabled", file=sys.stderr)
        cfg.sao = False

    rc = None
    if s.target_bitrate:
        rc = ratectrl.RateLambdaControl(s.target_bitrate, s.frame_rate,
                                        s.width, s.height, base_qp=s.qp)
    t0 = time.time()
    if s.intra_period == 1:
        if fast:
            from video_codecs_tpu_torch.models.hevc import quadtree_codec
            cfg.log2_ctb, cfg.log2_min_cb, cfg.log2_max_tb = 5, 3, 5
            cfg.sao = False
            enc = quadtree_codec.QuadtreeFastEncoder(cfg, device=device)
            stream, recons = enc.encode_sequence(frames)
        else:
            enc = intra_codec.IntraEncoder(cfg, device=device)
            stream, recons = enc.encode_sequence(frames)
    elif ra:
        from video_codecs_tpu_torch.models.hevc import ra_codec
        cfg.merge_cands = 1   # RA build codes 1 merge candidate
        cfg.temporal_mvp = False
        # DPB sizing must cover every RETAINED picture (ref_pics deltas),
        # not just the active list lengths
        cfg.num_refs = max(len(e.ref_pics) for e in s.gop_entries)
        enc = ra_codec.RandomAccessEncoder(
            cfg, gop=s.gop_entries, search_range=s.search_range,
            me_method=s.me_method, device=device)
        stream, recons = enc.encode_sequence_ra(frames)
    else:
        enc = inter_codec.LowDelayEncoder(
            cfg, search_range=s.search_range, me_method=s.me_method,
            device=device)
        stream, recons = enc.encode_sequence_ldp(frames, rate_control=rc)
    dt = time.time() - t0

    with open(s.bitstream_file, "wb") as f:
        f.write(stream)
    if s.recon_file:
        yuv.write_frames(s.recon_file,
                         np.stack([r[0] for r in recons]).astype(np.uint8),
                         np.stack([r[1] for r in recons]).astype(np.uint8),
                         np.stack([r[2] for r in recons]).astype(np.uint8))

    kbps = len(stream) * 8 * s.frame_rate / max(len(frames), 1) / 1000.0
    py = yuv.psnr(np.stack([r[0] for r in recons]), y)
    pu = yuv.psnr(np.stack([r[1] for r in recons]), u)
    pv = yuv.psnr(np.stack([r[2] for r in recons]), v)
    print("SUMMARY --------------------------------------------------------")
    print("        Total Frames |   Bitrate     Y-PSNR    U-PSNR    V-PSNR")
    print(f"              {len(frames):6d} a {kbps:12.4f} {py:9.4f} "
          f"{pu:9.4f} {pv:9.4f}")
    print(f" Total Time: {dt:12.3f} sec. ({len(frames) / dt:.3f} fps)")


if __name__ == "__main__":
    main()
