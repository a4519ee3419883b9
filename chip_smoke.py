#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through its hand-written CUDA kernels, the
SAD surface, the SAO statistics and the full RDOQ: the H.264 device
P-slice engine at
1280x720, the HEVC random-access GOP-8 headline at 1920x1072 (SAO off,
then on), the HEVC low-delay P row at 832x480 (as it is, with SAO, and
with timing SEI and the long-term IDR), both HEVC rows with HM's
TZSearch, the LD-P row under rate control, and the flat CTB16
random-access (SAO off, then on) and hierarchical-B engines at
1920x1072, and the reference's host low-delay P coder on HM's LD-P main
configuration at 832x480 (as it is, with weighted prediction, with
cu_qp_delta), the reference's encoder and decoder CLIs on HM's
random-access and low-delay P main cfgs at 832x480, the reference's
JM encoder CLI (the H.264 host IPPP coder at Main profile and baseline)
at 176x144, the H.264 host coder at High profile (the 8x8 transform,
I_8x8) and with B slices (spatial direct) at 176x144, and the rest of
that coder's options at 176x144 -- long-term references with MMCO and
list reordering, weighted prediction, perceptual RDO, intra refresh with
an SEI stream sent over RTP with loss and concealed by its receivers --
and HEVC's parallel tools at 1920x1072 (tiles, the tile columns coded
as one batch; WPP), the encoder CLI on HM's all-intra structure with
tiles at 832x480 and the host quadtree RD encoder at 192x128, and the
reference's last modules -- the tile-sharded RA engine at 1920x1072 and
its dry run, the experiment CLI, the syntax trace, the coding statistics
and the conversion and leaky-bucket tools -- in phases:

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the three kernels at once, one nvcc each, from
     video_codecs_tpu_torch/csrc/sad_surface.cu, sao_stats.cu and
     rdoq.cu;
  3. hold the kernel against its plain PyTorch version at the slice's
     shapes (and at search range 32), exactly, and time the kernel, the
     plain version and one PyTorch call for the same function
     (`torch.cdist` with p=1, the yardstick), each beside the kernel's
     bound at those shapes;
  4. encode a seeded 1280x720 clip (I P P P) on the card, check that the
     integer ME went through the kernel twice per P picture, decode the
     stream with the port's own H264Decoder and require the decoder's
     pictures to equal the encoder's;
  5. run the same P picture on the card and on the CPU (plain SAD) at
     search ranges 16 and 32 and a small clip's whole stream on both, and
     report where they differ (motion fields must agree exactly);
  6. rdoq-kernel: hold the full-RDOQ kernel against its plain version
     (`rdoq_dev_ref`) on the same CUDA tensors at the paths' shapes --
     the 1080p B picture's TU16 luma, TU8 chroma, RQT TU8 luma and TU4
     chroma (slice type 0, with the rate), the 1080p IDR's TU8, TU16 and
     TU32 trials (slice type 2, with the rate) and the LD-P P picture's
     TU16 luma and TU8 chroma (B = 1,560) -- on the forward transform of
     the seeded clips' residuals with an all-zero block and two at the
     coefficient clamp: levels exactly, rates bit for bit; time the
     kernel, the plain version and the bound at each shape;
     hevc-intra: encode one 416x240 picture through the port's HEVC
     all-intra CTB32 quadtree (`QuadtreeFastEncoder`) on the card and on
     the CPU and require equal state dicts and equal NAL bytes (the 1080p
     IDR now runs as the first picture of phase 7's GOP);
  7. hevc-ra: the repo's 1080p headline, HEVC random access GOP-8 on the
     CTB32 device quadtree (`QtDeviceRandomAccessEncoder`, bench.py:84-107
     settings: 1920x1072, QP 32, SR64 pyramid ME, CU8 tree off, TMVP,
     full RDOQ, one reference per list, MD5 picture-hash SEI):
     a. hold the SAD kernel against its plain version at the pyramid's
        shapes (4x4-pooled quarter-resolution stage n=4 r=16, the +-3
        full-resolution windows n=16 r=3; the CU8 tree's n=2 and n=8
        checked) and time the kernel, the plain version and
        `torch.cdist` beside the bound, per B picture;
     b. encode 9 pictures of a seeded 1920x1072 clip on the card, timing
        per picture the device phase (the IDR's quadtree, or
        encode_b_frame_dev + qt_merge_dev, with the copy back) and the
        host phase (CABAC serializer, hash SEI, TMVP store), with bytes,
        kbps, Y-PSNR, CU counts, the SAD kernel's launches (3 per list
        and reference: 6 per B picture, 3 for the anchor P) and the RDOQ
        kernel's (none of them may run the plain `rdoq_dev_ref`);
     c. decode the stream with the port's GeneralDecoder: every picture
        hash must match and the pictures must equal the encoder's; the
        stream's SHA-1 must be the JAX package's for the same clip and
        settings (computed on the CPU: RA_SHA1);
     d. encode small GOPs (96x64: 9 pictures at the headline settings,
        5 pictures with the CU8 tree and 2 references per list; 112x80:
        9 pictures with SAO, partial edge CTBs) on the card and on the
        CPU and require byte-equal streams (the card's through the RDOQ
        kernel, the CPU's through its plain version);
     e. sao-kernel: hold the SAO-statistics kernel against its plain
        version, all four outputs exactly, at the 1080p picture's padded
        planes (luma 1920x1088 at CTB 32, each chroma 960x544 at CTB 16)
        and at 112x80's, and time it beside its bound and the plain
        version per picture (no single PyTorch call computes it);
     f. hevc-ra-sao: the same GOP as b with SAO on (`cfg.sao`, HM's RA
        main tool set): per picture the device phase, the host phase,
        the SAO decision (statistics on the card, 3 kernel launches, and
        the offset search on the host) and the OFF/BO/EO CTBs per plane;
        the stream's SHA-1 must be the JAX package's (RA_SAO_SHA1), the
        port's GeneralDecoder must give every hash OK and the encoder's
        pictures, and the SAO kernel must run 24 times;
  8. hevc-ldp: bench.py's `bench_ldp_480` (bench.py:171-186) exactly,
     HEVC low-delay P on `inter_dev.DeviceLowDelayEncoder`: 832x480, QP 32
     with HM's LD-P QP/lambda ladder, 4 references, merge 5, TMVP, SBH,
     SR64 pyramid ME, MD5 picture-hash SEI, on bench.synth_clip's clip:
     a. hold the SAD kernel against its plain version at the LD-P
        pyramid's shapes (B = 52 x 30 blocks: n=4 r=16 and n=16 r=3)
        and time it beside its bound and `torch.cdist`;
     b. encode the 9 pictures on the card, printing per picture the
        device phase (the flat IDR, or encode_p_frame_dev, with the copy
        back, synchronised), the host phase (`_reconcile`, CABAC slice,
        hash SEI), the QP, bytes, Y-PSNR, intra / skip / merge / AMVP
        block counts, the SAD launches (3 per reference, 78 in all) and
        the RDOQ kernel's;
     c. decode with the port's GeneralDecoder (every hash OK, pictures
        equal the encoder's) and require the stream's SHA-1 to be the
        JAX package's with its AMVP predictor list repaired as the port
        repairs it (LDP_SHA1, computed on the CPU);
     d. encode a 96x64 clip with a scene cut (intra blocks in its P
        pictures) at 4 references on the card and on the CPU and
        require byte-equal streams;
     e. sao-kernel (flat shapes): hold the SAO-statistics kernel against
        its plain version at the flat engines' planes (luma CTB 16,
        chroma CTB 8: 832x480 / 416x240 and 1920x1072 / 960x536) and
        time it beside its bound and the plain version;
     f. hevc-ldp-sao: bench_ldp_480 with SAO (HM's LD-P main tool set):
        the IDR on the flat device encoder with the SAO decision and the
        Python slice writer, every picture's SAO from 3 sao_stats
        launches (27 in all, the plain version 0 times); per picture the
        device phase, the host phase, the SAO statistics' kernel time
        (profiler) and host clock and the SAO decision and apply; every
        hash OK, the SHA-1 the JAX package's with the spec AMVP list
        (LDP_SAO_SHA1);
     g. hevc-ldp-conf: bench_ldp_480 with HRD timing SEI, the IDR as the
        one long-term reference and no TMVP: 3 SAD launches per P
        picture (24), the prefix SEI read back (a buffering period on
        the first AU, picture timing on all, the CPB removal delay
        advancing), every hash OK with POC 0 the long-term reference of
        every P picture, the SHA-1 the JAX package's (LDP_CONF_SHA1);
  9. HM's motion search and rate control:
     a. sad-kernel-r64: hold the SAD kernel against its plain version at
        the search range 64 surfaces of TZSearch and the full search
        (n=16 B=1,560: the LD-P picture; n=16 B=8,040 and n=8 B=32,160:
        the 1080p picture and its CU8 tree) and time it beside its
        bound, the plain version and `torch.cdist`;
     b. hevc-ldp-tz: bench_ldp_480 with `me_method="tz"` (BASELINE's
        config 2, HM's FastSearch 1 at SearchRange 64) as in 8b-c: one
        SAD launch per reference (26), every hash OK, the SHA-1 the JAX
        package's with the spec AMVP list (LDP_TZ_SHA1);
     c. hevc-ra-tz: the GOP of 7b with `me_method="tz"`: one SAD launch
        per list and reference (15), every hash OK, RA_TZ_SHA1;
     d. hevc-ldp-rc: bench_ldp_480 (pyramid ME) with a RateLambdaControl
        at 2 Mb/s setting each picture's QP: the QPs, bits and kbps
        against the target, every hash OK, LDP_RC_SHA1; then pictures
        0-4 encoded, the state written with `checkpoint.save`, read
        back with `checkpoint.load`, and pictures 5-8 encoded from it:
        the resumed NALs must be the JAX package's resumed run's
        (RC_RESUMED_SHA1), and whether they equal pictures 5-8 of the
        one run is printed;
 10. the flat CTB16 B engines (scripts/diag_ra_gap.py's settings: QP 32,
     SBH, SR64 pyramid ME, one merge candidate, the intra candidate,
     deblocking, full RDOQ, MD5 hash SEI):
     a. hevc-flat-ra: `inter_dev.DeviceRandomAccessEncoder` over phase
        7's 9 pictures (GOP-8), per picture the device phase (the flat
        IDR, or the upload, encode_b_frame_dev and the copy back,
        synchronised), the host phase (`_reconcile_b`, CABAC slice, hash
        SEI), bytes, Y-PSNR, intra / skip / merge / AMVP / bi blocks,
        the SAD launches (3 per list, 45 in all) and the RDOQ kernel's
        (3 per inter picture, 24); every hash OK in the port's
        GeneralDecoder and the JAX package's SHA-1 (FLAT_RA_SHA1);
     b. hevc-hierb: `inter_dev.DeviceHierarchicalBEncoder` over the
        first 5 of those pictures (I0 P2 B1 P4 B3) as in a (18 SAD and
        12 RDOQ launches, HIERB_SHA1);
     c. flat-ra-cuda-vs-cpu: the flat RA GOP at 96x64 over 9 pictures on
        the card and on the CPU, byte-equal streams;
     d. hevc-flat-ra-sao: a with SAO over the GOP's first 5 pictures
        (IDR, P4, B2 B1 B3; cut from 9 for the script's time): 21 SAD
        and 15 sao_stats launches and the SAO split per picture as in
        8f, every hash OK (no JAX SHA-1: the JAX package's host SAO
        decision would take hours at 1080p; the CPU tests hold the 64x48
        SAO GOP to its stream);
     e. flat-ra-cuda-vs-cpu-sao: c with SAO, byte-equal streams, the
        card's through the SAO kernel (27 launches), the CPU's through
        its plain version;
 11. the reference's host low-delay P coder (`inter_codec.LowDelayEncoder`,
     what the reference's encoder CLI builds for HM's
     encoder_lowdelay_P_main.cfg: `host_ldp_cfg`), TZSearch at search
     range 64, on bench_synth_clip(832, 480, n, seed=42):
     a. hevc-ldp-host: 9 pictures at QP 32, 4 references, merge 5, TMVP,
        SBH, SAO, full RDOQ (the IDR on the host CTB loop with the host
        float64 `rdoq_np`): per picture pass 1 (the motion searches and
        the intra sweep on the card, copies back included), the raster
        decision and reconstruction on the host, the deblock on the card,
        the SAO decision and apply and CABAC with the SEI, bytes, Y-PSNR,
        intra / merge / skip / AMVP blocks and the SAD launches (1 per
        reference, 26) and sao_stats launches (27); no rdoq_dev launch;
        every hash OK in the port's GeneralDecoder and LowDelayDecoder
        with the encoder's pictures, and the JAX package's SHA-1 with the
        spec AMVP list (HOST_SHA1), printed beside the JAX package's
        stream as it writes it and that stream's hash results
        (HOST_AS_WRITTEN);
     b. hevc-ldp-wp: 5 pictures of the clip faded by 1 - 0.12 i with
        explicit weighted prediction, 1 reference, SAO off: each
        picture's pred_weight_table read back, the size beside the same
        pictures without WP (whose SAD launches are counted on their
        own), WP_SHA1;
     c. hevc-ldp-dqp: 5 pictures with cu_qp_delta under a CtuRateControl
        and a RateLambdaControl at 2 Mb/s, SAO off: each picture's slice
        QP and the range of its CU QPs, DQP_SHA1;
 12. the reference's encoder and decoder CLIs (`tools/encoder_app.main`,
     `tools/decoder_app.main`, called in this process) on HM 16.5's main
     cfgs as its users start them (`hm_cli_files`: the stock settings and
     GOPEntry tables, a per-sequence cfg, the clip as a YUV file):
     a. cli-ra: encoder_randomaccess_main.cfg at 832x480 over 9 pictures
        of bench_synth_clip (seed 42): the CLI builds the host random-
        access B coder (`ra_codec.RandomAccessEncoder`: TZSearch at
        search range 64, one merge candidate, no TMVP, SAO off with the
        reference's warning, the IDR with the host full RDOQ); per
        picture pass 1 on the card (`_p_pass1`), the host raster
        (`_b_raster`), the deblock on the card and CABAC with the SEI,
        bytes, Y-PSNR and intra / skip / merge / AMVP / bi blocks; the
        CLI's summary and warnings; SAD launches 15 (one per list),
        sao_stats and rdoq_dev 0; the recon file the encoder's pictures;
        the port's decoder CLI (GeneralDecoder for this stream) "(OK)"
        on every picture with the recon file's pictures; the port's
        RandomAccessDecoder every hash OK with the encoder's pictures;
        the stream the JAX package's CLI's (CLI_RA_SHA1), printed beside
        that script's decoders' results (the JAX decoder CLI's too);
     b. cli-ra-cuda-vs-cpu: a at 80x48 on the card and with
        --device=cpu: byte-equal streams and recon files;
     c. cli-ldp: encoder_lowdelay_P_main.cfg on the first 3 pictures of
        11a's clip: the CLI builds 11a's host LD-P coder, so its NAL units
        must be the first of 11a's stream from this run; SAD 3 and
        sao_stats 9 launches; the decoder CLI (LowDelayDecoder) "(OK)" on
        every picture;
 13. the reference's JM encoder CLI (`tools/jm_encoder_app.main`, called
     in this process) on a JM-style cfg (`jm_cli_files`) and 5 pictures
     of bench_synth_clip(176, 144, 5, seed=42), QP 28, search range 16:
     it builds the host IPPP coder `inter_codec.H264Encoder`, whose card
     stage (`host_me.RefSearch`: one SAD launch at n=4, r=32 per
     reference and P picture, the partition sums and the 16 quarter-pel
     phase planes) runs on the card:
     a. sad-kernel-jm: the kernel against its plain version at that shape
        (B=1,584), timed beside its bound, the plain version and
        `torch.cdist`;
     b. jm-main: CABAC, EPZS, 3 references, trellis; per picture the
        card stage, the searches (EPZS and the partitions' apart), the
        mode loops and the rest, the quantization and the entropy coder
        (`_h264_instrument`), bytes, Y-PSNR, SAD launches
        (9 in all: the list holds 1, 2, 3 and 3 references); the CLI's
        summary and warnings; the recon file the encoder's pictures and
        the port's H264Decoder's; the stream the JAX package's CLI's
        (JM_SHA1, scripts/jax_reference_sha1.py --jm-main);
     c. jm-baseline: b with CAVLC, full search, 1 reference and adaptive
        rounding (4 SAD launches; --jm-baseline);
     d. jm-cuda-vs-cpu: b at 64x48 on the card and with --device=cpu:
        byte-equal streams and recon files;
 15. the host H.264 coder at High profile and with B slices, at 176x144
     on bench_synth_clip(176, 144, n, seed=42), QP 28, search range 16
     (`phase_h264_high_b`), every search through the card stage:
     a. h264-high: `H264Encoder(..., transform8x8=True)` with 13b's
        settings (CABAC, EPZS, 3 references, trellis; High profile 100),
        5 pictures: per picture the card stage, the searches, the 8x8
        transforms of the 4x4/8x8 decision, I_8x8 and the recon, the
        quantization, the entropy coder and the rest (mode loops, MC,
        recon, deblock), the MBs coded with the 8x8 transform, bytes,
        Y-PSNR and SAD launches (9: 1, 2, 3, 3 references); the port's
        H264Decoder gives the encoder's pictures; the stream is the JAX
        package's (H264_HIGH_SHA1, scripts/jax_reference_sha1.py
        --h264-high);
     b. h264-b: `H264BEncoder(b_frames=2, b_qp_offset=2)`, CABAC, spatial
        direct, every partition of Table 7-14, 7 pictures coded I0 P3 B1
        B2 P6 B4 B5: per B picture its direct / skip / L0 / L1 / bi /
        partitioned / intra MBs and the stages of a (16x16 and partition
        searches apart), SAD launches 1 per P anchor and 2 per B picture
        (10); H264BDecoder gives the encoder's pictures in display order;
        the stream is the JAX package's (H264_B_SHA1, --h264-b);
     c. h264-hb-cuda-vs-cpu: a and b at 64x48 on the card and with
        device="cpu": byte-equal streams, 9 and 10 SAD launches on the
        card, none on the CPU;
 16. the rest of the host H.264 coder's options at 176x144 on
     bench_synth_clip(176, 144, n, seed=42) (`phase_h264_conf`,
     `H264_CONF_KW`), every search through the card stage, per picture
     the stages of 13b (the saliency model on the card apart), bytes,
     Y-PSNR, SAD launches (one per list0 entry and P picture) and the
     DPB after it; the port's H264Decoder gives the encoder's pictures
     and each stream is the JAX package's (H264_CONF_SHA1,
     scripts/jax_reference_sha1.py --h264-<kind>):
     a. h264-ltr: a baseline conferencing sender: CAVLC, 2 references
        beside the long-term IDR, every third P picture made the
        long-term one by MMCO 4+6, the long-term picture moved to
        ref_idx 0 by list reordering, 9 pictures (21 SAD launches: the
        lists hold 1, 2, then 3 pictures); `analyze.analyze` finds the
        long-term flag, the reordering and the MMCO where the encoder
        wrote them;
     b. h264-wp: [jm-main]'s settings with weighted prediction on 5
        pictures of the faded clip (`fade_clip`): each P picture's luma
        weights, a pred_weight_table on every P slice (9 SAD launches);
     c. h264-perc: perceptual RDO ("att+ssim", QP 30) over 5 pictures:
        the saliency model and eta on the card per picture, eta's range
        (4 SAD launches);
     d. h264-loss: one MB row of intra refresh a picture (11 MBs) over
        12 pictures, CAVLC (11 SAD launches; every P picture holds the 11
        forced intra MBs); a recovery-point and user-data SEI after the
        PPS, one RTP packet a NAL unit, the reference's 20 % loss after
        the first 3 packets (`h264_lossy`: packet 13, picture 10, is
        lost); H264Decoder(conceal=1) and (conceal=2) must give the JAX
        decoders' `concealed` lists and pictures (H264_LOSS_JAX,
        --h264-loss);
     e. h264-conf-cuda-vs-cpu: a-d at 64x48 on the card and with
        device="cpu": byte-equal streams, the SAD launches on the card,
        none on the CPU;
 17. HEVC tiles, WPP and the rest of the host paths (no SAD or RDOQ
     launch; SAO statistics in c):
     a. hevc-tiles: `parallel.tiles.encode_sequence_tiles` at 1920x1072
        with 4 uniform tile columns of 30 CTBs (`tiles_cfg`: QP 32, rdoq
        off, deblocking and the hash SEI on) over 3 pictures of
        synth_clip(1920, 1072, 3, seed=5): the columns stacked as one
        batch, 162 diagonals of 4 tiles' blocks (252 untiled); per
        picture the tile batch's device ms, the host ms (the slice writer
        with 4 substreams, the hash SEI) and the same picture's device ms
        untiled; `IntraEncoder(cfg).encode_sequence` gives the same
        bytes; TILES_SHA1 (scripts/jax_reference_sha1.py --tiles); the
        port's GeneralDecoder and IntraDecoder hash OK 3 of 3 with the
        encoder's pictures (`phase_hevc_tiles`);
     b. hevc-wpp: the same clip and settings with WPP through
        `IntraEncoder` on the card (one substream per CTB row), checked
        the same way against WPP_SHA1 (--wpp);
     c. cli-ai-tiles: the port's encoder CLI on HM's all-intra structure
        (`hm_cli_files(..., "ai", tile_columns=2)`: RDOQ 1, SAO 1,
        SignHideFlag 1) at 832x480 over 3 pictures: the host CTB loop
        tile by tile with the full RDOQ, 3 SAO launches a picture (9);
        per picture the loop, the SAO decision and the slice writer;
        CLI_AI_TILES_SHA1 (--cli-ai-tiles); the port's decoder CLI (OK)
        3 of 3 (`phase_cli_ai_tiles`);
     d. hevc-qt-host: `QuadtreeIntraEncoder` on the card at 192x128, CTB
        32, full RDOQ and SBH: its mode sweeps on the card, QT_HOST_SHA1
        (--qt-host), the port's GeneralDecoder and QuadtreeIntraDecoder
        hash OK (`phase_hevc_qt_host`);
 18. the last modules of the reference:
     a. tiled-ra: the tile-sharded RA engine (`parallel/sharded.py`, the
        counterpart of __graft_entry__.dryrun_multichip's encoders) at
        1920x1072 on synth_clip(1920, 1072, 9, seed=5) in 4 tile columns
        of 480 with a halo of 32 and the dry run's settings (QP 32,
        GOP-8, SR8 pyramid, CU8 tree, merge 5, full RDOQ, SBH) plus the
        MD5 hash SEI: first (stage 1) the SAD and RDOQ kernels against
        their plain versions at the 544x1072 slab's shapes, timed beside
        their bounds (`phase_tiled_kernels`); then (stage 3)
        `ShardedQt` (each column's halos copied from its neighbours)
        gives TILED_RA_SHA1 (scripts/jax_reference_sha1.py --tiled-ra),
        as `TiledRefQt` (the columns one after another) does in stage 2
        (`phase_tiled_ra_ref`), the two streams and launches equal; per
        picture the tiled device ms against the untiled engine's and
        the launches, TILED_COLUMNS x the untiled picture's;
        the size difference against the untiled stream (reported); the
        port's GeneralDecoder hash OK on every picture with the
        encoder's pictures, in a process of its own (`phase_tiled_ra`);
     b. dryrun: `graft_entry.dryrun_multichip(4)` on the card, its OK
        line and DRYRUN_SHA1 (--dryrun) (`phase_dryrun`);
     c. experiment: the experiment CLI on a seeded 832x480 YUV of 3
        pictures at QPs 28-40, --codec intra and --codec ldp: QP, kbps
        and Y-PSNR the JAX package's tables (EXPERIMENT_JAX,
        --experiment), then BD-rate of ldp against intra
        (`phase_experiment`);
     d. trace and statistics: [jm-main]'s encode with the syntax trace
        on, its trace equal to the port's decoder's; decoder_app --stats
        on that stream and on [cli-ra]'s (`phase_trace_tools`,
        `task_cli_ra`);
     e. tools: annexb_byte_count on the phase's streams, the leaky
        bucket over [jm-main]'s per-picture bits, convert_bitdepth 8 ->
        10 -> 8 on its YUV file (`phase_trace_tools`);
 19. require that nothing of the JAX package was imported, in this
     process or in any worker.

The phases run in three stages, to end well inside the 1,200 s the
script is given.  Stage 1, alone on the card: phases 1-2 and every
kernel-vs-plain check and kernel time (3, 6, 7a, 7e, 8a, 8e, 9a, 13a,
18a's slab shapes).  Stage 2: the end-to-end phases of 4-17, 18a's
sequential twin and 18b-e (POOL_TASKS),
WORKERS at a time,
each worker a spawned process of its own on the same card with
WORKER_THREADS CPU threads for torch; every phase zeroes the kernels'
counts it reads, and its launches come back to this process, which
prints each phase's output as the phase ends (so in the order they
end, not in the order above) and stops every worker at the first
failure.  Their times are taken beside three other phases sharing the
host and the card; 17a-b's streams go to the port's decoders in DECODERS
processes of their worker.  Stage 3, alone on the card again: 18a's
tile-sharded 1080p GOP and the untiled engine's, the stream decoded in
a process of its own while the card codes on (`run_stage3`).

Kernel times come from torch.profiler alone (asked up to three times);
where it records none the time is "not measured" (null in the JSON
line, with the reason), left out of any per-picture sum, and no share
of the bound is printed.  A wrapper call's CUDA-event time prints
beside the kernel's, never in its place.

Any failed check exits non-zero.  The last line is the result JSON; the
line before it lists the kernels, with the launches of the main paths'
encodes (a line before gives each path's), the SAD kernel's RA pyramid
per-B-picture times and bound, the SAO kernel's per 1080p picture and
the RDOQ kernel's for the 1080p B picture's TU16 luma call; the search
range 64 surfaces', the RDOQ shapes' and the SAO kernel's flat shapes'
times print on JSON lines of their own before them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import io
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as hevc_bs
from video_codecs_tpu_torch.models.h264 import inter_dev
from video_codecs_tpu_torch.models.h264.inter_codec import H264Decoder
from video_codecs_tpu_torch.models.hevc import bframe_codec as hevc_bc
from video_codecs_tpu_torch.models.hevc import checkpoint
from video_codecs_tpu_torch.models.hevc import decoder as hevc_decoder
from video_codecs_tpu_torch.models.hevc import headers as hevc_headers
from video_codecs_tpu_torch.models.hevc import inter_dev as hevc_inter_dev
from video_codecs_tpu_torch.models.hevc import intra_codec as hevc_intra_codec
from video_codecs_tpu_torch.models.hevc import inter_codec as hevc_pc
from video_codecs_tpu_torch.models.hevc import inter_qt, quadtree_codec
from video_codecs_tpu_torch.models.hevc import ra_codec as hevc_ra
from video_codecs_tpu_torch.models.hevc import encoder_dev, ratectrl
from video_codecs_tpu_torch.models.hevc import sei as sei_mod
from video_codecs_tpu_torch.ops import rdoq_dev as rdoq_ops
from video_codecs_tpu_torch.ops import sad_surface as ss
from video_codecs_tpu_torch.ops import sao as sao_ops
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.parallel import tiles
from video_codecs_tpu_torch.tools import decoder_app, encoder_app
from video_codecs_tpu_torch.utils import yuv
from video_codecs_tpu_torch.utils.device import to_device

# Files this script writes (the resumed run's checkpoint), in the
# repository's build directory.
BUILD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
KERNEL_SRC = "video_codecs_tpu_torch/csrc/sad_surface.cu"
REPLACES = "video_codecs_tpu/ops/pallas_sad.py:32"
SAO_SRC = "video_codecs_tpu_torch/csrc/sao_stats.cu"
SAO_REPLACES = "video_codecs_tpu/ops/sao.py:127"
RDOQ_SRC = "video_codecs_tpu_torch/csrc/rdoq.cu"
RDOQ_REPLACES = "video_codecs_tpu/ops/rdoq_jax.py:227"
W, H, QP, SR = 1280, 720, 28, 16
# The 1080p headline (bench.py:84-107): picture size, QP, search range
# and GOP length.
HEVC_W, HEVC_H, HEVC_QP = 1920, 1072, 32
RA_SR, RA_PICTURES = 64, 9
# The JAX package's stream for phase 7's GOP (synth_clip(1920, 1072, 9,
# seed=5) at ra_cfg's settings), on the CPU: bytes and SHA-1.
RA_BYTES, RA_SHA1 = 313869, "97c3eed7555fdec8392e28f0190c99645943f680"
# The same GOP with SAO on (scripts/jax_reference_sha1.py --ra-sao; all 9
# hashes OK in the JAX package's decoder).
RA_SAO_BYTES = 317260
RA_SAO_SHA1 = "48bee427dce04acf683246853f7ce746599d1127"
# bench_ldp_480 (bench.py:171-186): 832x480, 9 pictures of bench's clip,
# and the JAX package's stream for it on the CPU with its AMVP predictor
# list (motion.amvp_candidates) swapped for the spec's, which the port
# carries: bytes and SHA-1 (scripts/jax_reference_sha1.py).  As the JAX
# package writes it (172,535 bytes, SHA-1 0bbbb609...) the stream fails
# its picture hashes from POC 2 on in either package's decoder.
LDP_W, LDP_H, LDP_PICTURES, LDP_SR = 832, 480, 9, 64
LDP_BYTES, LDP_SHA1 = 172528, "321996139e1d64922af23de231bf6dd498493e12"
# HM's motion search and rate control (scripts/jax_reference_sha1.py
# --ldp-tz --ra-tz --ldp-rc, the JAX package on the CPU; the LD-P runs
# with the spec AMVP list, all 9 hashes OK in the JAX package's decoder):
# bench_ldp_480 with TZSearch (as the JAX package writes it: 173,411
# bytes, SHA-1 2b554799..., hashes fail from POC 2 on), the RA GOP with
# TZSearch, and bench_ldp_480's pyramid run under a RateLambdaControl at
# RC_BPS: its QPs, bytes and SHA-1, and those of pictures 5-8 resumed
# from a checkpoint of pictures 0-4 (the resumed pictures' NALs, Annex B).
LDP_TZ_BYTES, LDP_TZ_SHA1 = 173413, "4fc4fc4db26c698e6782bbcbabc60182478e8e1b"
RA_TZ_BYTES, RA_TZ_SHA1 = 314555, "6da8f0df6691e6e0e86b5802cd61840cb78ed3c6"
RC_BPS = 2_000_000
LDP_RC_BYTES, LDP_RC_SHA1 = 185151, "51771df4d0137e4389fb0405dfd93e1f8842ff74"
LDP_RC_QPS = [30, 32, 34, 36, 38, 40, 42, 44, 46]
# The flat CTB16 B engines at scripts/diag_ra_gap.py's settings on phase
# 7's clip (scripts/jax_reference_sha1.py --flat-ra --hierb, the JAX
# package on the CPU; every hash OK in both packages' GeneralDecoders):
# the RA GOP-8 over its 9 pictures and the hierarchical-B run over its
# first HIERB_PICTURES (I0 P2 B1 P4 B3).  The RA GOP with SAO, which no
# JAX SHA-1 gates, runs over the first FLAT_SAO_PICTURES only (IDR, P4,
# B2 B1 B3), to keep the script inside its time.
HIERB_PICTURES = 5
FLAT_SAO_PICTURES = 5
FLAT_RA_BYTES = 344846
FLAT_RA_SHA1 = "c837e7b257cb85bd937dbaac2d3c05e499795ded"
HIERB_BYTES = 351522
HIERB_SHA1 = "1535391b4838b43c8e6c1bddc90530ae624706b9"
# The LD-P row with SAO (HM's encoder_lowdelay_P_main.cfg tool set) and
# a conferencing sender's LD-P (HRD timing SEI, every P picture predicted
# from the IDR as a long-term reference, no TMVP): the JAX package's
# streams with the spec AMVP list (scripts/jax_reference_sha1.py
# --ldp-sao --ldp-conf, on the CPU; every hash OK in both packages'
# decoders).
LDP_SAO_BYTES = 175630
LDP_SAO_SHA1 = "6852ef4e35e6615941a9dce5ba1405d1b28907c6"
LDP_CONF_BYTES = 211034
LDP_CONF_SHA1 = "7b0e7524abeb3c6612be87ed35b392de1d2cc1e2"
RC_RESUME_AT = 5
RC_RESUMED_BYTES = 15567
RC_RESUMED_SHA1 = "cd2aaec4a7421f5f56138a7e2797a3341d4e504b"
# The reference's host low-delay P coder (`inter_codec.LowDelayEncoder`,
# what its encoder CLI builds for any low-delay HM cfg) on HM's
# encoder_lowdelay_P_main.cfg (`host_ldp_cfg`), TZSearch at search range
# 64, on bench_synth_clip's clip: HOST_PICTURES pictures as they are,
# WP_PICTURES of the faded clip with weighted prediction, DQP_PICTURES
# with cu_qp_delta under a CtuRateControl and a RateLambdaControl at
# RC_BPS.
HOST_PICTURES, WP_PICTURES, DQP_PICTURES = 9, 5, 5
HOST_SR, HOST_ME = 64, "tz"
# The JAX package's streams for them with the spec AMVP list
# (scripts/jax_reference_sha1.py --ldp-host --ldp-wp --ldp-dqp, on the
# CPU; every hash OK in both packages' decoders), and the rate-controlled
# run's QPs.
HOST_BYTES, HOST_SHA1 = 340373, "23c64556ce113832efbb556da4abc453d39d6599"
WP_BYTES, WP_SHA1 = 163055, "fa8f5022dcb595f7c0a57e07875a8421a7835175"
DQP_BYTES, DQP_SHA1 = 194621, "b086edcc5acb81c3e7468d8887d1a96b9ed7727c"
DQP_QPS = [30, 32, 34, 36, 38]
# The same streams as the JAX package writes them (its own AMVP list), and
# the picture-hash results that script printed for them: the host and
# cu_qp_delta streams fail from POC 2 on in a spec decoder; the WP stream
# (one reference) is the same either way.
HOST_AS_WRITTEN = {
    "": (340366, "f56785d4a53975ea19755e3006ff0942a23c64d9",
         "JAX GeneralDecoder 2 of 9, JAX LowDelayDecoder 9 of 9, the "
         "port's GeneralDecoder 2 of 9, the port's LowDelayDecoder 2 of 9"),
    "wp": (163055, "fa8f5022dcb595f7c0a57e07875a8421a7835175",
           "5 of 5 in all four decoders"),
    "dqp": (194625, "ee4e9635cc0042488afa5afc5684dee7d215cfa9",
            "JAX GeneralDecoder 2 of 5, JAX LowDelayDecoder 5 of 5, the "
            "port's GeneralDecoder 2 of 5, the port's LowDelayDecoder 2 of "
            "5")}
# The JAX package's encoder CLI (tools/encoder_app.main) on chip_smoke's
# `[cli-ra]` files (`hm_cli_files`: HM's encoder_randomaccess_main.cfg,
# 832x480, 9 pictures of bench_synth_clip, seed 42), on the CPU
# (scripts/jax_reference_sha1.py --cli-ra): bytes and SHA-1, and the hash
# results that script printed for the stream.
CLI_RA_BYTES, CLI_RA_SHA1 = 259591, "31a95f33a43bd6ae9fa261a749400398e216e5aa"
CLI_RA_JAX_DECODERS = (
    "hash OK 9 of 9 in the JAX package's RandomAccessDecoder and "
    "GeneralDecoder and in the port's; the JAX decoder CLI (its "
    "LowDelayDecoder with concealment) (OK) 1 of 9 with 5 pictures "
    "written, the port's decoder CLI 9 of 9")
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and
# operations/s on 8-bit integers, the type of the SAD kernel's inputs,
# and on float32 outside the tensor cores, the RDOQ costs' type.
PEAK_BYTES, PEAK_OPS = 3.35e12, 1979e12
PEAK_F32 = 67e12
# Seconds a per-picture torch.profiler session waits after it starts
# before the work it records.
PROFILER_SETTLE_S = 0.02


# The card's name and power limit as nvidia-smi gives them (main sets it).
CARD = ""

# Calls of the plain RDOQ (`rdoq_dev_ref`) by the device its coefficients
# lie on, counted by the wrapper `count_rdoq_ref` installs.
RDOQ_REF_CALLS = {"cuda": 0, "cpu": 0}
# The same for the plain SAO statistics (`sao_stats_ref`, `count_sao_ref`).
SAO_REF_CALLS = {"cuda": 0, "cpu": 0}


def count_rdoq_ref() -> None:
    """Count every call of `rdoq_dev_ref` (the wrapper `rdoq_dev` reaches
    it through the module's name) in RDOQ_REF_CALLS."""
    ref = rdoq_ops.rdoq_dev_ref

    def counted(coeff, *a, **kw):
        RDOQ_REF_CALLS[coeff.device.type] += 1
        return ref(coeff, *a, **kw)

    rdoq_ops.rdoq_dev_ref = counted


def count_sao_ref() -> None:
    """Count every call of `sao_stats_ref` (the wrapper `sao_stats`
    reaches it through the module's name) in SAO_REF_CALLS."""
    ref = sao_ops.sao_stats_ref

    def counted(orig, rec, ctb):
        SAO_REF_CALLS[rec.device.type] += 1
        return ref(orig, rec, ctb)

    sao_ops.sao_stats_ref = counted


def rdoq_routes(fn):
    """(fn's result, RDOQ-kernel launches, plain-version calls on CUDA
    tensors, on CPU tensors) of one call of fn()."""
    k0 = rdoq_ops.rdoq_dev.launches
    g0, c0 = RDOQ_REF_CALLS["cuda"], RDOQ_REF_CALLS["cpu"]
    out = fn()
    return (out, rdoq_ops.rdoq_dev.launches - k0,
            RDOQ_REF_CALLS["cuda"] - g0, RDOQ_REF_CALLS["cpu"] - c0)


def check_rdoq_routes(what: str, card: tuple, cpu: tuple) -> str:
    """The card's run launched the RDOQ kernel and never its plain version;
    the CPU's ran the plain version and launched nothing.  card and cpu
    are rdoq_routes' counts; returns them as words."""
    check(card[0] > 0 and card[1] == 0,
          f"{what}: on the card {card[0]} RDOQ-kernel launches and "
          f"{card[1]} plain-version calls (want > 0 and 0)")
    check(cpu[0] == 0 and cpu[2] > 0,
          f"{what}: on the CPU {cpu[0]} RDOQ-kernel launches and "
          f"{cpu[2]} plain-version calls (want 0 and > 0)")
    return (f"RDOQ kernel {card[0]} launches on the card, plain version "
            f"{cpu[2]} calls on the CPU")


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events, synchronised)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _smooth(a: np.ndarray, passes: int = 2) -> np.ndarray:
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for _ in range(passes):
        for ax in (0, 1):
            p = np.pad(a, [(2, 2) if i == ax else (0, 0) for i in (0, 1)],
                       mode="edge")
            n = a.shape[ax]
            a = sum(k[i] * np.take(p, np.arange(i, i + n), axis=ax)
                    for i in range(5))
    return a


def synth_clip(w: int, h: int, nf: int, seed: int):
    """Seeded 4:2:0 clip: a smooth textured background panning by (2, 1)
    px per frame, an object of a fifth of the width moving by (-5, 3), and
    sensor noise."""
    rng = np.random.default_rng(seed)
    m = 64
    bg = _smooth(rng.integers(0, 256, (h + 2 * m, w + 2 * m)).astype(float))
    bg = (bg - bg.mean()) * 2 + 128
    oh, ow = h // 4, w // 5
    obj = _smooth(rng.integers(0, 256, (oh, ow)).astype(float), 1)
    frames = []
    for f in range(nf):
        y = bg[m + f:m + f + h, m + 2 * f:m + 2 * f + w].copy()
        oy, ox = h // 3 + 3 * f, w // 2 - 5 * f
        y[oy:oy + oh, ox:ox + ow] = obj
        y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255).astype(np.uint8)
        u = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        v = ((255 - y[1::2, 1::2]) // 2 + 32).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def bench_synth_clip(w, h, n, seed=42):
    """bench.py's `synth_clip`, copied: a diagonal ramp with a moving
    sine band and seeded texture, sinusoidal chroma."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    tex = rng.integers(-24, 25, (h, w))
    frames = []
    for f in range(n):
        y = np.clip(((xx * 3 + yy * 2 + f * 7) % 256) * 0.7 + tex + 30 +
                    20 * np.sin(2 * np.pi * (xx + 8 * f) / 64),
                    0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(2 * np.pi * (xx[::2, ::2] + 4 * f)
                                      / 128), 0, 255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(2 * np.pi * (yy[::2, ::2] + 4 * f)
                                      / 128), 0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def fade_clip(frames):
    """`frames` faded to black: picture i's planes scaled by 1 - 0.12 i
    in float64 and truncated to 8 bits (tests/test_weighted_pred.py's
    fade)."""
    out = []
    for i, planes in enumerate(frames):
        g = 1.0 - 0.12 * i
        out.append(tuple(np.clip(p.astype(np.float64) * g, 0, 255)
                         .astype(np.uint8) for p in planes))
    return out


def h264_conf_clip(kind: str, w: int, h: int):
    """Phase 16's clip for `kind`: bench.py's (seed 42), faded for wp."""
    frames = bench_synth_clip(w, h, H264_CONF_PICTURES[kind])
    return fade_clip(frames) if kind == "wp" else frames


def h264_lossy(stream: bytes, sei, rtp, h: int) -> tuple:
    """[h264-loss]'s network: a recovery-point SEI (the refresh's period,
    one picture a MB row) with unregistered user data after the PPS, one
    RTP packet a NAL unit, the reference's deterministic loss, and the
    packets that arrive put back into Annex B.  `sei` and `rtp` are
    either package's modules.  Returns (the stream sent, the stream
    received, packets sent, packets received)."""
    nals = [p[12:] for p in rtp.packetize(stream)]    # the NAL units
    msg = sei.sei_nal([
        sei.RecoveryPoint(recovery_frame_cnt=h // 16),
        sei.UserDataUnregistered(uuid=bytes(range(16)), data=b"h264-loss")])
    sent = b"".join(b"\x00\x00\x00\x01" + n
                    for n in nals[:2] + [msg] + nals[2:])
    pkts = rtp.packetize(sent)
    kept = rtp.inject_loss(pkts, H264_LOSS_PERCENT,
                           keep_leading=H264_LOSS_KEEP)
    return sent, rtp.depacketize(kept), len(pkts), len(kept)


def pictures_sha1(pictures) -> str:
    """SHA-1 of decoded pictures: each plane's 8-bit samples in order."""
    d = hashlib.sha1()
    for pic in pictures:
        for plane in pic:
            d.update(np.ascontiguousarray(plane, np.uint8).tobytes())
    return d.hexdigest()


def host_ldp_cfg(variant: str = ""):
    """HM's encoder_lowdelay_P_main.cfg as the reference's encoder CLI
    builds it (tools/encoder_app.py:46-56, utils/config.py:86-113): 832x480
    (HM class C), QP 32, SignHideFlag 1, SAO 1, RDOQ 1 (rdoq="full"),
    MaxNumMergeCand 5, TMVPMode 1, 4 active references; the MD5 picture
    hash SEI on.  `variant` "wp": explicit weighted prediction with the
    one reference the reference allows it, SAO off; "dqp": cu_qp_delta
    (HM's LCU-level rate control signals it), SAO off."""
    cfg = hevc_headers.HevcConfig(width=LDP_W, height=LDP_H, qp=32,
                                  sign_data_hiding=True, sao=True,
                                  rdoq="full", merge_cands=5,
                                  temporal_mvp=True, num_refs=4)
    if variant == "wp":
        cfg.weighted_pred, cfg.num_refs, cfg.sao = True, 1, False
    elif variant == "dqp":
        cfg.cu_qp_delta, cfg.sao = True, False
    return cfg



# HM 16.5's encoder_randomaccess_main.cfg and encoder_lowdelay_P_main.cfg
# (hm-16.5rc1/cfg/) as the reference's encoder CLI reads them: the unit,
# coding-structure, motion-search, quantization, deblocking and coding-tool
# settings of the stock files with their GOPEntry tables (each FrameN line
# in HM's column layout, the inter-RPS columns after the reference
# pictures; ra_codec.parse_gop_entries reads the RA table as GOP8_RA).
# The reference's CLI warns about the options it does not implement and
# ignores them.
HM_MAIN_CFG = """\
#======== Profile ================
Profile                       : main
#======== Unit definition ================
MaxCUWidth                    : 64          # Maximum coding unit width in pixel
MaxCUHeight                   : 64          # Maximum coding unit height in pixel
MaxPartitionDepth             : 4           # Maximum coding unit depth
QuadtreeTULog2MaxSize         : 5           # Log2 of maximum transform size
QuadtreeTULog2MinSize         : 2           # Log2 of minimum transform size
QuadtreeTUMaxDepthInter       : 3
QuadtreeTUMaxDepthIntra       : 3
#======== Coding Structure =============
{structure}
#=========== Motion Search =============
FastSearch                    : 1           # 0:Full search  1:TZ search
SearchRange                   : 64          # (0: Search range is a Full frame)
BipredSearchRange             : 4           # Search range for bi-prediction refinement
HadamardME                    : 1           # Use of hadamard measure for fractional ME
FEN                           : 1           # Fast encoder decision
FDM                           : 1           # Fast Decision for Merge RD cost
#======== Quantization =============
QP                            : 32          # Quantization parameter(0-51)
MaxDeltaQP                    : 0           # CU-based multi-QP optimization
MaxCuDQPDepth                 : 0           # Max depth of a minimum CuDQP for sub-LCU-level delta QP
DeltaQpRD                     : 0           # Slice-based multi-QP optimization
RDOQ                          : 1           # RDOQ
RDOQTS                        : 1           # RDOQ for transform skip
#=========== Deblock Filter ============
LoopFilterOffsetInPPS         : 1           # Dbl params constant in PPS
LoopFilterDisable             : 0           # Disable deblocking filter (0=Filter, 1=No Filter)
LoopFilterBetaOffset_div2     : 0           # base_param: -6 ~ 6
LoopFilterTcOffset_div2       : 0           # base_param: -6 ~ 6
DeblockingFilterMetric        : 0           # blockiness metric
#=========== Misc. ============
InternalBitDepth              : 8           # codec operating bit-depth
#=========== Coding Tools =================
SAO                           : 1           # Sample adaptive offset  (0: OFF, 1: ON)
AMP                           : 1           # Asymmetric motion partitions (0: OFF, 1: ON)
TransformSkip                 : 1           # Transform skipping (0: OFF, 1: ON)
TransformSkipFast             : 1           # Fast Transform skipping (0: OFF, 1: ON)
SAOLcuBoundary                : 0           # SAOLcuBoundary using non-deblocked pixels (0: OFF, 1: ON)
#============ Slices ================
SliceMode                : 0                # 0: Disable all slice options.
SliceArgument            : 1500             # Argument for 'SliceMode'.
LFCrossSliceBoundaryFlag : 1                # In-loop filtering across slices
#============ PCM ================
PCMEnabledFlag                      : 0
#============ Tiles ================
TileUniformSpacing                  : 0
NumTileColumnsMinus1                : 0
NumTileRowsMinus1                   : 0
#============ WaveFront ================
WaveFrontSynchro                    : 0
#=========== Quantization Matrix =================
ScalingList                   : 0
#============ Lossless ================
TransquantBypassEnableFlag : 0
CUTransquantBypassFlagForce: 0
#============ Rate Control ======================
RateControl                         : 0
TargetBitrate                       : 1000000
KeepHierarchicalBit                 : 2
LCULevelRateControl                 : 1
RCLCUSeparateModel                  : 1
InitialQP                           : 0
RCForceIntraQP                      : 0
#============ Merge, TMVP, sign hiding ================
MaxNumMergeCand               : 5
TMVPMode                      : 1
SignHideFlag                  : 1
"""
HM_RA_STRUCTURE = """\
IntraPeriod                   : 32          # Period of I-Frame ( -1 = only first)
DecodingRefreshType           : 1           # Random Accesss 0:none, 1:CRA, 2:IDR, 3:Recovery Point SEI
GOPSize                       : 8           # GOP Size (number of B slice = GOPSize-1)
#        Type POC QPoffset QPfactor tcOffsetDiv2 betaOffsetDiv2 temporal_id #ref_pics_active #ref_pics reference pictures     predict deltaRPS #ref_idcs reference idcs
Frame1:  B    8   1        0.442    0            0              0           2                3         -8 -12 -16         0
Frame2:  B    4   2        0.3536   0            0              1           2                3         -4 -8 4            1       4        4         1 1 0 1
Frame3:  B    2   3        0.3536   0            0              2           2                4         -2 -6 2 6          1       2        4         1 1 1 1
Frame4:  B    1   4        0.68     0            0              3           2                4         -1 1 3 7           1       1        5         1 0 1 1 1
Frame5:  B    3   4        0.68     0            0              3           2                4         -1 -3 1 5          1       -2       5         1 1 1 1 0
Frame6:  B    6   3        0.3536   0            0              2           2                3         -2 -6 2            1       -3       5         0 1 1 1 0
Frame7:  B    5   4        0.68     0            0              3           2                4         -1 -5 1 3          1       1        4         1 1 1 1
Frame8:  B    7   4        0.68     0            0              3           2                4         -1 -3 -7 1         1       -2       5         1 1 1 1 0"""
HM_LDP_STRUCTURE = """\
IntraPeriod                   : -1          # Period of I-Frame ( -1 = only first)
DecodingRefreshType           : 0           # Random Accesss 0:none, 1:CRA, 2:IDR, 3:Recovery Point SEI
GOPSize                       : 4           # GOP Size (number of B slice = GOPSize-1)
#        Type POC QPoffset QPfactor tcOffsetDiv2 betaOffsetDiv2 temporal_id #ref_pics_active #ref_pics reference pictures predict deltaRPS #ref_idcs reference idcs
Frame1:  P    1   3        0.4624   0            0              0           4                4         -1 -5 -9 -13       0
Frame2:  P    2   2        0.4624   0            0              0           4                4         -1 -2 -6 -10       1      -1       5         1 1 1 0 1
Frame3:  P    3   3        0.4624   0            0              0           4                4         -1 -3 -7 -11       1      -1       5         0 1 1 1 1
Frame4:  P    4   1        0.578    0            0              0           4                4         -1 -4 -8 -12       1      -1       5         0 1 1 1 1"""
# encoder_intra_main.cfg's coding structure: every picture an IDR.
HM_AI_STRUCTURE = """\
IntraPeriod                   : 1           # Period of I-Frame ( -1 = only first)
DecodingRefreshType           : 0           # Random Accesss 0:none, 1:CRA, 2:IDR, 3:Recovery Point SEI
GOPSize                       : 1           # GOP Size (number of B slice = GOPSize-1)"""
# The per-sequence cfg (hm-16.5rc1/cfg/per-sequence/, HM class C's
# 832x480 layout) of a seeded clip.
HM_SEQUENCE_CFG = """\
#======== File I/O ===============
InputBitDepth                 : 8           # Input bitdepth
InputChromaFormat             : 420         # Ratio of luminance to chrominance samples
FrameRate                     : 30          # Frame Rate per second
FrameSkip                     : 0           # Number of frames to be skipped in input
SourceWidth                   : {w}         # Input  frame width
SourceHeight                  : {h}         # Input  frame height
FramesToBeEncoded             : {n}         # Number of frames to be coded
Level                         : 3.1
"""
CLI_W, CLI_H = 832, 480
CLI_RA_PICTURES, CLI_LDP_PICTURES, CLI_AI_PICTURES = 9, 3, 3
# [cli-ai-tiles]: HM's all-intra structure with two tile columns (HM's
# NumTileColumnsMinus1 : 1; 26 CTBs of 16 each, above its 256-sample
# minimum).
CLI_AI_TILE_COLUMNS = 2


def hm_cli_files(d: Path, kind: str, frames, w: int = CLI_W,
                 h: int = CLI_H, tile_columns: int = 1) -> list:
    """Write HM's main cfg of `kind` ("ra", "ldp" or "ai") with
    NumTileColumnsMinus1 = tile_columns - 1, the per-sequence cfg and the
    clip's YUV file into directory d; returns the encoder CLI's arguments
    (`-c main -c sequence -i in.yuv -b out.bin -o rec.yuv`, all in d)."""
    from video_codecs_tpu_torch.utils import yuv
    structure = {"ra": HM_RA_STRUCTURE, "ldp": HM_LDP_STRUCTURE,
                 "ai": HM_AI_STRUCTURE}[kind]
    main = d / f"encoder_{kind}_main.cfg"
    tiles_line = "NumTileColumnsMinus1                : "
    main.write_text(HM_MAIN_CFG.format(structure=structure).replace(
        tiles_line + "0", tiles_line + str(tile_columns - 1)))
    seq = d / f"Synth_{w}x{h}.cfg"
    seq.write_text(HM_SEQUENCE_CFG.format(w=w, h=h, n=len(frames)))
    src = d / "in.yuv"
    yuv.write_frames(str(src), *(np.stack([f[c] for f in frames])
                                 for c in range(3)))
    return ["-c", str(main), "-c", str(seq), "-i", str(src),
            "-b", str(d / "out.bin"), "-o", str(d / "rec.yuv")]


# Phase 18: the tile-sharded RA engine (parallel/sharded.py) on the
# headline's clip in TILED_COLUMNS columns of TILED_WT with the dry run's
# halo and encoder settings (graft_entry.dryrun_cfg, search range 8, the
# CU8 tree), and the experiment CLI's QP sweep on a seeded 832x480 YUV.
TILED_WT, TILED_HALO, TILED_SR = 480, 32, 8
TILED_COLUMNS = HEVC_W // TILED_WT
EXPERIMENT_PICTURES, EXPERIMENT_QPS = 3, "28,32,36,40"


def experiment_yuv(d: Path) -> Path:
    """Write bench_synth_clip(CLI_W, CLI_H, EXPERIMENT_PICTURES) as a YUV
    file in directory d (the experiment CLI's input); returns its path."""
    from video_codecs_tpu_torch.utils import yuv
    frames = bench_synth_clip(CLI_W, CLI_H, EXPERIMENT_PICTURES)
    path = d / f"exp_{CLI_W}x{CLI_H}.yuv"
    yuv.write_frames(str(path), *(np.stack([f[c] for f in frames])
                                  for c in range(3)))
    return path


def experiment_argv(path: Path, codec: str) -> list:
    """The experiment CLI's arguments for `codec` ("intra" or "ldp")."""
    return ["-i", str(path), "-W", str(CLI_W), "-H", str(CLI_H),
            "--qps", EXPERIMENT_QPS, "--codec", codec]


# The JM encoder CLI's runs (phases jm-main / jm-baseline): JM 18.5's
# geometry of its stock cfgs (176x144, the QCIF of foreman_part_qcif.yuv
# that bench.py's bench_jm_baseline and the JAX tests read), 5 pictures
# of bench.py's clip (seed 42) at QP 28, search range 16, IPPP.
JM_W, JM_H, JM_PICTURES, JM_SR = 176, 144, 5, 16
JM_SETTINGS = {
    # Main profile: CABAC, EPZS, 3 references, trellis (RDOQ)
    "main": dict(SymbolMode=1, SearchMode=3, NumberReferenceFrames=3,
                 UseRDOQuant=1, UseAdaptiveRounding=0, ProfileIDC=77),
    # Baseline: CAVLC, full search, 1 reference, adaptive rounding
    "baseline": dict(SymbolMode=0, SearchMode=0, NumberReferenceFrames=1,
                     UseRDOQuant=0, UseAdaptiveRounding=1, ProfileIDC=66),
}
# SAD launches of a run: one per reference and P picture (the Main
# settings' list holds 1, 2, 3 and 3 references).
JM_LAUNCHES = {"main": 1 + 2 + 3 + 3, "baseline": 4}
# The JAX package's JM encoder CLI on the same files
# (scripts/jax_reference_sha1.py --jm-main / --jm-baseline): bytes, SHA-1.
JM_SHA1 = {"main": (24931, "0af9146b4a7e9b2ed2841cdbb955e1f00025e61a"),
           "baseline": (32666, "3403d6c7d1168407c7757b918d2f0a6c86d0d1e6")}
# The host H.264 coder at High profile and with B slices (phase 15), at
# JM's QCIF on bench.py's clip (seed 42), QP 28, search range 16:
# [jm-main]'s settings with the 8x8 transform (the reference's JM CLI
# does not map Transform8x8Mode, so the phase calls the class), and B
# pictures between P anchors, b_qp_offset 2 as JM's stock QPBSlice 30
# against QPPSlice 28 (I0 P3 B1 B2 P6 B4 B5).
H264_HIGH_KW = dict(qp=28, search_range=JM_SR, entropy="cabac", n_refs=3,
                    me="epzs", quant="trellis", transform8x8=True)
H264_B_KW = dict(qp=28, search_range=JM_SR, b_frames=2, entropy="cabac",
                 b_qp_offset=2)
H264_HIGH_PICTURES, H264_B_PICTURES = 5, 7
# SAD launches: one per reference and P picture (the High run's list
# holds 1, 2, 3 and 3 references); the B run's two P anchors hold one
# reference each and each of its four B pictures searches two lists.
H264_HIGH_LAUNCHES = 1 + 2 + 3 + 3
H264_B_LAUNCHES = 2 + 2 * 4
# The JAX package's streams for them (scripts/jax_reference_sha1.py
# --h264-high / --h264-b, on the CPU): bytes, SHA-1.
H264_HIGH_SHA1 = (23753, "57437f38257e8b6f89abd0c02f25ddc793f4aaf5")
H264_B_SHA1 = (27423, "93b547699b1fe5308fabe1c9bce5ee9ed8f076ce")
# The rest of the H.264 host coder (phase 16), at JM's QCIF on bench.py's
# clip (seed 42), search range 16:
#   ltr:  a baseline conferencing sender -- CAVLC, 2 short-term
#         references beside a long-term one (the IDR, then every third P
#         picture by MMCO 4+6), the long-term picture moved to ref_idx 0
#         by list reordering;
#   wp:   [jm-main]'s settings (CABAC, EPZS, 3 references, trellis) with
#         weighted prediction, on the faded clip (`fade_clip`);
#   perc: the perceptual RDO of the reference's
#         test_perceptual_stream_jm_conformant (saliency-weighted lambda
#         and SSIM in the intra decision), QP 30;
#   loss: CAVLC with one MB row of intra refresh a picture (11 MBs),
#         sent over RTP with a recovery-point SEI and 20 % loss after the
#         first 3 packets (the parameter sets and the SEI).  12 pictures:
#         the reference's loss generator (an un-seeded libc rand, so the
#         same packets every run) keeps packets 3-12 and drops packet 13,
#         picture 10, so the stream must run past 10 pictures to lose one.
H264_CONF_KW = {
    "ltr": dict(qp=28, search_range=JM_SR, entropy="cavlc", n_refs=2,
                long_term=True, lt_period=3, reorder="lt_first"),
    "wp": dict(qp=28, search_range=JM_SR, entropy="cabac", me="epzs",
               n_refs=3, quant="trellis", weighted_pred=True),
    "perc": dict(qp=30, perceptual="att+ssim"),
    "loss": dict(qp=28, search_range=JM_SR, entropy="cavlc",
                 intra_refresh=11),
}
H264_CONF_PICTURES = {"ltr": 9, "wp": 5, "perc": 5, "loss": 12}
H264_LOSS_PERCENT, H264_LOSS_KEEP = 20, 3
# SAD launches: one per list0 entry and P picture, the lists' lengths in
# the port's CPU run of the same settings (ltr: 1, 2, then 3 a picture --
# two short-term references and the long-term one; wp: 1, 2, 3, 3).
H264_CONF_LAUNCHES = {"ltr": 1 + 2 + 3 * 6, "wp": 1 + 2 + 3 + 3, "perc": 4,
                      "loss": 11}
# The JAX package's streams for them (scripts/jax_reference_sha1.py
# --h264-ltr --h264-wp --h264-perc --h264-loss, on the CPU): bytes, SHA-1.
H264_CONF_SHA1 = {
    "ltr": (45350, "c52622b9e30a33ecdea04f8c2ca141fd0c9a6d44"),
    "wp": (26226, "5cb86818e1737ab560db44b99a86dc10c2fc7884"),
    "perc": (20779, "6a5e0f6449c5a6b5d1fbc17a848cd865dd0a3399"),
    "loss": (62496, "5e7a66a453e480b20fbc1bcb5722d8a7b2a7a788"),
}
# [h264-loss]'s network with the JAX package's SEI and RTP modules
# (--h264-loss): the stream sent and the stream received as (bytes,
# SHA-1), and per concealment mode the JAX H264Decoder's `concealed`
# list and its pictures' SHA-1 (`pictures_sha1`).
H264_LOSS_JAX = {
    "sent": (62533, "e8ceba37496f23f0b2652415334a27d5b623f86a"),
    "lossy": (57721, "f532324f83e0aded1d218228dfce7a111c6b8dd8"),
    1: ([10], "5f0c3575f5602ae83932111e44f2cca6dee60f1b"),
    2: ([10], "49319c3dc7858d76b743e25aab14c7ca5d9c76cd"),
}
# A JM-style cfg (jm18.5/bin/encoder_*.cfg layout: `Key = Value  # note`)
# with the mapped keys and four the CLI does not map (it warns about the
# one that is not 0, RDOptimization).
JM_CFG = """\
# JM 18.5 style encoder configuration
InputFile             = "{src}"   # Input sequence
FramesToBeEncoded     = {n}       # Number of frames to be coded
FrameRate             = 30.0      # Frame Rate per second
SourceWidth           = {w}       # Source frame width
SourceHeight          = {h}       # Source frame height
OutputFile            = "{out}"   # Bitstream
ReconFile             = "{rec}"   # Reconstructed YUV file
ProfileIDC            = {ProfileIDC}  # Profile IDC (66=baseline, 77=main)
LevelIDC              = 30        # Level IDC
IntraPeriod           = 0         # Period of I-pictures (0=only first)
QPISlice              = 28        # Quant. param for I Slices
QPPSlice              = 28        # Quant. param for P Slices
SearchRange           = {sr}        # Max search range
NumberReferenceFrames = {NumberReferenceFrames}  # Reference frames
SymbolMode            = {SymbolMode}  # 0=UVLC, 1=CABAC
SearchMode            = {SearchMode}  # -1 full, 0 fast full, 1 UMHex, 3 EPZS
UseRDOQuant           = {UseRDOQuant}  # RDOQ (trellis)
UseAdaptiveRounding   = {UseAdaptiveRounding}  # Adaptive rounding
RDOptimization        = 1         # rd-optimized mode decision
DisableSubpelME       = 0         # Disable sub-pixel motion estimation
NumberBFrames         = 0         # Number of B coded frames
ChromaQPOffset        = 0         # Chroma QP offset
"""


def jm_cli_files(d: Path, kind: str, frames) -> list:
    """Write the clip's YUV file and a JM-style cfg of `kind` ("main" or
    "baseline", JM_SETTINGS) into directory d; returns the JM encoder
    CLI's arguments (`-d d/encoder_<kind>.cfg`; out.264 and rec.yuv in
    d)."""
    from video_codecs_tpu_torch.utils import yuv
    src = d / "in.yuv"
    yuv.write_frames(str(src), *(np.stack([f[c] for f in frames])
                                 for c in range(3)))
    cfg = d / f"encoder_{kind}.cfg"
    h, w = frames[0][0].shape
    cfg.write_text(JM_CFG.format(src=src, n=len(frames), w=w, h=h,
                                 out=d / "out.264", rec=d / "rec.yuv",
                                 sr=JM_SR, **JM_SETTINGS[kind]))
    return ["-d", str(cfg)]

def cut_clip(w: int, h: int, nf: int, cut: int = 3):
    """A texture panning by (2, 1) px, then from picture `cut` on a smooth
    ramp no reference holds: the P pictures after it code intra blocks."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h + nf + 1, w + 2 * nf + 1)).astype(
        np.int32)
    yy, xx = np.mgrid[0:base.shape[0], 0:base.shape[1]]
    frames = []
    for f in range(nf):
        b = (128 + 60 * np.sin(xx / 5.0 + f) * np.cos(yy / 7.0) +
             (base - 128) // 6) if f < cut else 40 + 2 * xx + (yy // 8) * 9
        y = np.ascontiguousarray(np.clip(b, 0, 255).astype(np.uint8)[
            f:f + h, 2 * f:2 * f + w])
        frames.append((y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2 + 32))
    return frames


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def sad_bound(n: int, b: int, r: int) -> tuple[float, float, float]:
    """(ms, bytes, operations) the card needs at least for one SAD
    surface: uint8 cur and windows read once, the int32 surface written
    once, a subtract and an add for every absolute difference."""
    span = 2 * r + 1
    nbytes = b * (n * n + (n + 2 * r) ** 2) + 4 * b * span * span
    ops = 2 * b * span * span * n * n
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS) * 1e3, nbytes, ops


def sad_cdist(cur: torch.Tensor, win: torch.Tensor, n: int,
              r: int) -> torch.Tensor:
    """The yardstick: one PyTorch call (torch.cdist, p=1) for the same
    surface, in the chunks sad_surface_ref takes."""
    b, span = cur.shape[0], 2 * r + 1
    chunk = max(1, ss._CHUNK_ELEMS // (span * span * n * n))
    out = torch.empty((b, span * span), dtype=torch.float32,
                      device=cur.device)
    for s in range(0, b, chunk):
        c = cur[s:s + chunk].float().reshape(-1, 1, n * n)
        p = win[s:s + chunk].float().unfold(1, n, 1).unfold(2, n, 1)
        out[s:s + chunk] = torch.cdist(c, p.reshape(-1, span * span, n * n),
                                       p=1)[:, 0]
    return out.reshape(b, span, span)


def build_kernels() -> None:
    """Phase 2: one nvcc for each kernel's source, all started together,
    then load each library."""
    t0 = time.perf_counter()
    mods = (ss, sao_ops, rdoq_ops)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = list(pool.map(lambda m: m.build(), mods))
    for mod, (so, build_s, log) in zip(mods, builds):
        mod._load()
        print(f"[build] {so.name}: nvcc {build_s:.2f} s (0 = cached)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
    print(f"[build] all three kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernel() -> dict:
    """Phase 3: the SAD kernel vs plain (and the yardstick) at the H.264
    slice's shapes."""
    rng = np.random.default_rng(2024)
    pic = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0, ops=0)
    max_err = 0
    for n, b, r in ((16, 3600, 16), (8, 14400, 16), (16, 3600, 32),
                    (8, 37, 8)):
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        max_err = max(max_err, err)
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        if b < 100:                      # the ragged case: checked only
            print(f"[sad] n={n} B={b} r={r}: equal")
            continue
        tm = sad_times(cur, win, n, r, reps=7)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        gdiff = ops / 2e9
        rate = "" if ms is None else f", {gdiff / ms * 1e3:.0f} G/s"
        print(f"[sad] n={n} B={b} r={r}: equal; kernel {kms(ms, 3)} "
              f"(profiler{', ' + tm['note'] if tm['note'] else ''}; "
              f"{gdiff:.2f} G abs-diffs{rate}), {tm['event_ms']:.3f} ms a "
              f"wrapper call (CUDA events); bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G ops), "
              f"{of_bound(bound, ms)}; plain {plain:.3f} ms "
              f"({bound / plain:.2%}); torch.cdist {lib:.3f} ms "
              f"({bound / lib:.2%}, max abs err {lib_err:g})")
        if r == SR:
            add_kernel_ms(pic, 1, ms, tm["note"], f"n={n}")
            pic["plain_ms"] += plain
            pic["library_ms"] += lib
            pic["bytes"] += nbytes
            pic["ops"] += ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[sad] per 720p P picture at SR{SR} (n=16 + n=8): kernel "
          f"{kms(pic['ms'], 3)}, bound {pic['bound_ms']:.4f} ms "
          f"({pic['bound_by']}), {of_bound(pic['bound_ms'], pic['ms'])}; "
          f"plain {pic['plain_ms']:.3f} ms; torch.cdist "
          f"{pic['library_ms']:.3f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["max_abs_err"] = max_err
    return pic


def phase_encode_720p() -> int:
    """Phase 4: the slice end to end on the card.  Returns the kernel's
    launch count during the encode."""
    frames = synth_clip(W, H, 4, seed=7)
    enc = inter_dev.DeviceH264Encoder(W, H, qp=QP, search_range=SR,
                                      device="cuda")
    ss.sad_surface.launches = 0
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence(frames)
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    n_p = len(frames) - 1
    check(launches == 2 * n_p,
          f"{launches} SAD-kernel launches for {n_p} P pictures "
          "(want 2 each)")
    check(len(enc.p_times) == n_p, "P pictures did not take the device path")
    t0 = time.perf_counter()
    out = H264Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c], np.uint8),
                                 np.asarray(o[c], np.uint8)),
                  f"decoded frame {i} plane {c} != encoder recon")
    psnrs = [psnr(f[0], np.asarray(r[0])) for f, r in zip(frames, recons)]
    check(all(np.isfinite(p) and p > 25 for p in psnrs),
          f"implausible Y-PSNR {psnrs}")
    kbps = len(stream) * 8 / len(frames) * 30 / 1000
    print(f"[720p] {W}x{H} QP{QP} SR{SR} IPPP: {len(stream)} bytes, "
          f"{kbps:.1f} kbps at 30 fps, Y-PSNR "
          + " ".join(f"{p:.2f}" for p in psnrs)
          + f" dB; encode {t_enc:.2f} s, decode {t_dec:.2f} s; "
          f"SAD-kernel launches {launches}; decode bit-exact in the "
          "port's H264Decoder")
    for i, (dev_s, host_s) in enumerate(enc.p_times):
        print(f"[720p] P{i + 1}: device phase {dev_s * 1e3:.1f} ms, "
              f"host phase {host_s * 1e3:.1f} ms")
    return launches


def phase_cuda_vs_cpu() -> None:
    """Phase 5: the same work on the card and on the CPU (plain SAD)."""
    frames = synth_clip(W, H, 2, seed=11)
    (y, u, v), ref = frames[1], [p.astype(np.int32) for p in frames[0]]
    lam = 0.85 * 2.0 ** ((QP - 12) / 3.0)
    for sr in (16, 32):
        outs = []
        for dev in ("cuda", "cpu"):
            planes = [torch.from_numpy(p).to(dev) for p in (y, u, v, *ref)]
            with torch.inference_mode():
                t0 = time.perf_counter()
                st = inter_dev.encode_p_dev(*planes, qp=QP, w=W, h=H, sr=sr,
                                            lam=lam)
                st = {k: t.cpu().numpy() for k, t in st.items()}
            outs.append((st, time.perf_counter() - t0))
        (g, tg), (c, tc) = outs
        for k in ("mv16x", "mv16y", "mv8x", "mv8y"):
            check(np.array_equal(g[k], c[k]), f"{k} cuda != cpu at SR{sr}")
        diff = [k for k in g if not np.array_equal(g[k], c[k])]
        print(f"[cuda-vs-cpu] 720p P SR{sr}: motion fields equal; "
              f"split8 differences {int((g['split8'] != c['split8']).sum())}"
              f" of {g['split8'].size}; keys differing {diff or 'none'}; "
              f"cuda {tg * 1e3:.1f} ms, cpu {tc * 1e3:.1f} ms")

    small = synth_clip(176, 144, 3, seed=3)
    streams = {}
    for dev in ("cuda", "cpu"):
        enc = inter_dev.DeviceH264Encoder(176, 144, qp=QP, search_range=SR,
                                          device=dev)
        streams[dev] = enc.encode_sequence(small)[0]
    print(f"[cuda-vs-cpu] 176x144 IPP streams byte-equal: "
          f"{streams['cuda'] == streams['cpu']} "
          f"({len(streams['cuda'])} / {len(streams['cpu'])} bytes)")


def hevc_cfg(w: int, h: int):
    """The IDR settings of the 1080p headline (CTB32, min CU 8, max TB 32,
    RDOQ-lite, SBH), with deblocking and the MD5 picture-hash SEI on."""
    return hevc_headers.HevcConfig(
        width=w, height=h, qp=HEVC_QP, log2_ctb=5, log2_min_cb=3,
        log2_max_tb=5, sign_data_hiding=True, rdoq="lite", hash_sei=True)


# [hevc-tiles] / [hevc-wpp]: the flat CTB16 all-intra coder at the
# headline's 1920x1072 on synth_clip(1920, 1072, 3, seed=5): QP 32, rdoq
# off, deblocking and the MD5 hash SEI on; 4 uniform tile columns of 30
# CTBs (480 samples, above HM's 256-sample minimum), or WPP.
TILES_PICTURES, TILE_COLUMNS = 3, 4
# The JAX package's streams on the CPU (scripts/jax_reference_sha1.py
# --tiles --wpp --cli-ai-tiles --qt-host: parallel.tiles over 4 host
# devices; encode_frame_jit + the WPP slice writer; its encoder CLI; its
# QuadtreeIntraEncoder), the first three with the port's repaired slice
# writers swapped in (entry points in EBSP bytes, ROADMAP queue 3
# reference fault 16), each hash OK 3 of 3 (1 of 1) in its
# GeneralDecoder with its pictures the encoder's: bytes and SHA-1.  As
# written, the tile stream's SHA-1 is aa35efd1..., whose picture 2 (an
# emulation prevention byte in its third substream) fails a spec
# decoder's hash; the WPP and CLI streams hold no such byte.
TILES_BYTES, TILES_SHA1 = 880842, "16444e8f08a7bf7d1b34fc75df8cee173ad4c355"
WPP_BYTES, WPP_SHA1 = 881244, "0d81a19ee1e28276cec1e3c4112a74a967ab7a26"
CLI_AI_TILES_BYTES = 239131
CLI_AI_TILES_SHA1 = "c83787538f603f1b717a1138d7a039d90a602c33"
QT_HOST_BYTES, QT_HOST_SHA1 = 3351, "82d2108c5b971d2d05f7065b85b1685518dae411"
# [hevc-qt-host]: the host quadtree RD encoder (QuadtreeIntraEncoder) at
# CTB 32 on one 192x128 picture of synth_clip(192, 128, 1, seed=5).
QT_HOST_W, QT_HOST_H = 192, 128


def tiles_cfg(w: int, h: int, tile_columns: int = TILE_COLUMNS,
              wpp: bool = False):
    """[hevc-tiles]' settings (`tile_columns` 1 and `wpp` for [hevc-wpp]
    and the untiled timing): the HevcConfig defaults (CTB = CU = TU 16,
    deblocking and the hash SEI on) at QP 32."""
    return hevc_headers.HevcConfig(width=w, height=h, qp=HEVC_QP,
                                   tile_columns=tile_columns, wpp=wpp)


def qt_host_cfg(w: int, h: int):
    """[hevc-qt-host]'s settings: CTB 32, min CU 8, max TB 32, QP 32, SBH
    and HM's RDOQ : 1 (rdoq="full"), deblocking and the hash SEI on."""
    return hevc_headers.HevcConfig(
        width=w, height=h, qp=HEVC_QP, log2_ctb=5, log2_min_cb=3,
        log2_max_tb=5, sign_data_hiding=True, rdoq="full")


def rdoq_coeffs(cur: np.ndarray, ref: np.ndarray | None,
                log2: int) -> torch.Tensor:
    """[B, n, n] int32 coefficients on the card for every n x n block of a
    plane: the port's forward transform of cur - ref (ref None: cur less
    each block's rounded mean, an intra DC residual), then block 0 zeroed
    and blocks 1 and 2 set to the coefficient clamp (32,767; then
    alternating rows of -32,768 and 32,767)."""
    n = 1 << log2
    h, w = (d // n * n for d in cur.shape)
    res = cur[:h, :w].astype(np.int32)
    if ref is not None:
        res = res - ref[:h, :w].astype(np.int32)
    blk = res.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3).reshape(
        -1, n, n)
    if ref is None:
        blk = blk - np.round(blk.mean(axis=(1, 2), keepdims=True)).astype(
            np.int32)
    co = tr_ops.forward_transform(torch.from_numpy(
        np.ascontiguousarray(blk)).cuda(), log2)    # strided, as on the path
    co[0] = 0
    co[1] = 32767
    co[2, ::2] = -32768
    co[2, 1::2] = 32767
    return co


# Float32 operations per position of csrc/rdoq.cu: the level-0
# distortion (2), the level-0 cost (1), two candidate costs (4 each), the
# significance cost (1), the CG sums (2), the last-position total with
# its prefix and suffix sums (9) and the rate's final distortion (4).
RDOQ_OPS_PER_POS = 27


def rdoq_bound(b: int, log2: int, rate: bool,
               table_bytes: int) -> tuple[float, float, float]:
    """(ms, bytes, operations) the card needs at least for one RDOQ call:
    int32 coefficients read once, int32 levels written once, the float32
    rates written once (with the rate), the tables read once; the float32
    operations at the card's float32 rate."""
    nn = 1 << (2 * log2)
    nbytes = 8 * b * nn + (4 * b if rate else 0) + table_bytes
    ops = RDOQ_OPS_PER_POS * b * nn
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3, nbytes, ops


# RDOQ calls per RA B picture at each of phase_rdoq_kernel's B-picture
# shapes (inter_dev.encode_b_frame_dev and inter_qt.qt_merge_dev): TU16
# luma twice, TU8 chroma four times, the RQT's TU8 luma once and TU4
# chroma twice, 9 launches.
RA_B_RDOQ_CALLS = {"1080p B TU16 luma": 2, "1080p B TU8 chroma": 4,
                   "1080p B RQT TU8 luma": 1, "1080p B RQT TU4 chroma": 2}


def rdoq_shapes() -> list:
    """The RDOQ calls of the paths, on the card: (what, coefficients,
    log2, is_luma, slice type, with the rate, qp), the 1080p B picture's
    TU16 luma call first."""
    ra = synth_clip(HEVC_W, HEVC_H, 2, seed=5)
    ldp = bench_synth_clip(LDP_W, LDP_H, 2)
    idr = np.pad(ra[0][0], ((0, 16), (0, 0)), mode="edge")   # 1920x1088
    qb, qi, ql = HEVC_QP + 2, HEVC_QP, 37        # a B picture's, IDR, LD-P
    # (what, cur, ref, log2, luma, slice type, rate, qp)
    shapes = [
        ("1080p B TU16 luma", ra[1][0], ra[0][0], 4, True, 0, True, qb),
        ("1080p B TU8 chroma", ra[1][1], ra[0][1], 3, False, 0, True, qb),
        ("1080p B RQT TU8 luma", ra[1][0], ra[0][0], 3, True, 0, True, qb),
        ("1080p B RQT TU4 chroma", ra[1][1], ra[0][1], 2, False, 0, True,
         qb),
        ("1080p IDR TU8 trial", idr, None, 3, True, 2, True, qi),
        ("1080p IDR TU16 trial", idr, None, 4, True, 2, True, qi),
        ("1080p IDR TU32 trial", idr, None, 5, True, 2, True, qi),
        ("LD-P P TU16 luma", ldp[1][0], ldp[0][0], 4, True, 0, False, ql),
        ("LD-P P TU8 chroma", ldp[1][1], ldp[0][1], 3, False, 0, False, ql),
    ]
    return [(what, rdoq_coeffs(cur, ref, log2), log2, luma, st, rate, qp)
            for what, cur, ref, log2, luma, st, rate, qp in shapes]


def rdoq_lam(qp: int) -> float:
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def rdoq_row(tag: str, what: str, co, log2: int, luma: bool, st: int,
             rate: bool, qp: int) -> dict:
    """The full-RDOQ kernel against `rdoq_dev_ref` on the same CUDA
    coefficients, levels exactly and rates bit for bit, timed beside its
    bound and the plain version; prints one line under [tag] and returns
    its row."""
    b = co.shape[0]
    kw = dict(lam=rdoq_lam(qp), is_luma=luma, slice_type=st,
              return_rate=rate)
    got = rdoq_ops.rdoq_dev(co, qp, log2, **kw)
    torch.cuda.synchronize()
    want = rdoq_ops.rdoq_dev_ref(co, qp, log2, **kw)
    (g, gb), (w_, wb) = (got, want) if rate else ((got, None),
                                                  (want, None))
    err = int((g - w_).abs().max())
    same_bits = gb is None or torch.equal(gb.view(torch.int32),
                                          wb.view(torch.int32))
    check(err == 0 and same_bits,
          f"RDOQ kernel != plain at {what} B={b} (levels max abs err "
          f"{err}, rates bitwise equal {same_bits})")
    ev = cuda_ms(lambda: rdoq_ops.rdoq_dev(co, qp, log2, **kw), reps=11)
    ms, note = kernel_ms(lambda: rdoq_ops.rdoq_dev(co, qp, log2, **kw),
                         "rdoq_kernel")
    plain = cuda_ms(lambda: rdoq_ops.rdoq_dev_ref(co, qp, log2, **kw),
                    reps=3, warm=1)
    tab, rl = rdoq_ops._kernel_tables(qp, log2, luma, st, 0, co.device)
    bound, nbytes, ops = rdoq_bound(b, log2, rate,
                                    4 * (tab.numel() + rl.numel()))
    by = "operations" if ops / PEAK_F32 >= nbytes / PEAK_BYTES \
        else "bytes"
    nz = float((g != 0).float().mean())
    print(f"[{tag}] {what}: B={b} QP{qp} slice type {st}"
          f"{', with the rate' if rate else ''}: levels equal (max abs "
          f"err 0){', rates bitwise equal' if rate else ''}, "
          f"{nz:.2%} of levels nonzero; kernel {kms(ms)} (profiler"
          f"{', ' + note if note else ''}), {ev:.4f} ms a wrapper call "
          f"(CUDA events); bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} G float32 ops, {by}), "
          f"{of_bound(bound, ms)}; plain {plain:.2f} ms"
          f"{'' if ms is None else f' ({plain / ms:.0f}x the kernel)'}")
    return dict(what=what, b=b, log2=log2, qp=qp, ms=ms, event_ms=ev,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, max_abs_err=err, note=note or None)


def phase_rdoq_kernel() -> list:
    """Phase 6 (first): the full-RDOQ kernel against `rdoq_dev_ref` on the
    same CUDA tensors at the paths' shapes, levels exactly and rates bit
    for bit, each timed beside its bound and the plain version.  Returns
    one row per shape, the 1080p B picture's TU16 luma call first."""
    rows = []
    for what, co, log2, luma, st, rate, qp in rdoq_shapes():
        rows.append(rdoq_row("rdoq-kernel", what, co, log2, luma, st, rate,
                             qp))
        del co
    torch.cuda.empty_cache()
    b_rows = [r for r in rows if r["what"] in RA_B_RDOQ_CALLS]
    timed = [r for r in b_rows if r["ms"] is not None]
    per_b = {k: sum(RA_B_RDOQ_CALLS[r["what"]] * r[k] for r in timed)
             for k in ("ms", "event_ms", "bound_ms")}
    left_out = [r["what"] for r in b_rows if r["ms"] is None]
    calls = sum(RA_B_RDOQ_CALLS[r["what"]] for r in timed)
    gone = ("; left out, kernel not measured: " + ", ".join(left_out)
            if left_out else "")
    print(f"[rdoq-kernel] per 1080p RA B picture ({calls} of "
          f"{sum(RA_B_RDOQ_CALLS.values())} calls at the B shapes above"
          f"{gone}): kernel {per_b['ms']:.4f} ms, wrapper calls "
          f"{per_b['event_ms']:.4f} ms, bound {per_b['bound_ms']:.4f} ms")
    print("[rdoq-kernel] no single PyTorch call computes RDOQ (library_ms "
          "null)")
    return rows


def phase_hevc_intra() -> None:
    """Phase 6: the HEVC all-intra quadtree on the card against the CPU.
    The 1080p IDR now runs inside the RA GOP of phase 7."""
    # the 35-mode prediction is a float32 matmul that is exact only
    # without TF32 (the package turns it off at import)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    sw, sh = 416, 240                    # the repo's bench_intra_qt size
    y, u, v = synth_clip(sw, sh, 1, seed=9)[0]
    res = {}
    routes = {}
    for dev in ("cuda", "cpu"):
        e = quadtree_codec.QuadtreeFastEncoder(hevc_cfg(sw, sh), device=dev)
        t0 = time.perf_counter()
        st, *routes[dev] = rdoq_routes(lambda: {
            k: a.cpu().numpy() for k, a in e._dispatch(y, u, v).items()})
        res[dev] = (st, e.serialize_frame(st)[0],
                    time.perf_counter() - t0)
    (g, gn, tg), (c, cn, tc) = res["cuda"], res["cpu"]
    routed = check_rdoq_routes(f"hevc-intra {sw}x{sh}", routes["cuda"],
                               routes["cpu"])
    diff = {k: int((g[k] != c[k]).sum()) for k in g
            if not np.array_equal(g[k], c[k])}
    check(not diff, f"cuda != cpu at {sw}x{sh}: elements differing per "
                    f"key {diff}")
    check(gn == cn, f"cuda and cpu NAL bytes differ at {sw}x{sh}")
    print(f"[hevc-intra] {sw}x{sh} picture on the card and on the CPU: all "
          f"{len(g)} state keys equal, NAL bytes equal ({routed}) "
          f"({sum(len(n) for n in gn if n)} bytes); cuda {tg:.2f} s, "
          f"cpu {tc:.2f} s")


def ra_cfg(w: int, h: int, **kw):
    """The 1080p headline's settings (bench.py:84-107): CTB32, min CU 8,
    max TB 32, QP 32, SBH, merge-5, TMVP, with the MD5 picture-hash SEI."""
    cfg = hevc_headers.HevcConfig(
        width=w, height=h, qp=HEVC_QP, log2_ctb=5, log2_min_cb=3,
        log2_max_tb=5, reorder_pics=3, sign_data_hiding=True, rdoq="lite",
        merge_cands=5, hash_sei=True, temporal_mvp=True)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def ra_sad_shapes(w: int, h: int, sr: int, n: int = 16):
    """(n, B, r) of the pyramid's three SAD surfaces per list and
    reference: the 4x4-pooled exhaustive stage and two +-3 windows."""
    b = (w // n) * (h // n)
    return [(n // 4, b, max(1, (sr + 3) // 4)), (n, b, 3), (n, b, 3)]


def phase_ra_kernel() -> dict:
    """Phase 7a: the kernel against its plain version at the RA path's
    shapes (and the CU8 tree's), timed beside its bound; the totals are
    per B picture (two lists, one reference each)."""
    rng = np.random.default_rng(2025)
    pic = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    max_err = 0
    shapes = ra_sad_shapes(HEVC_W, HEVC_H, RA_SR)
    cu8 = ra_sad_shapes(HEVC_W, HEVC_H, RA_SR, n=8)
    for i, (n, b, r) in enumerate(shapes[:2] + cu8[:2]):
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        max_err = max(max_err, err)
        if i >= 2:                       # the CU8 tree's shapes: checked
            print(f"[ra-sad] n={n} B={b} r={r} (CU8 tree): equal")
            continue
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        tm = sad_times(cur, win, n, r)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        print(f"[ra-sad] n={n} B={b} r={r}: equal; kernel {kms(ms)} "
              f"(profiler{', ' + tm['note'] if tm['note'] else ''}), "
              f"{tm['event_ms']:.4f} ms a wrapper call (CUDA events); "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} G ops), {of_bound(bound, ms)}; plain "
              f"{plain:.3f} ms; torch.cdist {lib:.3f} ms (max abs err "
              f"{lib_err:g})")
        k = 2 * (1 if i == 0 else 2)     # per B picture: 2 lists
        add_kernel_ms(pic, k, ms, tm["note"], f"n={n} r={r}")
        pic["plain_ms"] += k * plain
        pic["library_ms"] += k * lib
        pic["bytes"] += k * nbytes
        pic["ops"] += k * ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[ra-sad] per 1080p B picture at SR{RA_SR} (2 lists x (quarter "
          f"stage + 2 windows), 6 launches): kernel {kms(pic['ms'])}, "
          f"bound {pic['bound_ms']:.4f} ms ({pic['bound_by']}), "
          f"{of_bound(pic['bound_ms'], pic['ms'])}; plain "
          f"{pic['plain_ms']:.3f} ms; torch.cdist {pic['library_ms']:.3f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["max_abs_err"] = max_err
    return pic


def sao_bound(h: int, w: int, ctb: int) -> tuple[float, float, float]:
    """(ms, bytes, operations) the card needs at least for one plane's SAO
    statistics: uint8 orig and rec read once, the 104 four-byte values of
    each CTB (EO counts and sums 4 x 5 each, band counts and sums 32 each)
    written once; per sample 8 neighbour differences, the orig - rec
    difference, the band shift and 10 accumulations."""
    nbytes = 2 * h * w + 104 * 4 * (h // ctb) * (w // ctb)
    ops = 20 * h * w
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS) * 1e3, nbytes, ops


def kernel_device_ms(fn, name: str, reps: int = 21) -> float | None:
    """Median device time in ms of the kernels called `name` that reps
    calls of fn() launch, from torch.profiler; None if the profiler saw
    none (kernel_ms asks again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return statistics.median(times) / 1e3 if times else None


def kernel_ms(fn, name: str, reps: int = 21,
              tries: int = 3) -> tuple[float | None, str]:
    """(kernel time in ms, "") from kernel_device_ms, asked up to `tries`
    times, or (None, the reason) when no profiler session recorded a
    kernel called `name`.  A wrapper call's CUDA-event time is never
    taken for the kernel's: it holds the wrapper's host work too."""
    for _ in range(tries):
        ms = kernel_device_ms(fn, name, reps)
        if ms is not None:
            return ms, ""
    return None, f"torch.profiler recorded no {name} in {tries} tries"


def of_bound(bound: float, ms: float | None) -> str:
    """The kernel time's share of its bound, from a kernel time only."""
    if ms is None:
        return "share of the bound not measured"
    return f"{bound / ms:.1%} of it"


def kms(ms: float | None, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def sad_times(cur, win, n: int, r: int, reps: int = 21) -> dict:
    """The SAD kernel's time from the profiler (`ms`, None with `note`
    when unrecorded), one wrapper call's from CUDA events (`event_ms`),
    the plain version's and torch.cdist's."""
    ms, note = kernel_ms(lambda: ss.sad_surface(cur, win, n, r),
                         "sad_surface_u8", reps)
    return dict(ms=ms, note=note,
                event_ms=cuda_ms(lambda: ss.sad_surface(cur, win, n, r),
                                 reps=reps),
                plain_ms=cuda_ms(lambda: ss.sad_surface_ref(cur, win, n, r),
                                 reps=3, warm=1),
                library_ms=cuda_ms(lambda: sad_cdist(cur, win, n, r),
                                   reps=3, warm=1))


def add_kernel_ms(pic: dict, k: float, ms: float | None, note: str,
                  what: str) -> None:
    """Add k kernel times to a per-picture total; an unrecorded one makes
    the total None, with the reason in pic["note"]."""
    if ms is None:
        pic["ms"] = None
        pic["note"] = "; ".join(filter(None, (pic.get("note"),
                                              f"{what}: {note}")))
    elif pic["ms"] is not None:
        pic["ms"] += k * ms


def sao_planes() -> list:
    """(what, orig, rec, ctb, timed) on the card: the RA SAO path's padded
    planes of a 1080p picture (timed) and of 112x80, rec within +-3 of
    orig."""
    y, u, v = synth_clip(HEVC_W, HEVC_H, 1, seed=5)[0]
    rng = np.random.default_rng(2027)
    planes = []
    for what, plane, ctb, timed in (
            ("1080p luma", y, 32, True), ("1080p Cb", u, 16, True),
            ("1080p Cr", v, 16, True), ("112x80 luma", y[:80, :112], 32,
                                        False),
            ("112x80 Cb", u[:40, :56], 16, False)):
        o = inter_qt._pad_to(np.ascontiguousarray(plane), ctb)
        r = np.clip(o.astype(np.int16) + rng.integers(-3, 4, o.shape),
                    0, 255).astype(np.uint8)
        planes.append((what, torch.from_numpy(np.ascontiguousarray(o)).cuda(),
                       torch.from_numpy(r).cuda(), ctb, timed))
    return planes


def phase_sao_kernel() -> dict:
    """Phase 7e: the SAO-statistics kernel against its plain version at
    the RA SAO path's padded planes, exactly, timed beside its bound; the
    totals are per 1080p picture (luma + two chroma planes, 3 launches)."""
    pic = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    max_err = 0.0
    for what, to, tr, ctb, timed in sao_planes():
        got = sao_ops.sao_stats(to, tr, ctb)
        torch.cuda.synchronize()
        want = sao_ops.sao_stats_ref(to, tr, ctb)
        check(all(g.dtype == w_.dtype and g.shape == w_.shape and
                  g.stride() == w_.contiguous().stride()
                  for g, w_ in zip(got, want)),
              f"SAO kernel outputs' dtypes, shapes or strides differ "
              f"({what})")
        err = max(float((g.double() - w_.double()).abs().max())
                  for g, w_ in zip(got, want))
        check(err == 0, f"SAO kernel != plain at {what} "
                        f"{tuple(to.shape)} (max abs err {err})")
        max_err = max(max_err, err)
        hp, wp = to.shape
        if not timed:
            print(f"[sao-kernel] {what} ({wp}x{hp} padded, CTB {ctb}): "
                  "all four outputs equal")
            continue
        ev = cuda_ms(lambda: sao_ops.sao_stats(to, tr, ctb), reps=21)
        ms, note = kernel_ms(lambda: sao_ops.sao_stats(to, tr, ctb),
                             "sao_stats_kernel")
        plain = cuda_ms(lambda: sao_ops.sao_stats_ref(to, tr, ctb), reps=3,
                        warm=1)
        bound, nbytes, ops = sao_bound(hp, wp, ctb)
        print(f"[sao-kernel] {what} ({wp}x{hp} padded, CTB {ctb}, "
              f"{(hp // ctb) * (wp // ctb)} CTBs): all four outputs equal; "
              f"kernel {kms(ms)} (profiler{', ' + note if note else ''}), "
              f"{ev:.4f} ms a wrapper call (CUDA events); bound "
              f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB), "
              f"{of_bound(bound, ms)}; plain {plain:.3f} ms")
        add_kernel_ms(pic, 1, ms, note, what)
        pic["event_ms"] += ev
        pic["plain_ms"] += plain
        pic["bytes"] += nbytes
        pic["ops"] += ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[sao-kernel] per 1080p picture (3 launches): kernel "
          f"{kms(pic['ms'])} ({pic['event_ms']:.4f} ms in wrapper calls), "
          f"bound {pic['bound_ms']:.4f} ms ({pic['bytes'] / 1e6:.2f} MB, "
          f"{pic['bound_by']}), {of_bound(pic['bound_ms'], pic['ms'])}; "
          f"plain {pic['plain_ms']:.3f} ms; no single PyTorch call computes "
          "these statistics (library_ms null)"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["library_ms"] = None
    pic["max_abs_err"] = max_err
    return pic


def phase_sao_kernel_flat() -> tuple[list, dict]:
    """Phase 8 (sao-kernel, flat shapes): the SAO-statistics kernel
    against its plain version at the flat CTB16 engines' planes (luma at
    CTB 16, chroma at CTB 8: 832x480 and 416x240 of the LD-P row, 1920x1072
    and 960x536 of the flat 1080p engines), rec within +-3 of orig, all
    four outputs exactly, each timed beside its bound and the plain
    version.  Returns the rows and the per-picture totals (LD-P and flat
    1080p, 3 launches each)."""
    rng = np.random.default_rng(2029)
    ldp = bench_synth_clip(LDP_W, LDP_H, 1)[0]
    flat = synth_clip(HEVC_W, HEVC_H, 1, seed=5)[0]
    rows, pics = [], {}
    for pic_name, planes in (("832x480", ldp), ("1920x1072", flat)):
        pic = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bytes=0, ops=0)
        for comp, plane in zip(("luma", "Cb", "Cr"), planes):
            ctb = 16 if comp == "luma" else 8
            o = np.ascontiguousarray(plane)
            r = np.clip(o.astype(np.int16) + rng.integers(-3, 4, o.shape),
                        0, 255).astype(np.uint8)
            to, tr = torch.from_numpy(o).cuda(), torch.from_numpy(r).cuda()
            got = sao_ops.sao_stats(to, tr, ctb)
            torch.cuda.synchronize()
            want = sao_ops.sao_stats_ref(to, tr, ctb)
            err = max(float((g.double() - w_.double()).abs().max())
                      for g, w_ in zip(got, want))
            check(err == 0 and all(g.dtype == w_.dtype and
                                   g.shape == w_.shape
                                   for g, w_ in zip(got, want)),
                  f"SAO kernel != plain at {pic_name} {comp} CTB {ctb} "
                  f"(max abs err {err})")
            ev = cuda_ms(lambda: sao_ops.sao_stats(to, tr, ctb), reps=21)
            ms, note = kernel_ms(lambda: sao_ops.sao_stats(to, tr, ctb),
                                 "sao_stats_kernel")
            plain = cuda_ms(lambda: sao_ops.sao_stats_ref(to, tr, ctb),
                            reps=3, warm=1)
            hp, wp = o.shape
            bound, nbytes, ops = sao_bound(hp, wp, ctb)
            what = f"{pic_name} {comp}"
            print(f"[sao-kernel] flat {what} ({wp}x{hp}, CTB {ctb}, "
                  f"{(hp // ctb) * (wp // ctb)} CTBs): all four outputs "
                  f"equal; kernel {kms(ms)} (profiler"
                  f"{', ' + note if note else ''}), {ev:.4f} ms a wrapper "
                  f"call (CUDA events); bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.2f} MB), {of_bound(bound, ms)}; plain "
                  f"{plain:.3f} ms")
            rows.append(dict(what=what, h=hp, w=wp, ctb=ctb, ms=ms,
                             event_ms=ev, plain_ms=plain, bound_ms=bound,
                             bound_by="bytes", max_abs_err=err,
                             note=note or None))
            add_kernel_ms(pic, 1, ms, note, what)
            pic["event_ms"] += ev
            pic["plain_ms"] += plain
            pic["bytes"] += nbytes
            pic["ops"] += ops
        pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                              pic["ops"] / PEAK_OPS) * 1e3
        print(f"[sao-kernel] flat {pic_name} picture (3 launches): kernel "
              f"{kms(pic['ms'])} ({pic['event_ms']:.4f} ms in wrapper "
              f"calls), bound {pic['bound_ms']:.4f} ms "
              f"({pic['bytes'] / 1e6:.2f} MB), "
              f"{of_bound(pic['bound_ms'], pic['ms'])}; plain "
              f"{pic['plain_ms']:.3f} ms"
              f"{'; ' + pic['note'] if pic.get('note') else ''}")
        pics[pic_name] = pic
    return rows, pics


def _sao_timer(enc, cur: dict) -> None:
    """Wrap enc._sao_decide_apply (the flat engines' SAO decision and
    apply): per picture its host clock, within it the three statistics
    calls' (`sao_stats`, synchronised: for the call, intra_codec's name
    `sao_ops` points at a copy of the module's namespace with the timed
    function, so that the module's own counter stays its), the kernel's
    device time from a torch.profiler session around the call (None when
    the session recorded fewer kernels than were launched), the
    sao_stats launches and the plain version's calls on the card; keep
    the parameters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stats = sao_ops.sao_stats
    orig = enc._sao_decide_apply

    def stats_timed(o, r, ctb):
        t0 = time.perf_counter()
        out = stats(o, r, ctb)
        torch.cuda.synchronize()
        cur["sao_stats"] = cur.get("sao_stats", 0.0) + \
            time.perf_counter() - t0
        return out

    timed_ops = types.SimpleNamespace(**vars(sao_ops))
    timed_ops.sao_stats = stats_timed

    def run(origs, recs):
        torch.cuda.synchronize()
        n0, p0 = stats.launches, SAO_REF_CALLS["cuda"]
        hevc_intra_codec.sao_ops = timed_ops
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # kernels launched right as a session starts can go
                # unrecorded (all three of every 832x480 picture's did)
                time.sleep(PROFILER_SETTLE_S)
                t0 = time.perf_counter()
                params, outs = orig(origs, recs)
                t1 = time.perf_counter()
        finally:
            hevc_intra_codec.sao_ops = sao_ops
        n = stats.launches - n0
        times = [e.device_time for e in prof.events()
                 if e.device_type == DeviceType.CUDA and
                 "sao_stats_kernel" in e.name]
        cur["sao"] = cur.get("sao", 0.0) + t1 - t0
        cur["sao_kernel_ms"] = sum(times) / 1e3 if len(times) == n else None
        cur["sao_recorded"] = len(times)
        cur["sao_launches"] = n
        cur["sao_ref"] = SAO_REF_CALLS["cuda"] - p0
        cur["sao_params"] = params
        return params, outs

    enc._sao_decide_apply = run


def _sao_idr(enc, log: list, cur: dict, timed, **fields):
    """enc.encode_frame for an IDR with SAO (`IntraEncoder.encode_frame`:
    the flat device encoder, the SAO decision, the Python slice writer)
    wrapped to log the picture: the device phase (`_dispatch`,
    synchronised), the host phase (`_encode_slice`, hash SEI) and the SAO
    decision (`_sao_timer`)."""
    dispatch = enc._dispatch

    def dispatch_synced(y, u, v):
        out = dispatch(y, u, v)
        torch.cuda.synchronize()
        return out

    enc._dispatch = timed("device", dispatch_synced, sync=True)
    enc._encode_slice = timed("host", enc._encode_slice)
    orig = enc.encode_frame

    def idr(y, u, v, *a, **kw):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec = orig(y, u, v)
        log.append(dict(poc=0, kind="I", qp=enc.cfg.qp, refs=0, lists=0,
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        info=None, **fields, **_picture_fields(cur)))
        return nals, rec

    return idr


def _picture_fields(cur: dict) -> dict:
    """The per-picture timings, launches and SAO parameters of `cur`
    (without the stages' other results)."""
    return {k: cur[k] for k in (
        "device", "host", "launches", "rdoq", "sao", "sao_stats",
        "sao_kernel_ms", "sao_recorded", "sao_launches", "sao_ref",
        "sao_params")
        if k in cur}


def _sao_summary(log: list, launches: int) -> str:
    """A SAO run's launches and its mean per-picture split as words."""
    n = len(log)

    def mean_ms(key):
        return sum(e[key] for e in log) / n * 1e3

    kern = [e["sao_kernel_ms"] for e in log]
    return (f"sao_stats launches {launches} ({launches / n:g} a picture; "
            "the plain version 0 times on the card); mean per picture: "
            f"device phase {mean_ms('device'):.1f} ms, host phase "
            f"{mean_ms('host'):.1f} ms, SAO statistics: kernel "
            f"{kms(None if None in kern else sum(kern) / n)} (profiler), "
            f"{mean_ms('sao_stats'):.1f} ms on the host clock; SAO "
            "decision and apply "
            f"{mean_ms('sao') - mean_ms('sao_stats'):.1f} ms (the encode's "
            "time includes one profiler session a picture around the SAO "
            "decision)")


def _sao_line(e: dict) -> str:
    """One picture's SAO split as words, after checking its launches."""
    _check_sao_picture(e)
    seen = ("" if e["sao_kernel_ms"] is not None else
            f": it recorded {e['sao_recorded']} of the kernels")
    return (f"SAO statistics: kernel {kms(e['sao_kernel_ms'])} "
            f"(profiler{seen}), {e['sao_stats'] * 1e3:.1f} ms on the host "
            "clock "
            f"({e['sao_launches']} launches); SAO decision and apply "
            f"{(e['sao'] - e['sao_stats']) * 1e3:.1f} ms; "
            f"{_sao_counts(e['sao_params'])}")


def _check_sao_picture(e: dict) -> None:
    check(e["sao_launches"] == 3 and e["sao_ref"] == 0,
          f"POC {e['poc']}: {e['sao_launches']} sao_stats launches and "
          f"{e['sao_ref']} plain-version calls on the card (want 3 and 0)")


def _ra_instrument(enc):
    """Time each picture of an RA encode: the device phase (device work +
    copy back, synchronised), the host phase (CABAC serializer, hash SEI,
    TMVP store), with SAO the decision (`_sao_decide_qt`) and within it
    the statistics on the card (`inter_qt._sao_stats`, synchronised, which
    this patches until the returned restore() is called), and the SAD,
    SAO and RDOQ kernels' launches; keep each picture's maps and SAO
    parameters."""
    log, cur = [], {}

    def timed(name, fn, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            n0 = ss.sad_surface.launches
            s0 = sao_ops.sao_stats.launches
            r0 = rdoq_ops.rdoq_dev.launches
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if name == "sao_stats":
                torch.cuda.synchronize()
            cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
            if name != "sao_stats":     # counted in "sao" around it
                cur["launches"] = cur.get("launches", 0) + \
                    ss.sad_surface.launches - n0
                cur["sao_launches"] = cur.get("sao_launches", 0) + \
                    sao_ops.sao_stats.launches - s0
                cur["rdoq"] = cur.get("rdoq", 0) + \
                    rdoq_ops.rdoq_dev.launches - r0
            if name in ("device", "sao"):
                cur["qt" if name == "device" else "sao_params"] = out
            return out
        return run

    enc._device_phase = timed("device", enc._device_phase, sync=True)
    enc._sao_decide_qt = timed("sao", enc._sao_decide_qt, sync=True)
    for name in ("_serialize_qt_slice", "_hash_sei", "_store_motion"):
        setattr(enc, name, timed("host", getattr(enc, name)))
    stats_fn = inter_qt._sao_stats
    inter_qt._sao_stats = timed("sao_stats", stats_fn, sync=True)
    orig_b = enc._encode_b_frame

    def b_frame(frame, poc, refs, is_anchor):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec = orig_b(frame, poc, refs, is_anchor)
        log.append(dict(poc=poc, kind="P" if is_anchor else "B",
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        **cur))
        return nals, rec

    def idr(y, u, v, *a, **kw):
        qi = enc._qt_intra
        torch.cuda.synchronize()
        n0 = ss.sad_surface.launches
        r0 = rdoq_ops.rdoq_dev.launches
        t0 = time.perf_counter()
        st = {k: t.cpu() for k, t in qi._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        nals, rec = qi.serialize_frame(st)
        t2 = time.perf_counter()
        log.append(dict(poc=0, kind="I", device=t1 - t0, host=t2 - t1,
                        total=t2 - t0, nals=nals, rec=rec,
                        launches=ss.sad_surface.launches - n0,
                        rdoq=rdoq_ops.rdoq_dev.launches - r0,
                        depth8=st["depth8"].numpy()))
        return nals, rec

    def restore():
        inter_qt._sao_stats = stats_fn

    enc._encode_b_frame = b_frame
    enc.encode_frame = idr
    return log, restore


def _sao_counts(params) -> str:
    """OFF / BO / EO CTBs per plane of one picture's SAO parameters."""
    out = []
    for c, plane in enumerate(("Y", "Cb", "Cr")):
        types = [p3[c].type_idx for p3 in params]
        out.append(f"{plane} " + "/".join(
            str(types.count(t)) for t in (sao_ops.SAO_OFF, sao_ops.SAO_BO,
                                          sao_ops.SAO_EO)))
    return "SAO CTBs OFF/BO/EO " + ", ".join(out)


def sad_launches_per_search(me_method: str) -> int:
    """SAD-kernel launches of one integer search: the pyramid's pooled
    stage and two +-3 windows, or TZ's / the full search's one surface."""
    return 3 if me_method == "pyr" else 1


def phase_hevc_ra(sao: bool = False,
                  me_method: str = "pyr") -> tuple[int, int, int]:
    """Phase 7b-c (7f with sao, 9b with me_method="tz"): the RA GOP-8
    headline at 1920x1072 on the card, decoded by the port's
    GeneralDecoder.  Returns the SAD-, SAO- and RDOQ-kernel launches of
    the encode."""
    w, h = HEVC_W, HEVC_H
    tag = ("hevc-ra-sao" if sao else "hevc-ra") + \
        ("" if me_method == "pyr" else f"-{me_method}")
    k = sad_launches_per_search(me_method)
    search = "pyramid" if me_method == "pyr" else \
        "TZSearch (HM FastSearch 1)"
    frames = synth_clip(w, h, RA_PICTURES, seed=5)
    print(f"[{tag}] {w}x{h} QP{HEVC_QP} GOP-8 random access, "
          f"{RA_PICTURES} pictures (POC 0..{RA_PICTURES - 1}: IDR, anchor "
          f"P at 8, B at 4 2 1 3 6 5 7); SR{RA_SR} {search} ME, CU8 tree "
          "off, TMVP, full RDOQ in the B pictures, 1 reference per list; "
          "SAO " + ("on" if sao else "off"))
    enc = inter_qt.QtDeviceRandomAccessEncoder(
        ra_cfg(w, h, sao=sao), search_range=RA_SR, me_method=me_method,
        cu8=False, num_refs_active=1, device="cuda")
    log, restore = _ra_instrument(enc)
    ss.sad_surface.launches = 0
    sao_ops.sao_stats.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    try:
        stream, recons = enc.encode_sequence_ra(frames)
    finally:
        restore()
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    sao_launches = sao_ops.sao_stats.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on the card")
    want = 0
    for e in log:
        nbytes = sum(len(n) for n in e["nals"] if n)
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            d8 = e["depth8"][:h // 8, :w // 8]
            cus = "CUs 32/16/8 (intra) " + "/".join(
                str(int((d8 == d).sum()) // (16 >> (2 * d)))
                for d in (0, 1, 2))
            other = 0.0
        else:
            qt = e["qt"]
            m2 = np.zeros(qt["split8"].shape, bool)
            g = np.repeat(np.repeat(qt["merged32"], 2, 0), 2, 1)
            m2[:g.shape[0], :g.shape[1]] = g
            cus = (f"CU32 merged {int(qt['merged32'].sum())} (residual "
                   f"{int(qt['res32'].sum())}), CU16 "
                   f"{int((~m2 & ~qt['split8']).sum())}, CU8 "
                   f"{4 * int(qt['split8'].sum())}")
            other = (e["total"] - e["device"] - e["host"] -
                     e.get("sao", 0.0))
            want += k * (2 if e["kind"] == "B" else 1)
            check(e["launches"] == k * (2 if e["kind"] == "B" else 1),
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches "
                  f"(want {k} per list and reference)")
            check(e["sao_launches"] == (3 if sao else 0),
                  f"POC {e['poc']}: {e['sao_launches']} SAO-kernel "
                  f"launches (want {3 if sao else 0})")
        check(e["rdoq"] > 0, f"POC {e['poc']}: no RDOQ-kernel launch")
        if sao and e["kind"] != "I":
            cus += (f"; SAO {e['sao'] * 1e3:.1f} ms (statistics on the card "
                    f"{e['sao_stats'] * 1e3:.1f} ms, {e['sao_launches']} "
                    f"launches; offset search on the host "
                    f"{(e['sao'] - e['sao_stats']) * 1e3:.1f} ms); "
                    + _sao_counts(e["sao_params"]))
        print(f"[{tag}] POC {e['poc']} ({e['kind']}): device phase "
              f"{e['device'] * 1e3:.1f} ms, host phase {e['host'] * 1e3:.1f}"
              f" ms, other {other * 1e3:.1f} ms; {nbytes} bytes, "
              f"{nbytes * 8 * 30 / 1000:.1f} kbps at 30 fps, Y-PSNR "
              f"{p:.2f} dB; {cus}; SAD-kernel launches {e['launches']}, "
              f"RDOQ-kernel launches {e['rdoq']}")
    check(launches == want, f"{launches} SAD-kernel launches in the GOP, "
                            f"want {want}")
    check(sao_launches == (24 if sao else 0),
          f"{sao_launches} SAO-kernel launches in the GOP, want "
          f"{24 if sao else 0}")
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    sha = hashlib.sha1(stream).hexdigest()
    y_psnr = np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)])
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, mean "
          f"Y-PSNR {y_psnr:.3f} dB, encode {t_enc:.2f} s "
          f"({len(frames) / t_enc:.3f} fps); SAD-kernel launches {launches}"
          f", SAO-kernel launches {sao_launches}, RDOQ-kernel launches "
          f"{rdoq_launches} (the plain version 0 times); SHA-1 {sha}")
    ref_bytes, ref_sha = ((RA_SAO_BYTES, RA_SAO_SHA1) if sao
                          else (RA_TZ_BYTES, RA_TZ_SHA1)
                          if me_method == "tz" else (RA_BYTES, RA_SHA1))
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"RA stream {len(stream)} bytes SHA-1 {sha}, the JAX package's "
          f"is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's, byte for byte "
          "(SHA-1)")

    t0 = time.perf_counter()
    dec = hevc_decoder.GeneralDecoder()
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    print(f"[{tag}] the port's GeneralDecoder: hash SEI OK on all "
          f"{len(frames)} pictures, pictures equal the encoder's, "
          f"{t_dec:.2f} s")
    return launches, sao_launches, rdoq_launches


def phase_ra_cuda_vs_cpu() -> None:
    """Phase 7d: small RA GOPs on the card and on the CPU; the streams
    must be byte-equal."""
    runs = [("96x64, 9 pictures, headline settings", 96, 64, 9,
             dict(search_range=RA_SR, cu8=False), {}),
            ("96x64, 5 pictures, CU8 tree + 2 refs per list", 96, 64, 5,
             dict(search_range=16, cu8=True, num_refs_active=2),
             dict(temporal_mvp=False)),
            ("112x80, 9 pictures, SAO, CU8 tree, SR8 (partial edge CTBs)",
             112, 80, 9, dict(search_range=8, cu8=True),
             dict(sao=True, temporal_mvp=False))]
    for what, w, h, n, kw, cfg_kw in runs:
        frames = synth_clip(w, h, n, seed=17)
        res = {}
        routes = {}
        for dev in ("cuda", "cpu"):
            enc = inter_qt.QtDeviceRandomAccessEncoder(
                ra_cfg(w, h, **cfg_kw), device=dev, **kw)
            s0 = sao_ops.sao_stats.launches
            t0 = time.perf_counter()
            stream, *routes[dev] = rdoq_routes(
                lambda: enc.encode_sequence_ra(frames)[0])
            res[dev] = (stream, time.perf_counter() - t0,
                        sao_ops.sao_stats.launches - s0)
        (g, tg, gl), (c, tc, cl) = res["cuda"], res["cpu"]
        routed = check_rdoq_routes(f"RA {what}", routes["cuda"],
                                   routes["cpu"])
        want = 3 * (n - 1) if cfg_kw.get("sao") else 0
        check((gl, cl) == (want, 0),
              f"RA {what}: SAO-kernel launches {gl} on the card, {cl} on "
              f"the CPU (want {want}, 0)")
        check(g == c, f"RA {what}: card and CPU streams differ "
                      f"({len(g)} / {len(c)} bytes)")
        dec = hevc_decoder.GeneralDecoder()
        dec.decode(g)
        check(dec.hash_status == [True] * n, f"RA {what}: hash mismatch")
        print(f"[ra-cuda-vs-cpu] {what}: streams byte-equal ({len(g)} "
              f"bytes), hash OK; {routed}; cuda {tg:.2f} s, cpu "
              f"{tc:.2f} s")


def ldp_cfg(w: int, h: int):
    """bench_ldp_480's settings (bench.py:171-186): QP 32, 4 references,
    merge 5, TMVP, SBH, CTB 16, deblocking and the MD5 hash SEI on (the
    HevcConfig defaults)."""
    return hevc_headers.HevcConfig(width=w, height=h, qp=32, num_refs=4,
                                   merge_cands=5, temporal_mvp=True,
                                   sign_data_hiding=True)


def phase_ldp_kernel() -> dict:
    """Phase 8a: the kernel against its plain version at the LD-P
    pyramid's shapes, timed beside its bound; the totals are per P
    picture with all 4 references (4 x (pooled stage + 2 windows))."""
    rng = np.random.default_rng(2026)
    pic = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    max_err = 0
    for i, (n, b, r) in enumerate(ra_sad_shapes(LDP_W, LDP_H, LDP_SR)[:2]):
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        max_err = max(max_err, err)
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        tm = sad_times(cur, win, n, r)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        print(f"[ldp-sad] n={n} B={b} r={r}: equal; kernel {kms(ms)} "
              f"(profiler{', ' + tm['note'] if tm['note'] else ''}), "
              f"{tm['event_ms']:.4f} ms a wrapper call (CUDA events); "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} G ops), {of_bound(bound, ms)}; plain "
              f"{plain:.3f} ms; torch.cdist {lib:.3f} ms (max abs err "
              f"{lib_err:g})")
        k = 4 * (1 if i == 0 else 2)     # per P picture: 4 references
        add_kernel_ms(pic, k, ms, tm["note"], f"n={n} r={r}")
        pic["plain_ms"] += k * plain
        pic["library_ms"] += k * lib
        pic["bytes"] += k * nbytes
        pic["ops"] += k * ops
    pic["bound_ms"] = max(pic["bytes"] / PEAK_BYTES,
                          pic["ops"] / PEAK_OPS) * 1e3
    pic["bound_by"] = ("operations" if pic["ops"] / PEAK_OPS >=
                       pic["bytes"] / PEAK_BYTES else "bytes")
    print(f"[ldp-sad] per 832x480 P picture at 4 references (12 launches): "
          f"kernel {kms(pic['ms'])}, bound {pic['bound_ms']:.4f} ms "
          f"({pic['bound_by']}), {of_bound(pic['bound_ms'], pic['ms'])}; "
          f"plain {pic['plain_ms']:.3f} ms; torch.cdist "
          f"{pic['library_ms']:.3f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    pic["max_abs_err"] = max_err
    return pic


def _timer(cur: dict):
    """timed(name, fn, sync): fn wrapped to add its host-clock seconds to
    cur[name] (after a synchronise when sync), its SAD- and RDOQ-kernel
    launches to cur["launches"] and cur["rdoq"], and to keep its result
    as cur[fn.__name__]."""
    def timed(name, fn, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            n0 = ss.sad_surface.launches
            r0 = rdoq_ops.rdoq_dev.launches
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
            cur["launches"] = cur.get("launches", 0) + \
                ss.sad_surface.launches - n0
            cur["rdoq"] = cur.get("rdoq", 0) + \
                rdoq_ops.rdoq_dev.launches - r0
            cur[fn.__name__] = out
            return out
        return run
    return timed


def _ldp_instrument(enc, sao: bool = False):
    """Time each picture of an LD-P encode: the device phase (upload,
    device work, copy back, synchronised), the host phase (`_reconcile`,
    CABAC slice, hash SEI), with SAO the decision (`_sao_timer`), and the
    SAD- and RDOQ-kernel launches; keep each picture's block decisions."""
    log, cur = [], {}
    timed = _timer(cur)

    enc._device_phase = timed("device", enc._device_phase, sync=True)
    for name in ("_reconcile", "_encode_p_slice", "_hash_sei"):
        setattr(enc, name, timed("host", getattr(enc, name)))
    orig_p = enc.encode_p_frame

    def p_frame(y, u, v, dpb, poc):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec, mf = orig_p(y, u, v, dpb, poc)
        log.append(dict(poc=poc, kind="P", qp=enc.cfg.qp,
                        refs=min(len(dpb), enc.cfg.num_refs),
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        info=cur["_reconcile"], **_picture_fields(cur)))
        return nals, rec, mf

    def idr(y, u, v, *a, **kw):
        torch.cuda.synchronize()
        n0 = ss.sad_surface.launches
        r0 = rdoq_ops.rdoq_dev.launches
        t0 = time.perf_counter()
        st = {k: t.cpu() for k, t in enc._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        nals, rec = enc.serialize_frame(st)
        t2 = time.perf_counter()
        log.append(dict(poc=0, kind="I", qp=enc.cfg.qp, refs=0,
                        device=t1 - t0, host=t2 - t1, total=t2 - t0,
                        nals=nals, rec=rec,
                        launches=ss.sad_surface.launches - n0,
                        rdoq=rdoq_ops.rdoq_dev.launches - r0))
        return nals, rec

    enc.encode_p_frame = p_frame
    if sao:
        _sao_timer(enc, cur)
        enc.encode_frame = _sao_idr(enc, log, cur, timed)
    else:
        enc.encode_frame = idr
    return log


def _ldp_expected(me_method: str, rc: bool,
                  variant: str = "") -> tuple[int, str, str]:
    """(bytes, SHA-1, what) of the JAX package's stream for an LD-P run."""
    if variant == "sao":
        return LDP_SAO_BYTES, LDP_SAO_SHA1, "the spec AMVP list"
    if variant == "conf":
        return LDP_CONF_BYTES, LDP_CONF_SHA1, "the spec AMVP list"
    if rc:
        return (LDP_RC_BYTES, LDP_RC_SHA1,
                "the spec AMVP list and the same controller")
    if me_method == "tz":
        return LDP_TZ_BYTES, LDP_TZ_SHA1, "the spec AMVP list"
    return LDP_BYTES, LDP_SHA1, "the spec AMVP list"


def ldp_variant_cfg(w: int, h: int, variant: str):
    """ldp_cfg with `variant`'s options: "sao" HM's LD-P main tool set
    (SAO on); "conf" a conferencing sender's HRD timing SEI and long-term
    IDR reference, without TMVP (the long-term mode's terms)."""
    cfg = ldp_cfg(w, h)
    if variant == "sao":
        cfg.sao = True
    elif variant == "conf":
        cfg.timing_sei = True
        cfg.long_term_idr = True
        cfg.temporal_mvp = False
    return cfg


def _check_conf_sei(stream: bytes, n: int) -> str:
    """The conferencing stream's prefix SEI read back with the port's
    parser: one buffering period on the first AU, picture timing on every
    AU with au_cpb_removal_delay_minus1 advancing."""
    aus = [sei_mod.parse_sei_rbsp(hevc_bs.strip_emulation_prevention(
        nal[2:])) for nal in hevc_bs.split_annexb(stream)
        if (nal[0] >> 1) & 0x3F == hevc_bs.NAL_PREFIX_SEI]
    check(len(aus) == n, f"{len(aus)} prefix SEI NAL units, want {n}")
    delays = []
    for k, au in enumerate(aus):
        bp = [m for m in au if isinstance(m, sei_mod.BufferingPeriod)]
        pt = [m for m in au if isinstance(m, sei_mod.PictureTiming)]
        check(len(bp) == (1 if k == 0 else 0) and len(pt) == 1,
              f"AU {k}: {len(bp)} buffering periods and {len(pt)} picture "
              "timings")
        delays.append(pt[0].au_cpb_removal_delay_minus1)
    check(delays == [0] + list(range(n - 1)),
          f"au_cpb_removal_delay_minus1 {delays}")
    bp0 = aus[0][0]
    return (f"prefix SEI read back: buffering period on AU 0 "
            f"(initial_cpb_removal_delay {bp0.initial_cpb_removal_delay}), "
            f"picture timing on all {n} AUs, au_cpb_removal_delay_minus1 "
            f"{delays}")


def phase_hevc_ldp(me_method: str = "pyr", rc: bool = False,
                   variant: str = ""):
    """Phase 8b-c (9a with me_method="tz", 9c with rc): bench_ldp_480 on
    the card, decoded by the port's GeneralDecoder and held to the JAX
    package's stream.  With rc a `RateLambdaControl` at RC_BPS sets each
    picture's QP instead of HM's LD-P ladder; `variant` "sao" and "conf"
    are phases hevc-ldp-sao and hevc-ldp-conf (`ldp_variant_cfg`).
    Returns the SAD-kernel launches of the encode, the per-picture log,
    the RDOQ-kernel launches and the sao_stats launches."""
    w, h = LDP_W, LDP_H
    tag = "hevc-ldp" + ("" if me_method == "pyr" else f"-{me_method}") + \
        ("-rc" if rc else "") + (f"-{variant}" if variant else "")
    sao = variant == "sao"
    k = sad_launches_per_search(me_method)
    frames = bench_synth_clip(w, h, LDP_PICTURES)
    search = "pyramid" if me_method == "pyr" else \
        "TZSearch (HM FastSearch 1)"
    qps = (f"RateLambdaControl at {RC_BPS / 1e6:g} Mb/s (base QP 32)" if rc
           else "QP 32 with HM's LD-P ladder")
    tools = {"": "4 references, merge 5, TMVP",
             "sao": "4 references, merge 5, TMVP, SAO (luma CTB 16, chroma "
                    "CTB 8)",
             "conf": "one long-term reference (the IDR), merge 5, no TMVP, "
                     "buffering-period and picture-timing SEI"}[variant]
    print(f"[{tag}] {w}x{h} low-delay P, {LDP_PICTURES} pictures of "
          f"bench.py's clip (seed 42): IDR + 8 P, {qps}, {tools}, SBH, "
          f"SR{LDP_SR} {search} ME, full RDOQ in the P pictures; card "
          f"{CARD}")
    enc = hevc_inter_dev.DeviceLowDelayEncoder(
        ldp_variant_cfg(w, h, variant), search_range=LDP_SR,
        me_method=me_method, device="cuda")
    controller = ratectrl.RateLambdaControl(RC_BPS, 30.0, w, h,
                                            base_qp=32) if rc else None
    log = _ldp_instrument(enc, sao=sao)
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    sao_ops.sao_stats.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    SAO_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence_ldp(frames, controller)
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    sao_launches = sao_ops.sao_stats.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on the card")
    check(SAO_REF_CALLS["cuda"] == 0,
          f"the plain SAO statistics ran {SAO_REF_CALLS['cuda']} times on "
          "the card")
    want = 0
    for e in log:
        nbytes = sum(len(n) for n in e["nals"] if n)
        e["bytes"] = nbytes
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            blocks = f"{(w // 16) * (h // 16)} intra (IDR)"
        else:
            cnt = dict(intra=0, skip=0, merge=0, amvp=0)
            for row in e["info"]:
                for b in row:
                    cnt["intra" if b.pred_mode == 1 else "skip" if b.skip
                        else "merge" if b.merge else "amvp"] += 1
            blocks = " / ".join(f"{k_} {v}" for k_, v in cnt.items())
            want += k * e["refs"]
            check(e["rdoq"] > 0, f"POC {e['poc']}: no RDOQ-kernel launch")
            check(e["launches"] == k * e["refs"],
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches "
                  f"(want {k} per reference, {e['refs']} references)")
        other = e["total"] - e["device"] - e["host"] - e.get("sao", 0.0)
        sao_words = "; " + _sao_line(e) if sao else ""
        print(f"[{tag}] POC {e['poc']} ({e['kind']}, QP {e['qp']}, "
              f"{e['refs']} refs): device phase {e['device'] * 1e3:.1f} ms,"
              f" host phase {e['host'] * 1e3:.1f} ms, other "
              f"{other * 1e3:.1f} ms; {nbytes} bytes ({nbytes * 8} bits), "
              f"Y-PSNR {p:.2f} dB; blocks {blocks}; SAD-kernel launches "
              f"{e['launches']}, RDOQ-kernel launches {e['rdoq']}"
              f"{sao_words}")
    n_refs = 8 if variant == "conf" else 26
    check(launches == want == k * n_refs,
          f"{launches} SAD-kernel launches in the run, want {want} = "
          f"{k * n_refs}")
    check(sao_launches == (3 * len(frames) if sao else 0),
          f"{sao_launches} sao_stats launches in the run")
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    sha = hashlib.sha1(stream).hexdigest()
    n = len(frames)
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, "
          f"encode {t_enc:.2f} s ({n / t_enc:.3f} fps); "
          f"SAD-kernel launches {launches}, RDOQ-kernel launches "
          f"{rdoq_launches} (the plain version 0 times); SHA-1 {sha}")
    if sao:
        print(f"[{tag}] {_sao_summary(log, sao_launches)}")
    if rc:
        check(enc.frame_qps == LDP_RC_QPS,
              f"rate-controlled QPs {enc.frame_qps}, the JAX package's "
              f"are {LDP_RC_QPS}")
        print(f"[{tag}] QPs {enc.frame_qps} (the JAX package's); "
              f"{kbps:.1f} kbps achieved against the {RC_BPS / 1e3:.0f} "
              f"kbps target ({kbps / (RC_BPS / 1e3):.2f}x); the IDR "
              f"{log[0]['bytes'] * 8} bits against "
              f"{RC_BPS / 30:.0f} bits a picture")
    if variant == "conf":
        print(f"[{tag}] {_check_conf_sei(stream, n)}")

    t0 = time.perf_counter()
    dec = hevc_decoder.GeneralDecoder()
    lt_refs = []
    if variant == "conf":
        lt_pocs = dec._lt_pocs

        def lt_counted(hdr):
            out = lt_pocs(hdr)
            lt_refs.append(out)
            return out

        dec._lt_pocs = lt_counted
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    lt_words = ""
    if variant == "conf":
        check(lt_refs == [[0]] * (n - 1),
              f"long-term references resolved {lt_refs}, want POC 0 in "
              "every P picture")
        lt_words = ", every P picture's long-term reference POC 0"
    print(f"[{tag}] the port's GeneralDecoder: hash SEI OK on all "
          f"{len(frames)} pictures, pictures equal the encoder's"
          f"{lt_words}, {t_dec:.2f} s")
    ref_bytes, ref_sha, what = _ldp_expected(me_method, rc, variant)
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"LD-P stream {len(stream)} bytes SHA-1 {sha}, the JAX "
          f"package's ({what}) is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's with {what}, byte for "
          "byte (SHA-1)")
    return launches, log, rdoq_launches, sao_launches


def phase_ldp_rc_resume(one_run: list) -> int:
    """Phase 9d: the rate-controlled run stopped after picture
    RC_RESUME_AT - 1, its state written with `checkpoint.save` and read
    back with `checkpoint.load`, and pictures RC_RESUME_AT.. encoded from
    it by a new encoder and a new controller.  The resumed NALs must be
    the JAX package's resumed run's; whether they also equal those
    pictures of the one run is printed (the state keeps only the newest
    picture, so the resumed run starts with one reference and the
    reference promises no such equality).  Returns the SAD- and
    RDOQ-kernel launches of both encodes."""
    w, h = LDP_W, LDP_H
    frames = bench_synth_clip(w, h, LDP_PICTURES)
    path = BUILD_DIR / "ldp_rc_state.npz"
    path.parent.mkdir(parents=True, exist_ok=True)

    def encoder():
        return (hevc_inter_dev.DeviceLowDelayEncoder(
                    ldp_cfg(w, h), search_range=LDP_SR, device="cuda"),
                ratectrl.RateLambdaControl(RC_BPS, 30.0, w, h, base_qp=32))

    enc, rc = encoder()
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    _, _, state = enc.encode_frames(frames[:RC_RESUME_AT], None, rc)
    checkpoint.save(state, str(path))
    t1 = time.perf_counter()
    enc, rc = encoder()
    loaded = checkpoint.load(str(path))
    check(loaded.poc == RC_RESUME_AT and loaded.rc == state.rc and all(
        np.array_equal(a, b) for a, b in zip(loaded.ref, state.ref)),
        "checkpoint.load did not give back the saved state")
    nals, recons, _ = enc.encode_frames(frames[RC_RESUME_AT:], loaded, rc)
    t2 = time.perf_counter()
    launches = ss.sad_surface.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    check(rdoq_launches > 0 and RDOQ_REF_CALLS["cuda"] == 0,
          f"the resumed encodes: {rdoq_launches} RDOQ-kernel launches, the "
          f"plain version {RDOQ_REF_CALLS['cuda']} times on the card")
    n_first = sum(min(p, 4) for p in range(RC_RESUME_AT))
    n_second = sum(min(p + 1, 4) for p in range(LDP_PICTURES - RC_RESUME_AT))
    want = 3 * (n_first + n_second)
    check(launches == want, f"{launches} SAD-kernel launches in the two "
                            f"resumed encodes, want {want}")
    resumed = hevc_bs.annexb(nals)
    sha = hashlib.sha1(resumed).hexdigest()
    same = [e["nals"] for e in one_run[RC_RESUME_AT:]] == [
        nals[2 * i:2 * i + 2] for i in range(LDP_PICTURES - RC_RESUME_AT)]
    print(f"[hevc-ldp-rc] resume: pictures 0-{RC_RESUME_AT - 1} encoded "
          f"({t1 - t0:.2f} s), the state (POC {loaded.poc}, the newest "
          f"picture's planes, {len(loaded.rc) - 1} controller values) "
          f"written with checkpoint.save ({path.stat().st_size} bytes) and "
          f"read back; pictures {RC_RESUME_AT}-{LDP_PICTURES - 1} encoded "
          f"from it by a new encoder and controller ({t2 - t1:.2f} s): QPs "
          f"{enc.frame_qps}, {len(resumed)} bytes, SHA-1 {sha}; "
          f"SAD-kernel launches {launches}, RDOQ-kernel launches "
          f"{rdoq_launches}")
    check(enc.frame_qps == LDP_RC_QPS[RC_RESUME_AT:],
          f"resumed QPs {enc.frame_qps}, want {LDP_RC_QPS[RC_RESUME_AT:]}")
    for i, r in enumerate(recons):
        p = psnr(frames[RC_RESUME_AT + i][0], r[0])
        check(np.isfinite(p) and p > 20, f"implausible Y-PSNR {p}")
    check((len(resumed), sha) == (RC_RESUMED_BYTES, RC_RESUMED_SHA1),
          f"resumed NALs {len(resumed)} bytes SHA-1 {sha}, the JAX "
          f"package's are {RC_RESUMED_BYTES} bytes {RC_RESUMED_SHA1}")
    print(f"[hevc-ldp-rc] the resumed NALs are the JAX package's resumed "
          f"run's, byte for byte (SHA-1); equal to pictures "
          f"{RC_RESUME_AT}-{LDP_PICTURES - 1} of the one run: {same}")
    return launches, rdoq_launches


def phase_ldp_cuda_vs_cpu() -> None:
    """Phase 8d: a 96x64 LD-P run at 4 references on the card and on
    the CPU, with intra blocks in its P pictures: byte-equal streams."""
    w, h, n = 96, 64, 5
    frames = cut_clip(w, h, n)
    res, routes = {}, {}
    for dev in ("cuda", "cpu"):
        enc = hevc_inter_dev.DeviceLowDelayEncoder(
            ldp_cfg(w, h), search_range=LDP_SR, device=dev)
        modes = []
        phase = enc._device_phase

        def keep(*a, **kw):
            st = phase(*a, **kw)
            modes.append(st["pred_mode"])
            return st

        enc._device_phase = keep
        t0 = time.perf_counter()
        stream, *routes[dev] = rdoq_routes(
            lambda: enc.encode_sequence_ldp(frames)[0])
        res[dev] = (stream, time.perf_counter() - t0, modes)
    (g, tg, gm), (c, tc, cm) = res["cuda"], res["cpu"]
    routed = check_rdoq_routes("LD-P 96x64", routes["cuda"], routes["cpu"])
    intra = [int((m == 1).sum()) for m in gm]
    check(all(np.array_equal(a, b) for a, b in zip(gm, cm)),
          "LD-P 96x64: card and CPU block modes differ")
    check(sum(intra) > 0, "LD-P 96x64: no intra block in the P pictures")
    check(g == c, f"LD-P 96x64: card and CPU streams differ ({len(g)} / "
                  f"{len(c)} bytes)")
    dec = hevc_decoder.GeneralDecoder()
    dec.decode(g)
    check(dec.hash_status == [True] * n, "LD-P 96x64: hash mismatch")
    print(f"[ldp-cuda-vs-cpu] 96x64, 5 pictures, 4 references, scene cut "
          f"at 3: intra blocks per P picture {intra} (through the "
          f"wavefront on the card); streams byte-equal ({len(g)} bytes), "
          f"hash OK; {routed}; cuda {tg:.2f} s, cpu {tc:.2f} s")


def phase_sad_r64() -> list:
    """Phase 9 (first): the kernel against its plain version at the
    search range 64 surfaces that TZ and the full search take, exactly,
    timed beside its bound, the plain version and `torch.cdist`: the
    LD-P picture's blocks (n=16, B=1,560, one launch per reference), the
    1080p picture's (n=16, B=8,040, one per list and reference) and the
    1080p CU8 tree's (n=8, B=32,160).  Returns one row per shape."""
    rng = np.random.default_rng(2028)
    rows = []
    for what, n, b in (("LD-P 832x480", 16, LDP_W * LDP_H // 256),
                       ("RA 1920x1072", 16, HEVC_W * HEVC_H // 256),
                       ("RA 1920x1072 CU8", 8, HEVC_W * HEVC_H // 64)):
        r = 64
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        want = ss.sad_surface_ref(cur, win, n, r)
        err = int((got - want).abs().max())
        check(err == 0, f"kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        del got
        lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
        del want
        tm = sad_times(cur, win, n, r, reps=11)
        ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
        bound, nbytes, ops = sad_bound(n, b, r)
        by = "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES \
            else "bytes"
        gdiff = ops / 2e9
        rate = "" if ms is None else (f", {gdiff / ms * 1e3:.0f} G/s; "
                                      f"{ms / bound:.2f}x the bound")
        print(f"[sad-kernel-r64] {what}: n={n} B={b} r={r}: equal (max abs "
              f"err 0); kernel {kms(ms)} (profiler"
              f"{', ' + tm['note'] if tm['note'] else ''}; {gdiff:.2f} G "
              f"abs-diffs{rate}), {tm['event_ms']:.4f} ms a wrapper call "
              f"(CUDA events); bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} G ops, {by}), {of_bound(bound, ms)}; plain "
              f"{plain:.3f} ms; torch.cdist {lib:.3f} ms (max abs err "
              f"{lib_err:g})")
        rows.append(dict(what=what, n=n, b=b, r=r, ms=ms,
                         event_ms=tm["event_ms"], plain_ms=plain,
                         library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err, note=tm["note"] or None))
        del cur, win
        torch.cuda.empty_cache()
    return rows


def _host_instrument(enc, sao: bool):
    """Time each picture of the host LD-P coder by stage: pass 1 (the
    motion searches and the intra sweep on the card, copies back
    included: `_p_pass1`, for the IDR `decide_modes`), the raster
    decision and reconstruction (`_p_raster`; the IDR's CTB loop), the
    deblock (`_p_deblock`; inside the IDR's CTB loop), with SAO the
    decision and apply (`_sao_timer`), and CABAC with the hash SEI; count
    each picture's SAD- and RDOQ-kernel launches and keep its block
    decisions.  A host B coder (`bframe_codec.HierarchicalBEncoder`) is
    timed the same way per anchor P and B picture: `_p_pass1`,
    `_b_raster`, `_p_deblock`, `_encode_b_slice` with the SEI."""
    log, cur = [], {}
    timed = _timer(cur)
    enc._p_pass1 = timed("pass1", enc._p_pass1, sync=True)
    enc.decide_modes = timed("modes", enc.decide_modes, sync=True)
    enc._p_raster = timed("raster", enc._p_raster)
    enc._encode_frame_host = timed("raster", enc._encode_frame_host)
    enc._p_deblock = timed("deblock", enc._p_deblock)
    for name in ("_encode_p_slice", "_encode_slice", "_hash_sei"):
        setattr(enc, name, timed("cabac", getattr(enc, name)))
    if sao:
        _sao_timer(enc, cur)
    orig_p, orig_i = enc.encode_p_frame, enc.encode_frame

    def p_frame(y, u, v, dpb, poc):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec, mf = orig_p(y, u, v, dpb, poc)
        log.append(dict(poc=poc, kind="P", qp=enc.cfg.qp,
                        refs=min(len(dpb), enc.cfg.num_refs),
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        info=cur["_p_raster"][0], **cur))
        return nals, rec, mf

    def idr(y, u, v, *a, **kw):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec = orig_i(y, u, v, *a, **kw)
        cur["raster"] -= cur["modes"]        # the CTB loop calls the sweep
        cur["pass1"] = cur.pop("modes")
        log.append(dict(poc=0, kind="I", qp=enc.cfg.qp, refs=0,
                        total=time.perf_counter() - t0, nals=nals, rec=rec,
                        info=None, **cur))
        return nals, rec

    enc.encode_p_frame, enc.encode_frame = p_frame, idr
    if isinstance(enc, hevc_bc.HierarchicalBEncoder):
        enc._b_raster = timed("raster", enc._b_raster)
        enc._encode_b_slice = timed("cabac", enc._encode_b_slice)
        orig_b = enc._encode_b_frame

        def b_frame(frame, poc, refs, is_anchor):
            cur.clear()
            t0 = time.perf_counter()
            nals, rec = orig_b(frame, poc, refs, is_anchor)
            log.append(dict(poc=poc, kind="P" if is_anchor else "B",
                            qp=enc.cfg.qp, refs=len(refs),
                            total=time.perf_counter() - t0, nals=nals,
                            rec=rec, info=cur["_b_raster"][0], **cur))
            return nals, rec

        enc._encode_b_frame = b_frame
    return log


def _host_blocks(info) -> dict:
    cnt = dict(intra=0, merge=0, skip=0, amvp=0)
    for row in info:
        for b in row:
            cnt["intra" if b.pred_mode == hevc_pc.MODE_INTRA else "skip"
                if b.skip else "merge" if b.merge else "amvp"] += 1
    return cnt


def _wp_tables(stream: bytes) -> list:
    """The pred_weight_table of every P slice, read back with the port's
    parser: [(luma w, o), (Cb w, o), (Cr w, o)] per picture."""
    sps = pps = None
    out = []
    for nal in hevc_bs.split_annexb(stream):
        t = (nal[0] >> 1) & 0x3F
        rbsp = hevc_bs.strip_emulation_prevention(nal[2:])
        if t == hevc_bs.NAL_SPS:
            sps = hevc_headers.parse_sps(rbsp)
        elif t == hevc_bs.NAL_PPS:
            pps = hevc_headers.parse_pps(rbsp)
        elif t == hevc_pc.NAL_TRAIL_R:
            wp = hevc_pc.parse_p_slice_header(
                rbsp, pps, sps_tmvp=sps.temporal_mvp, sps_sao=sps.sao,
                sps_lt=sps.long_term_idr).wp
            out.append(tuple(zip(wp["w"], wp["o"])))
    return out


def phase_hevc_ldp_host(variant: str = "") -> tuple:
    """Phases hevc-ldp-host / -wp / -dqp: the reference's host LD-P coder
    (`inter_codec.LowDelayEncoder`, what its encoder CLI builds for HM's
    encoder_lowdelay_P_main.cfg) on `host_ldp_cfg(variant)`, TZSearch at
    search range 64, on bench_synth_clip's clip: per picture the stage
    times, bytes, Y-PSNR, block kinds and kernel launches; both port
    decoders must give every hash OK and the encoder's pictures, no
    `rdoq_dev` may launch (the host coder quantizes with the float64 host
    RDOQ), and the stream must be the JAX package's with the spec AMVP
    list.  "wp" codes the faded clip with weighted prediction (and again
    without, for the size), "dqp" signals cu_qp_delta under a
    CtuRateControl and a RateLambdaControl.  Returns the SAD- and
    sao_stats launches of the encode, the SAD launches of the encode
    without WP (0 but for "wp") and the stream."""
    w, h = LDP_W, LDP_H
    n = {"": HOST_PICTURES, "wp": WP_PICTURES, "dqp": DQP_PICTURES}[variant]
    tag = "hevc-ldp-host" if not variant else f"hevc-ldp-{variant}"
    frames = bench_synth_clip(w, h, n)
    if variant == "wp":
        frames = fade_clip(frames)
    cfg = host_ldp_cfg(variant)
    sao = cfg.sao
    what = {"": "HM's encoder_lowdelay_P_main.cfg as the reference's CLI "
                "builds it: QP 32, 4 references, merge 5, TMVP, SBH, SAO, "
                "full RDOQ (the host float64 rdoq_np in the IDR)",
            "wp": "the same settings with explicit weighted prediction, 1 "
                  "reference, SAO off, on the clip faded by 1 - 0.12 i",
            "dqp": "the same settings with cu_qp_delta under a "
                   f"CtuRateControl and a RateLambdaControl at "
                   f"{RC_BPS / 1e6:g} Mb/s, SAO off"}[variant]
    print(f"[{tag}] {w}x{h} low-delay P on the host coder "
          f"(inter_codec.LowDelayEncoder), {n} pictures of bench.py's clip "
          f"(seed 42): {what}; SR{HOST_SR} TZSearch; card {CARD}")
    enc = hevc_pc.LowDelayEncoder(cfg, search_range=HOST_SR,
                                  me_method=HOST_ME, device="cuda")
    controller = None
    if variant == "dqp":
        enc.ctu_rc = ratectrl.CtuRateControl()
        controller = ratectrl.RateLambdaControl(RC_BPS, 30.0, w, h,
                                                base_qp=32)
    log = _host_instrument(enc, sao)
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    sao_ops.sao_stats.launches = 0
    RDOQ_REF_CALLS["cuda"] = RDOQ_REF_CALLS["cpu"] = 0
    SAO_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence_ldp(frames, controller)
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    sao_launches = sao_ops.sao_stats.launches
    check(rdoq_ops.rdoq_dev.launches == 0 and
          RDOQ_REF_CALLS["cuda"] + RDOQ_REF_CALLS["cpu"] == 0,
          f"rdoq_dev ran in the host coder ({rdoq_ops.rdoq_dev.launches} "
          "launches)")
    check(SAO_REF_CALLS["cuda"] == 0,
          f"the plain SAO statistics ran {SAO_REF_CALLS['cuda']} times on "
          "the card")
    want = 0
    for e in log:
        nbytes = sum(len(x) for x in e["nals"] if x)
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            blocks = f"{(w // 16) * (h // 16)} intra (IDR)"
            dbk = "in the CTB loop"
        else:
            cnt = _host_blocks(e["info"])
            blocks = " / ".join(f"{k_} {v}" for k_, v in cnt.items())
            dbk = f"{e.get('deblock', 0.0) * 1e3:.1f} ms"
            want += e["refs"]
            check(e["launches"] == e["refs"],
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches, "
                  f"want 1 per reference ({e['refs']})")
        sao_words = "; " + _sao_line(e) if sao else ""
        qp_words = ""
        if variant == "dqp" and e["info"] is not None:
            qs = [b.qp for row in e["info"] for b in row]
            qp_words = f", CU QPs {min(qs)}..{max(qs)}"
        print(f"[{tag}] POC {e['poc']} ({e['kind']}, slice QP {e['qp']}"
              f"{qp_words}, {e['refs']} refs): pass 1 "
              f"{e['pass1'] * 1e3:.1f} ms, raster decision and recon "
              f"{e['raster'] * 1e3:.1f} ms, deblock {dbk}{sao_words}, "
              f"CABAC + SEI {e['cabac'] * 1e3:.1f} ms (total "
              f"{e['total'] * 1e3:.1f} ms); {nbytes} bytes, Y-PSNR "
              f"{p:.2f} dB; blocks {blocks}; SAD-kernel launches "
              f"{e['launches']}")
    check(launches == want, f"{launches} SAD-kernel launches, want {want}")
    check(sao_launches == (3 * n if sao else 0),
          f"{sao_launches} sao_stats launches")
    kbps = len(stream) * 8 * 30 / n / 1000
    sha = hashlib.sha1(stream).hexdigest()
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, mean "
          f"Y-PSNR {np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)]):.3f}"
          f" dB, encode {t_enc:.2f} s ({n / t_enc:.3f} fps); SAD-kernel "
          f"launches {launches}, sao_stats launches {sao_launches}, "
          f"rdoq_dev launches 0; QPs {enc.frame_qps}; SHA-1 {sha}")
    off_launches = 0
    if variant == "wp":
        tabs = _wp_tables(stream)
        for k_, t in enumerate(tabs):
            print(f"[{tag}] POC {k_ + 1} pred_weight_table (w, o) Y {t[0]} "
                  f"Cb {t[1]} Cr {t[2]} (log2 denominators 6)")
        check(len(tabs) == n - 1 and all(t[0][0] != 64 for t in tabs),
              f"weights {tabs}")
        off = host_ldp_cfg("wp")
        off.weighted_pred = False
        ss.sad_surface.launches = 0
        ref_s, _ = hevc_pc.LowDelayEncoder(
            off, search_range=HOST_SR, me_method=HOST_ME,
            device="cuda").encode_sequence_ldp(frames)
        off_launches = ss.sad_surface.launches
        check(off_launches == n - 1,
              f"{off_launches} SAD-kernel launches without WP, want {n - 1}")
        print(f"[{tag}] with WP {len(stream)} bytes, the same pictures "
              f"without WP {len(ref_s)} bytes ({len(stream) / len(ref_s):.3f}x; "
              f"that encode's SAD-kernel launches {off_launches})")
    for cls in (hevc_decoder.GeneralDecoder, hevc_pc.LowDelayDecoder):
        t0 = time.perf_counter()
        dec = cls()
        out = dec.decode(stream)
        t_dec = time.perf_counter() - t0
        check(dec.hash_status == [True] * n,
              f"{cls.__name__}: picture hash SEI {dec.hash_status}")
        check(len(out) == n, f"{cls.__name__}: {len(out)} pictures")
        for i, (r, o) in enumerate(zip(recons, out)):
            for c in range(3):
                check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                      f"{cls.__name__}: picture {i} plane {c} != the "
                      "encoder's")
        print(f"[{tag}] the port's {cls.__name__}: hash SEI OK on all {n} "
              f"pictures, pictures equal the encoder's, {t_dec:.2f} s")
    ref_bytes, ref_sha, ref_qps = {
        "": (HOST_BYTES, HOST_SHA1, [32] * HOST_PICTURES),
        "wp": (WP_BYTES, WP_SHA1, [32] * WP_PICTURES),
        "dqp": (DQP_BYTES, DQP_SHA1, DQP_QPS)}[variant]
    check(enc.frame_qps == ref_qps,
          f"QPs {enc.frame_qps}, the JAX package's are {ref_qps}")
    opt = {"": "--ldp-host", "wp": "--ldp-wp", "dqp": "--ldp-dqp"}[variant]
    w_bytes, w_sha, w_hash = HOST_AS_WRITTEN[variant]
    print(f"[{tag}] the JAX package's streams (scripts/jax_reference_sha1.py "
          f"{opt}, CPU): with the spec AMVP list {ref_bytes} bytes SHA-1 "
          f"{ref_sha}, hash OK {n} of {n} in all four decoders; as it "
          f"writes them {w_bytes} bytes SHA-1 {w_sha}, hash OK {w_hash}")
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"stream {len(stream)} bytes SHA-1 {sha}, the JAX package's "
          f"(spec AMVP list) is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's with the spec AMVP "
          "list, byte for byte (SHA-1)")
    return launches, sao_launches, off_launches, stream



def _cli(main, argv: list) -> tuple[str, str, float]:
    """Run a CLI's main(argv) in this process, so that the kernels'
    launch counters can be read: (its standard output, its standard
    error, seconds)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _b_blocks(info) -> dict:
    cnt = dict(intra=0, skip=0, merge=0, amvp=0, bi=0)
    for row in info:
        for b in row:
            cnt["intra" if b.pred_mode == hevc_bc.MODE_INTRA else "skip"
                if b.skip else "merge" if b.merge else "bi"
                if b.inter_dir == 3 else "amvp"] += 1
    return cnt


def _decoder_app(tag: str, d: Path, n: int) -> float:
    """The port's decoder CLI on d/out.bin: "(OK)" for n of n pictures and
    its output file equal to the encoder CLI's recon file d/rec.yuv;
    returns its seconds."""
    out, _, t = _cli(decoder_app.main, ["-b", str(d / "out.bin"), "-o",
                                        str(d / "dec.yuv")])
    oks = out.count("(OK)")
    check(oks == n and f"{n} pictures decoded (hevc)" in out,
          f"[{tag}] decoder_app: (OK) for {oks} of {n}: {out[-400:]}")
    check((d / "dec.yuv").read_bytes() == (d / "rec.yuv").read_bytes(),
          f"[{tag}] decoder_app's pictures != the encoder CLI's recon file")
    return t


def _cli_launches(main, argv: list):
    """_cli(main, argv) with the SAD-, SAO- and RDOQ-kernel counters and
    the plain versions' call counts set to 0 just before; returns
    (stdout, stderr, seconds, SAD, sao_stats and rdoq_dev launches, plain
    RDOQ calls, plain SAO statistics calls on the card)."""
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    sao_ops.sao_stats.launches = 0
    RDOQ_REF_CALLS["cuda"] = RDOQ_REF_CALLS["cpu"] = 0
    SAO_REF_CALLS["cuda"] = 0
    out, err, t = _cli(main, argv)
    return (out, err, t, ss.sad_surface.launches, sao_ops.sao_stats.launches,
            rdoq_ops.rdoq_dev.launches,
            RDOQ_REF_CALLS["cuda"] + RDOQ_REF_CALLS["cpu"],
            SAO_REF_CALLS["cuda"])


def phase_cli_ra() -> int:
    """Phase cli-ra: the port's encoder CLI on HM 16.5's
    encoder_randomaccess_main.cfg (`hm_cli_files`), as a user starts it,
    in this process: it builds `ra_codec.RandomAccessEncoder` (the host
    flat 16x16 B coder) on the card.  Per picture pass 1 on the card, the
    host raster, the deblock on the card and CABAC with the SEI; the
    CLI's summary and warnings; 15 SAD launches (one per list), no SAO or
    RDOQ kernel; the recon file the encoder's pictures; the port's
    decoder CLI "(OK)" for every picture with the recon file's pictures,
    `RandomAccessDecoder` every hash OK with the encoder's pictures; the
    stream the JAX package's encoder CLI's (CLI_RA_SHA1).  Returns the
    SAD launches."""
    w, h, n = CLI_W, CLI_H, CLI_RA_PICTURES
    tag = "cli-ra"
    frames = bench_synth_clip(w, h, n)
    d = BUILD_DIR / "cli_ra"
    d.mkdir(parents=True, exist_ok=True)
    argv = hm_cli_files(d, "ra", frames, w, h)
    print(f"[{tag}] the port's encoder CLI (tools/encoder_app.main) on HM "
          f"16.5's encoder_randomaccess_main.cfg and a per-sequence cfg: "
          f"{w}x{h}, {n} pictures of bench.py's clip (seed 42), QP 32, GOP "
          "8 from its Frame1-8 lines, IntraPeriod 32, FastSearch 1 "
          "SearchRange 64, RDOQ 1, SignHideFlag 1, MaxNumMergeCand 5, "
          "TMVPMode 1, SAO 1; card " + CARD)
    made = []
    cls = hevc_ra.RandomAccessEncoder

    def build(*a, **kw):
        enc = cls(*a, **kw)
        made.append((enc, _host_instrument(enc, sao=False)))
        return enc

    hevc_ra.RandomAccessEncoder = build
    try:
        out, err, t_enc, launches, sao_n, rdoq_n, rdoq_ref, sao_ref = \
            _cli_launches(encoder_app.main, argv)
    finally:
        hevc_ra.RandomAccessEncoder = cls
    check(len(made) == 1, f"the CLI built {len(made)} RandomAccessEncoders")
    enc, log = made[0]
    cfg = enc.cfg
    check(enc.device.type == "cuda", f"the CLI's encoder is on {enc.device}")
    check((cfg.width, cfg.height, cfg.sao, cfg.merge_cands, cfg.temporal_mvp,
           cfg.rdoq, cfg.sign_data_hiding, enc.me_method, enc.search_range,
           enc.gop) == (w, h, False, 1, False, "full", True, "tz", 64,
                        hevc_ra.GOP8_RA),
          f"the CLI's RA settings {cfg} {enc.me_method} {enc.search_range}")
    sao_warning = ("** warning: SAO on the hierarchical-B build not "
                   "implemented yet — disabled")
    check(sao_warning in err, f"no SAO warning: {err[-300:]}")
    ignored = [ln.split("option ")[1].split(" not implemented")[0]
               for ln in err.splitlines() if "** warning: option " in ln]
    print(f"[{tag}] the CLI's warnings: {len(ignored)} options ignored "
          f"({', '.join(ignored)}); {sao_warning[12:]}")
    for ln in out.strip().splitlines():
        print(f"[{tag}] {ln}")
    want = 0
    for e in log:
        nbytes = sum(len(x) for x in e["nals"] if x)
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            blocks = f"{(w // 16) * (h // 16)} intra (IDR)"
            dbk = "in the CTB loop"
        else:
            cnt = _b_blocks(e["info"])
            blocks = " / ".join(f"{k_} {v}" for k_, v in cnt.items())
            dbk = f"{e['deblock'] * 1e3:.1f} ms"
            want += e["refs"]
            check(e["launches"] == e["refs"],
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches, "
                  f"want 1 per list ({e['refs']})")
        print(f"[{tag}] POC {e['poc']} ({e['kind']}, QP {e['qp']}, "
              f"{e['refs']} lists): pass 1 {e['pass1'] * 1e3:.1f} ms, "
              f"raster decision and recon {e['raster'] * 1e3:.1f} ms, "
              f"deblock {dbk}, CABAC + SEI {e['cabac'] * 1e3:.1f} ms (total "
              f"{e['total'] * 1e3:.1f} ms); {nbytes} bytes, Y-PSNR "
              f"{p:.2f} dB; blocks {blocks}; SAD-kernel launches "
              f"{e['launches']}")
    check(len(log) == n, f"{len(log)} pictures coded")
    check(launches == want == 15,
          f"{launches} SAD-kernel launches, want 15 (1 per list)")
    check(sao_n == 0 and sao_ref == 0, f"{sao_n} sao_stats launches")
    check(rdoq_n == 0 and rdoq_ref == 0,
          f"rdoq_dev: {rdoq_n} launches, {rdoq_ref} plain-version calls")
    stream = (d / "out.bin").read_bytes()
    sha = hashlib.sha1(stream).hexdigest()
    recons = {e["poc"]: e["rec"] for e in log}
    ry, ru, rv = yuv.read_frames(str(d / "rec.yuv"), w, h)
    for k_ in range(n):
        for c, plane in enumerate((ry, ru, rv)):
            check(np.array_equal(plane[k_], recons[k_][c]),
                  f"[{tag}] recon file picture {k_} plane {c} != the "
                  "encoder's")
    print(f"[{tag}] {len(stream)} bytes, SHA-1 {sha}; encoder_app.main "
          f"{t_enc:.2f} s ({n / t_enc:.3f} fps); SAD-kernel launches "
          f"{launches}, sao_stats 0, rdoq_dev 0; the recon file holds the "
          "encoder's pictures")
    check(decoder_app._needs_general(stream),
          "decoder_app would take LowDelayDecoder for the RA stream")
    t_app = _decoder_app(tag, d, n)
    print(f"[{tag}] the port's decoder_app (the stream has TRAIL_N "
          f"pictures and B slices: GeneralDecoder): (OK) for {n} of {n} "
          f"pictures, its output file equals the recon file, {t_app:.2f} s")
    t0 = time.perf_counter()
    dec = hevc_ra.RandomAccessDecoder()
    got = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * n,
          f"RandomAccessDecoder: picture hash SEI {dec.hash_status}")
    for k_, o in enumerate(got):
        for c in range(3):
            check(np.array_equal(np.asarray(o[c]), recons[k_][c]),
                  f"RandomAccessDecoder: picture {k_} plane {c} != the "
                  "encoder's")
    print(f"[{tag}] the port's RandomAccessDecoder: hash SEI OK on all {n} "
          f"pictures, pictures equal the encoder's, {t_dec:.2f} s")
    print(f"[{tag}] the JAX package's encoder CLI on the same files "
          "(scripts/jax_reference_sha1.py --cli-ra, CPU): "
          f"{CLI_RA_BYTES} bytes SHA-1 {CLI_RA_SHA1}; {CLI_RA_JAX_DECODERS}")
    check((len(stream), sha) == (CLI_RA_BYTES, CLI_RA_SHA1),
          f"stream {len(stream)} bytes SHA-1 {sha}, the JAX package's CLI "
          f"wrote {CLI_RA_BYTES} bytes {CLI_RA_SHA1}")
    print(f"[{tag}] the stream is the JAX package's encoder CLI's, byte for "
          "byte (SHA-1)")
    return launches


def phase_cli_ra_cuda_vs_cpu() -> None:
    """Phase cli-ra-cuda-vs-cpu: the encoder CLI on HM's RA main cfg at
    80x48 (9 pictures of bench.py's clip) on the card and with
    --device=cpu: byte-equal streams and recon files, 15 SAD launches on
    the card and none on the CPU."""
    tag = "cli-ra-cuda-vs-cpu"
    frames = bench_synth_clip(80, 48, CLI_RA_PICTURES)
    runs = []
    for dev in ("cuda", "cpu"):
        d = BUILD_DIR / f"cli_ra_small_{dev}"
        d.mkdir(parents=True, exist_ok=True)
        argv = hm_cli_files(d, "ra", frames, 80, 48)
        if dev == "cpu":
            argv.append("--device=cpu")
        _, _, t, sad_n = _cli_launches(encoder_app.main, argv)[:4]
        runs.append(((d / "out.bin").read_bytes(),
                     (d / "rec.yuv").read_bytes(), sad_n, t))
    (sg, rg, ng, tg), (sc, rc_, nc, tc) = runs
    check(sg == sc and rg == rc_,
          f"[{tag}] the card's stream ({len(sg)} bytes) != the CPU's "
          f"({len(sc)} bytes), or their recon files differ")
    check(ng == 15 and nc == 0,
          f"[{tag}] SAD-kernel launches: card {ng}, CPU {nc} (want 15, 0)")
    print(f"[{tag}] 80x48, {CLI_RA_PICTURES} pictures: streams byte-equal "
          f"({len(sg)} bytes), recon files equal; SAD-kernel launches: card "
          f"{ng}, CPU 0; cuda {tg:.2f} s, cpu {tc:.2f} s")


def phase_cli_ldp(host_stream: bytes) -> tuple[int, int]:
    """Phase cli-ldp: the port's encoder CLI on HM 16.5's
    encoder_lowdelay_P_main.cfg (`hm_cli_files`) over the first
    CLI_LDP_PICTURES pictures of `[hevc-ldp-host]`'s clip: it builds
    `inter_codec.LowDelayEncoder` with `host_ldp_cfg`'s settings, so its
    NAL units must be the first NAL units of that phase's stream from
    this run (the host coder codes a picture from the ones before it
    only); 1 SAD launch per reference and 3 sao_stats per picture; the
    port's decoder CLI (LowDelayDecoder) "(OK)" for every picture with the
    recon file's pictures.  Returns the SAD and sao_stats launches."""
    w, h, n = CLI_W, CLI_H, CLI_LDP_PICTURES
    tag = "cli-ldp"
    frames = bench_synth_clip(w, h, n)
    d = BUILD_DIR / "cli_ldp"
    d.mkdir(parents=True, exist_ok=True)
    argv = hm_cli_files(d, "ldp", frames, w, h)
    out, err, t_enc, sad_n, sao_n, rdoq_n, rdoq_ref, sao_ref = \
        _cli_launches(encoder_app.main, argv)
    for ln in out.strip().splitlines():
        print(f"[{tag}] {ln}")
    want_sad = sum(min(k_, 4) for k_ in range(n))
    check(sad_n == want_sad and sao_n == 3 * n and sao_ref == 0,
          f"[{tag}] SAD-kernel launches {sad_n} (want {want_sad}), "
          f"sao_stats {sao_n} (want {3 * n}), plain SAO {sao_ref}")
    check(rdoq_n == 0 and rdoq_ref == 0, f"[{tag}] rdoq_dev ran")
    stream = (d / "out.bin").read_bytes()
    nals = hevc_bs.split_annexb(stream)
    host_nals = hevc_bs.split_annexb(host_stream)
    check(nals == host_nals[:len(nals)],
          f"[{tag}] the CLI's {len(nals)} NAL units are not the first NAL "
          "units of [hevc-ldp-host]'s stream")
    check(not decoder_app._needs_general(stream),
          "decoder_app would route the LD-P stream to GeneralDecoder")
    t_app = _decoder_app(tag, d, n)
    print(f"[{tag}] HM 16.5's encoder_lowdelay_P_main.cfg through the port's "
          f"encoder CLI: {w}x{h}, {n} pictures, {len(stream)} bytes, "
          f"encoder_app.main {t_enc:.2f} s; SAD-kernel launches {sad_n}, "
          f"sao_stats {sao_n}, rdoq_dev 0; its {len(nals)} NAL units are "
          f"the first {len(nals)} of [hevc-ldp-host]'s stream from this run "
          "(the JAX package's with the spec AMVP list); the port's "
          f"decoder_app (LowDelayDecoder): (OK) for {n} of {n}, its output "
          f"file equals the recon file, {t_app:.2f} s; {len(err.splitlines())}"
          " warnings")
    return sad_n, sao_n

def phase_sad_jm() -> dict:
    """Phase 13a (sad-kernel-jm): the SAD kernel against its plain version at the
    host H.264 coder's card-stage shape -- n=4, r=32 (twice search range
    16), B=1,584 (the 4x4 blocks of a 176x144 picture), one launch per
    reference and P picture -- on windows cut as `host_me.sad_surfaces`
    cuts them from a seeded picture pair, exactly; timed beside its bound,
    the plain version and `torch.cdist`.  Returns the row."""
    from video_codecs_tpu_torch.models.h264 import host_me
    n, r = 4, 2 * JM_SR
    frames = bench_synth_clip(JM_W, JM_H, 2)
    cur_y = torch.from_numpy(frames[1][0]).cuda()
    ref_y = torch.from_numpy(frames[0][0]).cuda()
    ys = torch.arange(-r, JM_H + r, device="cuda").clamp(0, JM_H - 1)
    xs = torch.arange(-r, JM_W + r, device="cuda").clamp(0, JM_W - 1)
    wn = n + 2 * r
    win = ref_y[ys][:, xs].unfold(0, wn, 4).unfold(1, wn, 4).reshape(
        -1, wn, wn).contiguous()
    cur = cur_y.unfold(0, 4, 4).unfold(1, 4, 4).reshape(-1, 4, 4).contiguous()
    b = cur.shape[0]
    got = ss.sad_surface(cur, win, n, r)
    torch.cuda.synchronize()
    want = ss.sad_surface_ref(cur, win, n, r)
    err = int((got - want).abs().max())
    check(err == 0, f"kernel != plain at n={n} B={b} r={r} (max abs err "
                    f"{err})")
    stage = host_me.sad_surfaces(cur_y, ref_y, JM_SR)
    check(torch.equal(stage[(4, 4)].reshape(-1, 2 * r + 1, 2 * r + 1), got),
          "host_me.sad_surfaces' 4x4 surfaces != the kernel's on its cut")
    lib_err = float((sad_cdist(cur, win, n, r) - want).abs().max())
    tm = sad_times(cur, win, n, r)
    ms, plain, lib = tm["ms"], tm["plain_ms"], tm["library_ms"]
    bound, nbytes, ops = sad_bound(n, b, r)
    by = "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES else "bytes"
    print(f"[sad-kernel-jm] the host H.264 coder's card stage at {JM_W}x"
          f"{JM_H}, search range {JM_SR}: n={n} B={b} r={r}: equal to the "
          f"plain version (max abs err 0); kernel {kms(ms)} (profiler"
          f"{', ' + tm['note'] if tm['note'] else ''}), {tm['event_ms']:.4f}"
          f" ms a wrapper call (CUDA events); bound {bound:.4f} ms "
          f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops, {by}), "
          f"{of_bound(bound, ms)}; plain {plain:.3f} ms; torch.cdist "
          f"{lib:.3f} ms (max abs err {lib_err:g})")
    return dict(what=f"H.264 host coder {JM_W}x{JM_H}", n=n, b=b, r=r,
                ms=ms, event_ms=tm["event_ms"], plain_ms=plain,
                library_ms=lib, bound_ms=bound, bound_by=by, max_abs_err=err,
                note=tm["note"] or None)


def _h264_instrument(enc, skips: dict | None = None):
    """Time each picture of the host H.264 coder (`H264Encoder` or
    `H264BEncoder`) by stage: the card stage (`_card_stage`, one
    `host_me.RefSearch` per reference or list, synchronised by its copy
    back), the integer searches with their sub-pel refinement (`_search`,
    `_search_epzs`, `_search_umhex`; 16x16 blocks and partitions apart),
    the 8x8 transforms (`forward8x8`, `quant8x8`, `dequant8x8`,
    `inverse8x8`: the 4x4/8x8 decision, I_8x8 and the 8x8 recon), the
    luma quantization (`_quant_ac`) and the entropy coder (the MB
    writers and CAVLC's `encode_block`); the rest of a picture is the
    mode and partition loops, MC, the 4x4 transforms, reconstruction and
    the deblock; with perceptual RDO the saliency model (`_att_eta`,
    on the encoder's device) apart.  Per picture also the SAD-kernel
    launches, the 8x8-transform MBs (`_trans8`), the POC and the B
    coder's mb_type histogram (`mb_type_stats`) with the skips
    `skips["n"]` counts.
    Returns (log, restore)."""
    from video_codecs_tpu_torch.entropy import cavlc
    from video_codecs_tpu_torch.ops import h264_transform as ht
    cur = {}

    def timed(name, fn, split=None):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                k = split(a, kw) if split else name
                cur[k] = cur.get(k, 0.0) + time.perf_counter() - t0
        return run

    def search_kind(a, kw):
        pw = a[6] if len(a) > 6 else kw.get("pw", 16)
        ph = a[7] if len(a) > 7 else kw.get("ph", 16)
        return "search" if (pw, ph) == (16, 16) else "search_part"

    enc._card_stage = timed("card", enc._card_stage)
    enc._search = timed("", enc._search, search_kind)
    for name in ("_search_epzs", "_search_umhex"):
        setattr(enc, name, timed("search", getattr(enc, name)))
    enc._quant_ac = timed("quant", enc._quant_ac)
    if getattr(enc, "att", False):
        enc._att_eta = timed("att", enc._att_eta)
    for name in ("_write_p_mb_cabac", "_write_mb_cabac",
                 "_write_b_mb_cabac"):
        if hasattr(enc, name):
            setattr(enc, name, timed("entropy", getattr(enc, name)))
    keep = {n: getattr(ht, n) for n in ("forward8x8", "quant8x8",
                                         "dequant8x8", "inverse8x8")}
    for n, fn in keep.items():
        setattr(ht, n, timed("t8", fn))
    encode_block = cavlc.encode_block
    cavlc.encode_block = timed("entropy", encode_block)
    log = []

    def picture(kind, fn, lists):
        def run(*a, **kw):
            cur.clear()
            n0 = ss.sad_surface.launches
            s0 = dict(getattr(enc, "mb_type_stats", {}))
            k0 = skips["n"] if skips else 0
            t0 = time.perf_counter()
            rbsp, rec = fn(*a, **kw)
            total = time.perf_counter() - t0
            s1 = getattr(enc, "mb_type_stats", {})
            log.append(dict(kind=kind, refs=lists(a), rbsp=rbsp, rec=rec,
                            poc=a[4] if kind == "B" else kw.get("poc"),
                            total=total, t8=int(enc._trans8.sum())
                            if kind != "B" else 0,
                            launches=ss.sad_surface.launches - n0,
                            types={k: s1[k] - s0.get(k, 0) for k in s1
                                   if s1[k] != s0.get(k, 0)},
                            skip=(skips["n"] - k0) if skips else 0,
                            stages=dict(cur)))
            return rbsp, rec
        return run

    enc._encode_p_frame = picture("P", enc._encode_p_frame,
                                  lambda a: len(a[3]))
    enc.encode_frame = picture("I", enc.encode_frame, lambda a: 0)
    if hasattr(enc, "_encode_b_frame"):
        enc._encode_b_frame = picture("B", enc._encode_b_frame,
                                      lambda a: 2)

    def restore():
        cavlc.encode_block = encode_block
        for n, fn in keep.items():
            setattr(ht, n, fn)

    return log, restore


def _h264_stages(e: dict) -> str:
    st = e["stages"]
    rest = e["total"] - sum(st.values())
    words = [f"card stage {st.get('card', 0.0) * 1e3:.1f} ms",
             f"searches {st.get('search', 0.0) * 1e3:.1f} ms"]
    if "search_part" in st:
        words.append(f"partition searches {st['search_part'] * 1e3:.1f} ms")
    if "t8" in st:
        words.append(f"8x8 transforms (4x4/8x8 decision, I_8x8, recon) "
                     f"{st['t8'] * 1e3:.1f} ms")
    if "att" in st:
        words.append(f"saliency model and eta (card) "
                     f"{st['att'] * 1e3:.1f} ms")
    words += [f"quantization {st.get('quant', 0.0) * 1e3:.1f} ms",
              f"entropy coder {st.get('entropy', 0.0) * 1e3:.1f} ms",
              f"mode and partition loops, MC, 4x4 transforms, recon and "
              f"deblock {rest * 1e3:.1f} ms",
              f"total {e['total'] * 1e3:.1f} ms"]
    return ", ".join(words)


def phase_jm(kind: str) -> int:
    """Phase 13b-c (jm-main, jm-baseline): the port's JM encoder CLI
    (`tools/jm_encoder_app.main`, in this process) on a JM-style cfg
    (`jm_cli_files`) and 5 pictures of bench.py's clip at 176x144: it
    builds the host IPPP coder `inter_codec.H264Encoder` on the card.
    Per picture the card stage, the searches, the mode loops and the
    rest, the quantization and the entropy coder, bytes, Y-PSNR and SAD
    launches (one per reference and P picture); the CLI's summary and
    warnings; the recon file the encoder's pictures and the port's
    H264Decoder's; the stream the JAX package's CLI's (JM_SHA1).
    Returns the SAD launches."""
    from video_codecs_tpu_torch.models.h264 import inter_codec as h264
    from video_codecs_tpu_torch.tools import jm_encoder_app
    tag = f"jm-{kind}"
    s = JM_SETTINGS[kind]
    frames = bench_synth_clip(JM_W, JM_H, JM_PICTURES)
    d = BUILD_DIR / f"jm_{kind}"
    d.mkdir(parents=True, exist_ok=True)
    argv = jm_cli_files(d, kind, frames)
    print(f"[{tag}] the port's JM encoder CLI (tools/jm_encoder_app.main) "
          f"on a JM-style cfg: {JM_W}x{JM_H}, {JM_PICTURES} pictures of "
          f"bench.py's clip (seed 42), QP 28, IPPP, SearchRange {JM_SR}, "
          f"SymbolMode {s['SymbolMode']}, SearchMode {s['SearchMode']}, "
          f"NumberReferenceFrames {s['NumberReferenceFrames']}, UseRDOQuant "
          f"{s['UseRDOQuant']}, UseAdaptiveRounding "
          f"{s['UseAdaptiveRounding']}; card {CARD}")
    made = []
    cls = h264.H264Encoder

    def build(*a, **kw):
        enc = cls(*a, **kw)
        made.append((enc, _h264_instrument(enc)))
        return enc

    h264.H264Encoder = build
    try:
        out, err, t_enc, launches = _cli_launches(jm_encoder_app.main,
                                                  argv)[:4]
    finally:
        h264.H264Encoder = cls
        for _, (_, restore) in made:
            restore()
    check(len(made) == 1, f"the CLI built {len(made)} H264Encoders")
    enc, (log, _) = made[0]
    want_cfg = ("cabac" if s["SymbolMode"] else "cavlc",
                {0: "full", 3: "epzs"}[s["SearchMode"]],
                s["NumberReferenceFrames"],
                "trellis" if s["UseRDOQuant"] else
                "around" if s["UseAdaptiveRounding"] else "normal", JM_SR)
    check(enc.device.type == "cuda", f"the CLI's encoder is on {enc.device}")
    check((enc.entropy, enc.me, enc.n_refs, enc.quant, enc.sr) == want_cfg,
          f"the CLI's settings {enc.entropy} {enc.me} {enc.n_refs} "
          f"{enc.quant} {enc.sr}, want {want_cfg}")
    warned = [ln for ln in err.splitlines() if ln.startswith("**")]
    print(f"[{tag}] the CLI's warnings: {' | '.join(warned) or 'none'}")
    for ln in out.strip().splitlines():
        print(f"[{tag}] {ln}")
    want = 0
    for i, e in enumerate(log):
        p = psnr(frames[i][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        want += e["refs"]
        check(e["launches"] == e["refs"],
              f"picture {i}: {e['launches']} SAD-kernel launches, want 1 "
              f"per reference ({e['refs']})")
        print(f"[{tag}] picture {i} ({e['kind']}, {e['refs']} references): "
              f"{_h264_stages(e)}; {len(e['rbsp'])} bytes, Y-PSNR "
              f"{p:.2f} dB; SAD-kernel launches {e['launches']}")
    check(len(log) == JM_PICTURES, f"{len(log)} pictures coded")
    check(launches == want == JM_LAUNCHES[kind],
          f"{launches} SAD-kernel launches, want {JM_LAUNCHES[kind]} (one "
          "per reference and P picture)")
    stream = (d / "out.264").read_bytes()
    sha = hashlib.sha1(stream).hexdigest()
    ry, ru, rv = yuv.read_frames(str(d / "rec.yuv"), JM_W, JM_H)
    for k_, e in enumerate(log):
        for c, plane in enumerate((ry, ru, rv)):
            check(np.array_equal(plane[k_], e["rec"][c]),
                  f"[{tag}] recon file picture {k_} plane {c} != the "
                  "encoder's")
    t0 = time.perf_counter()
    got = H264Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    check(len(got) == JM_PICTURES, f"H264Decoder: {len(got)} pictures")
    for k_, g in enumerate(got):
        for c, plane in enumerate((ry, ru, rv)):
            check(np.array_equal(plane[k_], g[c]),
                  f"[{tag}] H264Decoder picture {k_} plane {c} != the "
                  "recon file's")
    print(f"[{tag}] {len(stream)} bytes, SHA-1 {sha}; jm_encoder_app.main "
          f"{t_enc:.2f} s ({JM_PICTURES / t_enc:.3f} fps); SAD-kernel "
          f"launches {launches}; the recon file holds the encoder's "
          f"pictures; the port's H264Decoder gives them ({t_dec:.2f} s)")
    ref_bytes, ref_sha = JM_SHA1[kind]
    print(f"[{tag}] the JAX package's JM encoder CLI on the same files "
          f"(scripts/jax_reference_sha1.py --jm-{kind}, CPU): {ref_bytes} "
          f"bytes SHA-1 {ref_sha}")
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"stream {len(stream)} bytes SHA-1 {sha}, the JAX package's CLI "
          f"wrote {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's JM encoder CLI's, byte "
          "for byte (SHA-1)")
    return launches


def phase_jm_cuda_vs_cpu() -> None:
    """Phase 13d (jm-cuda-vs-cpu): the JM encoder CLI with the Main
    settings on 5 pictures at 64x48 on the card and with --device=cpu:
    byte-equal streams and recon files, 9 SAD launches on the card and
    none on the CPU."""
    from video_codecs_tpu_torch.tools import jm_encoder_app
    tag = "jm-cuda-vs-cpu"
    frames = bench_synth_clip(64, 48, JM_PICTURES)
    runs = []
    for dev in ("cuda", "cpu"):
        d = BUILD_DIR / f"jm_small_{dev}"
        d.mkdir(parents=True, exist_ok=True)
        argv = jm_cli_files(d, "main", frames)
        if dev == "cpu":
            argv.append("--device=cpu")
        _, _, t, sad_n = _cli_launches(jm_encoder_app.main, argv)[:4]
        runs.append(((d / "out.264").read_bytes(),
                     (d / "rec.yuv").read_bytes(), sad_n, t))
    (sg, rg, ng, tg), (sc, rc_, nc, tc) = runs
    check(sg == sc and rg == rc_,
          f"[{tag}] the card's stream ({len(sg)} bytes) != the CPU's "
          f"({len(sc)} bytes), or their recon files differ")
    check(ng == JM_LAUNCHES["main"] and nc == 0,
          f"[{tag}] SAD-kernel launches: card {ng}, CPU {nc} (want "
          f"{JM_LAUNCHES['main']}, 0)")
    print(f"[{tag}] 64x48, {JM_PICTURES} pictures, the Main settings: "
          f"streams byte-equal ({len(sg)} bytes), recon files equal; "
          f"SAD-kernel launches: card {ng}, CPU 0; cuda {tg:.2f} s, cpu "
          f"{tc:.2f} s")


def _b_counts(e: dict) -> str:
    t = e["types"]
    parts = sum(v for k, v in t.items() if isinstance(k, int) and k >= 4)
    direct = t.get(0, 0) - e["skip"]
    return (f"direct {direct}, skip {e['skip']}, L0 {t.get(1, 0)}, L1 "
            f"{t.get(2, 0)}, bi {t.get(3, 0)}, partitioned {parts} "
            f"(16x8/8x16 {parts - t.get(22, 0)}, B_8x8 {t.get(22, 0)}), "
            f"intra {t.get('intra', 0)}")


def h264_high_b_encoder(kind: str, w: int, h: int, device: str):
    """The host H.264 coder of phase 15: `H264Encoder` with the High
    settings (kind "high") or `H264BEncoder` with the B settings
    ("b")."""
    from video_codecs_tpu_torch.models.h264 import bslice_codec
    from video_codecs_tpu_torch.models.h264 import inter_codec as h264
    if kind == "high":
        return h264.H264Encoder(w, h, device=device, **H264_HIGH_KW)
    return bslice_codec.H264BEncoder(w, h, device=device, **H264_B_KW)


def phase_h264_high_b(kind: str, device: str = "cuda") -> int:
    """Phase 15a-b (h264-high, h264-b): the host H.264 coder at JM's QCIF
    on bench.py's clip (seed 42), QP 28, search range 16.  h264-high:
    `H264Encoder(..., transform8x8=True)`, [jm-main]'s settings with the
    8x8 transform (CABAC, EPZS, 3 references, trellis; High profile 100),
    5 pictures: per picture the stages of `_h264_instrument`, the MBs
    coded with the 8x8 transform, bytes, Y-PSNR and the SAD launches
    (one per reference and P picture: 9); the port's H264Decoder gives
    the encoder's pictures.  h264-b: `H264BEncoder(b_frames=2,
    b_qp_offset=2)`, CABAC, 7 pictures coded I0 P3 B1 B2 P6 B4 B5:
    per B picture its direct / skip / L0 / L1 / bi / partitioned /
    intra MBs and the stages, SAD launches 1 per P anchor and 2 per B
    picture (10); H264BDecoder gives the encoder's pictures in display
    order.  Each stream must be the JAX package's
    (scripts/jax_reference_sha1.py --h264-high / --h264-b).  Returns the
    SAD launches."""
    from video_codecs_tpu_torch.models.h264 import bslice_codec
    tag = f"h264-{kind}"
    n = H264_HIGH_PICTURES if kind == "high" else H264_B_PICTURES
    frames = bench_synth_clip(JM_W, JM_H, n)
    kw = H264_HIGH_KW if kind == "high" else H264_B_KW
    print(f"[{tag}] the host H.264 coder "
          f"({'H264Encoder' if kind == 'high' else 'H264BEncoder'}) at "
          f"{JM_W}x{JM_H}, {n} pictures of bench.py's clip (seed 42): "
          f"{', '.join(f'{k}={v}' for k, v in kw.items())}; card {CARD}")
    enc = h264_high_b_encoder(kind, JM_W, JM_H, device)
    skips = {"n": 0}
    cabac_cls = bslice_codec.hc.H264CabacEncoder
    skip_flag = cabac_cls.mb_skip_flag_b

    def count_skip(self, flag, *a):
        skips["n"] += int(bool(flag))
        return skip_flag(self, flag, *a)

    cabac_cls.mb_skip_flag_b = count_skip
    log, restore = _h264_instrument(enc, skips)
    ss.sad_surface.launches = 0
    t0 = time.perf_counter()
    try:
        stream, recons = enc.encode_sequence(frames)
    finally:
        restore()
        cabac_cls.mb_skip_flag_b = skip_flag
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    check(len(log) == n, f"[{tag}] {len(log)} pictures coded, want {n}")
    want = 0
    order = []
    t8_all = 0
    for k_, e in enumerate(log):
        # display index: POC / 2 in the B run (poc_type 0), the coding
        # order in the IPPP run
        i = k_ if e["poc"] is None else e["poc"] // 2
        order.append(f"{e['kind']}{i}")
        p = psnr(frames[i][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"[{tag}] implausible Y-PSNR {p}")
        want += e["refs"]
        check(e["launches"] == e["refs"],
              f"[{tag}] picture {i}: {e['launches']} SAD-kernel launches, "
              f"want 1 per reference or list ({e['refs']})")
        t8_all += e["t8"]
        extra = ""
        if kind == "high":
            extra = f"; 8x8-transform MBs {e['t8']} of {JM_W * JM_H // 256}"
        elif e["kind"] == "B":
            extra = f"; MBs: {_b_counts(e)}"
        print(f"[{tag}] {e['kind']}{i} ({e['refs']} "
              f"{'lists' if e['kind'] == 'B' else 'references'}): "
              f"{_h264_stages(e)}; {len(e['rbsp'])} bytes, Y-PSNR "
              f"{p:.2f} dB; SAD-kernel launches {e['launches']}{extra}")
    want_n = H264_HIGH_LAUNCHES if kind == "high" else H264_B_LAUNCHES
    check(launches == want == want_n,
          f"[{tag}] {launches} SAD-kernel launches, want {want_n}")
    if kind == "high":
        check(t8_all > 0, f"[{tag}] no MB took the 8x8 transform")
    sha = hashlib.sha1(stream).hexdigest()
    t0 = time.perf_counter()
    if kind == "high":
        got = H264Decoder().decode(stream)
        dec_name = "H264Decoder"
    else:
        got = bslice_codec.H264BDecoder().decode(stream)
        dec_name = "H264BDecoder (display order)"
    t_dec = time.perf_counter() - t0
    check(len(got) == n, f"[{tag}] {dec_name}: {len(got)} pictures")
    for k_, (g, r) in enumerate(zip(got, recons)):
        for c in range(3):
            check(np.array_equal(np.asarray(g[c]), np.asarray(r[c])),
                  f"[{tag}] {dec_name} picture {k_} plane {c} != the "
                  "encoder's")
    y_psnr = np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)])
    print(f"[{tag}] coding order {' '.join(order)}; {len(stream)} bytes, "
          f"mean Y-PSNR {y_psnr:.2f} dB, encode {t_enc:.2f} s "
          f"({n / t_enc:.3f} fps); SAD-kernel launches {launches}; SHA-1 "
          f"{sha}; the port's {dec_name} gives the encoder's pictures "
          f"({t_dec:.2f} s)")
    ref_bytes, ref_sha = H264_HIGH_SHA1 if kind == "high" else H264_B_SHA1
    print(f"[{tag}] the JAX package's stream for the same clip and "
          f"settings (scripts/jax_reference_sha1.py --h264-{kind}, CPU): "
          f"{ref_bytes} bytes SHA-1 {ref_sha}")
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"[{tag}] stream {len(stream)} bytes SHA-1 {sha}, the JAX "
          f"package's is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's, byte for byte (SHA-1)")
    return launches


def phase_h264_hb_cuda_vs_cpu() -> None:
    """Phase 15c (h264-hb-cuda-vs-cpu): 15a and 15b's coders at 64x48 on
    the card and with device="cpu": byte-equal streams, the card's
    searches through the SAD kernel (9 and 10 launches), the CPU's
    through its plain version (0)."""
    tag = "h264-hb-cuda-vs-cpu"
    words = []
    for kind, n, want_n in (("high", H264_HIGH_PICTURES, H264_HIGH_LAUNCHES),
                            ("b", H264_B_PICTURES, H264_B_LAUNCHES)):
        frames = bench_synth_clip(64, 48, n)
        res = {}
        for dev in ("cuda", "cpu"):
            enc = h264_high_b_encoder(kind, 64, 48, dev)
            ss.sad_surface.launches = 0
            t0 = time.perf_counter()
            stream, _ = enc.encode_sequence(frames)
            res[dev] = (stream, ss.sad_surface.launches,
                        time.perf_counter() - t0)
        (g, ng, tg), (c, nc, tc) = res["cuda"], res["cpu"]
        check(g == c, f"[{tag}] {kind}: the card's stream ({len(g)} bytes) "
                      f"!= the CPU's ({len(c)} bytes)")
        check(ng == want_n and nc == 0,
              f"[{tag}] {kind}: SAD-kernel launches card {ng}, CPU {nc} "
              f"(want {want_n}, 0)")
        words.append(f"{kind} ({n} pictures) byte-equal ({len(g)} bytes), "
                     f"SAD-kernel launches card {ng}, CPU 0, cuda {tg:.2f} "
                     f"s, cpu {tc:.2f} s")
    print(f"[{tag}] 64x48: {'; '.join(words)}")


def _conf_recorder(enc):
    """Per P picture of phase 16's coder: its reordering and MMCO
    commands, its intra MBs (the refresh's forced ones among them), its
    slice's weights and its eta's range; and after every picture the DPB
    as "frame_num" or "frame_num(LTidx)" words.  Install before
    `_h264_instrument`.  Returns (record, restore)."""
    from video_codecs_tpu_torch.models.h264 import dpb as dpb_mod
    rec = {"p": [], "dpb": []}
    cnt = {"intra": 0}
    orig_mb, orig_p = enc._encode_mb, enc._encode_p_frame
    orig_mark = dpb_mod.Dpb.mark

    def encode_mb(*a, **kw):
        if kw.get("p_slice") or kw.get("mb_type_offset"):
            cnt["intra"] += 1
        return orig_mb(*a, **kw)

    def p_frame(*a, **kw):
        cnt["intra"] = 0
        out = orig_p(*a, **kw)
        eta = enc._eta
        rec["p"].append(dict(
            reorder=kw.get("reorder_cmds"), mmco=kw.get("mmco"),
            intra=cnt["intra"], wp=enc._wp,
            eta=None if eta is None else (float(eta.min()),
                                          float(eta.max()))))
        return out

    def mark(self, cur, mmco=None):
        orig_mark(self, cur, mmco)
        rec["dpb"].append(" ".join(
            f"{p.frame_num}" + (f"(LT{p.lt_idx})" if p.long_term else "")
            for p in self.pics))

    enc._encode_mb, enc._encode_p_frame = encode_mb, p_frame
    dpb_mod.Dpb.mark = mark

    def restore():
        dpb_mod.Dpb.mark = orig_mark

    return rec, restore


def _conf_words(kind: str, p: dict) -> str:
    """Phase 16's per-P-picture fields for `kind`."""
    if kind == "ltr":
        return (f"; reordering {p['reorder'] or 'none'}, MMCO "
                f"{p['mmco'] or 'none (sliding window)'}")
    if kind == "wp":
        return "; luma weight/offset per reference " + " ".join(
            f"{w['w'][0]}/{w['o'][0]}" for w in p["wp"])
    if kind == "perc":
        return f"; eta {p['eta'][0]:.4f}..{p['eta'][1]:.4f}"
    return f"; intra MBs {p['intra']} (11 forced by the refresh)"


def phase_h264_conf(kind: str, device: str = "cuda") -> int:
    """Phase 16a-d (h264-ltr, h264-wp, h264-perc, h264-loss): the host
    H.264 coder with the options of the reference's that the port
    carries since this slice, at JM's QCIF on bench.py's clip (seed 42),
    `H264_CONF_KW[kind]` on the card: per picture the stages of
    `_h264_instrument` (the saliency model on the card apart for perc),
    bytes, Y-PSNR, SAD launches (one per list0 entry and P picture), the
    DPB after the picture and the kind's own fields (`_conf_words`); the
    port's H264Decoder gives the encoder's pictures; the stream is the
    JAX package's (H264_CONF_SHA1, scripts/jax_reference_sha1.py
    --h264-<kind>).  ltr: `analyze.analyze` finds the long-term IDR, the
    reordering and the MMCO commands on the slices the encoder wrote them
    to.  wp: every P slice carries a pred_weight_table.  loss: every P
    picture holds at least the 11 forced intra MBs; the stream goes
    through `h264_lossy` (SEI, RTP, the reference's loss) and both
    concealment modes must give the JAX decoders' `concealed` lists and
    pictures (H264_LOSS_JAX).  Returns the SAD launches."""
    from video_codecs_tpu_torch.models.h264 import inter_codec as h264
    from video_codecs_tpu_torch.models.h264 import sei as h264_sei
    from video_codecs_tpu_torch.tools import analyze, rtp
    tag = f"h264-{kind}"
    kw, n = H264_CONF_KW[kind], H264_CONF_PICTURES[kind]
    frames = h264_conf_clip(kind, JM_W, JM_H)
    print(f"[{tag}] the host H.264 coder (H264Encoder) at {JM_W}x{JM_H}, "
          f"{n} pictures of bench.py's clip (seed 42"
          f"{', faded by 1 - 0.12 i' if kind == 'wp' else ''}): "
          f"{', '.join(f'{k}={v}' for k, v in kw.items())}; card {CARD}")
    enc = h264.H264Encoder(JM_W, JM_H, device=device, **kw)
    rec, restore_rec = _conf_recorder(enc)
    log, restore = _h264_instrument(enc)
    ss.sad_surface.launches = 0
    t0 = time.perf_counter()
    try:
        stream, recons = enc.encode_sequence(frames)
    finally:
        restore()
        restore_rec()
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    check(len(log) == n and len(rec["p"]) == n - 1,
          f"[{tag}] {len(log)} pictures coded, want {n}")
    want = 0
    for i, e in enumerate(log):
        p = psnr(frames[i][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"[{tag}] implausible Y-PSNR {p}")
        want += e["refs"]
        check(e["launches"] == e["refs"],
              f"[{tag}] picture {i}: {e['launches']} SAD-kernel launches, "
              f"want 1 per list0 entry ({e['refs']})")
        extra = _conf_words(kind, rec["p"][i - 1]) if i else ""
        print(f"[{tag}] {e['kind']}{i} ({e['refs']} references): "
              f"{_h264_stages(e)}; {len(e['rbsp'])} bytes, Y-PSNR "
              f"{p:.2f} dB; SAD-kernel launches {e['launches']}; DPB after "
              f"it {rec['dpb'][i]}{extra}")
    check(launches == want == H264_CONF_LAUNCHES[kind],
          f"[{tag}] {launches} SAD-kernel launches, want "
          f"{H264_CONF_LAUNCHES[kind]} (the list0 lengths)")
    rows = analyze.analyze(stream)
    slices = [r for r in rows if r["type"] in (1, 5)]
    if kind == "ltr":
        idr = analyze.analyze(stream, verbose=True)[2]
        check(idr["fields"]["dec_ref_pic_marking"].get(
            "long_term_reference") == 1,
            f"[{tag}] the IDR is not marked long-term: {idr}")
        got = [("reorder_l0" in r, "mmco" in r) for r in slices[1:]]
        made = [(bool(q["reorder"]), bool(q["mmco"])) for q in rec["p"]]
        check(got == made and any(m for _, m in made),
              f"[{tag}] analyze finds reordering / MMCO on {got}, the "
              f"encoder wrote them on {made}")
        print(f"[{tag}] analyze.analyze: long_term_reference_flag 1 on the "
              f"IDR; reordering on P pictures "
              f"{[i + 1 for i, g in enumerate(got) if g[0]]}, MMCO on "
              f"{[i + 1 for i, g in enumerate(got) if g[1]]}, where the "
              "encoder wrote them")
    if kind == "wp":
        check(all(r.get("wp") for r in slices[1:]) and
              all(q["wp"] for q in rec["p"]),
              f"[{tag}] a P slice without a pred_weight_table")
    if kind == "loss":
        intra = [q["intra"] for q in rec["p"]]
        check(all(k_ >= 11 for k_ in intra),
              f"[{tag}] intra MBs per P picture {intra}, want at least "
              "the 11 of the refresh")
    sha = hashlib.sha1(stream).hexdigest()
    t0 = time.perf_counter()
    got = H264Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    check(len(got) == n, f"[{tag}] H264Decoder: {len(got)} pictures")
    for k_, (g, r) in enumerate(zip(got, recons)):
        for c in range(3):
            check(np.array_equal(np.asarray(g[c]), np.asarray(r[c])),
                  f"[{tag}] H264Decoder picture {k_} plane {c} != the "
                  "encoder's")
    y_psnr = np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)])
    print(f"[{tag}] {len(stream)} bytes, mean Y-PSNR {y_psnr:.2f} dB, "
          f"encode {t_enc:.2f} s ({n / t_enc:.3f} fps); SAD-kernel "
          f"launches {launches}; SHA-1 {sha}; the port's H264Decoder gives "
          f"the encoder's pictures ({t_dec:.2f} s)")
    ref_bytes, ref_sha = H264_CONF_SHA1[kind]
    print(f"[{tag}] the JAX package's stream for the same clip and "
          f"settings (scripts/jax_reference_sha1.py --h264-{kind}, CPU): "
          f"{ref_bytes} bytes SHA-1 {ref_sha}")
    check((len(stream), sha) == (ref_bytes, ref_sha),
          f"[{tag}] stream {len(stream)} bytes SHA-1 {sha}, the JAX "
          f"package's is {ref_bytes} bytes {ref_sha}")
    print(f"[{tag}] the stream is the JAX package's, byte for byte (SHA-1)")
    if kind == "loss":
        _h264_loss_decode(tag, stream, h264_sei, rtp, analyze)
    return launches


def _h264_loss_decode(tag: str, stream: bytes, h264_sei, rtp,
                      analyze) -> None:
    """[h264-loss]'s network and receivers: `h264_lossy` with the port's
    SEI and RTP modules, then H264Decoder(conceal=1) and (conceal=2) on
    what arrives; the bytes sent and received, the `concealed` lists and
    the pictures' SHA-1 must be the JAX package's (H264_LOSS_JAX)."""
    sent, lossy, n_sent, n_kept = h264_lossy(stream, h264_sei, rtp, JM_H)
    msgs = analyze.analyze(sent)[2]
    check(msgs["name"] == "SEI" and msgs["messages"] ==
          ["RecoveryPoint", "UserDataUnregistered"],
          f"[{tag}] analyze reads the SEI NAL as {msgs}")
    got_sent = (len(sent), hashlib.sha1(sent).hexdigest())
    got_lossy = (len(lossy), hashlib.sha1(lossy).hexdigest())
    print(f"[{tag}] sent {n_sent} RTP packets ({got_sent[0]} bytes, the "
          f"SEI NAL after the PPS: {', '.join(msgs['messages'])}), "
          f"{H264_LOSS_PERCENT} % loss after the first {H264_LOSS_KEEP}: "
          f"{n_kept} arrive ({got_lossy[0]} bytes)")
    check(got_sent == H264_LOSS_JAX["sent"] and
          got_lossy == H264_LOSS_JAX["lossy"],
          f"[{tag}] sent {got_sent}, received {got_lossy}; the JAX "
          f"package's {H264_LOSS_JAX['sent']}, {H264_LOSS_JAX['lossy']}")
    for mode in (1, 2):
        dec = H264Decoder(conceal=mode)
        t0 = time.perf_counter()
        pics = dec.decode(lossy)
        t = time.perf_counter() - t0
        sha = pictures_sha1(pics)
        want = H264_LOSS_JAX[mode]
        print(f"[{tag}] H264Decoder(conceal={mode}) "
              f"({'frame copy' if mode == 1 else 'motion copy'}): "
              f"{len(pics)} pictures, concealed {dec.concealed}, pictures "
              f"SHA-1 {sha} ({t:.2f} s); the JAX decoder's: concealed "
              f"{want[0]}, SHA-1 {want[1]}")
        check(len(pics) == H264_CONF_PICTURES["loss"] and dec.concealed and
              (dec.concealed, sha) == want,
              f"[{tag}] conceal={mode}: concealed {dec.concealed}, SHA-1 "
              f"{sha}; the JAX decoder's {want}")
    print(f"[{tag}] both concealment modes give the JAX decoders' "
          "pictures and concealed lists")


def phase_h264_conf_cuda_vs_cpu() -> None:
    """Phase 16e (h264-conf-cuda-vs-cpu): 16a-d's coders at 64x48 on the
    card and with device="cpu": byte-equal streams, the card's searches
    through the SAD kernel (one launch per list0 entry and P picture),
    the CPU's through its plain version (0)."""
    from video_codecs_tpu_torch.models.h264 import inter_codec as h264
    tag = "h264-conf-cuda-vs-cpu"
    words = []
    for kind in ("ltr", "wp", "perc", "loss"):
        frames = h264_conf_clip(kind, 64, 48)
        res = {}
        for dev in ("cuda", "cpu"):
            enc = h264.H264Encoder(64, 48, device=dev, **H264_CONF_KW[kind])
            lists = []
            orig = enc._card_stage

            def card_stage(y, refs, _orig=orig, _lists=lists):
                _lists.append(len(refs))
                return _orig(y, refs)

            enc._card_stage = card_stage
            ss.sad_surface.launches = 0
            t0 = time.perf_counter()
            stream, _ = enc.encode_sequence(frames)
            res[dev] = (stream, ss.sad_surface.launches, sum(lists),
                        time.perf_counter() - t0)
        (g, ng, kg, tg), (c, nc, kc, tc) = res["cuda"], res["cpu"]
        check(g == c, f"[{tag}] {kind}: the card's stream ({len(g)} bytes) "
                      f"!= the CPU's ({len(c)} bytes)")
        check(ng == kg == kc > 0 and nc == 0,
              f"[{tag}] {kind}: SAD-kernel launches card {ng}, CPU {nc} "
              f"(want {kg}, 0)")
        words.append(f"{kind} ({len(frames)} pictures) byte-equal "
                      f"({len(g)} bytes), SAD-kernel launches card {ng}, "
                      f"CPU 0, cuda {tg:.2f} s, cpu {tc:.2f} s")
    print(f"[{tag}] 64x48: {'; '.join(words)}")


def flat_cfg(w: int, h: int, reorder: int, sao: bool = False):
    """scripts/diag_ra_gap.py's settings of the flat CTB16 B engines: QP
    32, SBH, CTB = CU = TU 16, one merge candidate, no TMVP, deblocking
    and the MD5 hash SEI on (the HevcConfig defaults); SAO when asked."""
    return hevc_headers.HevcConfig(width=w, height=h, qp=HEVC_QP,
                                   reorder_pics=reorder,
                                   sign_data_hiding=True, sao=sao)


def flat_encoder(kind: str, w: int, h: int, device: str,
                 sao: bool = False):
    """The flat RA GOP-8 ("ra") or hierarchical-B ("hierb") engine at
    search range 64 with the pyramid ME, and its encode call."""
    if kind == "ra":
        enc = hevc_inter_dev.DeviceRandomAccessEncoder(
            flat_cfg(w, h, 3, sao), search_range=RA_SR, device=device)
        return enc, enc.encode_sequence_ra
    enc = hevc_inter_dev.DeviceHierarchicalBEncoder(
        flat_cfg(w, h, 1, sao), search_range=RA_SR, device=device)
    return enc, enc.encode_sequence_rab


def _flat_instrument(enc, sao: bool = False):
    """Time each picture of a flat B-engine encode: the device phase
    (`inter_dev._b_device_phase`: upload, encode_b_frame_dev, copy back,
    synchronised; the IDR's flat intra dispatch and copy back), the host
    phase (`_reconcile_b`, CABAC slice, hash SEI; the IDR's serializer),
    with SAO the decision (`_sao_timer`), and the SAD- and RDOQ-kernel
    launches; keep each picture's block grid.  The module functions are
    patched until restore() is called."""
    log, cur = [], {}
    timed = _timer(cur)
    mod = hevc_inter_dev

    keep = mod._b_device_phase, mod._reconcile_b
    mod._b_device_phase = timed("device", keep[0], sync=True)
    mod._reconcile_b = timed("host", keep[1])
    for name in ("_encode_b_slice", "_hash_sei"):
        setattr(enc, name, timed("host", getattr(enc, name)))
    orig_b = enc._encode_b_frame

    def b_frame(frame, poc, refs, is_anchor):
        cur.clear()
        t0 = time.perf_counter()
        nals, rec = orig_b(frame, poc, refs, is_anchor)
        log.append(dict(poc=poc, kind="P" if is_anchor else "B",
                        lists=len(refs), total=time.perf_counter() - t0,
                        nals=nals, rec=rec, info=cur["_reconcile_b"],
                        **_picture_fields(cur)))
        return nals, rec

    def idr(y, u, v, *a, **kw):
        torch.cuda.synchronize()
        n0 = ss.sad_surface.launches
        r0 = rdoq_ops.rdoq_dev.launches
        t0 = time.perf_counter()
        st = {k: t.cpu() for k, t in enc._dispatch(y, u, v).items()}
        t1 = time.perf_counter()
        nals, rec = enc.serialize_frame(st)
        t2 = time.perf_counter()
        log.append(dict(poc=0, kind="I", lists=0, device=t1 - t0,
                        host=t2 - t1, total=t2 - t0, nals=nals, rec=rec,
                        info=None, launches=ss.sad_surface.launches - n0,
                        rdoq=rdoq_ops.rdoq_dev.launches - r0))
        return nals, rec

    def restore():
        mod._b_device_phase, mod._reconcile_b = keep

    enc._encode_b_frame = b_frame
    if sao:
        _sao_timer(enc, cur)
        enc.encode_frame = _sao_idr(enc, log, cur, timed)
    else:
        enc.encode_frame = idr
    return log, restore


def phase_hevc_flat(kind: str, sao: bool = False) -> tuple[int, int, int]:
    """Phase 10 (hevc-flat-ra, hevc-hierb; hevc-flat-ra-sao with sao):
    the flat CTB16 B engines at 1920x1072 on the card, decoded by the
    port's GeneralDecoder and held to the JAX package's stream (with SAO
    to every hash OK: the JAX package's SHA-1 would take hours of its
    host SAO decision; the CPU tests and flat-ra-cuda-vs-cpu hold the
    SAO stream to the JAX package's).  Returns the SAD-, RDOQ- and
    SAO-kernel launches of the encode."""
    w, h = HEVC_W, HEVC_H
    tag = ("hevc-flat-ra" if kind == "ra" else "hevc-hierb") + \
        ("-sao" if sao else "")
    frames = synth_clip(w, h, RA_PICTURES, seed=5)
    if kind == "ra" and sao:
        frames = frames[:FLAT_SAO_PICTURES]
        order = ("GOP-8 random access (DeviceRandomAccessEncoder) cut to "
                 f"{FLAT_SAO_PICTURES} pictures: IDR, anchor P at 4, B at "
                 "2 1 3")
    elif kind == "ra":
        order = ("GOP-8 random access (DeviceRandomAccessEncoder), 9 "
                 "pictures: IDR, anchor P at 8, B at 4 2 1 3 6 5 7")
    else:
        frames = frames[:HIERB_PICTURES]
        order = ("2-level hierarchical B (DeviceHierarchicalBEncoder), "
                 f"{HIERB_PICTURES} pictures: I0 P2 B1 P4 B3")
    print(f"[{tag}] {w}x{h} QP{HEVC_QP} {order}; flat CTB = CU = TU 16, "
          f"SR{RA_SR} pyramid ME, one merge candidate, intra blocks in "
          "the inter pictures, deblocking, full RDOQ in the inter "
          f"pictures, SBH, MD5 hash SEI{', SAO' if sao else ''}; card "
          f"{CARD}")
    enc, encode = flat_encoder(kind, w, h, "cuda", sao)
    log, restore = _flat_instrument(enc, sao)
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    sao_ops.sao_stats.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    SAO_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    try:
        stream, recons = encode(frames)
    finally:
        restore()
    t_enc = time.perf_counter() - t0
    launches = ss.sad_surface.launches
    rdoq_launches = rdoq_ops.rdoq_dev.launches
    sao_launches = sao_ops.sao_stats.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on the card")
    check(SAO_REF_CALLS["cuda"] == 0,
          f"the plain SAO statistics ran {SAO_REF_CALLS['cuda']} times on "
          "the card")
    check(sao_launches == (3 * len(frames) if sao else 0),
          f"{sao_launches} sao_stats launches in the run")
    want = 0
    for e in log:
        nbytes = sum(len(n) for n in e["nals"] if n)
        p = psnr(frames[e["poc"]][0], e["rec"][0])
        check(np.isfinite(p) and p > 25, f"implausible Y-PSNR {p}")
        if e["kind"] == "I":
            blocks = f"{(w // 16) * (h // 16)} intra (IDR)"
            check(e["launches"] == 0 and e["rdoq"] == 0,
                  f"POC 0: {e['launches']} SAD and {e['rdoq']} RDOQ "
                  "launches in the IDR (want 0 and 0)")
        else:
            cnt = dict(intra=0, skip=0, merge=0, amvp=0, bi=0)
            for row in e["info"]:
                for b in row:
                    cnt["intra" if b.pred_mode == 1 else "skip" if b.skip
                        else "merge" if b.merge else "amvp"] += 1
                    cnt["bi"] += int(b.pred_mode == 0 and b.inter_dir == 3)
            blocks = " / ".join(f"{k_} {v}" for k_, v in cnt.items())
            want += 3 * e["lists"]
            check(e["launches"] == 3 * e["lists"],
                  f"POC {e['poc']}: {e['launches']} SAD-kernel launches "
                  f"(want 3 per list, {e['lists']} lists)")
            check(e["rdoq"] == 3,
                  f"POC {e['poc']}: {e['rdoq']} RDOQ-kernel launches (want "
                  "3: TU16 luma, TU8 Cb, TU8 Cr)")
        other = e["total"] - e["device"] - e["host"] - e.get("sao", 0.0)
        sao_words = "; " + _sao_line(e) if sao else ""
        print(f"[{tag}] POC {e['poc']} ({e['kind']}): device phase "
              f"{e['device'] * 1e3:.1f} ms, host phase "
              f"{e['host'] * 1e3:.1f} ms, other {other * 1e3:.1f} ms; "
              f"{nbytes} bytes, Y-PSNR {p:.2f} dB; blocks {blocks}; "
              f"SAD-kernel launches {e['launches']}, RDOQ-kernel launches "
              f"{e['rdoq']}{sao_words}")
    n_inter = len(frames) - 1
    want_n = 18 if kind == "hierb" else 21 if sao else 45
    check(launches == want == want_n,
          f"{launches} SAD-kernel launches in the run, want {want}")
    check(rdoq_launches == 3 * n_inter,
          f"{rdoq_launches} RDOQ-kernel launches, want {3 * n_inter}")
    kbps = len(stream) * 8 * 30 / len(frames) / 1000
    sha = hashlib.sha1(stream).hexdigest()
    y_psnr = np.mean([psnr(f[0], r[0]) for f, r in zip(frames, recons)])
    print(f"[{tag}] {len(stream)} bytes, {kbps:.1f} kbps at 30 fps, mean "
          f"Y-PSNR {y_psnr:.3f} dB, encode {t_enc:.2f} s "
          f"({len(frames) / t_enc:.3f} fps); SAD-kernel launches {launches},"
          f" RDOQ-kernel launches {rdoq_launches} (the plain version 0 "
          f"times); SHA-1 {sha}")
    if sao:
        print(f"[{tag}] {_sao_summary(log, sao_launches)}; no JAX SHA-1 "
              "at this size (see the docstring)")
    else:
        ref_bytes, ref_sha = ((FLAT_RA_BYTES, FLAT_RA_SHA1) if kind == "ra"
                              else (HIERB_BYTES, HIERB_SHA1))
        check((len(stream), sha) == (ref_bytes, ref_sha),
              f"{tag} stream {len(stream)} bytes SHA-1 {sha}, the JAX "
              f"package's is {ref_bytes} bytes {ref_sha}")
        print(f"[{tag}] the stream is the JAX package's, byte for byte "
              "(SHA-1)")
    t0 = time.perf_counter()
    dec = hevc_decoder.GeneralDecoder()
    out = dec.decode(stream)
    t_dec = time.perf_counter() - t0
    check(dec.hash_status == [True] * len(frames),
          f"picture hash SEI mismatch: {dec.hash_status}")
    check(len(out) == len(frames), "decoder returned a wrong picture count")
    for i, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            check(np.array_equal(np.asarray(r[c]), np.asarray(o[c])),
                  f"decoded picture {i} plane {c} != encoder recon")
    print(f"[{tag}] the port's GeneralDecoder: hash SEI OK on all "
          f"{len(frames)} pictures, pictures equal the encoder's, "
          f"{t_dec:.2f} s")
    return launches, rdoq_launches, sao_launches


def phase_flat_ra_cuda_vs_cpu(sao: bool = False) -> None:
    """Phase 10 (flat-ra-cuda-vs-cpu): the flat RA GOP-8 at 96x64 over 9
    pictures on the card and on the CPU: byte-equal streams, the card's
    through the RDOQ kernel (and with SAO the SAO-statistics kernel at
    CTB 16 and 8, a partial strip at chroma's 6 CTBs), the CPU's through
    their plain versions."""
    w, h, n = 96, 64, 9
    frames = synth_clip(w, h, n, seed=17)
    res, routes = {}, {}
    for dev in ("cuda", "cpu"):
        enc, encode = flat_encoder("ra", w, h, dev, sao)
        k0 = sao_ops.sao_stats.launches
        g0, c0 = SAO_REF_CALLS["cuda"], SAO_REF_CALLS["cpu"]
        t0 = time.perf_counter()
        stream, *routes[dev] = rdoq_routes(lambda: encode(frames)[0])
        res[dev] = (stream, time.perf_counter() - t0)
        routes[dev].append((sao_ops.sao_stats.launches - k0,
                            SAO_REF_CALLS["cuda"] - g0,
                            SAO_REF_CALLS["cpu"] - c0))
    (g, tg), (c, tc) = res["cuda"], res["cpu"]
    routed = check_rdoq_routes("flat RA 96x64", routes["cuda"][:3],
                               routes["cpu"][:3])
    tag = "flat-ra-cuda-vs-cpu" + ("-sao" if sao else "")
    if sao:
        kc, rc_, _ = routes["cuda"][3]
        kp, _, rp = routes["cpu"][3]
        check(kc == 3 * n and rc_ == 0 and kp == 0 and rp == 3 * n,
              f"{tag}: SAO kernel {kc} launches and plain {rc_} calls on "
              f"the card, {kp} and {rp} on the CPU (want {3 * n}, 0, 0, "
              f"{3 * n})")
        routed += (f"; SAO kernel {kc} launches on the card, plain version "
                   f"{rp} calls on the CPU")
    check(g == c, f"{tag}: card and CPU streams differ ({len(g)} / "
                  f"{len(c)} bytes)")
    dec = hevc_decoder.GeneralDecoder()
    dec.decode(g)
    check(dec.hash_status == [True] * n, f"{tag}: hash mismatch")
    print(f"[{tag}] 96x64, 9 pictures{', SAO' if sao else ''}: streams "
          f"byte-equal ({len(g)} bytes), hash OK; {routed}; cuda "
          f"{tg:.2f} s, cpu {tc:.2f} s")


def decode_check(kind: str, stream: bytes) -> tuple:
    """Decode an all-intra stream with the port's GeneralDecoder
    ("general"), IntraDecoder ("intra") or QuadtreeIntraDecoder ("qt"):
    (hash_status, SHA-1 of the pictures, seconds).  `task_tiles_wpp`
    runs it in processes of its own beside the card's encodes (host work
    only)."""
    dec = {"general": hevc_decoder.GeneralDecoder,
           "intra": hevc_intra_codec.IntraDecoder,
           "qt": quadtree_codec.QuadtreeIntraDecoder}[kind]()
    t0 = time.perf_counter()
    pics = dec.decode(stream)
    return list(dec.hash_status), pictures_sha1(pics), \
        time.perf_counter() - t0


def submit_decodes(pool, stream: bytes) -> dict:
    """An all-intra stream's pictures are independent: submit each
    picture (the parameter sets, its slice and its hash SEI) to `pool`
    for the port's GeneralDecoder and IntraDecoder; returns {kind: [one
    future of decode_check a picture]}."""
    nals = hevc_bs.split_annexb(stream)
    pics = [hevc_bs.annexb(nals[:3] + nals[k:k + 2])
            for k in range(3, len(nals), 2)]
    return {kind: [pool.submit(decode_check, kind, p) for p in pics]
            for kind in ("general", "intra")}


def check_decodes(tag: str, futs: dict, recons, n: int) -> str:
    """Every decode of futs ({kind: futures of decode_check, a picture
    each}) reports its hash OK and the encoder's picture; returns each
    decoder's seconds, summed over the pictures."""
    words = []
    for kind, picture_futs in futs.items():
        check(len(picture_futs) == n, f"[{tag}] {len(picture_futs)} "
                                      f"pictures, not {n}")
        secs = 0.0
        for rec, fut in zip(recons, picture_futs):
            status, sha, t = fut.result()
            secs += t
            check(status == [True],
                  f"[{tag}] the port's {kind} decoder: hash OK {status}")
            check(sha == pictures_sha1([rec]), f"[{tag}] the port's {kind} "
                  "decoder's pictures are not the encoder's")
        words.append(f"{kind} {secs:.2f} s")
    return ", ".join(words)


def _timed(obj, name: str, sink: list, sync: bool = False):
    """Wrap obj.name so that each call appends its seconds to sink (the
    card synchronised before and after with `sync`); returns a function
    that restores the original."""
    orig = getattr(obj, name)

    def wrapped(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapped)
    return lambda: setattr(obj, name, orig)


def untiled_ms(y, u, v, cfg) -> float:
    """Device ms of one picture through the untiled flat CTB16 encoder
    (`encoder_dev.encode_frame`, tile_columns 1), as [hevc-tiles] times
    the tile batch (`tiles.encode_tiles_dev`): the mode sweep, the
    wavefront (252 diagonals at 1920x1072) and the deblock, synchronised,
    without the upload and the copy back."""
    bw, bh = cfg.width // 16, cfg.height // 16
    with torch.inference_mode():
        planes = [to_device(np.asarray(p, np.uint8), "cuda")
                  for p in (y, u, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encoder_dev.encode_frame(*planes, cfg.qp, bw, bh)
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def phase_hevc_tiles(pool, wpp: bool = False) -> tuple:
    """Phase 17a/b (`task_tiles_wpp`): the all-intra CTB16 coder at 1920x1072 on
    TILES_PICTURES pictures of synth_clip(1920, 1072, 3, seed=5)
    (`tiles_cfg`: QP 32, rdoq off, deblocking and the hash SEI on).
    [hevc-tiles]: `parallel.tiles.encode_sequence_tiles` with 4 uniform
    tile columns of 30 CTBs: the columns stacked as one batch, 162
    diagonals of 4 tiles' blocks where the untiled picture has 252; per
    picture the tile batch's device ms (`tiles.encode_tiles_dev`: the
    sweep, the wavefront and the deblock of the assembled picture,
    synchronised, without the upload and the copy back), the host
    ms (the Python slice writer with its 4 substreams, the hash SEI) and,
    before the decodes start, the same pictures' device ms untiled
    (`untiled_ms`); `phase_tiles_untiled` prints them side by side and
    holds `IntraEncoder(cfg).encode_sequence` on the card to the same
    bytes.
    [hevc-wpp] (`wpp`): `IntraEncoder` with WPP on the card (the
    device encoder, then the WPP slice writer: one substream per CTB
    row); per picture device ms (`_dispatch`, the upload included) and
    host ms.  Each stream's SHA-1 is the JAX
    package's (TILES_SHA1 / WPP_SHA1); the port's GeneralDecoder and
    IntraDecoder decode it in `pool`'s processes (hash OK for every
    picture, the encoder's pictures).  Returns (the decodes' futures, the
    recons, (the clip, the stream, the device seconds a picture))."""
    w, h, n = HEVC_W, HEVC_H, TILES_PICTURES
    tag = "hevc-wpp" if wpp else "hevc-tiles"
    frames = synth_clip(w, h, n, seed=5)
    cfg = tiles_cfg(w, h, 1, True) if wpp else tiles_cfg(w, h)
    bw, bh = w // 16, h // 16
    tbw = bw // TILE_COLUMNS
    dev_s, host_s = [], []
    ic = hevc_intra_codec.IntraEncoder
    undo = [_timed(ic, "_encode_slice", host_s),
            _timed(ic, "_hash_sei", host_s)]
    if wpp:
        undo.append(_timed(ic, "_dispatch", dev_s, sync=True))
    else:
        undo.append(_timed(tiles, "encode_tiles_dev", dev_s, sync=True))
    t0 = time.perf_counter()
    try:
        if wpp:
            stream, recons = ic(cfg).encode_sequence(frames)
        else:
            stream, recons = tiles.encode_sequence_tiles(cfg, frames)
    finally:
        for f in undo:
            f()
    t_enc = time.perf_counter() - t0
    # the untiled times before the decodes load the host, as the tile
    # batch's were taken
    untiled = [] if wpp else [untiled_ms(*f, cfg) for f in frames]
    futs = submit_decodes(pool, stream)
    sha = hashlib.sha1(stream).hexdigest()
    want = (WPP_BYTES, WPP_SHA1) if wpp else (TILES_BYTES, TILES_SHA1)
    check((len(stream), sha) == want,
          f"[{tag}] {len(stream)} bytes, SHA-1 {sha}: not the JAX "
          f"package's {want}")
    for i in range(n):
        print(f"[{tag}] POC {i}: device {1e3 * dev_s[i]:.1f} ms, host "
              f"{1e3 * (host_s[2 * i] + host_s[2 * i + 1]):.1f} ms (slice "
              f"writer {1e3 * host_s[2 * i]:.1f}, hash SEI "
              f"{1e3 * host_s[2 * i + 1]:.1f})")
    what = (f"WPP ({bh} substreams a picture)" if wpp else
            f"{TILE_COLUMNS} tile columns of {tbw} CTBs")
    entry = ("IntraEncoder.encode_sequence" if wpp
             else "encode_sequence_tiles")
    print(f"[{tag}] {w}x{h}, {n} pictures, {what}: {len(stream)} bytes, "
          f"SHA-1 {sha[:12]}... = the JAX package's; {entry} "
          f"{t_enc:.2f} s")
    return futs, recons, (frames, stream, dev_s, untiled)


def phase_tiles_untiled(frames, stream, dev_s, untiled) -> None:
    """The rest of [hevc-tiles], while the decoders run: each picture's
    device ms untiled (`untiled_ms`, 252 diagonals, taken before the
    decodes started) beside the tile batch's (162 diagonals of 4 tiles'
    blocks), and `IntraEncoder(cfg).encode_sequence` on the card, whose
    device route takes the tile batch: the same bytes."""
    w, h = HEVC_W, HEVC_H
    cfg = tiles_cfg(w, h)
    bw, bh = w // 16, h // 16
    tbw = bw // TILE_COLUMNS
    steps_t, steps_f = tbw + 2 * (bh - 1), bw + 2 * (bh - 1)
    check((steps_t, steps_f) == (162, 252),
          f"[hevc-tiles] diagonals {steps_t} / {steps_f}")
    for i in range(len(frames)):
        print(f"[hevc-tiles] POC {i}: tile batch {1e3 * dev_s[i]:.1f} ms of "
              f"device time ({steps_t} diagonals), the same picture "
              f"untiled {untiled[i]:.1f} ms ({steps_f})")
    t0 = time.perf_counter()
    again, _ = hevc_intra_codec.IntraEncoder(cfg).encode_sequence(frames)
    check(again == stream, "[hevc-tiles] IntraEncoder(cfg).encode_sequence "
                           "!= parallel.tiles' stream")
    print(f"[hevc-tiles] IntraEncoder(cfg).encode_sequence on the card: the "
          f"same bytes, {time.perf_counter() - t0:.2f} s")


def phase_cli_ai_tiles() -> int:
    """Phase cli-ai-tiles: the port's encoder CLI on HM's all-intra
    structure (`hm_cli_files(d, "ai", ..., tile_columns=2)`:
    IntraPeriod 1, RDOQ 1, SAO 1, SignHideFlag 1, NumTileColumnsMinus1
    1) over CLI_AI_PICTURES pictures of bench_synth_clip(832, 480, 3), in
    this process: it builds `IntraEncoder` on the card, whose host CTB
    loop codes the two tile columns one after the other with the full
    RDOQ on the host, deblocks on the card and decides SAO from the SAO
    kernel's statistics (3 launches a picture, 9 in all).  Per picture
    the host loop (with its deblock), the SAO decision and the slice
    writer; CLI_AI_TILES_SHA1; the port's decoder CLI "(OK)" for 3 of 3
    and its output file the recon file.  Returns the SAO launches."""
    w, h, n = CLI_W, CLI_H, CLI_AI_PICTURES
    tag = "cli-ai-tiles"
    frames = bench_synth_clip(w, h, n)
    d = BUILD_DIR / "cli_ai_tiles"
    d.mkdir(parents=True, exist_ok=True)
    argv = hm_cli_files(d, "ai", frames, w, h,
                        tile_columns=CLI_AI_TILE_COLUMNS)
    ic = hevc_intra_codec.IntraEncoder
    loop_s, sao_s, cabac_s = [], [], []
    undo = [_timed(ic, "_encode_frame_host", loop_s, sync=True),
            _timed(ic, "_sao_decide_apply", sao_s, sync=True),
            _timed(ic, "_encode_slice", cabac_s)]
    try:
        out, err, t_enc, sad_n, sao_n, rdoq_n, rdoq_ref, sao_ref = \
            _cli_launches(encoder_app.main, argv)
    finally:
        for f in undo:
            f()
    for ln in out.strip().splitlines():
        print(f"[{tag}] {ln}")
    check(sao_n == 3 * n and sao_ref == 0 and sad_n == 0 and rdoq_n == 0
          and rdoq_ref == 0,
          f"[{tag}] sao_stats launches {sao_n} (want {3 * n}), plain SAO "
          f"{sao_ref}, SAD {sad_n}, rdoq_dev {rdoq_n}, plain RDOQ "
          f"{rdoq_ref}")
    stream = (d / "out.bin").read_bytes()
    sha = hashlib.sha1(stream).hexdigest()
    check((len(stream), sha) == (CLI_AI_TILES_BYTES, CLI_AI_TILES_SHA1),
          f"[{tag}] {len(stream)} bytes, SHA-1 {sha}: not the JAX "
          "package's")
    for i in range(n):
        print(f"[{tag}] POC {i}: host CTB loop (full RDOQ, the deblock on "
              f"the card) {1e3 * loop_s[i]:.1f} ms, SAO decision "
              f"{1e3 * sao_s[i]:.1f} ms, slice writer "
              f"{1e3 * cabac_s[i]:.1f} ms")
    t_app = _decoder_app(tag, d, n)
    print(f"[{tag}] HM's all-intra structure with {CLI_AI_TILE_COLUMNS} "
          f"tile columns through the port's encoder CLI: {w}x{h}, {n} "
          f"pictures, {len(stream)} bytes, SHA-1 {sha[:12]}... = the JAX "
          f"package's; encoder_app.main {t_enc:.2f} s; sao_stats launches "
          f"{sao_n}, SAD 0, rdoq_dev 0; the port's decoder_app: (OK) for "
          f"{n} of {n}, its output file equals the recon file, "
          f"{t_app:.2f} s; {len(err.splitlines())} warnings")
    return sao_n


def phase_hevc_qt_host() -> None:
    """Phase hevc-qt-host: `QuadtreeIntraEncoder`, the host quadtree RD
    encoder, on the card (`qt_host_cfg`: CTB 32, min CU 8, QP 32, SBH,
    the full RDOQ on the host) over one 192x128 picture of
    synth_clip(192, 128, 1, seed=5): each node's 35-mode prediction on
    the card (`_best_mode`, one call and one copy back), the deblock on
    the card; QT_HOST_SHA1; the port's GeneralDecoder and
    QuadtreeIntraDecoder hash OK with the encoder's picture."""
    w, h = QT_HOST_W, QT_HOST_H
    tag = "hevc-qt-host"
    enc = quadtree_codec.QuadtreeIntraEncoder(qt_host_cfg(w, h))
    modes_s = []
    undo = _timed(enc, "_best_mode", modes_s, sync=True)
    t0 = time.perf_counter()
    try:
        nals, rec = enc.encode_frame(*synth_clip(w, h, 1, seed=5)[0])
    finally:
        undo()
    t_enc = time.perf_counter() - t0
    stream = hevc_bs.annexb(enc.stream_headers() + nals)
    sha = hashlib.sha1(stream).hexdigest()
    check((len(stream), sha) == (QT_HOST_BYTES, QT_HOST_SHA1),
          f"[{tag}] {len(stream)} bytes, SHA-1 {sha}: not the JAX "
          "package's")
    words = []
    for kind in ("general", "qt"):
        status, pic_sha, secs = decode_check(kind, stream)
        check(status == [True] and pic_sha == pictures_sha1([rec]),
              f"[{tag}] the port's {kind} decoder: hash {status}, "
              "pictures the encoder's: " + str(pic_sha ==
                                                pictures_sha1([rec])))
        words.append(f"{kind} {secs:.2f} s")
    print(f"[{tag}] QuadtreeIntraEncoder on the card, {w}x{h} at CTB 32: "
          f"{len(stream)} bytes, SHA-1 {sha[:12]}... = the JAX package's; "
          f"encode_frame {t_enc:.2f} s, of it {len(modes_s)} mode sweeps "
          f"on the card {sum(modes_s):.2f} s; the port's decoders hash OK "
          f"1 of 1 with the encoder's picture ({', '.join(words)})")


# ---- phase 18: the tile-sharded RA engine, the dry run, the tools ------

# The JAX package's streams for phase 18 (scripts/jax_reference_sha1.py,
# CPU): --tiled-ra (the dry run's TiledRefQt over the JAX encoder on
# synth_clip(1920, 1072, 9, seed=5) in TILED_COLUMNS columns, repaired as
# graft_entry.py says) and --dryrun (dryrun_multichip(4)'s decomposition).
TILED_RA_BYTES = 623416
TILED_RA_SHA1 = "be9e8712e042606fe090ee28bd71ddd5664f437b"
DRYRUN_BYTES = 61388
DRYRUN_SHA1 = "2d401f4bc21da44c96cca85f743fefe89517ac3e"
# The JAX package's experiment CLI on experiment_yuv's file, per codec:
# (QP, kbps, Y-PSNR) as its table prints them (--experiment; ldp with the
# spec AMVP list, ROADMAP queue 3 fault 0).
EXPERIMENT_JAX = {
    "intra": [("28", "26173.76", "33.6646"), ("32", "17294.00", "29.7532"),
              ("36", "9045.12", "26.3436"), ("40", "3216.32", "24.3451")],
    "ldp": [("28", "16553.84", "33.7336"), ("32", "11125.28", "29.7969"),
            ("36", "6524.80", "26.3825"), ("40", "2558.64", "24.3950")],
}
# Kernel calls per tile column and B picture of the tiled engine with the
# CU8 tree: (n, r) -> SAD launches, (log2, luma) -> RDOQ launches; an
# anchor P picture has one list: half the SAD launches, the same RDOQ.
TILED_SAD_CALLS = {(4, 2): 2, (16, 3): 4, (2, 2): 2, (8, 3): 4}
TILED_RDOQ_CALLS = {(4, True): 2, (3, False): 4, (3, True): 2,
                    (2, False): 4}


def tiled_cfg():
    from video_codecs_tpu_torch import graft_entry
    return graft_entry.dryrun_cfg(HEVC_W, HEVC_H, HEVC_QP)


def tiled_slab(plane: np.ndarray, scale: int = 1) -> np.ndarray:
    """Tile column 0's halo-padded slab of a picture plane, as
    `sharded.TiledRefQt` gathers it (clamped column indices)."""
    lo, hi = -TILED_HALO // scale, (TILED_WT + TILED_HALO) // scale
    return np.ascontiguousarray(np.take(
        plane, np.clip(np.arange(lo, hi), 0, plane.shape[1] - 1), axis=1))


def phase_tiled_kernels() -> dict:
    """Phase 18a (first part, stage 1): the SAD and RDOQ kernels against
    their plain versions at the tile slab's shapes (a 544x1072 column of
    1080p: 34 x 67 blocks of 16, 68 x 134 of 8), timed beside their bounds;
    the per-picture sums are per tiled B picture (TILED_COLUMNS columns,
    the pyramid of both trees per list, the CU8 tree's RDOQ)."""
    tag = "tiled-kernels"
    sw = TILED_WT + 2 * TILED_HALO
    b16, b8 = (sw // 16) * (HEVC_H // 16), (sw // 8) * (HEVC_H // 8)
    rng = np.random.default_rng(2031)
    pic = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    rows = []
    for (n, r), calls in TILED_SAD_CALLS.items():
        b = b16 if n in (4, 16) else b8
        cur = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                            dtype=np.uint8)).cuda()
        win = torch.from_numpy(rng.integers(
            0, 256, (b, n + 2 * r, n + 2 * r), dtype=np.uint8)).cuda()
        got = ss.sad_surface(cur, win, n, r)
        torch.cuda.synchronize()
        err = int((got - ss.sad_surface_ref(cur, win, n, r)).abs().max())
        check(err == 0, f"[{tag}] SAD kernel != plain at n={n} B={b} r={r} "
                        f"(max abs err {err})")
        tm = sad_times(cur, win, n, r)
        bound, nbytes, ops = sad_bound(n, b, r)
        k = 2 * calls * TILED_COLUMNS
        add_kernel_ms(pic, k, tm["ms"], tm["note"], f"SAD n={n} r={r}")
        pic["plain_ms"] += k * tm["plain_ms"]
        pic["bytes"] += k * nbytes
        pic["ops"] += k * ops
        print(f"[{tag}] SAD n={n} B={b} r={r}: equal; kernel {kms(tm['ms'])}"
              f" (profiler{', ' + tm['note'] if tm['note'] else ''}), "
              f"{tm['event_ms']:.4f} ms a wrapper call (CUDA events); bound "
              f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G "
              f"ops), {of_bound(bound, tm['ms'])}; plain "
              f"{tm['plain_ms']:.3f} ms; torch.cdist "
              f"{tm['library_ms']:.3f} ms; {k} launches per tiled B picture")
        rows.append(dict(kernel="sad_surface", n=n, b=b, r=r, ms=tm["ms"],
                         plain_ms=tm["plain_ms"], bound_ms=bound,
                         library_ms=tm["library_ms"], max_abs_err=err))
    frames = synth_clip(HEVC_W, HEVC_H, 2, seed=5)
    qb = HEVC_QP + 2                                  # a B picture's QP
    for (log2, luma), calls in TILED_RDOQ_CALLS.items():
        c = 0 if luma else 1
        cur, ref = (tiled_slab(f[c], 1 if luma else 2) for f in
                    (frames[1], frames[0]))
        co = rdoq_coeffs(cur, ref, log2)
        what = (f"slab TU{1 << log2} {'luma' if luma else 'chroma'}")
        row = rdoq_row(tag, what, co, log2, luma, 0, True, qb)
        k = calls * TILED_COLUMNS
        add_kernel_ms(pic, k, row["ms"], row["note"], what)
        pic["plain_ms"] += k * row["plain_ms"]
        pic["bound_rdoq"] = pic.get("bound_rdoq", 0.0) + k * row["bound_ms"]
        rows.append(dict(kernel="rdoq_dev", **row))
        del co
    torch.cuda.empty_cache()
    sad_bound_ms = max(pic["bytes"] / PEAK_BYTES, pic["ops"] / PEAK_OPS) * 1e3
    print(f"[{tag}] per tiled 1080p B picture ({TILED_COLUMNS} columns: "
          f"{2 * sum(TILED_SAD_CALLS.values()) * TILED_COLUMNS} SAD and "
          f"{sum(TILED_RDOQ_CALLS.values()) * TILED_COLUMNS} RDOQ launches):"
          f" kernels {kms(pic['ms'])}, bound {sad_bound_ms:.4f} ms (SAD) + "
          f"{pic['bound_rdoq']:.4f} ms (RDOQ), plain {pic['plain_ms']:.1f} ms"
          f"{'; ' + pic['note'] if pic.get('note') else ''}")
    print(json.dumps({"tiled_ra_kernels": rows}))
    return pic


def decode_ra(stream: bytes) -> tuple:
    """Decode a random-access stream with the port's GeneralDecoder:
    (hash_status, each picture's SHA-1, seconds).  Stage 3 runs it in a
    process of its own beside the card's encodes (host work only)."""
    dec = hevc_decoder.GeneralDecoder()
    t0 = time.perf_counter()
    pics = dec.decode(stream)
    return list(dec.hash_status), [pictures_sha1([p]) for p in pics], \
        time.perf_counter() - t0


def _tiled_instrument(enc) -> list:
    """Per picture of an RA encode: the device phase (synchronised, the
    copy back included; the IDR's whole encode) and its SAD and RDOQ
    launches, appended to the returned log."""
    log = []

    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            n0, r0 = ss.sad_surface.launches, rdoq_ops.rdoq_dev.launches
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append(dict(kind=name, ms=(time.perf_counter() - t0) * 1e3,
                            sad=ss.sad_surface.launches - n0,
                            rdoq=rdoq_ops.rdoq_dev.launches - r0))
            return out
        return run

    enc.encode_frame = wrap("I", enc.encode_frame)
    enc._device_phase = wrap("B/P", enc._device_phase)
    orig = enc._encode_b_frame

    def b_frame(frame, poc, refs, is_anchor):
        out = orig(frame, poc, refs, is_anchor)
        log[-1].update(poc=poc, kind="P" if is_anchor else "B")
        return out

    enc._encode_b_frame = b_frame
    return log


def phase_tiled_ra(dpool) -> tuple:
    """Phase 18a (stage 3): the tile-sharded RA engine at 1920x1072 --
    `sharded.ShardedQt`, TILED_COLUMNS columns of TILED_WT with a halo of
    TILED_HALO, each column's halos copied from its neighbours, the dry
    run's encoder settings with the hash SEI -- on the card; then the
    untiled engine for the times.  The stream is the JAX package's
    (TILED_RA_SHA1); the port's GeneralDecoder, in a process of its own,
    gives every hash OK with the encoder's pictures; each B or P picture
    launches TILED_COLUMNS times the untiled picture's SAD and RDOQ
    kernels.  Returns the launches and the stream's SHA-1 (main holds
    them to `phase_tiled_ra_ref`'s)."""
    from video_codecs_tpu_torch.parallel import sharded
    from video_codecs_tpu_torch.tools import convert
    tag = "tiled-ra"
    w, h, n = HEVC_W, HEVC_H, RA_PICTURES
    frames = synth_clip(w, h, n, seed=5)
    print(f"[{tag}] {w}x{h}, {n} pictures of the headline's clip in "
          f"{TILED_COLUMNS} tile columns of {TILED_WT} (halo {TILED_HALO}): "
          f"the dry run's engine (QP {HEVC_QP} GOP-8, SR{TILED_SR} pyramid, "
          "CU8 tree, merge 5, full RDOQ, SBH) with the MD5 hash SEI; card "
          + CARD)
    kw = dict(search_range=TILED_SR, tile_width=TILED_WT, halo=TILED_HALO,
              device="cuda")
    enc = sharded.ShardedQt(tiled_cfg(), **kw)
    log = _tiled_instrument(enc)
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    stream, recons = enc.encode_sequence_ra(frames)
    t_enc = time.perf_counter() - t0
    sad, rdoq = ss.sad_surface.launches, rdoq_ops.rdoq_dev.launches
    check(RDOQ_REF_CALLS["cuda"] == 0,
          f"[{tag}] the plain RDOQ ran {RDOQ_REF_CALLS['cuda']} times on "
          "the card")
    dec = dpool.submit(decode_ra, stream)
    sha = hashlib.sha1(stream).hexdigest()
    print(f"[{tag}] ShardedQt on {[str(d) for d in enc.devices]}: "
          f"{len(stream)} bytes, SHA-1 {sha}, encode {t_enc:.2f} s; SAD "
          f"launches {sad}, RDOQ {rdoq} (the plain version 0 times)")
    mono = inter_qt.QtDeviceRandomAccessEncoder(
        tiled_cfg(), search_range=TILED_SR, device="cuda")
    mlog = _tiled_instrument(mono)
    mstream = mono.encode_sequence_ra(frames)[0]
    for e, m in zip(log, mlog):
        check(e["kind"] == m["kind"], f"[{tag}] picture order differs")
        k = 1 if e["kind"] == "I" else TILED_COLUMNS
        check(e["sad"] == k * m["sad"] and e["rdoq"] == k * m["rdoq"],
              f"[{tag}] POC {e.get('poc', 0)}: SAD {e['sad']} RDOQ "
              f"{e['rdoq']} launches, want {k} x the untiled {m['sad']} / "
              f"{m['rdoq']}")
        what = ("the IDR's quadtree encode (untiled in both runs)"
                if e["kind"] == "I" else "device phase")
        print(f"[{tag}] POC {e.get('poc', 0)} ({e['kind']}): {what} "
              f"{e['ms']:.1f} ms tiled against {m['ms']:.1f} ms untiled "
              f"(ratio {e['ms'] / m['ms']:.2f}); launches SAD {e['sad']} / "
              f"RDOQ {e['rdoq']} = {k} x the untiled {m['sad']} / "
              f"{m['rdoq']}")
    print(f"[{tag}] the untiled engine's stream: {len(mstream)} bytes, the "
          f"tiled one's differs by {len(stream) - len(mstream):+d} bytes "
          "(float32 RD sums over other shapes; reported, not asserted)")
    count = convert.annexb_byte_count(stream)
    check(count["total"] + count["start_code"] == len(stream),
          f"[{tag}] annexb_byte_count {count} does not add up")
    print(f"[{tag}] annexb_byte_count: {count}")
    print(f"[{tag}] the JAX package's decomposition on the CPU "
          "(scripts/jax_reference_sha1.py --tiled-ra): "
          f"{TILED_RA_BYTES} bytes SHA-1 {TILED_RA_SHA1}")
    check((len(stream), sha) == (TILED_RA_BYTES, TILED_RA_SHA1),
          f"[{tag}] stream {len(stream)} bytes SHA-1 {sha}, the JAX "
          f"package's is {TILED_RA_BYTES} bytes {TILED_RA_SHA1}")
    status, shas, t_dec = dec.result()
    check(status == [True] * n, f"[{tag}] GeneralDecoder hash {status}")
    check(shas == [pictures_sha1([r]) for r in recons],
          f"[{tag}] the decoded pictures are not the encoder's")
    print(f"[{tag}] the stream is the JAX package's (SHA-1); the port's "
          f"GeneralDecoder: hash OK {n} of {n}, the encoder's pictures "
          f"({t_dec:.2f} s in its own process)")
    return sad, rdoq, sha


def phase_tiled_ra_ref() -> tuple:
    """Phase 18a's sequential decomposition (stage 2): `TiledRefQt` on the
    card, the columns one after another with their halos gathered, on
    [tiled-ra]'s clip and settings; its stream must be TILED_RA_SHA1, and
    main holds [tiled-ra]'s ShardedQt stream to it.  Returns its SAD and
    RDOQ launches and its stream's SHA-1."""
    from video_codecs_tpu_torch.parallel import sharded
    tag = "tiled-ra-ref"
    frames = synth_clip(HEVC_W, HEVC_H, RA_PICTURES, seed=5)
    enc = sharded.TiledRefQt(tiled_cfg(), search_range=TILED_SR,
                             tile_width=TILED_WT, halo=TILED_HALO,
                             device="cuda")
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    stream = enc.encode_sequence_ra(frames)[0]
    secs = time.perf_counter() - t0
    sad, rdoq = ss.sad_surface.launches, rdoq_ops.rdoq_dev.launches
    check(RDOQ_REF_CALLS["cuda"] == 0, f"[{tag}] the plain RDOQ ran")
    sha = hashlib.sha1(stream).hexdigest()
    check((len(stream), sha) == (TILED_RA_BYTES, TILED_RA_SHA1),
          f"[{tag}] stream {len(stream)} bytes SHA-1 {sha}, want "
          f"{TILED_RA_BYTES} bytes {TILED_RA_SHA1}")
    print(f"[{tag}] TiledRefQt (the {TILED_COLUMNS} columns one after "
          f"another, halos gathered) on [tiled-ra]'s clip: {len(stream)} "
          f"bytes, the JAX package's SHA-1, {secs:.2f} s beside the other "
          f"workers; SAD launches {sad}, RDOQ {rdoq}")
    return sad, rdoq, sha


def phase_dryrun() -> tuple[int, int]:
    """Phase 18b: `graft_entry.dryrun_multichip(4)` on the card (its
    columns all on it, or on the cards round-robin): its OK line and its
    stream the JAX package's decomposition's (DRYRUN_SHA1).  Returns its
    SAD and RDOQ launches (three encodes of 9 pictures at 384x96)."""
    from video_codecs_tpu_torch import graft_entry
    tag = "dryrun"
    ss.sad_surface.launches = 0
    rdoq_ops.rdoq_dev.launches = 0
    RDOQ_REF_CALLS["cuda"] = 0
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(4)
    secs = time.perf_counter() - t0
    sad, rdoq = ss.sad_surface.launches, rdoq_ops.rdoq_dev.launches
    check(out["line"].startswith("dryrun_multichip OK:"),
          f"[{tag}] {out['line']}")
    check(RDOQ_REF_CALLS["cuda"] == 0, f"[{tag}] the plain RDOQ ran")
    sha = hashlib.sha1(out["stream"]).hexdigest()
    check((len(out["stream"]), sha) == (DRYRUN_BYTES, DRYRUN_SHA1),
          f"[{tag}] stream {len(out['stream'])} bytes SHA-1 {sha}, the JAX "
          f"package's decomposition's is {DRYRUN_BYTES} bytes {DRYRUN_SHA1}")
    print(f"[{tag}] {secs:.2f} s; SAD launches {sad}, RDOQ {rdoq}; the "
          f"stream ({len(out['stream'])} bytes) is the JAX package's "
          "(scripts/jax_reference_sha1.py --dryrun, SHA-1)")
    return sad, rdoq


def _stdout_of(fn, *a) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


def phase_experiment() -> int:
    """Phase 18c: the experiment CLI (`tools/experiment.main`, in this
    process) on experiment_yuv's 832x480 file at EXPERIMENT_QPS, --codec
    intra (the flat intra device encoder) and --codec ldp (the host LD-P
    coder, one SAD launch per reference and P picture): each table's QP,
    kbps and Y-PSNR columns the JAX package's (EXPERIMENT_JAX), then the
    BD-rate and BD-PSNR of ldp against intra.  Returns the SAD launches."""
    from video_codecs_tpu_torch.tools import experiment
    tag = "experiment"
    d = BUILD_DIR / "experiment"
    d.mkdir(parents=True, exist_ok=True)
    path = experiment_yuv(d)
    pts, sad = {}, 0
    for codec in ("intra", "ldp"):
        ss.sad_surface.launches = 0
        t0 = time.perf_counter()
        text = _stdout_of(experiment.main, experiment_argv(path, codec))
        secs = time.perf_counter() - t0
        rows = [ln.split("\t") for ln in text.strip().splitlines()[2:]]
        want_sad = (0 if codec == "intra" else
                    (EXPERIMENT_PICTURES - 1) * len(rows))
        check(ss.sad_surface.launches == want_sad,
              f"[{tag}] {codec}: {ss.sad_surface.launches} SAD launches, "
              f"want {want_sad}")
        sad += ss.sad_surface.launches
        print(f"[{tag}] --codec {codec}, {EXPERIMENT_PICTURES} pictures, "
              f"{secs:.2f} s, SAD launches {ss.sad_surface.launches}:")
        print(text.rstrip())
        got = [tuple(r[:3]) for r in rows]
        check(got == EXPERIMENT_JAX[codec],
              f"[{tag}] {codec}: (QP, kbps, Y-PSNR) {got}, the JAX "
              f"package's {EXPERIMENT_JAX[codec]}")
        pts[codec] = [experiment.RDPoint(int(r[0]), float(r[1]),
                                         float(r[2]), float(r[3]),
                                         float(r[4])) for r in rows]
    cmp = experiment.compare(pts["intra"], pts["ldp"])
    print(f"[{tag}] both tables' QP, kbps and Y-PSNR are the JAX "
          "package's (scripts/jax_reference_sha1.py --experiment); ldp "
          f"against intra: BD-rate {cmp['bd_rate_pct']:.2f} %, BD-PSNR "
          f"{cmp['bd_psnr_db']:.3f} dB")
    return sad


def phase_trace_tools() -> int:
    """Phase 18d-e: [jm-main]'s encode (the JM CLI in this process) with
    `utils/trace.start()`: the stream is still JM_SHA1 and its encode
    trace equals the port's H264Decoder's decode trace line for line;
    `decoder_app --stats` on the stream; `annexb_byte_count` (its total
    plus the start codes is the stream's length), the leaky bucket over
    its per-picture bits (the parameter file read back), and
    `convert_bitdepth` 8 -> 10 -> 8 on its YUV file (the same bytes back).
    Returns the SAD launches of the traced encode."""
    from video_codecs_tpu_torch.tools import convert, jm_encoder_app, misc
    from video_codecs_tpu_torch.utils import trace
    tag = "trace-tools"
    d = BUILD_DIR / "jm_trace"
    d.mkdir(parents=True, exist_ok=True)
    argv = jm_cli_files(d, "main", bench_synth_clip(JM_W, JM_H,
                                                    JM_PICTURES))
    ss.sad_surface.launches = 0
    trace.start()
    try:
        _stdout_of(jm_encoder_app.main, argv)
    finally:
        enc_trace = trace.stop()
    sad = ss.sad_surface.launches
    stream = (d / "out.264").read_bytes()
    sha = hashlib.sha1(stream).hexdigest()
    check((len(stream), sha) == JM_SHA1["main"],
          f"[{tag}] traced stream {len(stream)} bytes SHA-1 {sha}, want "
          f"{JM_SHA1['main']}")
    trace.start()
    try:
        H264Decoder().decode(stream)
    finally:
        dec_trace = trace.stop()
    check(enc_trace == dec_trace and len(enc_trace) > 1000,
          f"[{tag}] encode trace ({len(enc_trace)} lines) != decode trace "
          f"({len(dec_trace)} lines)")
    kinds = sorted({ln.split()[0] for ln in enc_trace})
    print(f"[{tag}] [jm-main] with the trace on: the stream is still the "
          f"JAX CLI's (SHA-1), {sad} SAD launches; encode trace == decode "
          f"trace, {len(enc_trace)} lines of {kinds}")
    text = _stdout_of(decoder_app.main, ["-b", str(d / "out.264"),
                                         "--stats"])
    check("TOTAL" in text and f"{JM_PICTURES} pictures decoded" in text,
          f"[{tag}] decoder_app --stats: {text[-200:]}")
    print(f"[{tag}] decoder_app --stats on it:\n{text.rstrip()}")
    count = convert.annexb_byte_count(stream)
    check(count["total"] + count["start_code"] == len(stream),
          f"[{tag}] annexb_byte_count {count} does not add up")
    bits = [8 * len(nal) for nal in hevc_bs.split_annexb(stream)
            if nal[0] & 0x1F in (1, 5)]
    check(len(bits) == JM_PICTURES, f"[{tag}] {len(bits)} slices")
    params = misc.leaky_bucket_params(bits, 30.0)
    misc.write_leaky_bucket_file(d / "leaky.bin", params)
    check(misc.read_leaky_bucket_file(d / "leaky.bin") ==
          [tuple(p) for p in params], f"[{tag}] leaky-bucket file differs")
    src = (d / "in.yuv").read_bytes()
    ten = convert.convert_bitdepth(src, 8, 10)
    check(len(ten) == 2 * len(src) and
          convert.convert_bitdepth(ten, 10, 8) == src,
          f"[{tag}] 8 -> 10 -> 8 bits does not give the file back")
    print(f"[{tag}] annexb_byte_count {count}; leaky bucket (R, B, F) per "
          f"bucket over its {len(bits)} pictures' bits {bits}: {params} "
          f"(file read back equal); convert_bitdepth 8 -> 10 -> 8 on its "
          f"{len(src)}-byte YUV file gives the same bytes ({len(ten)} at "
          "10 bits)")
    return sad


def task_cli_ra() -> int:
    """cli-ra, then `decoder_app --stats` on its stream (the port routes
    it to the GeneralDecoder; the HEVC CabacDecoder hooks count the bins
    per context class) and its annexb_byte_count: cli-ra's SAD
    launches."""
    from video_codecs_tpu_torch.tools import convert
    launches = phase_cli_ra()
    path = BUILD_DIR / "cli_ra" / "out.bin"
    t0 = time.perf_counter()
    text = _stdout_of(decoder_app.main, ["-b", str(path), "--stats"])
    check(text.count("[(OK)]") == CLI_RA_PICTURES and "TOTAL" in text,
          f"[cli-ra-stats] decoder_app --stats: {text[-300:]}")
    stream = path.read_bytes()
    count = convert.annexb_byte_count(stream)
    check(count["total"] + count["start_code"] == len(stream),
          f"[cli-ra-stats] annexb_byte_count {count} does not add up")
    print(f"[cli-ra-stats] decoder_app --stats on [cli-ra]'s stream "
          f"({time.perf_counter() - t0:.2f} s):\n{text.rstrip()}\n"
          f"[cli-ra-stats] annexb_byte_count {count}")
    return launches


def jax_modules() -> list:
    """The modules of the JAX package or of JAX this process imported."""
    return [m for m in sys.modules
            if m.split(".")[0] in ("video_codecs_tpu", "jax")]


def pick(fn, idx, *args, **kw):
    """Item idx of fn(*args, **kw)'s tuple, or the tuple of items idx."""
    out = fn(*args, **kw)
    return out[idx] if isinstance(idx, int) else tuple(out[i] for i in idx)


def task_ldp_rc() -> tuple:
    """hevc-ldp-rc and its resumed run: their SAD and RDOQ launches."""
    sad, log, rdoq, _ = phase_hevc_ldp(rc=True)
    return (sad, rdoq) + tuple(phase_ldp_rc_resume(log))


def task_ldp_host() -> tuple:
    """hevc-ldp-host, then cli-ldp, which holds its NAL units to the host
    run's: the SAD and sao_stats launches of both."""
    sad, sao, _, stream = phase_hevc_ldp_host()
    return (sad, sao) + tuple(phase_cli_ldp(stream))


def _stop(pool, done: bool) -> None:
    """Shut a process pool down, its running processes stopped first
    unless the work ended (the executor has no call that stops a task)."""
    if not done:
        for proc in list((pool._processes or {}).values()):
            proc.terminate()
    pool.shutdown(wait=True, cancel_futures=True)


def task_tiles_wpp() -> None:
    """Phase 17a-b in a stage-2 worker: [hevc-tiles]
    (with its untiled times), [hevc-wpp], then the IntraEncoder check of
    [hevc-tiles]; each stream's pictures go to the GeneralDecoder and the
    IntraDecoder one by one in DECODERS spawned processes of this worker
    (host work) while the card codes on, and every decode must report its
    hash OK with the encoder's picture.  A failure stops the decoders."""
    n = TILES_PICTURES
    dpool = concurrent.futures.ProcessPoolExecutor(
        DECODERS, mp_context=multiprocessing.get_context("spawn"))
    done = False
    try:
        t_f, t_rec, tiled = phase_hevc_tiles(dpool)
        w_f, w_rec, _ = phase_hevc_tiles(dpool, wpp=True)
        phase_tiles_untiled(*tiled)
        for tag, futs, recons in (("hevc-tiles", t_f, t_rec),
                                  ("hevc-wpp", w_f, w_rec)):
            times = check_decodes(tag, futs, recons, n)
            print(f"[{tag}] the port's decoders, a picture at a time: hash "
                  f"OK {n} of {n} with the encoder's pictures in each "
                  f"({times} of decoding)")
        done = True
    finally:
        _stop(dpool, done)


# Stage 2's phases as (name, function, arguments, keywords), the longest
# first (their times alone on one H100: PERF.md), so that the workers end
# together.  main reads each result by its name.
POOL_TASKS = [
    ("hevc-tiles-wpp", task_tiles_wpp, (), {}),
    ("hevc-ldp-host", task_ldp_host, (), {}),
    ("720p", phase_encode_720p, (), {}),
    ("experiment", phase_experiment, (), {}),
    ("cli-ra", task_cli_ra, (), {}),
    ("hevc-flat-ra-sao", pick, (phase_hevc_flat, (0, 1, 2), "ra"),
     {"sao": True}),
    ("hevc-flat-ra", pick, (phase_hevc_flat, (0, 1), "ra"), {}),
    ("hevc-ldp-wp", pick, (phase_hevc_ldp_host, (0, 2), "wp"), {}),
    ("hevc-ldp-dqp", pick, (phase_hevc_ldp_host, 0, "dqp"), {}),
    ("hevc-hierb", pick, (phase_hevc_flat, (0, 1), "hierb"), {}),
    ("cli-ai-tiles", phase_cli_ai_tiles, (), {}),
    ("ra-cuda-vs-cpu", phase_ra_cuda_vs_cpu, (), {}),
    ("hevc-ra-sao", phase_hevc_ra, (), {"sao": True}),
    ("hevc-ldp-rc", task_ldp_rc, (), {}),
    ("tiled-ra-ref", phase_tiled_ra_ref, (), {}),
    ("dryrun", phase_dryrun, (), {}),
    ("hevc-ldp-sao", pick, (phase_hevc_ldp, (0, 2, 3)), {"variant": "sao"}),
    ("hevc-ldp-conf", pick, (phase_hevc_ldp, (0, 2)), {"variant": "conf"}),
    ("hevc-ra", pick, (phase_hevc_ra, (0, 2)), {}),
    ("hevc-ldp-tz", pick, (phase_hevc_ldp, (0, 2)), {"me_method": "tz"}),
    ("hevc-ra-tz", pick, (phase_hevc_ra, (0, 2)), {"me_method": "tz"}),
    ("hevc-ldp", pick, (phase_hevc_ldp, (0, 2)), {}),
    ("cuda-vs-cpu", phase_cuda_vs_cpu, (), {}),
    ("jm-main", phase_jm, ("main",), {}),
    ("jm-baseline", phase_jm, ("baseline",), {}),
    ("flat-ra-cuda-vs-cpu-sao", phase_flat_ra_cuda_vs_cpu, (),
     {"sao": True}),
    ("flat-ra-cuda-vs-cpu", phase_flat_ra_cuda_vs_cpu, (), {}),
    ("hevc-intra", phase_hevc_intra, (), {}),
    ("cli-ra-cuda-vs-cpu", phase_cli_ra_cuda_vs_cpu, (), {}),
    ("ldp-cuda-vs-cpu", phase_ldp_cuda_vs_cpu, (), {}),
    ("jm-cuda-vs-cpu", phase_jm_cuda_vs_cpu, (), {}),
    ("h264-high", phase_h264_high_b, ("high",), {}),
    ("h264-b", phase_h264_high_b, ("b",), {}),
    ("h264-hb-cuda-vs-cpu", phase_h264_hb_cuda_vs_cpu, (), {}),
    ("h264-conf-cuda-vs-cpu", phase_h264_conf_cuda_vs_cpu, (), {}),
    ("h264-loss", phase_h264_conf, ("loss",), {}),
    ("h264-ltr", phase_h264_conf, ("ltr",), {}),
    ("h264-wp", phase_h264_conf, ("wp",), {}),
    ("h264-perc", phase_h264_conf, ("perc",), {}),
    ("hevc-qt-host", phase_hevc_qt_host, (), {}),
    ("trace-tools", phase_trace_tools, (), {}),
]
# Processes stage 2 runs its phases in, and the CPU threads each gives
# torch: the host has 8 cores, and most phases keep one of them busy
# with Python while the card waits.
WORKERS, WORKER_THREADS = 5, 2


def worker_init(card: str) -> None:
    """Start a stage-2 worker: load the three kernels stage 1 built and
    count the plain versions' calls, as main does."""
    global CARD
    CARD = card
    torch.set_num_threads(WORKER_THREADS)
    for mod in (ss, sao_ops, rdoq_ops):
        mod._load()
    count_rdoq_ref()
    count_sao_ref()


def run_task(name: str, fn, args: tuple, kw: dict) -> tuple:
    """Run one phase in a worker with its output kept: (name, passed,
    result, standard output, standard error, seconds).  A failed check
    (SystemExit) or an exception is caught here, its traceback kept, and
    reported as not passed, and so is an import of the JAX package."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    ok, res = False, None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            res = fn(*args, **kw)
            bad = jax_modules()
            check(not bad, f"{name}: the JAX package was imported: "
                           f"{bad[:5]}")
            ok = True
        except (Exception, SystemExit):
            traceback.print_exc()
    return (name, ok, res, out.getvalue(), err.getvalue(),
            time.perf_counter() - t0)


def run_pool(tasks: list) -> dict:
    """Stage 2: run tasks on WORKERS spawned processes that share the
    card, print each phase's output as it ends, and return the results
    by name.  The first phase that fails stops every worker and exits
    non-zero."""
    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=worker_init, initargs=(CARD,))
    results, done = {}, False
    try:
        futs = [pool.submit(run_task, *t) for t in tasks]
        for fut in concurrent.futures.as_completed(futs):
            name, ok, res, out, err, secs = fut.result()
            sys.stdout.write(out)
            sys.stderr.write(err)
            print(f"[pool] {name}: {secs:.1f} s in its worker", flush=True)
            check(ok, f"phase {name} failed")
            results[name] = res
        done = True
    finally:
        _stop(pool, done)
    print(f"[pool] {len(tasks)} phases on {WORKERS} workers in "
          f"{time.perf_counter() - t0:.1f} s")
    return results


def run_stage3() -> tuple:
    """Stage 3: [tiled-ra] alone on the card, its stream decoded by the
    port's GeneralDecoder in a spawned process of its own meanwhile (host
    work); returns its SAD and RDOQ launches and the stream's SHA-1."""
    dpool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    done = False
    try:
        out = phase_tiled_ra(dpool)
        done = True
        return out
    finally:
        _stop(dpool, done)


# Processes that decode [hevc-tiles]' and [hevc-wpp]'s pictures beside
# the card's encodes.
DECODERS = 4


def main() -> None:
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    build_kernels()
    count_rdoq_ref()
    count_sao_ref()
    # Stage 1: the kernels against their plain versions, timed alone.
    phase_kernel()
    rq = phase_rdoq_kernel()
    k = phase_ra_kernel()
    sk = phase_sao_kernel()
    phase_ldp_kernel()
    sao_flat, _ = phase_sao_kernel_flat()
    r64 = phase_sad_r64()
    sad_jm = phase_sad_jm()
    phase_tiled_kernels()
    print(f"[time] stage 1 (the build and the kernels alone) ended at "
          f"{time.perf_counter() - t_start:.1f} s")
    # Stage 2: the earlier slices' paths, WORKERS at a time.
    res = run_pool(POOL_TASKS)
    ra_launches, ra_rdoq = res["hevc-ra"]
    ra_sao_sad, sao_launches, ra_sao_rdoq = res["hevc-ra-sao"]
    ldp_launches, ldp_rdoq = res["hevc-ldp"]
    ldp_sao, ldp_sao_rdoq, ldp_sao_stats = res["hevc-ldp-sao"]
    ldp_conf, ldp_conf_rdoq = res["hevc-ldp-conf"]
    ldp_tz, ldp_tz_rdoq = res["hevc-ldp-tz"]
    ra_tz, ra_tz_rdoq = res["hevc-ra-tz"]
    ldp_rc, ldp_rc_rdoq, rc_resumed, resumed_rdoq = res["hevc-ldp-rc"]
    flat_ra, flat_ra_rdoq = res["hevc-flat-ra"]
    hierb, hierb_rdoq = res["hevc-hierb"]
    flat_sao, flat_sao_rdoq, flat_sao_stats = res["hevc-flat-ra-sao"]
    host_sad, host_sao, cli_ldp_sad, cli_ldp_sao = res["hevc-ldp-host"]
    wp_sad, wp_off_sad = res["hevc-ldp-wp"]
    dqp_sad = res["hevc-ldp-dqp"]
    cli_ra_sad = res["cli-ra"]
    jm_main = res["jm-main"]
    jm_base = res["jm-baseline"]
    h264_high = res["h264-high"]
    h264_b = res["h264-b"]
    conf = {kind: res[f"h264-{kind}"]
            for kind in ("ltr", "wp", "perc", "loss")}
    cli_ai_sao = res["cli-ai-tiles"]
    exp_sad = res["experiment"]
    dry_sad, dry_rdoq = res["dryrun"]
    trace_sad = res["trace-tools"]
    # Stage 3: the tile-sharded 1080p GOP alone on the card; the port's
    # decoder checks its stream in a process of its own meanwhile.
    t3 = time.perf_counter()
    tiled_sad, tiled_rdoq, tiled_sha = run_stage3()
    print(f"[time] stage 3 ([tiled-ra] and its decode) "
          f"{time.perf_counter() - t3:.1f} s")
    ref_sad, ref_rdoq, ref_sha = res["tiled-ra-ref"]
    check(tiled_sha == ref_sha and (ref_sad, ref_rdoq) == (tiled_sad,
                                                           tiled_rdoq),
          f"[tiled-ra] ShardedQt's stream {tiled_sha} ({tiled_sad} / "
          f"{tiled_rdoq} launches) != TiledRefQt's {ref_sha} ({ref_sad} / "
          f"{ref_rdoq})")
    print("[tiled-ra] ShardedQt's stream (stage 3) is TiledRefQt's "
          "(stage 2), byte for byte, with the same launches")
    jax_mods = jax_modules()
    check(not jax_mods, f"the JAX package was imported: {jax_mods[:5]}")
    print("[imports] nothing of video_codecs_tpu or jax was imported, "
          "in this process or in stage 2's workers")

    launches = (ra_launches + ra_sao_sad + ldp_launches + ldp_sao +
                ldp_conf + ldp_tz + ra_tz + ldp_rc + rc_resumed + flat_ra +
                hierb + flat_sao + host_sad + wp_sad + wp_off_sad + dqp_sad +
                cli_ra_sad + cli_ldp_sad + jm_main + jm_base + h264_high +
                h264_b + sum(conf.values()) + tiled_sad + ref_sad + dry_sad +
                exp_sad + trace_sad)
    sao_all = (sao_launches + ldp_sao_stats + flat_sao_stats + host_sao +
               cli_ldp_sao + cli_ai_sao)
    print(f"[kernels] sad_surface launches: RA GOP {ra_launches}, RA GOP "
          f"with SAO {ra_sao_sad}, LD-P run {ldp_launches}, LD-P SAO run "
          f"{ldp_sao}, LD-P conferencing run {ldp_conf}, LD-P TZ run "
          f"{ldp_tz}, RA TZ GOP {ra_tz}, LD-P rate-controlled run {ldp_rc} "
          f"and its resumed run {rc_resumed}, flat RA GOP {flat_ra}, flat "
          f"hierarchical-B run {hierb}, flat RA GOP with SAO {flat_sao}, "
          f"host LD-P run {host_sad}, its WP run {wp_sad} and that run's "
          f"pictures without WP {wp_off_sad}, its "
          f"cu_qp_delta run {dqp_sad}, the encoder CLI on HM's RA main cfg "
          f"{cli_ra_sad} and on its LD-P main cfg {cli_ldp_sad}, the JM "
          f"encoder CLI's Main run {jm_main} and baseline run {jm_base}, "
          f"the host H.264 coder's High-profile run {h264_high} and B run "
          f"{h264_b}, its long-term / MMCO / reordering run {conf['ltr']}, "
          f"weighted-prediction run {conf['wp']}, perceptual run "
          f"{conf['perc']} and intra-refresh run {conf['loss']}, the "
          f"tile-sharded RA GOP {tiled_sad} and its sequential twin "
          f"{ref_sad}, the dry run {dry_sad}, the "
          f"experiment CLI's LD-P sweep {exp_sad} and the traced JM run "
          f"{trace_sad}, together {launches}; its "
          "times and bound below are the RA pyramid path's per B picture "
          "(the search range 64 surfaces' on the next line). sao_stats "
          f"launches: RA GOP with SAO {sao_launches}, LD-P SAO run "
          f"{ldp_sao_stats}, flat RA GOP with SAO {flat_sao_stats}, host "
          f"LD-P run {host_sao}, the encoder CLI on HM's LD-P main cfg "
          f"{cli_ldp_sao} and on its all-intra structure with tiles "
          f"{cli_ai_sao}, together {sao_all} (the plain version 0 "
          "times in them); its "
          "times and bound are per 1080p RA picture (3 planes; the flat "
          "shapes' on the sao_stats_flat line)")
    rdoq_launches = (ra_rdoq + ra_sao_rdoq + ldp_rdoq + ldp_sao_rdoq +
                     ldp_conf_rdoq + ldp_tz_rdoq + ra_tz_rdoq + ldp_rc_rdoq +
                     resumed_rdoq + flat_ra_rdoq + hierb_rdoq + flat_sao_rdoq +
                     tiled_rdoq + ref_rdoq + dry_rdoq)
    r = rq[0]
    print(f"[kernels] rdoq_dev launches: RA GOP {ra_rdoq}, RA GOP with SAO "
          f"{ra_sao_rdoq}, LD-P run {ldp_rdoq}, LD-P SAO run {ldp_sao_rdoq}, "
          f"LD-P conferencing run {ldp_conf_rdoq}, LD-P TZ run "
          f"{ldp_tz_rdoq}, "
          f"RA TZ GOP {ra_tz_rdoq}, LD-P rate-controlled run {ldp_rc_rdoq} "
          f"and its resumed run {resumed_rdoq}, flat RA GOP {flat_ra_rdoq}, "
          f"flat hierarchical-B run {hierb_rdoq}, flat RA GOP with SAO "
          f"{flat_sao_rdoq}, the tile-sharded RA GOP {tiled_rdoq} and its "
          f"sequential twin {ref_rdoq}, the dry run {dry_rdoq} (the host "
          "coders and the encoder CLI 0), "
          f"together {rdoq_launches}; "
          f"the plain version ran 0 times in them; its times and bound are "
          f"the {r['what']} call's (B={r['b']}; every shape on the next "
          "line)")
    print(json.dumps({"sad_surface_r64": r64}))
    print(json.dumps({"sad_surface_jm": sad_jm}))
    print(json.dumps({"rdoq_dev_shapes": rq}))
    print(json.dumps({"sao_stats_flat": sao_flat}))
    print(f"[time] {time.perf_counter() - t_start:.1f} s from the start, "
          "the kernels' build included")

    print(json.dumps({"kernels": [{
        "name": "sad_surface", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "ms_note": k.get("note")}, {
        "name": "sao_stats", "route": "cuda", "source": SAO_SRC,
        "replaces": SAO_REPLACES, "launches": sao_all,
        "max_abs_err": sk["max_abs_err"], "ms": sk["ms"],
        "plain_ms": sk["plain_ms"], "bound_ms": sk["bound_ms"],
        "bound_by": sk["bound_by"], "library_ms": sk["library_ms"],
        "ms_note": sk.get("note")}, {
        "name": "rdoq_dev", "route": "cuda", "source": RDOQ_SRC,
        "replaces": RDOQ_REPLACES, "launches": rdoq_launches,
        "max_abs_err": max(x["max_abs_err"] for x in rq), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "ms_note": r["note"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
