"""video_codecs_tpu_torch — the PyTorch/CUDA port of video_codecs_tpu.

The JAX package `video_codecs_tpu` is the reference: every function here
returns the same integers (and the same bitstream bytes) as its JAX
counterpart on the same inputs.  The port imports `torch`, numpy and the
standard library, and nothing of `video_codecs_tpu` -- not even its
modules that do not import JAX.  What it needs of the reference's host
code (bit writer, CAVLC and H.264 CABAC, transforms, trellis and
adaptive rounding, deblocking, the H.264 host IPPP coder at Main
profile, its decoder and DPB, the JM encoder CLI; the HEVC spec tables, CABAC, residual coding,
parameter sets and the intra/quadtree syntax and decoders, and the
native C++ CABAC writer, the inter host classes of the random-access
and low-delay P encoders and the general decoder) it carries as its own copy, function by
function under the same names, with each original's file and line in a
comment; only the tests import both packages.

Rules: plain functions on tensors, an explicit `device` everywhere (the
entry points `DeviceH264Encoder`, `H264Encoder`, `QuadtreeFastEncoder`,
`QtDeviceRandomAccessEncoder`, `DeviceLowDelayEncoder` and the flat
`IntraEncoder` run on the card unless the caller asks for the CPU), no autograd (work runs under `torch.inference_mode()`), and
a hand-written CUDA kernel wherever the reference had a Pallas kernel
(and for its SAO-statistics and full-RDOQ XLA loops).  A
kernel wrapper launches its kernel for a CUDA tensor or raises; it runs
the plain PyTorch version only for a CPU tensor.

Module map (port -> JAX counterpart):

  utils/device.py            (explicit devices; devconst.py's in-trace
                             constants have no counterpart)
  entropy/bitstream.py       entropy/bitstream.py (whole)
  entropy/cavlc.py           entropy/cavlc.py (whole)
  ops/h264_transform.py      ops/h264_transform.py (4x4 part)
  ops/h264_deblock.py        ops/h264_deblock.py (whole)
  ops/h264_interp.py         ops/h264_interp.py (whole; decoder MC)
  ops/interp.py              ops/interp.py (HEVC MC, numpy twins)
  ops/cost.py                ops/cost.py (sad, sse, hadamard_satd_8x8)
  ops/sad_surface.py         ops/pallas_sad.py (sad_surface, _sad_kernel)
    + csrc/sad_surface.cu      the Hopper kernel for it
  ops/sao.py                 ops/sao.py (whole; sao_stats_dev as
                             sao_stats / sao_stats_ref)
    + csrc/sao_stats.cu        the Hopper kernel for it
  ops/me.py                  ops/me.py (integer_search, tz_search,
                             pyramid_search, _refine, motion_search)
  ops/h264_dev.py            ops/h264_jax.py
  models/h264/dpb.py         models/h264/dpb.py (sliding window)
  entropy/h264_cabac.py,     entropy/h264_cabac.py, h264_ctx_data.py
    h264_ctx_data.py           (whole)
  ops/h264_rdoq.py           ops/h264_rdoq.py (whole)
  models/h264/intra_codec.py models/h264/intra_codec.py (CAVLC, CABAC)
  models/h264/inter_codec.py models/h264/inter_codec.py (the host IPPP
                             coder, CAVLC and CABAC decoder)
  models/h264/host_me.py     (the host coder's card stage: its SAD
                             surfaces and sub-pel phase planes)
  tools/jm_encoder_app.py    tools/jm_encoder_app.py
  models/hevc/inter_dev.py   models/hevc/inter_jax.py (MV helpers,
                             _intra_wavefront, encode_p_frame_dev,
                             DeviceLowDelayEncoder, b_me_one,
                             encode_b_frame_dev, lambdas)
  models/h264/inter_dev.py   models/h264/inter_jax.py (encode_p_dev,
                             DeviceH264Encoder)
  utils/rom.py               utils/rom.py (whole)
  entropy/cabac.py, ctx.py,  entropy/cabac.py, ctx.py, residual.py
    residual.py                (whole)
  entropy/native.py          entropy/native.py (flat and quadtree
                             serializers)
    + csrc/cabac_enc.cpp       csrc/cabac_enc.cpp (byte copy)
  models/hevc/headers.py     models/hevc/headers.py (whole)
  ops/transform.py           ops/transform.py
  ops/quant.py               ops/quant.py
  ops/intra.py               ops/intra.py
  ops/deblock.py             ops/deblock.py (scalar-QP BS deblocking)
  ops/rdoq.py                ops/rdoq.py (fractional-bit table)
  ops/rdoq_dev.py            ops/rdoq_jax.py (rdoq_dev as rdoq_dev /
                             rdoq_dev_ref)
    + csrc/rdoq.cu             the Hopper kernel for it
  models/hevc/encoder_dev.py models/hevc/encoder_jax.py (helpers and
                             the flat CTB16 intra encoder encode_frame;
                             tile-column stacks)
  parallel/tiles.py          parallel/tiles.py (the tile columns as one
                             batch where the reference shards them)
  models/hevc/encoder_qt_dev.py  models/hevc/encoder_jax_qt.py (whole)
  models/hevc/intra_codec.py models/hevc/intra_codec.py (helpers, the
                             flat IDR host tail, sao() syntax, hash SEI,
                             decoder NAL loop)
  models/hevc/quadtree_codec.py  models/hevc/quadtree_codec.py (whole:
                             syntax, QuadtreeIntraDecoder,
                             QuadtreeIntraEncoder, QuadtreeFastEncoder)
  utils/debug.py             utils/debug.py (whole)
  models/hevc/motion.py,     models/hevc/motion.py, motion_hm.py (whole;
    motion_hm.py               amvp_candidates repaired to the spec)
  models/hevc/checkpoint.py  models/hevc/checkpoint.py (whole)
  models/hevc/ratectrl.py    models/hevc/ratectrl.py (the picture-level
                             controllers)
  models/hevc/inter_codec.py, models/hevc/inter_codec.py, bframe_codec.py,
    bframe_codec.py,           ra_codec.py (the LD-P host P coder; the RA
    ra_codec.py                encoder's chain of bases and helpers)
  models/hevc/inter_qt.py    models/hevc/inter_qt.py (qt_merge_dev,
                             QtDeviceRandomAccessEncoder)
  models/hevc/decoder.py     models/hevc/decoder.py (GeneralDecoder,
                             whole)
  parallel/sharded.py        __graft_entry__.py's TiledRefQt and
                             ShardedQt (the RA engine on halo-padded tile
                             columns)
  graft_entry.py             __graft_entry__.py (entry,
                             dryrun_multichip)
  utils/trace.py,            utils/trace.py, coding_stats.py (whole; the
    coding_stats.py            H.264 CABAC engines wrapped, the HEVC
                               CabacDecoder hooked)
  tools/convert.py,          tools/convert.py, experiment.py (whole),
    experiment.py,             tools/misc.py (whole)
    misc.py
"""

import torch

# Exact float32 everywhere: decision costs are compared in float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
