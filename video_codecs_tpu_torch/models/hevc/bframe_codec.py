"""Hierarchical-B encoder base of the random-access encoders.

The port's copy of the part of video_codecs_tpu/models/hevc/bframe_codec.py
that the random-access quadtree encoder reaches: the class in its chain of
bases, whose methods that encoder overrides or does not call.  Cut: the
flat 16x16 B-picture host coder, its slice writer and parser and
`HierarchicalBDecoder` (the port decodes with models/hevc/decoder.py).
"""

from __future__ import annotations

from video_codecs_tpu_torch.models.hevc import inter_codec as pc

DC = 1
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
MODE_INTER, MODE_INTRA = 0, 1
L0, L1 = 0, 1


# video_codecs_tpu/models/hevc/bframe_codec.py:236
class HierarchicalBEncoder(pc.LowDelayEncoder):
    """I0 + P anchors (delta 2) + non-reference B pictures between."""
