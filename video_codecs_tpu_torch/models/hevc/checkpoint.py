"""The encoder state at a picture boundary, as `encode_frames` returns it.

The port's copy of the part of video_codecs_tpu/models/hevc/checkpoint.py
that the low-delay encoder's `encode_frames` calls (each function keeps
its name and a comment gives the original's line).  Cut: saving and
loading a state and resuming a rate controller; the port's encoders
refuse `start_state` and `rate_control`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# video_codecs_tpu/models/hevc/checkpoint.py:18
@dataclasses.dataclass
class EncoderState:
    poc: int
    ref: tuple[np.ndarray, np.ndarray, np.ndarray] | None
    rc: dict | None  # rate-controller __dict__ (plain floats/ints)


# video_codecs_tpu/models/hevc/checkpoint.py:25
def capture(poc: int, ref, rate_control=None) -> EncoderState:
    rc = None
    if rate_control is not None:
        rc = {k: v for k, v in vars(rate_control).items()
              if isinstance(v, (int, float))}
        rc["__class__"] = type(rate_control).__name__
    return EncoderState(poc=poc,
                        ref=tuple(np.asarray(p).copy() for p in ref)
                        if ref is not None else None,
                        rc=rc)
