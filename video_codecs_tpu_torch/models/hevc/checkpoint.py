"""Encoder checkpoint/resume: the low-delay encoder's state at a picture
boundary, as `encode_frames` returns it and takes it back.

The port's copy of video_codecs_tpu/models/hevc/checkpoint.py (each
function keeps its name and a comment gives the original's line).  The
resumable state is {the newest reference's planes, the POC, the rate
controller's parameters}: `capture` takes it, `save` and `load` write it
to an .npz file (or any file object numpy writes to) and read it back,
and `restore_rc` puts the parameters into a new controller of the same
class.  A state written by the JAX package's `save` loads here, field by
field: numpy planes, the POC and the controller's float/int dict.
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


# video_codecs_tpu/models/hevc/checkpoint.py:37
def save(state: EncoderState, path: str) -> None:
    buf: dict = {"poc": np.int64(state.poc)}
    if state.ref is not None:
        buf["ref_y"], buf["ref_u"], buf["ref_v"] = state.ref
    if state.rc is not None:
        keys = [k for k in state.rc if k != "__class__"]
        buf["rc_keys"] = np.array(keys)
        buf["rc_vals"] = np.array([float(state.rc[k]) for k in keys])
        buf["rc_class"] = np.array([state.rc["__class__"]])
    np.savez(path, **buf)


# video_codecs_tpu/models/hevc/checkpoint.py:49
def load(path: str) -> EncoderState:
    z = np.load(path, allow_pickle=False)
    ref = None
    if "ref_y" in z:
        ref = (z["ref_y"], z["ref_u"], z["ref_v"])
    rc = None
    if "rc_keys" in z:
        rc = {str(k): float(v) for k, v in zip(z["rc_keys"], z["rc_vals"])}
        rc["__class__"] = str(z["rc_class"][0])
    return EncoderState(poc=int(z["poc"]), ref=ref, rc=rc)


# video_codecs_tpu/models/hevc/checkpoint.py:61
def restore_rc(state: EncoderState, rate_control) -> None:
    if state.rc is None or rate_control is None:
        return
    assert state.rc["__class__"] == type(rate_control).__name__
    for k, v in state.rc.items():
        if k == "__class__":
            continue
        cur = getattr(rate_control, k, None)
        setattr(rate_control, k,
                int(v) if isinstance(cur, int) else v)
