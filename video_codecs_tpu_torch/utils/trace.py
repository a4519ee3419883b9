"""Syntax-element trace mode (conformance debugging).

Parity: HM's ENC_DEC_TRACE (TypeDef.h:70, DTRACE_CABAC) and JM's
TRACE levels (lencod/inc/defines.h:25): both make the encoder and
decoder dump every coded syntax element so the two traces can be
diffed line-for-line — the reference's primary desync-hunting tool.

Here: `start()` begins collecting, `stop()` returns the trace; the
H.264 CABAC entropy engines are wrapped at the syntax-element level
(`wrap_syntax`) so an encode trace and the decode trace of the same
stream must be identical. Zero overhead when no trace is active.

The port's copy of video_codecs_tpu/utils/trace.py, whole; each function
keeps its name and a comment gives the original's line.  The port's
H.264 coders wrap their CABAC engines at the reference's six sites.
"""

from __future__ import annotations

_active: list[str] | None = None


# video_codecs_tpu/utils/trace.py:19
def start() -> None:
    global _active
    _active = []


# video_codecs_tpu/utils/trace.py:24
def stop() -> list[str]:
    global _active
    t, _active = _active or [], None
    return t


# video_codecs_tpu/utils/trace.py:30
def active() -> bool:
    return _active is not None


# video_codecs_tpu/utils/trace.py:34
def log(name: str, value) -> None:
    if _active is not None:
        _active.append(f"{name} {value}")


# video_codecs_tpu/utils/trace.py:39
def _fmt(v):
    if isinstance(v, (list, tuple)):
        return " ".join(str(int(x)) for x in v)
    return int(v)


# syntax elements on the H.264 CABAC engines: encoder carries the value
# in arg[pos]; the decoder returns it (post-processed by `ret`)
_SPEC = {
    "mb_skip_flag_p": (0, lambda r: r),
    "mb_type_i": (0, lambda r: r),
    "mb_type_p": (0, lambda r: r[0]),
    "ref_idx": (0, lambda r: r),
    "mvd": (0, lambda r: r),
    "cbp": (0, lambda r: r),
    "mb_qp_delta": (0, lambda r: r),
    "intra4x4_pred_mode": (0, lambda r: r),
    "intra_chroma_pred_mode": (0, lambda r: r),
    "residual_block": (1, lambda r: r),
    "final": (0, lambda r: r),
}


_depth = 0   # reentrancy guard: a syntax element may code nested
             # elements internally (e.g. mb_type's terminate bin uses
             # final); only the OUTER element is traced so encoder
             # (logs before coding) and decoder (logs after parsing)
             # produce identical sequences.


# video_codecs_tpu/utils/trace.py:69
def wrap_syntax(engine, role: str):
    """Wrap an entropy engine's syntax-element methods to emit trace
    lines. role: "write" (encoder: value is an argument) or "read"
    (decoder: value is the return). No-op when tracing is inactive."""
    if _active is None:
        return engine
    assert role in ("write", "read")
    for name, (argpos, ret) in _SPEC.items():
        orig = getattr(engine, name, None)
        if orig is None:
            continue

        def make(name=name, orig=orig, argpos=argpos, ret=ret):
            def wrapped(*a, **k):
                global _depth
                outer = _depth == 0
                if outer and role == "write":
                    log(name, _fmt(a[argpos]))
                _depth += 1
                try:
                    r = orig(*a, **k)
                finally:
                    _depth -= 1
                if outer and role == "read":
                    log(name, _fmt(ret(r)))
                return r
            return wrapped

        setattr(engine, name, make())
    return engine
