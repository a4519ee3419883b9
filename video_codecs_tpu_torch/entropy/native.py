"""ctypes bindings for the native CABAC slice serializers: the flat CTB16
intra slice (`encode_slice_native`) and the quadtree slice
(`encode_slice_qt_native`).

The port's copy of video_codecs_tpu/entropy/native.py (each function
keeps its name and a comment gives the original's line),
over the port's byte-for-byte copy of csrc/cabac_enc.cpp
(video_codecs_tpu_torch/csrc/cabac_enc.cpp).  The library is built with
`g++ -O2` at first use into build/torch_kernels/ under the repository
root (never beside the sources) and rebuilt when the source changes.  A
failed build raises: there is no fallback here, and the plain Python
serializer (models/hevc/quadtree_codec.encode_slice_qt) gives the same
bytes, as does the flat one (models/hevc/intra_codec.IntraEncoder
._encode_slice).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import ctx
from video_codecs_tpu_torch.models.hevc import headers

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "cabac_enc.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIB = None


# video_codecs_tpu/entropy/native.py:24
def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = hashlib.blake2b(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode(),
                          digest_size=8).hexdigest()
    so = _BUILD_DIR / f"libvct_cabac_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.vct_encode_slice.restype = ctypes.c_int
    lib.vct_encode_slice.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),   # modes
        ctypes.POINTER(ctypes.c_uint8),   # cbf [3][B]
        ctypes.POINTER(ctypes.c_int32),   # levels_y
        ctypes.POINTER(ctypes.c_int32),   # levels_cb
        ctypes.POINTER(ctypes.c_int32),   # levels_cr
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,  # header
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,  # init states
        ctypes.POINTER(ctypes.c_int),     # offsets
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,  # out
        ctypes.c_int,                     # sign_hiding
    ]
    lib.vct_encode_slice_qt.restype = ctypes.c_int
    lib.vct_encode_slice_qt.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,      # w, h, log2_ctb
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int,   # depth8, pw8
        ctypes.POINTER(ctypes.c_int8),                 # m8
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int,   # m16, pw16
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int,   # m32, pw32
        ctypes.POINTER(ctypes.c_int16),                # coef_y
        ctypes.POINTER(ctypes.c_int16),                # coef_u
        ctypes.POINTER(ctypes.c_int16),                # coef_v
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,  # header
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,  # init states
        ctypes.POINTER(ctypes.c_int),                  # offsets (12)
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,  # out
        ctypes.c_int,                                  # sign_hiding
    ]
    _LIB = lib
    return lib


# video_codecs_tpu/entropy/native.py:76
def encode_slice_native(bw: int, bh: int, qp: int, modes: np.ndarray,
                        cbf: np.ndarray, levels_y: np.ndarray,
                        levels_cb: np.ndarray, levels_cr: np.ndarray,
                        header: bytes, init_states: np.ndarray,
                        sign_hiding: bool = False) -> bytes:
    """Returns the EBSP payload (header + slice data) of a flat CTB16
    intra slice."""
    lib = _load()
    offs = np.array([
        ctx.off("part_size"), ctx.off("prev_intra_luma_pred"),
        ctx.off("chroma_pred_mode"), ctx.off("cbf_luma"),
        ctx.off("cbf_chroma"), ctx.off("last_x"), ctx.off("last_y"),
        ctx.off("sig_cg"), ctx.off("sig_flag"), ctx.off("one_flag"),
        ctx.off("abs_flag")], dtype=np.int32)

    modes = np.ascontiguousarray(modes, np.int32)
    cbf = np.ascontiguousarray(cbf, np.uint8)
    levels_y = np.ascontiguousarray(levels_y, np.int32)
    levels_cb = np.ascontiguousarray(levels_cb, np.int32)
    levels_cr = np.ascontiguousarray(levels_cr, np.int32)
    header_arr = np.frombuffer(header, np.uint8)
    states = np.ascontiguousarray(init_states, np.uint8)
    cap = levels_y.nbytes + levels_cb.nbytes + levels_cr.nbytes + \
        len(header) + 4096
    out = np.zeros(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.vct_encode_slice(
        bw, bh, qp,
        p(modes, ctypes.c_int32), p(cbf, ctypes.c_uint8),
        p(levels_y, ctypes.c_int32), p(levels_cb, ctypes.c_int32),
        p(levels_cr, ctypes.c_int32),
        p(header_arr, ctypes.c_uint8), len(header),
        p(states, ctypes.c_uint8), states.size,
        p(offs, ctypes.c_int), p(out, ctypes.c_uint8), cap,
        1 if sign_hiding else 0)
    if n < 0:
        raise RuntimeError(f"native slice serializer failed ({n})")
    return out[:n].tobytes()


# video_codecs_tpu/entropy/native.py:122
def encode_slice_qt_native(cfg, st) -> bytes:
    """Quadtree slice serializer (device-quadtree path outputs).

    st: host dict from encoder_qt_dev.encode_frame_qt (depth8/m8/m16/m32
    int8 maps on the padded grids, coef planes int16 at true dims).
    Returns the EBSP payload (slice header + slice data)."""
    lib = _load()
    offs = np.array([
        ctx.off("part_size"), ctx.off("prev_intra_luma_pred"),
        ctx.off("chroma_pred_mode"), ctx.off("cbf_luma"),
        ctx.off("cbf_chroma"), ctx.off("last_x"), ctx.off("last_y"),
        ctx.off("sig_cg"), ctx.off("sig_flag"), ctx.off("one_flag"),
        ctx.off("abs_flag"), ctx.off("split_cu_flag")], dtype=np.int32)

    depth8 = np.ascontiguousarray(st["depth8"], np.int8)
    m8 = np.ascontiguousarray(st["m8"], np.int8)
    m16 = np.ascontiguousarray(st["m16"], np.int8)
    m32 = np.ascontiguousarray(st["m32"], np.int8)
    cy = np.ascontiguousarray(st["coef_y"], np.int16)
    cu = np.ascontiguousarray(st["coef_u"], np.int16)
    cv = np.ascontiguousarray(st["coef_v"], np.int16)
    header = headers.write_slice_header(cfg, bs.NAL_IDR_W_RADL,
                                        sao_flags=False).data()
    header_arr = np.frombuffer(header, np.uint8)
    states = np.ascontiguousarray(ctx.init_states(ctx.I, cfg.qp), np.uint8)
    cap = cy.nbytes + cu.nbytes + cv.nbytes + len(header) + 4096
    out = np.zeros(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.vct_encode_slice_qt(
        cfg.width, cfg.height, cfg.log2_ctb,
        p(depth8, ctypes.c_int8), depth8.shape[1],
        p(m8, ctypes.c_int8),
        p(m16, ctypes.c_int8), m16.shape[1],
        p(m32, ctypes.c_int8), m32.shape[1],
        p(cy, ctypes.c_int16), p(cu, ctypes.c_int16), p(cv, ctypes.c_int16),
        p(header_arr, ctypes.c_uint8), len(header),
        p(states, ctypes.c_uint8), states.size,
        p(offs, ctypes.c_int), p(out, ctypes.c_uint8), cap,
        1 if cfg.sign_data_hiding else 0)
    if n < 0:
        raise RuntimeError(f"native quadtree serializer failed ({n})")
    return out[:n].tobytes()
