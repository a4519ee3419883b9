"""The HEVC intra reconstruction wavefronts as hand-written Hopper kernels.

Two entries launch the two kernels of csrc/intra_wavefront.cu, one
persistent launch per call, on CUDA tensors:

  `qt_wavefront`    the quadtree IDR's wavefront over CTB32 units
                    (`encoder_qt_dev.encode_frame_qt_device`, the reference's
                    encoder_jax_qt.py:276), counted in
                    `qt_wavefront.launches`;
  `flat_wavefront`  the flat CTB16 wavefront over 16x16 blocks
                    (`encoder_dev.encode_frame_device`, encoder_jax.py:231,
                    and `inter_dev._intra_wavefront`, inter_jax.py:125),
                    counted in `flat_wavefront.launches`.

Each call allocates a zeroed int32 scratch tensor (the kernel's ticket
counter and one done flag per unit) and records the CTAs it launched in
`.last_grid`.  The plain versions are the model modules' eager loops
(`encode_frame_qt_device_ref`, `encode_frame_device_ref`,
`_intra_wavefront_ref`); the public functions there run them for CPU
tensors and call these entries for CUDA tensors, which launch or raise:
there is no other path.  The kernels take hard quantisation and
RDOQ-lite (the values the port's callers pass); the full RDOQ raises
ValueError.  The source is built with nvcc at first use into
build/torch_kernels/ as the other kernels are (`sad_surface.build_library`:
a plain-C shared library loaded with ctypes, keyed by the source's hash).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops.sad_surface import (build_library,
                                                    launch_stream)
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import to_device

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "intra_wavefront.cu"
_LIB = None

# Offsets of the int32 table buffer, as csrc/intra_wavefront.cu's `Tab`.
TAB_SCAN = 1360                          # the DCT matrices before it
TAB_ANGLE = TAB_SCAN + 4080
TAB_INV_ANGLE = TAB_ANGLE + 35
TAB_QUANT_SCALE = TAB_INV_ANGLE + 35
TAB_INV_QUANT_SCALE = TAB_QUANT_SCALE + 6
TAB_SIZE = TAB_INV_QUANT_SCALE + 6


def build() -> tuple[Path, float, str]:
    """Compile csrc/intra_wavefront.cu (`sad_surface.build_library`)."""
    return build_library(_SRC, "vct_intra_wavefront")


def _load() -> ctypes.CDLL:
    """The built library, with its two entry points' C signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        qt = lib.vct_intra_qt_wavefront
        qt.restype = i
        ip = ctypes.POINTER(i)
        qt.argtypes = [p] * 13 + [i] * 8 + [p] * 4 + [ip, p]
        flat = lib.vct_intra_flat_wavefront
        flat.restype = i
        flat.argtypes = [p] * 11 + [i] + [p] * 3 + [i] * 11 + [p] * 4 + [
            ip, p]
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def tables_np() -> np.ndarray:
    """The kernels' int32 table buffer: the DCT matrices (N = 4..32), the
    scans (log2 2..5, diagonal / horizontal / vertical), the intra angles
    and inverse angles (positive) per mode, the quantiser's scales."""
    dct = [rom.dct_matrix(1 << l).astype(np.int32).ravel()
           for l in (2, 3, 4, 5)]
    scans = [rom.scan_order(l, t).astype(np.int32)
             for l in (2, 3, 4, 5) for t in (rom.SCAN_DIAG, rom.SCAN_HOR,
                                             rom.SCAN_VER)]
    angles = np.zeros(35, np.int32)
    angles[2:] = rom.INTRA_PRED_ANGLES
    inv = np.zeros(35, np.int32)
    inv[11:26] = -rom.INTRA_INV_ANGLES
    out = np.concatenate(dct + scans + [angles, inv, rom.QUANT_SCALES,
                                        rom.INV_QUANT_SCALES]).astype(np.int32)
    assert out.size == TAB_SIZE
    return out


def lite_lambdas(lam_luma: float, lam_chroma: float,
                 lam_scale: float) -> np.ndarray:
    """float32 [luma, chroma] x [log2 2..5]: RDOQ-lite's transform-domain
    lambda as `quant.rdoq_lite` forms it for `lam` and `lam_scale`."""
    return np.array([[np.float32(float(lam_scale) * float(lam) * float(
        4 ** (15 - 8 - log2))) for log2 in (2, 3, 4, 5)]
        for lam in (lam_luma, lam_chroma)], np.float32)


def _rdoq_mode(rdoq) -> int:
    """0: hard quantisation, 1: RDOQ-lite; the full RDOQ is not taken."""
    if isinstance(rdoq, str) and rdoq == "full":
        raise ValueError("the intra wavefront kernels take hard quantisation "
                         "and RDOQ-lite, not rdoq='full'")
    return 1 if rdoq else 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, the planes on {dev}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous {dtype}, got "
                         f"{t.dtype}{'' if t.is_contiguous() else ' strided'}")


def _device(y: torch.Tensor) -> torch.device:
    if y.device.type != "cuda":
        raise ValueError(f"intra wavefront kernel: no kernel for {y.device}")
    return y.device


@functools.lru_cache(maxsize=None)
def _tables_dev(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The table buffer and the RDOQ-lite rates on `dev`, uploaded once."""
    return (to_device(tables_np(), dev, torch.int32),
            to_device(quant_ops.log_1p_tables()[1], dev, torch.float32))


@functools.lru_cache(maxsize=256)
def _consts(dev: torch.device, lam: tuple[float, float], lam_scale: float):
    """(tables, rates, lam_td) on `dev`, cached per card and lambda value:
    a call hashes a few floats, never the tables' bytes."""
    return _tables_dev(dev) + (
        to_device(lite_lambdas(*lam, lam_scale), dev, torch.float32),)


def _launch(fn, *args) -> int:
    """Call a C entry with its trailing (grid out-parameter, stream) and
    raise on a launch error; returns the CTAs launched."""
    grid = ctypes.c_int(0)
    err = fn(*args[:-1], ctypes.byref(grid), args[-1])
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError "
                           f"{err}")
    return grid.value


def qt_wavefront(y, u, v, depth8, m8, m16, m32, qp: int, qp_c: int, w: int,
                 h: int, sbh: bool, rdoq, lam: tuple[float, float],
                 lam_scale: float) -> dict:
    """The quadtree IDR's wavefront on the card: padded int32 planes y
    [ph, pw], u / v [ph/2, pw/2] and the decided maps (depth8 [ph/8, pw/8],
    m8 / m16 / m32) -> the dict of `encode_frame_qt_device` (rec_y/u/v and
    coef_y/u/v, int32, padded dims).  lam: RDOQ-lite's lambda for the luma
    and the chroma QP; lam_scale its rate scale.  One launch on the
    current stream, no host sync."""
    dev = _device(y)
    ph, pw = y.shape
    ins = dict(y=y.int().contiguous(), u=u.int().contiguous(),
               v=v.int().contiguous(), depth8=depth8.int().contiguous(),
               m8=m8.int().contiguous(), m16=m16.int().contiguous(),
               m32=m32.int().contiguous())
    shapes = dict(y=(ph, pw), u=(ph // 2, pw // 2), v=(ph // 2, pw // 2),
                  depth8=(ph // 8, pw // 8), m8=(ph // 8, pw // 8),
                  m16=(ph // 16, pw // 16), m32=(ph // 32, pw // 32))
    for k, t in ins.items():
        _check(k, t, torch.int32, dev)
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"qt_wavefront: {k} {tuple(t.shape)}, want "
                             f"{shapes[k]}")
    lite = _rdoq_mode(rdoq)
    # every CTB writes its whole tile (zeros where the tree codes no CU)
    st = {k: torch.empty(shapes[k[-1]], dtype=torch.int32, device=dev)
          for k in ("rec_y", "rec_u", "rec_v", "coef_y", "coef_u",
                    "coef_v")}
    sync = torch.zeros(1 + (ph // 32) * (pw // 32), dtype=torch.int32,
                       device=dev)
    tab, rate, lam_td = _consts(dev, (float(lam[0]), float(lam[1])),
                                float(lam_scale))
    qt_wavefront.last_grid = _launch(
        _load().vct_intra_qt_wavefront,
        *(ins[k].data_ptr() for k in ("y", "u", "v", "depth8", "m8", "m16",
                                      "m32")),
        *(st[k].data_ptr() for k in ("rec_y", "rec_u", "rec_v", "coef_y",
                                     "coef_u", "coef_v")),
        ph, pw, w, h, qp, qp_c, int(bool(sbh)), lite, tab.data_ptr(),
        rate.data_ptr(), lam_td.data_ptr(), sync.data_ptr(),
        launch_stream(dev))
    qt_wavefront.launches += 1
    return st


qt_wavefront.launches = 0
qt_wavefront.last_grid = 0


def flat_wavefront(y, u, v, modes, rec, levels, cbf, qp: int, qp_c: int,
                   bw: int, bh: int, sbh: bool, rdoq,
                   lam: tuple[float, float], lam_scale: float, *,
                   intra: torch.Tensor | None = None,
                   lv_planes: bool = False) -> None:
    """The flat CTB16 wavefront on the card, in place: int32 planes y [H, W]
    (or a stack of tile columns [T, H, W]) and u / v, modes [(T,) bh, bw];
    rec = (rec_y, rec_u, rec_v) like the originals, coded in place; levels
    = (y, cb, cr) as [B, 16, 16] / [B, 8, 8] blocks, block (t, bx, by) at
    t * bw * bh + by * bw + bx, or with lv_planes as planes like rec;
    cbf = three [B] bool.  intra [bh, bw] bool (on the card) codes only
    its blocks; the kernel reads it, the host never does.  One launch on
    the current stream."""
    dev = _device(y)
    nt = y.shape[0] if y.dim() == 3 else 1
    H, W = y.shape[-2:]
    Hc, Wc = u.shape[-2:]
    lead = (nt,) if y.dim() == 3 else ()
    for k, t, shp in (("y", y, lead + (H, W)), ("u", u, lead + (Hc, Wc)),
                      ("v", v, lead + (Hc, Wc)), ("modes", modes,
                                                  lead + (bh, bw)),
                      ("rec_y", rec[0], lead + (H, W)),
                      ("rec_u", rec[1], lead + (Hc, Wc)),
                      ("rec_v", rec[2], lead + (Hc, Wc))):
        _check(k, t, torch.int32, dev)
        if tuple(t.shape) != shp:
            raise ValueError(f"flat_wavefront: {k} {tuple(t.shape)}, want "
                             f"{shp}")
    b = nt * bw * bh
    lshapes = ((lead + (H, W), lead + (Hc, Wc), lead + (Hc, Wc))
               if lv_planes else ((b, 16, 16), (b, 8, 8), (b, 8, 8)))
    for k, t, shp in zip(("levels_y", "levels_cb", "levels_cr"), levels,
                         lshapes):
        _check(k, t, torch.int32, dev)
        if tuple(t.shape) != shp:
            raise ValueError(f"flat_wavefront: {k} {tuple(t.shape)}, want "
                             f"{shp}")
    for k, t in zip(("cbf_y", "cbf_u", "cbf_v"), cbf):
        _check(k, t, torch.bool, dev)
        if tuple(t.shape) != (b,):
            raise ValueError(f"flat_wavefront: {k} {tuple(t.shape)}, want "
                             f"({b},)")
    if intra is not None:
        if y.dim() == 3:
            raise ValueError("flat_wavefront: an intra grid needs one picture")
        if intra.dtype != torch.bool:     # the kernel reads bytes of 0 / 1
            intra = intra.to(torch.uint8)
        intra = intra.contiguous()
        _check("intra", intra, intra.dtype, dev)
        if tuple(intra.shape) != (bh, bw):
            raise ValueError(f"flat_wavefront: intra {tuple(intra.shape)}")
    lite = _rdoq_mode(rdoq)
    sync = torch.zeros(1 + b, dtype=torch.int32, device=dev)
    tab, rate, lam_td = _consts(dev, (float(lam[0]), float(lam[1])),
                                float(lam_scale))
    flat_wavefront.last_grid = _launch(
        _load().vct_intra_flat_wavefront,
        y.data_ptr(), u.data_ptr(), v.data_ptr(), modes.data_ptr(),
        None if intra is None else intra.data_ptr(),
        *(t.data_ptr() for t in rec), *(t.data_ptr() for t in levels),
        int(lv_planes), *(t.data_ptr() for t in cbf), nt, H, W, Hc, Wc, bw,
        bh, qp, qp_c, int(bool(sbh)), lite, tab.data_ptr(), rate.data_ptr(),
        lam_td.data_ptr(), sync.data_ptr(), launch_stream(dev))
    flat_wavefront.launches += 1


flat_wavefront.launches = 0
flat_wavefront.last_grid = 0
