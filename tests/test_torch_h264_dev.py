"""The PyTorch port's H.264 device P-slice engine against the JAX engine
(models/h264/inter_jax.py), on the same seeded clips, with tolerance 0:
`encode_p_dev` outputs key by key, whole streams byte for byte, and the
decoded pictures bit-exact in the port's own H264Decoder and in the JAX
package's.  Also the fence between the two packages: the port imports
nothing of `video_codecs_tpu`.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_codecs_tpu.models.h264 import inter_jax as ij
from video_codecs_tpu.models.h264.inter_codec import H264Decoder
from video_codecs_tpu_torch.models.h264 import inter_dev as tid
from video_codecs_tpu_torch.models.h264.inter_codec import (
    H264Decoder as PortH264Decoder)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shifted_clip(w, h, nf, seed=0):
    """tests/test_h264_dev.py's clip: one noise texture panning."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 16, w + 16), np.uint8)
    frames = []
    for f in range(nf):
        y = np.ascontiguousarray(base[f:f + h, 2 * f:2 * f + w])
        frames.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                       (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return frames


def mixed_motion_clip(w, h, nf, seed=0):
    """Smooth texture in which each MB moves on its own and about half the
    MBs split into 8x8 blocks that move on their own, so both P_16x16 and
    P_8x8 win somewhere; MVs reach past the picture edge."""
    rng = np.random.default_rng(seed)
    pad = 24
    base = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad)).astype(float)
    k = np.array([1, 4, 6, 4, 1.0]) / 16
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, "same")
    frames = []
    for f in range(nf):
        y = base[pad:pad + h, pad:pad + w].copy()
        if f:
            for my in range(0, h, 16):
                for mx in range(0, w, 16):
                    d = rng.integers(-7, 8, 2)
                    split = rng.random() < 0.5
                    for by in (0, 8):
                        for bx in (0, 8):
                            if split:
                                d = rng.integers(-7, 8, 2)
                            sy, sx = pad + my + by + d[1], pad + mx + bx + d[0]
                            y[my + by:my + by + 8, mx + bx:mx + bx + 8] = \
                                base[sy:sy + 8, sx:sx + 8]
        y = np.clip(y + rng.normal(0, 1.5, y.shape), 0, 255).astype(np.uint8)
        frames.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                       (y[1::2, ::2] // 2 + 32).astype(np.uint8)))
    return frames


@pytest.mark.parametrize("w,h,sr,qp", [(96, 80, 8, 30), (64, 48, 16, 28)])
def test_encode_p_dev_matches_jax(w, h, sr, qp):
    frames = mixed_motion_clip(w, h, 2, seed=w)
    (y, u, v), ref = frames[1], [p.astype(np.int32) for p in frames[0]]
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    sj = ij.encode_p_dev(*[jnp.asarray(p) for p in (y, u, v, *ref)],
                         qp=qp, w=w, h=h, sr=sr, lam=lam)
    st = tid.encode_p_dev(*[torch.from_numpy(p) for p in (y, u, v, *ref)],
                          qp=qp, w=w, h=h, sr=sr, lam=lam)
    assert sorted(st) == sorted(sj)
    for k in sj:
        a, b = np.asarray(sj[k]), st[k].numpy()
        assert (b.shape, b.dtype) == (a.shape, a.dtype), k
        np.testing.assert_array_equal(b, a, err_msg=k)
    # the P_16x16 / P_8x8 decision went both ways
    assert 0 < int(np.asarray(sj["split8"]).sum()) < sj["split8"].size


def _decode_equal(stream, recons):
    for dec in (PortH264Decoder(), H264Decoder()):
        out = dec.decode(stream)
        assert len(out) == len(recons)
        for i, (r, o) in enumerate(zip(recons, out)):
            for c in range(3):
                np.testing.assert_array_equal(
                    np.asarray(r[c], np.uint8), np.asarray(o[c], np.uint8),
                    err_msg=f"frame {i} plane {c}")


@pytest.mark.parametrize("clip", [shifted_clip, mixed_motion_clip])
def test_stream_byte_equal_to_jax_engine(clip):
    frames = clip(96, 80, 4)
    sj, rj = ij.DeviceH264Encoder(96, 80, qp=30,
                                  search_range=8).encode_sequence(frames)
    enc = tid.DeviceH264Encoder(96, 80, qp=30, search_range=8,
                                device="cpu")
    sp, rp = enc.encode_sequence(frames)
    assert sp == sj
    for a, b in zip(rp, rj):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
    _decode_equal(sp, rp)
    assert len(enc.p_times) == 3


def test_host_fallback_cases_raise():
    # several references have no device path and no host P coder in the
    # port: the constructor refuses them
    with pytest.raises(NotImplementedError):
        tid.DeviceH264Encoder(32, 32, qp=30, search_range=4,
                              device="cpu", n_refs=2)
    enc = tid.DeviceH264Encoder(32, 32, qp=30, search_range=4)
    assert enc.device == torch.device("cuda")     # the card by default


def test_port_runs_without_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["video_codecs_tpu"] = None
        import numpy as np
        import video_codecs_tpu_torch
        from video_codecs_tpu_torch.models.h264.inter_dev import (
            DeviceH264Encoder)
        from video_codecs_tpu_torch.models.h264.inter_codec import (
            H264Decoder)
        rng = np.random.default_rng(3)
        base = rng.integers(0, 256, (48, 64), np.uint8)
        frames = []
        for f in range(3):
            y = np.ascontiguousarray(base[f:f + 32, 2 * f:2 * f + 48])
            frames.append((y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2))
        enc = DeviceH264Encoder(48, 32, qp=28, search_range=8,
                                device="cpu")
        stream, recons = enc.encode_sequence(frames)
        out = H264Decoder().decode(stream)
        assert all(np.array_equal(np.asarray(r[c], np.uint8),
                                  np.asarray(o[c], np.uint8))
                   for r, o in zip(recons, out) for c in range(3))
        bad = [m for m in sys.modules
               if m in ("jax", "video_codecs_tpu")
               or m.startswith(("jax.", "video_codecs_tpu."))
               if sys.modules[m] is not None]
        assert not bad, bad
        assert len(enc.p_times) == 2
        from video_codecs_tpu_torch.models.hevc import encoder_qt_dev
        from video_codecs_tpu_torch.models.hevc import headers
        from video_codecs_tpu_torch.models.hevc import quadtree_codec
        cfg = headers.HevcConfig(width=64, height=40, qp=32, log2_ctb=5,
                                 log2_min_cb=3, log2_max_tb=5,
                                 sign_data_hiding=True, rdoq="lite")
        hevc = quadtree_codec.QuadtreeFastEncoder(cfg, device="cpu")
        hstream, hrec = hevc.encode_sequence(
            [(base[:40, :64], base[:40:2, :64:2], base[1:41:2, :64:2])])
        dec = quadtree_codec.QuadtreeIntraDecoder()
        hout = dec.decode(hstream)
        assert dec.hash_status == [True]
        assert all(np.array_equal(hrec[0][c], hout[0][c]) for c in range(3))
        assert encoder_qt_dev.CTB == 32
        bad = [m for m in sys.modules
               if m in ("jax", "video_codecs_tpu")
               or m.startswith(("jax.", "video_codecs_tpu."))
               if sys.modules[m] is not None]
        assert not bad, bad
        print("OK", len(stream))
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")


_FENCED = ["chip_smoke.py", "scripts/profile_torch_h264_p.py",
           "scripts/profile_torch_hevc_intra.py",
           "scripts/profile_torch_hevc_ra.py",
           "scripts/profile_torch_hevc_ldp.py",
           *sorted(str(p.relative_to(REPO)) for p in
                   pathlib.Path(REPO, "video_codecs_tpu_torch").rglob("*.py"))]


@pytest.mark.parametrize("path", _FENCED)
def test_port_imports_nothing_of_jax_package(path):
    """No `import video_codecs_tpu...` / `from video_codecs_tpu... import`
    anywhere in the port, its smoke run or its profiler, at any depth."""
    tree = ast.parse(pathlib.Path(REPO, path).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in ("video_codecs_tpu", "jax")]
    assert not bad, bad
