"""The port's HEVC random-access GOP-8 encoder on the CTB32 quadtree and
its general decoder against the JAX package's, on the CPU.

For each configuration (one test each, so that no pytest-xdist worker
compiles another's JAX programs) the JAX `QtDeviceRandomAccessEncoder`
and the port's encode the same seeded clip:
  - the streams are byte-equal, decode with every picture hash OK in the
    port's `GeneralDecoder`, and the decoded pictures are the encoder's;
  - stage parity without cascades: the JAX encoder's two device stages
    (`inter_jax.encode_b_frame_dev`, `inter_qt.qt_merge_dev`) are wrapped
    inside the test to record their inputs and outputs (no file of the
    JAX package is edited), the same inputs go through the port's stages,
    and the dicts are compared key by key.
Tolerance 0 everywhere, float32 rates included.  The clips mirror
tests/test_inter_qt.py.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from video_codecs_tpu.models.hevc import decoder as jdec
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import inter_jax as jinter
from video_codecs_tpu.models.hevc import inter_qt as jqt
from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import inter_qt as tqt

torch.set_grad_enabled(False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clip(w, h, n, seed=3):
    """tests/test_inter_qt.py's panning-noise clip."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + n + 1, w + 2 * n + 1)).astype(np.uint8)
    frames = []
    for f in range(n):
        y = np.ascontiguousarray(base[f:f + h, 2 * f:2 * f + w])
        u = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        v = (y[1::2, ::2] // 2 + 32).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def divergent_clip(w, h, n):
    """tests/test_inter_qt.py's per-8x8 divergent motion (CU8 pays)."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.uint8)
    frames = []
    for f in range(n):
        y = np.ascontiguousarray(base[16:16 + h, 16:16 + w]).copy()
        if f:
            r2 = np.random.default_rng(100 + f)
            for by in range(h // 8):
                for bx in range(w // 8):
                    dy, dx = r2.integers(-3, 4, 2)
                    y[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] = \
                        base[16 + by * 8 + dy:16 + (by + 1) * 8 + dy,
                             16 + bx * 8 + dx:16 + (bx + 1) * 8 + dx]
        u = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        v = (y[1::2, ::2] // 2 + 32).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _cfg(mod, w, h, **kw):
    cfg = mod.HevcConfig(width=w, height=h, qp=32, log2_ctb=5,
                         log2_min_cb=3, log2_max_tb=5, reorder_pics=3,
                         sign_data_hiding=True, rdoq="lite", merge_cands=5)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _np(v):
    return np.asarray(v)


def _t(v):
    """A recorded JAX input as the port takes it: arrays as CPU tensors,
    0-d integers as Python ints."""
    a = np.asarray(v)
    return int(a) if a.ndim == 0 else torch.from_numpy(a.copy())


def _dict_equal(got, want, what):
    """Every key equal, dtype and values (the float32 `coef_bits` too)."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    bad = []
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w_ = np.asarray(want[k])
        assert g.dtype == w_.dtype, (what, k, g.dtype, w_.dtype)
        if not np.array_equal(g, w_):
            bad.append((k, int((g != w_).sum())))
    assert not bad, (what, bad)


def _run(monkeypatch, w, h, frames, enc_kw, **cfg_kw):
    """Encode `frames` with both encoders, recording the JAX encoder's
    device stages; check streams, decoders and stage parity."""
    calls = {"b": [], "qt": []}
    orig_b, orig_qt = jinter.encode_b_frame_dev, jqt.qt_merge_dev

    def rec_b(*args, **kw):
        out = orig_b(*args, **kw)
        calls["b"].append((args, kw, {k: _np(v) for k, v in out.items()}))
        return out

    def rec_qt(*args, **kw):
        out = orig_qt(*args, **kw)
        calls["qt"].append((args, kw, {k: _np(v) for k, v in out.items()}))
        return out

    monkeypatch.setattr(jinter, "encode_b_frame_dev", rec_b)
    monkeypatch.setattr(jqt, "qt_merge_dev", rec_qt)
    jenc = jqt.QtDeviceRandomAccessEncoder(_cfg(jheaders, w, h, **cfg_kw),
                                           **enc_kw)
    js, _ = jenc.encode_sequence_ra(frames)
    tenc = tqt.QtDeviceRandomAccessEncoder(_cfg(theaders, w, h, **cfg_kw),
                                           device="cpu", **enc_kw)
    ts, trec = tenc.encode_sequence_ra(frames)
    assert len(ts) == len(js)
    assert ts == js
    dec = tdec.GeneralDecoder()
    out = dec.decode(ts)
    assert dec.hash_status == [True] * len(frames)
    for k, (r, o) in enumerate(zip(trec, out)):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c],
                                          err_msg=f"picture {k} plane {c}")

    # stage parity, each stage fed the reference's own inputs
    assert len(calls["b"]) == len(calls["qt"]) == len(frames) - 1
    for i, ((ba, bkw, bout), (qa, qkw, qout)) in enumerate(
            zip(calls["b"], calls["qt"])):
        kw = dict(bkw)
        if kw.get("tmvp_fields") is not None:
            kw["tmvp_fields"] = tuple(_t(v) for v in kw["tmvp_fields"])
        st16 = tinter.encode_b_frame_dev(*(_t(a) for a in ba), **kw)
        _dict_equal(st16, bout, f"encode_b_frame_dev, call {i}")
        qargs = [_t(a) for a in qa[:9]]
        qst = {k: _t(v) for k, v in qa[9].items()}
        got = tqt.qt_merge_dev(*qargs, qst, **qkw)
        _dict_equal(got, qout, f"qt_merge_dev, call {i}")
    return ts, out


def test_ra_96x64_gop9_streams_decoders_and_stages(monkeypatch):
    """The full 9-picture GOP-8 (CU8 tree on, as the encoder's default),
    and the port's decoder on the JAX stream against the JAX decoder."""
    w, h = 96, 64
    frames = clip(w, h, 9)
    ts, out = _run(monkeypatch, w, h, frames, dict(search_range=16))
    jd = jdec.GeneralDecoder()
    jout = jd.decode(ts)
    assert jd.hash_status == [True] * 9
    for a, b in zip(out, jout):
        for c in range(3):
            np.testing.assert_array_equal(a[c], np.asarray(b[c]))


def test_ra_80x48_boundary_ctbs(monkeypatch):
    """Picture not a CTB32 multiple: implicit boundary splits.  Three
    pictures (IDR, the anchor P at POC 2, the B at POC 1) hold every
    slice type; the 9-picture GOP is the 96x64 test's."""
    w, h = 80, 48
    _run(monkeypatch, w, h, clip(w, h, 3, seed=5), dict(search_range=16))


def test_ra_cu8_two_refs_per_list(monkeypatch):
    """CU8 split tree + 2 active refs per list ([R, H, W] stacks: the B
    picture at POC 1 has POC 0 and 2 in both lists)."""
    w, h = 96, 64
    _run(monkeypatch, w, h, divergent_clip(w, h, 3),
         dict(search_range=8, cu8=True, num_refs_active=2))


def test_ra_headline_settings_tmvp(monkeypatch):
    """The headline's settings at 96x64: SR64, pyramid ME, no CU8 tree,
    TMVP on (temporal candidates from the stored collocated field)."""
    w, h = 96, 64
    _run(monkeypatch, w, h, clip(w, h, 3, seed=13),
         dict(search_range=64, me_method="pyr", cu8=False),
         temporal_mvp=True)


def test_ra_tz_cu8(monkeypatch):
    """HM's TZSearch at search range 64 in both trees: the per-16 search
    and the CU8 tree's per-8 one (`b_me_one(..., n=8)`), TMVP on.  Three
    pictures (IDR, the anchor P at POC 2, the B at POC 1) hold every slice
    type and both temporal layers' lambdas."""
    w, h = 96, 64
    _run(monkeypatch, w, h, clip(w, h, 3, seed=21),
         dict(search_range=64, me_method="tz", cu8=True),
         temporal_mvp=True)


def test_ra_cut_options_raise():
    cfg = _cfg(theaders, 64, 64, sao=True)       # SAO is ported
    assert tqt.QtDeviceRandomAccessEncoder(cfg).device == torch.device("cuda")
    for m in ("tz", "full", "auto"):             # HM's searches are ported
        assert tqt.QtDeviceRandomAccessEncoder(
            _cfg(theaders, 64, 64), me_method=m,
            device="cpu").me_method == m
    with pytest.raises(ValueError):              # no such search
        tqt.QtDeviceRandomAccessEncoder(_cfg(theaders, 64, 64),
                                        me_method="hex", device="cpu")
    enc = tqt.QtDeviceRandomAccessEncoder(_cfg(theaders, 64, 64))
    assert enc.device == torch.device("cuda")     # the card by default
    assert enc._qt_intra.device == torch.device("cuda")
    z = torch.zeros((64, 64), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):      # tile-sharded inputs
        tinter.encode_b_frame_dev(
            z, z[::2, ::2], z[::2, ::2], z, z[::2, ::2], z[::2, ::2],
            z, z[::2, ::2], z[::2, ::2], qp=32, w=64, h=64, has_l1=False,
            search_range=8, sbh=True, rdoq=True, deblock=False,
            allow_intra=False, merge_eval="best4", me_fields=[])


@pytest.mark.parametrize("feature", ["tile_columns", "wpp",
                                     "weighted_pred", "cu_qp_delta",
                                     "long_term_idr"])
def test_general_decoder_cut_syntax_raises(feature):
    """The parameter sets of syntax the decoder does not carry raise;
    long-term reference pictures, weighted prediction and cu_qp_delta,
    ported since, are parsed."""
    cfg = _cfg(theaders, 64, 64)
    setattr(cfg, feature, 2 if feature == "tile_columns" else True)
    stream = tbs.annexb([
        tbs.nal_unit(tbs.NAL_VPS, theaders.write_vps(cfg)),
        tbs.nal_unit(tbs.NAL_SPS, theaders.write_sps(cfg)),
        tbs.nal_unit(tbs.NAL_PPS, theaders.write_pps(cfg))])
    dec = tdec.GeneralDecoder()
    if feature == "long_term_idr":
        assert dec.decode(stream) == []
        assert dec.sps.lt_present and dec.sps.lt_refs == []
        return
    if feature in ("weighted_pred", "cu_qp_delta"):
        assert dec.decode(stream) == []
        assert getattr(dec.pps, feature)
        assert dec.pps.diff_cu_qp_delta_depth == 0
        return
    with pytest.raises(NotImplementedError):
        dec.decode(stream)


def test_ra_runs_without_jax(tmp_path):
    """The RA encoder and the general decoder import nothing of JAX or
    of the JAX package."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["video_codecs_tpu"] = None
        import numpy as np
        from video_codecs_tpu_torch.models.hevc import decoder, headers
        from video_codecs_tpu_torch.models.hevc import inter_qt
        rng = np.random.default_rng(3)
        base = rng.integers(0, 256, (48, 80), np.uint8)
        frames = []
        for f in range(5):
            y = np.ascontiguousarray(base[f:f + 32, 2 * f:2 * f + 64])
            frames.append((y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2))
        cfg = headers.HevcConfig(width=64, height=32, qp=32, log2_ctb=5,
                                 log2_min_cb=3, log2_max_tb=5,
                                 reorder_pics=3, sign_data_hiding=True,
                                 rdoq="lite", merge_cands=5,
                                 temporal_mvp=True)
        enc = inter_qt.QtDeviceRandomAccessEncoder(
            cfg, search_range=64, cu8=False, device="cpu")
        stream, recons = enc.encode_sequence_ra(frames)
        dec = decoder.GeneralDecoder()
        out = dec.decode(stream)
        assert dec.hash_status == [True] * 5, dec.hash_status
        assert all(np.array_equal(r[c], o[c])
                   for r, o in zip(recons, out) for c in range(3))
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
