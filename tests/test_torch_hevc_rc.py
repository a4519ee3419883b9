"""Picture-level rate control and checkpoint resume in the port against
the JAX package's, on the CPU.

  - the controllers of models/hevc/ratectrl.py are the original's text,
    class by class, and give the original's QP sequence (and state) on a
    fixed list of picture bit counts;
  - `checkpoint.save` / `load` / `restore_rc` read what the other
    package wrote, field by field;
  - one low-delay P stream (bench_ldp_480's settings and clip at 64x48,
    6 pictures) under `RateLambdaControl` is the JAX encoder's byte for
    byte with the same per-picture QPs, and the port, resumed from a
    state the JAX encoder captured after picture 3 and wrote with the
    JAX package's `checkpoint.save`, emits the JAX encoder's resumed NALs.
    The JAX side runs with its AMVP predictor list swapped for the spec's,
    as the port carries it (tests/test_torch_hevc_ldp.py).
Tolerance 0: QPs, bytes and the controllers' floats are equal.
"""

import ast
import io
import pathlib

import numpy as np
import pytest
import torch
from bench import synth_clip

from video_codecs_tpu.models.hevc import checkpoint as jcp
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import inter_jax as jinter
from video_codecs_tpu.models.hevc import motion as jmotion
from video_codecs_tpu.models.hevc import ratectrl as jrc
from video_codecs_tpu_torch.models.hevc import checkpoint as tcp
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import motion as tmotion
from video_codecs_tpu_torch.models.hevc import ratectrl as trc

torch.set_grad_enabled(False)
REPO = pathlib.Path(__file__).resolve().parents[1]
RC = "models/hevc/ratectrl.py"

# The copied definitions, in the port's order (the two controllers that
# set QPs inside a picture, UrqBasicUnitControl and CtuRateControl, too).
_COPIED = ("RateLambdaControl", "UrqQuadraticControl", "_clip",
           "HmRateControl", "UrqBasicUnitControl", "GopRateLambdaControl",
           "CtuRateControl")
_CONSTS = ("_ALPHA_MIN", "_BETA_MIN", "_BETA1")


def _top(path):
    """name -> (first line, source) of the module's classes, functions
    and assignments (keyed by their first target)."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            out[node.name] = (node.lineno, ast.get_source_segment(text, node))
        elif isinstance(node, ast.Assign):
            t = node.targets[0]
            name = t.elts[0].id if isinstance(t, ast.Tuple) else t.id
            out[name] = (node.lineno, ast.get_source_segment(text, node))
    return out, text.split("\n")


def test_copy_matches_original_source():
    port, lines = _top(REPO / "video_codecs_tpu_torch" / RC)
    orig, _ = _top(REPO / "video_codecs_tpu" / RC)
    assert [k for k in port if k in orig and k not in _CONSTS] == \
        list(_COPIED)
    assert "UrqBasicUnitControl" in port and "CtuRateControl" in port
    for name in _COPIED:
        line, src = port[name]
        assert src == orig[name][1], name
        assert lines[line - 2] == \
            f"# video_codecs_tpu/{RC}:{orig[name][0]}", name
    for name in _CONSTS:
        assert port[name][1] == orig[name][1], name
    first = orig[_CONSTS[0]][0]
    assert f"# video_codecs_tpu/{RC}:{first}-{orig[_CONSTS[-1]][0]}" in lines


# ---- the controllers on a fixed list of bit counts --------------------------

_BITS = (61000, 9100, 14200, 30500, 3900, 8800, 15100, 11800, 9300, 52000,
         7000, 2500, 26000, 12000)
_MADS = (6.5, 4.25, 5.0, 9.75, 2.5, 4.0, 5.5, 5.25, 4.5, 11.0, 3.75, 1.5,
         8.0, 5.0)


def _make(mod, kind):
    w, h, bps = 416, 240, 400_000.0
    if kind == "RateLambdaControl":
        return mod.RateLambdaControl(bps, 30.0, w, h, base_qp=32)
    if kind == "UrqQuadraticControl":
        return mod.UrqQuadraticControl(bps, 30.0, w, h, base_qp=30)
    if kind == "HmRateControl":
        return mod.HmRateControl(bps, 30.0, w, h,
                                 gop_weights=(1.0, 0.5, 0.7, 0.5),
                                 n_levels=3)
    return mod.GopRateLambdaControl(bps, 30.0, w, h, base_qp=34,
                                    gop_qp_offsets=(1, 4, 3, 4))


@pytest.mark.parametrize("kind", ["RateLambdaControl", "UrqQuadraticControl",
                                  "HmRateControl", "GopRateLambdaControl"])
def test_controller_qp_sequence(kind):
    """pick_qp() before each picture and update(bits, mad) after it, as
    encode_frames drives them: the same QPs and the same state."""
    j, t = _make(jrc, kind), _make(trc, kind)
    qps = []
    for bits, mad in zip(_BITS, _MADS):
        q = t.pick_qp()
        assert q == j.pick_qp()
        qps.append(q)
        t.update(bits, mad)
        j.update(bits, mad)
        assert vars(t) == vars(j)
    assert len(set(qps)) >= 3, qps                 # the QP moves


def test_hm_rate_control_levels_and_intra_model():
    """HmRateControl's own interface: an intra picture at level 0 with
    its SATD cost, then inter pictures at levels 1 and 2."""
    j, t = _make(jrc, "HmRateControl"), _make(trc, "HmRateControl")
    plan = [(0, 2.1e6), (1, None), (2, None), (2, None), (1, None),
            (0, 1.7e6), (2, None), (1, None)]
    for (level, cost), bits in zip(plan, _BITS):
        got = t.start_picture(level, intra_cost=cost)
        assert got == j.start_picture(level, intra_cost=cost)
        for rc in (t, j):
            rc.update_after_picture(level, bits, got[1], got[0],
                                    is_intra=cost is not None,
                                    intra_cost=cost)
        assert vars(t) == vars(j)


# ---- checkpoints ------------------------------------------------------------

def _state(mod, cp):
    rng = np.random.default_rng(4)
    ref = (rng.integers(0, 256, (48, 64), dtype=np.uint8),
           rng.integers(0, 256, (24, 32), dtype=np.uint8),
           rng.integers(0, 256, (24, 32), dtype=np.uint8))
    rc = _make(mod, "RateLambdaControl")
    for bits in _BITS[:5]:
        rc.pick_qp()
        rc.update(bits, 0.0)
    return cp.capture(6, ref, rc), rc


def _same_state(a, b):
    assert a.poc == b.poc
    for p, q in zip(a.ref, b.ref):
        assert p.dtype == q.dtype
        np.testing.assert_array_equal(p, q)
    assert a.rc == b.rc


def test_checkpoint_save_load_both_ways(tmp_path):
    """A state the port writes loads in the JAX package and back, a file
    the JAX package writes loads in the port, and restore_rc rebuilds
    the controller in a new one of the same class."""
    ts, trc_ = _state(trc, tcp)
    js, _ = _state(jrc, jcp)
    _same_state(ts, js)
    tcp.save(ts, str(tmp_path / "port.npz"))
    jcp.save(js, str(tmp_path / "jax.npz"))
    _same_state(jcp.load(str(tmp_path / "port.npz")), js)
    loaded = tcp.load(str(tmp_path / "jax.npz"))
    _same_state(loaded, ts)
    assert isinstance(loaded.rc["prev_qp"], float)  # stored as floats
    fresh = _make(trc, "RateLambdaControl")
    tcp.restore_rc(loaded, fresh)
    assert vars(fresh) == vars(trc_)
    assert isinstance(fresh.prev_qp, int)
    with pytest.raises(AssertionError):            # another class
        tcp.restore_rc(loaded, _make(trc, "UrqQuadraticControl"))
    empty = tcp.EncoderState(poc=3, ref=None, rc=None)
    buf = io.BytesIO()
    tcp.save(empty, buf)
    buf.seek(0)
    assert tcp.load(buf) == empty


# ---- a rate-controlled LD-P stream, and a resumed one -----------------------

# 64x48 at 30 fps: about 1,700 bits a picture, well under what QP 32
# spends on bench's clip, so the controller raises the QP
_TARGET_BPS = 50_000


def _cfg(mod, w, h):
    return mod.HevcConfig(width=w, height=h, qp=32, num_refs=4,
                          merge_cands=5, temporal_mvp=True,
                          sign_data_hiding=True)


def test_ldp_rate_control_stream_and_resume(monkeypatch):
    w, h, n = 64, 48, 6
    frames = synth_clip(w, h, n, seed=0)
    monkeypatch.setattr(jmotion, "amvp_candidates", tmotion.amvp_candidates)

    def pair():
        return (jinter.DeviceLowDelayEncoder(_cfg(jheaders, w, h),
                                             search_range=64),
                jrc.RateLambdaControl(_TARGET_BPS, 30.0, w, h, base_qp=32),
                tinter.DeviceLowDelayEncoder(_cfg(theaders, w, h),
                                             search_range=64, device="cpu"),
                trc.RateLambdaControl(_TARGET_BPS, 30.0, w, h, base_qp=32))

    je, jr, te, tr = pair()
    js, _ = je.encode_sequence_ldp(frames, jr)
    ts, trec = te.encode_sequence_ldp(frames, tr)
    assert te.frame_qps == je.frame_qps
    assert len(set(te.frame_qps)) >= 3, te.frame_qps
    assert te.frame_qps[0] in (30, 31, 32, 33, 34)   # base_qp +- 2
    assert vars(tr) == vars(jr)
    assert ts == js
    dec = tdec.GeneralDecoder()
    out = dec.decode(ts)
    assert dec.hash_status == [True] * n
    for r, o in zip(trec, out):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c])

    # the JAX encoder stops after picture 3 and writes its state
    je, jr, te, tr = pair()
    _, _, state = je.encode_frames(frames[:4], None, jr)
    buf = io.BytesIO()
    jcp.save(state, buf)
    # both resume from those bytes with a new encoder and controller
    je, jr, te, tr = pair()
    buf.seek(0)
    want, _, jfinal = je.encode_frames(frames[4:], jcp.load(buf), jr)
    buf.seek(0)
    got, _, tfinal = te.encode_frames(frames[4:], tcp.load(buf), tr)
    assert te.frame_qps == je.frame_qps
    assert got == want
    assert vars(tr) == vars(jr)
    assert tfinal.poc == jfinal.poc == n
    assert tfinal.rc == jfinal.rc
