"""HRD timing SEI and the long-term IDR reference in the port against the
JAX package's, on the CPU.

  - models/hevc/sei.py is a whole copy: its text function by function,
    and every message's payload bytes both ways (each package's parser
    reads the other's writer);
  - the port's `GeneralDecoder` decodes the JAX host `LowDelayEncoder`'s
    long-term stream (the IDR outlives the short-term window) with every
    hash OK;
  - one 64x48 LD-P stream with SAO, timing SEI and the long-term IDR
    together is byte-equal to the JAX `DeviceLowDelayEncoder`'s, its SEI
    reads back as written, and it decodes hash OK in the port;
  - the two long-term cases the reference writes wrongly raise.
Tolerance 0 everywhere.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
from test_torch_hevc_host import _defs

from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.models.hevc import checkpoint as tcheckpoint
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc import sei as tsei

torch.set_grad_enabled(False)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _jsei():
    pytest.importorskip("jax")
    from video_codecs_tpu.models.hevc import sei
    return sei


def test_sei_copy_matches_original_source():
    """Every function and method of the port's sei.py is the original's
    text, under a comment giving the original's first line."""
    port, lines = _defs(REPO / "video_codecs_tpu_torch/models/hevc/sei.py")
    orig, _ = _defs(REPO / "video_codecs_tpu/models/hevc/sei.py")
    assert set(port) == set(orig)
    tag = re.compile(r"#\s*video_codecs_tpu/models/hevc/sei.py:(\d+)$")
    for name, (first, src) in port.items():
        m = tag.search(lines[first - 2].strip())
        assert m and int(m.group(1)) == orig[name][0], name
        assert src == orig[name][1], name
    assert set(tsei._TYPES) == set(_jsei()._TYPES)


def _to(mod, msg):
    """The same message as an instance of `mod`'s class (nested messages
    too)."""
    if isinstance(msg, tuple) and len(msg) == 2 and isinstance(msg[0], int):
        return msg                        # an unknown payload (type, bytes)
    cls = getattr(mod, type(msg).__name__)
    kw = {f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)}
    if "messages" in kw:
        kw["messages"] = [_to(mod, m) for m in kw["messages"]]
    return cls(**kw)


def _messages():
    import test_sei
    jsei = _jsei()
    return test_sei.MESSAGES + [
        jsei.BufferingPeriod(initial_cpb_removal_delay=90000),
        jsei.PictureTiming(au_cpb_removal_delay_minus1=7,
                           pic_dpb_output_delay=1),
        jsei.UserDataUnregistered(uuid=b"\xaa" * 16, data=b"x" * 600),
        jsei.ScalableNesting(messages=[jsei.RecoveryPoint(
            recovery_poc_cnt=4), jsei.ContentLightLevel()])]


def test_sei_payload_bytes_equal_both_ways():
    """Each message written by the port and by the JAX package: the same
    RBSP bytes, and each package's parser reads the other's bytes back to
    the message; the NAL units too, and all messages in one SEI."""
    jsei = _jsei()
    msgs = _messages()
    assert {type(m).__name__ for m in msgs} >= {
        c.__name__ for c in jsei._TYPES.values()}
    for jm in msgs:
        tm = _to(tsei, jm)
        tb, jb = tsei.write_sei_rbsp([tm]), jsei.write_sei_rbsp([jm])
        assert tb == jb, type(jm).__name__
        assert tsei.parse_sei_rbsp(jb) == [tm], type(jm).__name__
        assert jsei.parse_sei_rbsp(tb) == [jm], type(jm).__name__
        assert tsei.sei_nal([tm]) == jsei.sei_nal([jm])
        assert tsei.sei_nal([tm], prefix=False) == \
            jsei.sei_nal([jm], prefix=False)
    tall = [_to(tsei, m) for m in msgs]
    assert tsei.write_sei_rbsp(tall) == jsei.write_sei_rbsp(msgs)
    assert tsei.parse_sei_rbsp(jsei.write_sei_rbsp(msgs)) == tall
    unknown = bytes([200, 3, 1, 2, 3]) + b"\x80"
    assert tsei.parse_sei_rbsp(unknown) == jsei.parse_sei_rbsp(unknown) == \
        [(200, b"\x01\x02\x03")]


def test_general_decoder_decodes_jax_long_term_stream():
    """tests/test_long_term.py's `_encode_lt(64, 48, 12)`: the JAX host
    LowDelayEncoder keeps the IDR as a long-term picture past the
    short-term window; every picture hash OK in the port's decoder, the
    pictures the encoder's, the long-term entry parsed."""
    pytest.importorskip("jax")
    import test_long_term
    stream, recons = test_long_term._encode_lt(64, 48, 12)
    dec = tdec.GeneralDecoder()
    out = dec.decode(stream)
    assert dec.sps.lt_present and dec.sps.lt_refs == []
    assert dec.hash_status == [True] * 12
    for k, (r, o) in enumerate(zip(recons, out)):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(r[c]), o[c],
                                          err_msg=f"picture {k} plane {c}")


def _prefix_sei(stream):
    return [tsei.parse_sei_rbsp(tbs.strip_emulation_prevention(nal[2:]))
            for nal in tbs.split_annexb(stream)
            if (nal[0] >> 1) & 0x3F == tbs.NAL_PREFIX_SEI]


def _conf_cfg(mod):
    """64x48 LD-P with SAO, HRD timing SEI and the long-term IDR: one
    reference, no TMVP (the long-term mode's terms), merge 5, SBH."""
    return mod.HevcConfig(width=64, height=48, qp=30, num_refs=1,
                          merge_cands=5, sign_data_hiding=True, sao=True,
                          timing_sei=True, long_term_idr=True)


def test_ldp_sao_timing_sei_long_term_stream_equals_jax():
    """The JAX `DeviceLowDelayEncoder` (SAO IDR on its host CTB loop) and
    the port's on the CPU (the flat device IDR) write the same bytes with
    all three options on (`ld_ladder=False`: one QP, one JAX program);
    one buffering period on the first AU, picture timing on every AU with
    its CPB removal delay advancing; every hash OK in the port's decoder
    with the IDR resolved as the long-term reference."""
    pytest.importorskip("jax")
    import test_inter_jax
    from video_codecs_tpu.models.hevc import headers as jheaders
    from video_codecs_tpu.models.hevc import inter_jax as jinter
    frames = test_inter_jax.clip(64, 48, 5)
    js, _ = jinter.DeviceLowDelayEncoder(
        _conf_cfg(jheaders), search_range=16,
        ld_ladder=False).encode_sequence_ldp(frames)
    ts, trec = tinter.DeviceLowDelayEncoder(
        _conf_cfg(theaders), search_range=16, ld_ladder=False,
        device="cpu").encode_sequence_ldp(frames)
    assert ts == js
    aus = _prefix_sei(ts)
    assert len(aus) == len(frames)
    for k, au in enumerate(aus):
        bp = [m for m in au if isinstance(m, tsei.BufferingPeriod)]
        (pt,) = [m for m in au if isinstance(m, tsei.PictureTiming)]
        assert len(bp) == (1 if k == 0 else 0)
        assert pt.au_cpb_removal_delay_minus1 == max(0, k - 1)
        assert pt.pic_dpb_output_delay == 1
    assert aus[0][0].initial_cpb_removal_delay == 90000
    dec = tdec.GeneralDecoder()
    lt_refs = []
    orig_lt = dec._lt_pocs

    def lt_pocs(h):
        out = orig_lt(h)
        lt_refs.append(out)
        return out

    dec._lt_pocs = lt_pocs
    out = dec.decode(ts)
    assert dec.sps.lt_present and dec.sps.sao
    assert dec.hash_status == [True] * len(frames)
    assert lt_refs == [[0]] * (len(frames) - 1)
    for k, (r, o) in enumerate(zip(trec, out)):
        for c in range(3):
            np.testing.assert_array_equal(r[c], o[c],
                                          err_msg=f"picture {k} plane {c}")


def test_long_term_cases_the_reference_writes_wrongly_raise():
    """ADVICE.md:4-5: past POC 255 the 8-bit lsb of the long-term IDR
    matches POC 256 too, and a resumed run signals lsb 0 for a reference
    that is not the IDR; both raise before anything is coded."""
    enc = tinter.DeviceLowDelayEncoder(_conf_cfg(theaders), search_range=16,
                                       device="cpu")
    z = np.zeros((48, 64), np.uint8)
    pic = (z, z[::2, ::2], z[::2, ::2])
    enc.encode_frame = enc.encode_p_frame = None     # nothing may be coded
    with pytest.raises(ValueError, match="POC 255"):
        enc.encode_frames([pic] * 257)
    with pytest.raises(ValueError, match="start_state"):
        enc.encode_frames([pic], start_state=tcheckpoint.capture(1, pic))
