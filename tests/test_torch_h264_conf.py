"""The rest of the H.264 host coder in the port, against the JAX
package's, on the CPU: long-term references with MMCO and list
reordering, weighted prediction of P slices, intra refresh, perceptual
RDO and concealment.

The same seeded numpy inputs go through both packages.  Streams are
byte-equal and decoded pictures equal (tolerance 0); the DPB is read
after every picture it marks, in the encoders and in the decoders, as
plain tuples (frame_num, long-term index, the planes' SHA-1 and
MaxLongTermFrameIdx), and must be equal; so must each P picture's
weights, intra-refresh cursor and adaptive-rounding offsets, and the
decoders' `concealed` lists.  The perceptual model's per-MB lambda
weights `eta` are float32 from convolutions whose summation order is
XLA's on one side and PyTorch's on the other: they agree within
ETA_ATOL, and the streams they drive are byte-equal.  Clips are 32x32
to 96x96; the card case lives in tests/test_torch_h264_main.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from video_codecs_tpu.entropy import bitstream as jbs
from video_codecs_tpu.models.h264 import dpb as jdpb
from video_codecs_tpu.models.h264 import inter_codec as jinter
from video_codecs_tpu.models.h264 import intra_codec as jintra
from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.models.h264 import dpb as tdpb
from video_codecs_tpu_torch.models.h264 import inter_codec as tinter
from video_codecs_tpu_torch.models.h264 import intra_codec as tintra

torch.set_grad_enabled(False)

#: |eta(port) - eta(JAX)|: a few float32 ulps of the saliency maps,
#: divided by the blocks' standard deviation (measured up to 7.3e-6 on
#: 64x48 to 176x144 pictures)
ETA_ATOL = 1e-5


def _planes_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(
                np.asarray(a[c], np.int32), np.asarray(b[c], np.int32),
                err_msg=f"picture {i} plane {c}")


def translating_frames(n=6, w=64, h=48, seed=3):
    """tests/test_h264_conceal.py's clip: noise under a global motion of
    (4, 2) pixels a picture."""
    rng = np.random.default_rng(seed)
    by = rng.integers(0, 256, (h + 32, w + 32)).astype(np.uint8)
    bu = rng.integers(0, 256, (h // 2 + 16, w // 2 + 16)).astype(np.uint8)
    bv = rng.integers(0, 256, (h // 2 + 16, w // 2 + 16)).astype(np.uint8)
    out = []
    for t in range(n):
        dx, dy = t * 4, t * 2
        out.append((by[dy:dy + h, dx:dx + w],
                    bu[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2],
                    bv[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2]))
    return out


def static_clip(n=4, w=64, h=48):
    """tests/test_intra_refresh.py's clip: one noise picture, repeated."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return [(y, u, v)] * n


def smooth_clip(w, h, n, seed, fade=0.0):
    """A smoothed noise texture drifting by a few pixels a picture, its
    brightness scaled by 1 - fade * t (a fade to black when fade > 0)."""
    rng = np.random.default_rng(seed)
    pad = 16
    base = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad)).astype(float)
    k = np.array([1, 4, 6, 4, 1.0]) / 16
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, "same")
    out = []
    for t in range(n):
        dy, dx = pad + (t % 3) - 1, pad + 2 * t - n
        y = base[dy:dy + h, dx:dx + w] * (1.0 - fade * t)
        y = np.clip(y + rng.normal(0, 1.0, y.shape), 0, 255)
        out.append(tuple(p.astype(np.uint8) for p in
                         (y, y[::2, ::2] * 0.5 + 64, y[1::2, ::2] * 0.5 + 32)))
    return out


# ---- the DPB ----------------------------------------------------------------

def _state(d):
    """A Dpb as plain values: (frame_num, lt_idx, SHA-1 of the planes)
    per picture in its order, then MaxLongTermFrameIdx."""
    return (tuple((p.frame_num, p.lt_idx, hashlib.sha1(b"".join(
        np.ascontiguousarray(pl, np.int32).tobytes() for pl in p.planes)
        ).hexdigest()) for p in d.pics), d.max_lt_idx)


def _pic(mod, fn, lt=None):
    sh = (np.full((16, 16), fn, np.int32),) * 3
    return mod.RefPic(sh, frame_num=fn, lt_idx=lt)


def test_sliding_window_evicts_mid_list_pic():
    """tests/test_h264_dpb.py's twin: eviction is by identity."""
    d = tdpb.Dpb(2)
    d.mark(_pic(tdpb, 0, lt=0))      # long-term head stays
    d.mark(_pic(tdpb, 1))
    d.mark(_pic(tdpb, 2))            # evicts fn=1 (mid list), not the LT
    assert [p.frame_num for p in d.pics] == [0, 2]
    assert d.pics[0].long_term


def test_mmco6_unmarks_duplicate_lt_idx():
    d = tdpb.Dpb(3)
    d.mark(_pic(tdpb, 0), mmco=[(6, 0)])
    cur = _pic(tdpb, 1)
    d.mark(cur, mmco=[(4, 1), (6, 0)])
    lts = [p for p in d.pics if p.long_term]
    assert lts == [cur]        # old lt_idx-0 picture dropped


def test_mmco3_unmarks_duplicate_lt_idx():
    d = tdpb.Dpb(3)
    d.mark(_pic(tdpb, 0), mmco=[(6, 0)])
    d.mark(_pic(tdpb, 1))
    # assign lt_idx 0 to the short-term fn=1 (difference_of_pic_nums=1)
    d.mark(_pic(tdpb, 2), mmco=[(3, 1, 0)])
    lts = [p for p in d.pics if p.long_term]
    assert len(lts) == 1 and lts[0].frame_num == 1


def test_reorder_missing_pic_raises_diagnosable():
    d = tdpb.Dpb(2)
    d.mark(_pic(tdpb, 0))
    with pytest.raises(ValueError, match="long-term"):
        d.apply_reorder(d.default_list0(1), [(2, 0)], 1, 1)
    with pytest.raises(ValueError, match="short-term"):
        d.apply_reorder(d.default_list0(1), [(0, 5)], 1, 1)


def _commands(rng, fn, d):
    """Seeded MMCO commands (or None: the sliding window) for the
    picture with frame_num fn, valid for the DPB d."""
    if rng.random() < 0.35:
        return None
    st = [p for p in d.pics if not p.long_term]
    cmds = []
    for _ in range(int(rng.integers(1, 4))):
        op = int(rng.integers(1, 7))
        if op in (1, 3) and st:
            p = st[int(rng.integers(0, len(st)))]
            diff = fn - d.pic_num(p, fn)
            cmds.append((1, diff) if op == 1 else
                        (3, diff, int(rng.integers(0, 3))))
        elif op == 2:
            cmds.append((2, int(rng.integers(0, 3))))
        elif op == 4:
            cmds.append((4, int(rng.integers(0, 4))))
        elif op == 6:
            cmds.append((6, int(rng.integers(0, 3))))
    return cmds


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dpb_marking_and_reorder_equal(seed):
    """Seeded pictures with MMCO 1-4 and 6, the sliding window, wrapped
    frame_nums, IDR resets and reordered lists (short-term both ways and
    long-term): the port's Dpb stays the JAX Dpb's after every command,
    and so do the lists and the errors."""
    rng = np.random.default_rng(seed)
    dt, dj = tdpb.Dpb(3, 4), jdpb.Dpb(3, 4)
    fn = 0
    for i in range(60):
        if rng.random() < 0.05:
            dt.idr_reset()
            dj.idr_reset()
            fn = 0
        cmds = _commands(rng, fn, dj)
        dt.mark(_pic(tdpb, fn), cmds)
        dj.mark(_pic(jdpb, fn), cmds)
        assert _state(dt) == _state(dj), (i, cmds)
        fn = (fn + 1) % 16
        lt, lj = dt.default_list0(fn), dj.default_list0(fn)
        assert [p.frame_num for p in lt] == [p.frame_num for p in lj]
        reo = [(int(rng.integers(0, 3)), int(rng.integers(1, 4)))
               for _ in range(int(rng.integers(1, 3)))]
        reo = [(op, a - 1 if op == 2 else a) for op, a in reo]
        outs = []
        for d, lst in ((dt, lt), (dj, lj)):
            try:
                outs.append([(p.frame_num, p.lt_idx) for p in
                             d.apply_reorder(lst, reo, fn, 2)])
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], reo


# ---- whole streams ------------------------------------------------------------

def _recorded_run(mod, frames, monkeypatch, device=None, **kw):
    """Encode with `mod`'s H264Encoder and decode with its H264Decoder,
    recording the DPB after each mark, and per P picture the weights,
    the intra-refresh cursor, the adaptive-rounding offsets and eta."""
    marks, pics = [], []
    dpb_cls = (tdpb if mod is tinter else jdpb).Dpb
    orig_mark = dpb_cls.mark

    def mark(self, cur, mmco=None):
        orig_mark(self, cur, mmco)
        marks.append(_state(self))
    monkeypatch.setattr(dpb_cls, "mark", mark)
    orig_p = mod.H264Encoder._encode_p_frame

    def p_frame(self, *a, **k):
        out = orig_p(self, *a, **k)
        around = getattr(self, "_around", None)
        pics.append(dict(
            wp=self._wp, cursor=self._refresh_cursor,
            around=None if around is None else
            {k_: v.tolist() for k_, v in around.off.items()},
            eta=None if self._eta is None else np.array(self._eta)))
        return out
    monkeypatch.setattr(mod.H264Encoder, "_encode_p_frame", p_frame)
    extra = {} if device is None else {"device": device}
    enc = mod.H264Encoder(**kw, **extra)
    stream, recons = enc.encode_sequence(frames)
    enc_marks = list(marks)
    del marks[:]
    dec = mod.H264Decoder()
    out = dec.decode(stream)
    monkeypatch.undo()
    return dict(stream=stream, recons=recons, enc_marks=enc_marks,
                dec_marks=list(marks), pics=pics, out=out, enc=enc)


def _streams_equal(frames, monkeypatch, **kw):
    t = _recorded_run(tinter, frames, monkeypatch, device="cpu", **kw)
    j = _recorded_run(jinter, frames, monkeypatch, **kw)
    assert t["stream"] == j["stream"]
    _planes_equal(t["recons"], j["recons"])
    assert t["enc_marks"] == j["enc_marks"]
    assert len(t["enc_marks"]) == len(frames)
    assert t["dec_marks"] == j["dec_marks"] == t["enc_marks"]
    _planes_equal(t["out"], t["recons"])
    _planes_equal(jinter.H264Decoder().decode(t["stream"]), t["recons"])
    assert len(t["pics"]) == len(j["pics"]) == len(frames) - 1
    for a, b in zip(t["pics"], j["pics"]):
        assert (a["wp"], a["cursor"], a["around"]) == \
            (b["wp"], b["cursor"], b["around"])
        assert (a["eta"] is None) == (b["eta"] is None)
        if a["eta"] is not None:
            assert a["eta"].dtype == np.float32
            np.testing.assert_allclose(a["eta"], b["eta"], rtol=0,
                                       atol=ETA_ATOL)
    return t


_LTR_CASES = {
    "lt-period-reorder-cavlc": dict(entropy="cavlc", n_refs=2,
                                    long_term=True, lt_period=2,
                                    reorder="lt_first"),
    "lt-reorder-epzs-cabac": dict(entropy="cabac", me="epzs", n_refs=2,
                                  long_term=True, reorder="lt_first"),
    "lt-period-umhex-around": dict(entropy="cabac", me="umhex",
                                   quant="around", n_refs=1, lt_period=2),
}


@pytest.mark.parametrize("name", sorted(_LTR_CASES))
def test_long_term_stream_equal(name, monkeypatch):
    """The long-term IDR, MMCO 4+6 every lt_period P pictures and the
    lt_first reordering (the card stage searches the reordered list, so
    EPZS's temporal predictor sees the long-term picture as ref 0):
    stream, pictures and the DPB after every picture equal, in both
    encoders and both decoders."""
    kw = _LTR_CASES[name]
    t = _streams_equal(smooth_clip(64, 48, 5, seed=2), monkeypatch,
                       width=64, height=48, qp=30, search_range=8, **kw)
    # the IDR is long-term (lt_idx 0) in every case
    assert t["enc_marks"][0][0][0][1] == 0
    if kw.get("lt_period"):
        # MMCO 4+6: the current picture of every lt_period-th P picture
        # becomes the only long-term one
        lts = [[p for p in m[0] if p[1] is not None]
               for m in t["enc_marks"]]
        assert [len(x) for x in lts] == [1] * 5
        assert lts[2][0][0] == 2 and lts[4][0][0] == 4


@pytest.mark.parametrize("name,kw", [
    ("cabac-epzs-trellis-3", dict(entropy="cabac", me="epzs",
                                  quant="trellis", n_refs=3)),
    ("cavlc-full-1", dict(entropy="cavlc", n_refs=1)),
])
def test_weighted_pred_fade_stream_equal(name, kw, monkeypatch):
    """Weighted prediction of P slices on a fade: each P picture's
    weights per reference (`estimate_wp`), the pred_weight_table, the
    weighted final prediction and the decoder's `_mc_wp` equal."""
    t = _streams_equal(smooth_clip(64, 48, 5, seed=4, fade=0.1),
                       monkeypatch, width=64, height=48, qp=30,
                       search_range=8, weighted_pred=True, **kw)
    assert all(p["wp"] is not None for p in t["pics"])
    assert any(w["w"][0] != 64 for p in t["pics"] for w in p["wp"])


def test_wp_helpers_equal():
    """estimate_wp, write_pred_weight_table and parse_pred_weight_table
    on seeded planes and weight lists, bits equal both ways."""
    rng = np.random.default_rng(9)
    planes = []
    for g in (1.0, 0.7, 1.3, 0.0):
        y = rng.integers(0, 200, (32, 48)).astype(np.float64)
        planes.append(tuple(np.clip(p * g + rng.integers(-3, 4, p.shape),
                                    0, 255).astype(np.uint8)
                            for p in (y, y[::2, ::2], y[1::2, ::2])))
    wps = []
    for a in planes:
        for b in planes:
            wt, wj = tinter.estimate_wp(a, b), jinter.estimate_wp(a, b)
            assert wt == wj
            wps.append(wt)
    for logd in (0, 5, 6):
        bt, bj = tbs.BitWriter(), jbs.BitWriter()
        tinter.write_pred_weight_table(bt, wps, logd)
        jinter.write_pred_weight_table(bj, wps, logd)
        bt.rbsp_trailing_bits()
        bj.rbsp_trailing_bits()
        assert bt.data() == bj.data()
        got = tinter.parse_pred_weight_table(tbs.BitReader(bt.data()),
                                            len(wps))
        assert got == jinter.parse_pred_weight_table(
            jbs.BitReader(bt.data()), len(wps))
        for g, wp in zip(got, wps):
            assert (g["w"], g["o"], g["logd"]) == (wp["w"], wp["o"], logd)


def test_intra_refresh_forces_intra_on_static_content():
    """tests/test_intra_refresh.py's twin: on a static scene the forced
    intra MBs make every P slice more than twice as large; the port's
    streams are the JAX package's."""
    frames = static_clip(4)
    base = tinter.H264Encoder(64, 48, qp=28, device="cpu").encode_sequence(
        frames)[0]
    refr = tinter.H264Encoder(64, 48, qp=28, intra_refresh=4,
                              device="cpu").encode_sequence(frames)[0]
    sizes = [[len(n) for n in tbs.split_annexb(s) if n[0] & 0x1F == 1]
             for s in (base, refr)]
    assert len(sizes[0]) == len(sizes[1]) == 3
    assert all(r > 2 * b for b, r in zip(*sizes)), sizes
    assert base == jinter.H264Encoder(64, 48, qp=28).encode_sequence(
        frames)[0]
    assert refr == jinter.H264Encoder(64, 48, qp=28,
                                      intra_refresh=4).encode_sequence(
        frames)[0]


@pytest.mark.parametrize("entropy,n", [("cavlc", 5), ("cabac", 7)])
def test_intra_refresh_stream_equal(entropy, n, monkeypatch):
    """Cyclic intra refresh (5 MBs a P picture over 12 MBs: the cursor
    wraps) on a moving clip, with adaptive rounding: the cursor and the
    rounding offsets after every picture equal."""
    t = _streams_equal(smooth_clip(64, 48, n, seed=5), monkeypatch,
                       width=64, height=48, qp=28, search_range=8,
                       entropy=entropy, quant="around", intra_refresh=5)
    assert [p["cursor"] for p in t["pics"]] == \
        [(5 * (i + 1)) % 12 for i in range(n - 1)]


@pytest.mark.parametrize("perc,size", [("att+ssim", (64, 48)),
                                       ("att", (96, 96)),
                                       ("ssim", (96, 64))])
def test_perceptual_stream_equal(perc, size, monkeypatch):
    """Perceptual RDO: the saliency weights of every P picture within
    ETA_ATOL of the JAX package's and the streams byte-equal (the IDR's
    eta from the picture alone, the P pictures' with the motion term)."""
    w, h = size
    t = _streams_equal(smooth_clip(w, h, 3, seed=7), monkeypatch,
                       width=w, height=h, qp=30, search_range=8,
                       perceptual=perc)
    assert all((p["eta"] is not None) == ("att" in perc)
               for p in t["pics"])


def test_att_eta_and_block_ssim_equal():
    """`_att_eta` over a sequence (the previous picture kept on the
    encoder's device) and `block_ssim` on seeded blocks."""
    frames = smooth_clip(96, 64, 4, seed=8)
    et = tintra.H264IntraEncoder(96, 64, perceptual="att", device="cpu")
    ej = jintra.H264IntraEncoder(96, 64, perceptual="att")
    for y, _, _ in frames:
        a, b = et._att_eta(y), ej._att_eta(y)
        assert a.shape == b.shape == (4, 6)
        np.testing.assert_allclose(a, b, rtol=0, atol=ETA_ATOL)
    assert et._prev_y.device == torch.device("cpu")
    rng = np.random.default_rng(2)
    for _ in range(20):
        a = rng.integers(0, 256, (16, 16))
        b = np.clip(a + rng.integers(-30, 31, a.shape), 0, 255)
        assert tintra.block_ssim(a, b) == jintra.block_ssim(a, b)


# ---- concealment -----------------------------------------------------------

def _drop_nth_slice(stream: bytes, n: int) -> bytes:
    out, seen = [], 0
    for nal in tbs.split_annexb(stream):
        if (nal[0] & 0x1F) in (1, 5):
            seen += 1
            if seen == n:
                continue
        out.append(b"\x00\x00\x00\x01" + nal)
    return b"".join(out)


def _cut_nth_slice(stream: bytes, n: int) -> bytes:
    """The n-th slice NAL cut to a third of its bytes: it fails to
    parse."""
    out, seen = [], 0
    for nal in tbs.split_annexb(stream):
        if (nal[0] & 0x1F) in (1, 5):
            seen += 1
            if seen == n:
                nal = nal[:max(len(nal) // 3, 4)]
        out.append(b"\x00\x00\x00\x01" + nal)
    return b"".join(out)


def _conceal_equal(lossy, mode):
    dt, dj = tinter.H264Decoder(conceal=mode), jinter.H264Decoder(
        conceal=mode)
    out_t, out_j = dt.decode(lossy), dj.decode(lossy)
    assert dt.concealed == dj.concealed
    _planes_equal(out_t, out_j)
    return dt, out_t


def test_conceal_fills_lost_frame():
    """tests/test_h264_conceal.py's twin: the third P picture lost; frame
    copy and motion copy conceal it as the JAX decoders do, and motion
    copy wins on a global translation."""
    frames = translating_frames()
    stream, _ = tinter.H264Encoder(64, 48, qp=30,
                                   device="cpu").encode_sequence(frames)
    lossy = _drop_nth_slice(stream, 4)       # lose the 3rd P picture
    fc, out_fc = _conceal_equal(lossy, 1)
    assert len(out_fc) == len(frames) and fc.concealed == [3]
    mc, out_mc = _conceal_equal(lossy, 2)
    assert len(out_mc) == len(frames) and mc.concealed == [3]

    def psnr(out):
        d = np.stack([o[0] for o in out]).astype(np.float64) - \
            np.stack([f[0] for f in frames])
        return 10 * np.log10(255.0 ** 2 / np.mean(d * d))
    assert psnr(out_mc) > psnr(out_fc) + 1.0
    assert psnr(out_mc) > 15


@pytest.mark.parametrize("entropy,how", [("cavlc", "cut"),
                                         ("cabac", "drop2"),
                                         ("cabac", "clean")])
def test_conceal_lost_and_broken_slices_equal(entropy, how):
    """A slice cut short (it raises inside the decoder), two pictures lost
    in a row (a frame_num gap of 2) and a clean stream (nothing to
    conceal), both modes: `concealed` and the pictures equal."""
    frames = translating_frames(n=6)
    stream, recons = tinter.H264Encoder(64, 48, qp=30, entropy=entropy,
                                        n_refs=2, device="cpu"
                                        ).encode_sequence(frames)
    if how == "cut":
        lossy = _cut_nth_slice(stream, 3)
        want = [2]
    elif how == "drop2":
        lossy = _drop_nth_slice(_drop_nth_slice(stream, 3), 3)
        want = [2, 3]
    else:
        lossy, want = stream, []
    for mode in (1, 2):
        dec, out = _conceal_equal(lossy, mode)
        assert dec.concealed == want
        if how == "clean":
            _planes_equal(out, recons)
