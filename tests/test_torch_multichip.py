"""The tile-sharded random-access engine (parallel/sharded.py), the
sharded inputs of `encode_b_frame_dev` and the entry points of
graft_entry.py against the JAX package, on the CPU, at tolerance 0.

The JAX side of the tiled stream is a test-local `TiledRefQt` over the
JAX package's `QtDeviceRandomAccessEncoder`, built as
`__graft_entry__.dryrun_multichip` builds it (halo-padded columns
gathered with clamped indices, `encode_b_frame_dev` with `gx_blk0` /
`pic_bw`, `qt_merge_dev`, the maps cropped by `_QT_GRAN`) with the
dryrun's two faults repaired as the port repairs them: the picture's QP
in place of the base QP, and the deblock of the assembled picture in
place of each padded column's (`_jax_deblock_maps`, the jnp text of
qt_merge_dev's deblock).

The `cuda` case runs where JAX is not installed, so JAX is imported only
inside the tests that compare with it:

    python -m pytest --noconftest -m cuda tests/test_torch_multichip.py
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch import graft_entry
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.parallel import sharded

torch.set_grad_enabled(False)

WT, H, HALO, SR, PICTURES = 64, 64, 32, 8, 3


def _cfg(headers, w, h):
    return headers.HevcConfig(width=w, height=h, qp=32, log2_ctb=5,
                              log2_min_cb=3, log2_max_tb=5, reorder_pics=3,
                              sign_data_hiding=True, rdoq="lite",
                              merge_cands=5)


def _jax_deblock_maps(qt, qp):
    """qt_merge_dev's deblock (video_codecs_tpu/models/hevc/inter_qt.py:
    380-423) in jnp, on the assembled picture's maps."""
    import jax.numpy as jnp

    from video_codecs_tpu.models.hevc import inter_qt
    from video_codecs_tpu.ops import deblock as deblock_ops

    def up8(f):
        return jnp.repeat(jnp.repeat(f, 2, axis=0), 2, axis=1)

    q = {k: jnp.asarray(v) for k, v in qt.items()}
    pm8 = up8(q["pred_mode"].astype(jnp.int32))
    dir8 = q["dir8"].astype(jnp.int32)
    r0, r1 = q["r0_8"].astype(jnp.int32), q["r1_8"].astype(jnp.int32)
    inner = q["tusplit"] | q["split8"]
    eff8 = jnp.where(up8(inner), q["cbf_y8"], up8(q["cbf_y"]))

    def bs_pair8(a, b):
        intra2 = (pm8 == inter_qt.MODE_INTRA)[a] | \
            (pm8 == inter_qt.MODE_INTRA)[b]
        d0 = (jnp.abs(q["mv0x8"][a] - q["mv0x8"][b]) >= 4) | \
            (jnp.abs(q["mv0y8"][a] - q["mv0y8"][b]) >= 4) | (r0[a] != r0[b])
        d1 = (jnp.abs(q["mv1x8"][a] - q["mv1x8"][b]) >= 4) | \
            (jnp.abs(q["mv1y8"][a] - q["mv1y8"][b]) >= 4) | (r1[a] != r1[b])
        mv_diff = jnp.where(dir8[a] == 3, d0 | d1,
                            jnp.where((dir8[a] & 1) > 0, d0, d1))
        one = eff8[a] | eff8[b] | (dir8[a] != dir8[b]) | mv_diff
        return jnp.where(intra2, 2, jnp.where(one, 1, 0)).astype(jnp.int32)

    ver8 = bs_pair8(np.s_[:, :-1], np.s_[:, 1:]).T
    hor8 = bs_pair8(np.s_[:-1, :], np.s_[1:, :])
    ver8 = ver8.at[0::2].set(
        jnp.where(jnp.repeat(inner.T, 2, axis=1), ver8[0::2], 0))
    hor8 = hor8.at[0::2].set(
        jnp.where(jnp.repeat(inner, 2, axis=1), hor8[0::2], 0))
    return deblock_ops.deblock_420_bs(
        q["rec_y"].astype(jnp.int32), q["rec_u"].astype(jnp.int32),
        q["rec_v"].astype(jnp.int32), qp, ver8, hor8, block=8)


def _jax_tiled_ref(wt, halo, record):
    """The dryrun's TiledRefQt over the JAX encoder, repaired; every
    column's inputs and `encode_b_frame_dev` dict go into `record`."""
    import jax.numpy as jnp

    from video_codecs_tpu.models.hevc import inter_jax, inter_qt

    class TiledRefQt(inter_qt.QtDeviceRandomAccessEncoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.qt_log = {}
            self._poc = None

        def _encode_b_frame(self, frame, poc, refs, is_anchor):
            self._poc = poc
            return super()._encode_b_frame(frame, poc, refs, is_anchor)

        def _device_phase(self, y, u, v, args, has_l1, lam):
            cfg = self.cfg
            w, h = cfg.width, cfg.height

            def slab(a, scale=1):
                lo = (ti * wt - halo) // scale
                hi = ((ti + 1) * wt + halo) // scale
                a = np.asarray(a)
                idx = np.clip(np.arange(lo, hi), 0, a.shape[-1] - 1)
                return jnp.asarray(np.take(a, idx, axis=-1))

            outs = {k: [] for k in sharded.KEYS}
            for ti in range(w // wt):
                wp = wt + 2 * halo
                pl = [slab(y), slab(u, 2), slab(v, 2),
                      slab(args[0]), slab(args[1], 2), slab(args[2], 2),
                      slab(args[3]), slab(args[4], 2), slab(args[5], 2)]
                kw = dict(qp=cfg.qp, w=wp, h=h, has_l1=has_l1,
                          search_range=self.search_range,
                          sbh=cfg.sign_data_hiding, rdoq=True,
                          me_method="pyr", deblock=False, allow_intra=False,
                          merge_eval="best4", lam=lam, rqt=True, cu8=True)
                g = dict(gx_blk0=(ti * wt - halo) // 16, pic_bw=w // 16)
                st16 = inter_jax.encode_b_frame_dev(
                    *pl, **kw, **{k: jnp.int32(v) for k, v in g.items()})
                record.append(([np.asarray(p) for p in pl], kw, g,
                               {k: np.asarray(v) for k, v in st16.items()}))
                qt = inter_qt.qt_merge_dev(
                    *pl, st16, qp=cfg.qp, w=wp, h=h, has_l1=has_l1,
                    sbh=cfg.sign_data_hiding, rdoq=True, deblock=False,
                    lam=lam)
                for k in sharded.KEYS:
                    c = sharded.crop_cells(k, halo)
                    outs[k].append(np.asarray(qt[k][:, c:-c]))
            full = {k: np.concatenate(outs[k], axis=-1) for k in outs}
            rec = _jax_deblock_maps(full, cfg.qp)
            for k, r in zip(("rec_y", "rec_u", "rec_v"), rec):
                full[k] = np.asarray(r).astype(np.uint8)
            self.qt_log[self._poc] = full
            return full

    return TiledRefQt


def test_tiled_ra_equals_jax_sharded_and_stages():
    """2 tile columns of 64, 64 rows, 3 pictures of the dryrun's clip at
    its settings (the IDR, the anchor P at POC 2 and the B at POC 1: one
    JAX compile per temporal layer): the port's TiledRefQt gives the JAX
    decomposition's stream and maps; each column's `encode_b_frame_dev` dict (with
    gx_blk0 / pic_bw) is the JAX one's key by key on the recorded
    inputs; ShardedQt on two CPU devices gives the same maps and bytes;
    every picture hash OK in the port's GeneralDecoder with the
    encoder's pictures."""
    from video_codecs_tpu.models.hevc import headers as jheaders

    w = 2 * WT
    frames = graft_entry.dryrun_clip(w, H, PICTURES)
    record = []
    jenc = _jax_tiled_ref(WT, HALO, record)(_cfg(jheaders, w, H),
                                            search_range=SR)
    jstream, _ = jenc.encode_sequence_ra(frames)
    tenc = sharded.TiledRefQt(_cfg(theaders, w, H), search_range=SR,
                              tile_width=WT, halo=HALO, device="cpu")
    tstream, recons = tenc.encode_sequence_ra(frames)
    assert tstream == jstream
    for poc, maps in jenc.qt_log.items():
        for k in sharded.KEYS:
            np.testing.assert_array_equal(tenc.qt_log[poc][k], maps[k],
                                          err_msg=f"poc {poc} {k}")
    # the anchor P's and the B picture's columns, stage by stage
    assert len(record) == 4
    for planes, kw, g, st16 in record:
        got = tinter.encode_b_frame_dev(
            *(torch.from_numpy(p.copy()) for p in planes), **kw, **g)
        assert set(got) == set(st16)
        for k, v in st16.items():
            assert got[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    senc = sharded.ShardedQt(_cfg(theaders, w, H), search_range=SR,
                             tile_width=WT, halo=HALO, device="cpu",
                             devices=["cpu", "cpu"])
    assert senc.encode_sequence_ra(frames)[0] == jstream
    for poc, maps in tenc.qt_log.items():
        for k in sharded.KEYS:
            np.testing.assert_array_equal(senc.qt_log[poc][k], maps[k])
    dec = tdec.GeneralDecoder()
    pics = dec.decode(tstream)
    assert dec.hash_status == [True] * PICTURES
    for p, r in zip(pics, recons):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(p[c]), r[c])


def test_encode_b_frame_dev_me_fields_equal_jax():
    """me_fields in place of reference 0's ME (list 0 holds two
    references, so reference 1 is searched), with gx_blk0 / pic_bw of a
    middle column and of the picture's last (one JAX compile: both are
    traced): the dict is the JAX function's key by key."""
    import jax.numpy as jnp

    from video_codecs_tpu.models.hevc import inter_jax
    rng = np.random.default_rng(7)
    h, w = 32, 96
    bw, bh = w // 16, h // 16

    def plane(hh, ww, n=None):
        shape = (hh, ww) if n is None else (n, hh, ww)
        return rng.integers(0, 256, shape).astype(np.uint8)

    planes = [plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2),
              plane(h, w, 2), plane(h // 2, w // 2, 2),
              plane(h // 2, w // 2, 2), plane(h, w, 1),
              plane(h // 2, w // 2, 1), plane(h // 2, w // 2, 1)]
    me = [tuple(rng.integers(lo, hi, bw * bh).astype(np.int32)
                for lo, hi in ((-20, 21), (-12, 13), (0, 9000)))
          for _ in range(1)]
    kw = dict(qp=30, w=w, h=h, has_l1=False, search_range=8, sbh=True,
              rdoq=True, deblock=False, allow_intra=False,
              merge_eval="best4", lam=180.0)
    for g0 in (2, 10):
        want = inter_jax.encode_b_frame_dev(
            *(jnp.asarray(p) for p in planes),
            me_fields=[tuple(jnp.asarray(a) for a in f) for f in me],
            gx_blk0=jnp.int32(g0), pic_bw=jnp.int32(g0 + bw - 2), **kw)
        got = tinter.encode_b_frame_dev(
            *(torch.from_numpy(p) for p in planes),
            me_fields=[tuple(torch.from_numpy(a) for a in f) for f in me],
            gx_blk0=g0, pic_bw=g0 + bw - 2, **kw)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=f"{g0} {k}")


def test_dryrun_multichip_on_cpu_devices(monkeypatch, capsys):
    """dryrun_multichip(2) at its smallest size (columns of 32, 32 rows)
    on two CPU devices: its checks pass, it prints its OK line, and the
    N-device stream decodes hash OK with every picture; its frame-axis
    step on the run's leaf B pictures; without a card and without
    devices it raises."""
    monkeypatch.setenv("VCT_DRYRUN_WT", "32")
    monkeypatch.setenv("VCT_DRYRUN_H", "32")
    out = graft_entry.dryrun_multichip(2, devices=["cpu", "cpu"])
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip OK:") and "64x32" in line
    assert out["stream"] == out["tiled_stream"]
    dec = tdec.GeneralDecoder()
    dec.decode(out["stream"])
    assert dec.hash_status == [True] * 9
    # the frame axis (n_devices > 4) on this run: two leaf B pictures,
    # each on a frame row of two CPU devices, give the sequential maps
    enc = out["encoder"]
    leaves = graft_entry.leaf_pocs(enc, 2)
    note = graft_entry.leaf_batch(enc, leaves, out["frames"], out["recons"],
                                  [["cpu", "cpu"], ["cpu", "cpu"]])
    assert len(leaves) == 2 and "maps equal" in note
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        graft_entry.dryrun_multichip(2)


def test_entry_equals_jax():
    """entry(): the flat all-intra step on its seeded 64x48 inputs, on
    the CPU, returns the JAX entry's arrays."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    jentry = importlib.import_module("__graft_entry__").entry
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(fn(*args), jfn(*jargs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_refusals():
    """TMVP has no tiled input; tile widths and halos are multiples of 32
    that divide the picture; ShardedQt needs a device per column."""
    with pytest.raises(ValueError, match="TMVP"):
        cfg = _cfg(theaders, 128, 64)
        cfg.temporal_mvp = True
        sharded.TiledRefQt(cfg, tile_width=64, device="cpu")
    for wt, halo in ((48, 32), (64, 16), (96, 32)):
        with pytest.raises(ValueError, match="multiples of 32"):
            sharded.TiledRefQt(_cfg(theaders, 128, 64), tile_width=wt,
                               halo=halo, device="cpu")
    with pytest.raises(ValueError, match="2 devices"):
        sharded.ShardedQt(_cfg(theaders, 128, 64), tile_width=64,
                          device="cpu", devices=["cpu"])
    assert sharded.default_devices(3, "cpu") == ["cpu"] * 3


# ---- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_card_equals_cpu():
    """ShardedQt at 2 columns of 64, 64 rows, 3 pictures on the card
    (both columns on it) gives the CPU's stream byte for byte, through
    the SAD and RDOQ kernels, and the TiledRefQt's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels, no interpret mode)")
    from video_codecs_tpu_torch.ops import rdoq_dev
    from video_codecs_tpu_torch.ops import sad_surface as ss
    w = 2 * WT
    frames = graft_entry.dryrun_clip(w, H, PICTURES)
    streams, launches = [], []
    for dev in ("cuda", "cpu"):
        n0 = (ss.sad_surface.launches, rdoq_dev.rdoq_dev.launches)
        enc = sharded.ShardedQt(_cfg(theaders, w, H), search_range=SR,
                                tile_width=WT, halo=HALO, device=dev,
                                devices=[dev, dev])
        streams.append(enc.encode_sequence_ra(frames)[0])
        launches.append((ss.sad_surface.launches - n0[0],
                         rdoq_dev.rdoq_dev.launches - n0[1]))
    assert streams[0] == streams[1]
    assert launches[0][0] > 0 and launches[0][1] > 0
    assert launches[1] == (0, 0)
    ref = sharded.TiledRefQt(_cfg(theaders, w, H), search_range=SR,
                             tile_width=WT, halo=HALO, device="cuda")
    assert ref.encode_sequence_ra(frames)[0] == streams[0]
