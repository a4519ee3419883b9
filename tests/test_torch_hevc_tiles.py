"""HEVC tiles and WPP in the port against the JAX package.

The port's `parallel/tiles.py` codes the tile columns as one batch (a
leading tile dimension where the reference shards them over a device
mesh with `shard_map`), its `IntraEncoder` writes tile and WPP slices
(the device route for rdoq off, the host CTB loop otherwise) and its
`IntraDecoder` and `GeneralDecoder` decode them.  The tests hold the
bytes, the recon and the decoded pictures to the JAX package's with
tolerance 0 at 128x64 (2 pictures), 64x48 for WPP (tests/test_tiles.py's
size), and hold the host quadtree RD encoder, `utils/debug`, the proxy
rate of `_code_blocks_rate` and the inter coders' refusals of tiles and
WPP to the reference (tests/conftest.py forces 8 host devices, so the
reference's `shard_map` runs on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_intra_codec import synth_frame
from video_codecs_tpu.entropy import bitstream as jbs
from video_codecs_tpu.models.hevc import encoder_jax as jenc
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import intra_codec as jic
from video_codecs_tpu.models.hevc import quadtree_codec as jqc
from video_codecs_tpu.parallel import tiles as jtiles
from video_codecs_tpu.utils import debug as jdebug
from video_codecs_tpu_torch.models.hevc import bframe_codec as tbc
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import encoder_dev as tenc
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import inter_codec as tpc
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.models.hevc import quadtree_codec as tqc
from video_codecs_tpu_torch.models.hevc import ra_codec as tra
from video_codecs_tpu_torch.parallel import tiles as ttiles
from video_codecs_tpu_torch.utils import debug as tdebug


def _cfgs(**kw):
    return jheaders.HevcConfig(**kw), theaders.HevcConfig(**kw)


def _same_recons(a, b):
    for ra, rb in zip(a, b):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(ra[c]),
                                          np.asarray(rb[c]))


def _decoded_equal(stream, n, recons, intra_cls=tic.IntraDecoder):
    """The port's GeneralDecoder and `intra_cls` on `stream`: every hash
    OK and the encoder's pictures (the JAX package's GeneralDecoder on
    the JAX streams: tests/test_torch_hevc_dec_tools.py)."""
    for dec in (tdec.GeneralDecoder(), intra_cls()):
        out = dec.decode(stream)
        assert dec.hash_status == [True] * n
        _same_recons(recons, out)


def test_tile_batch_equals_jax_host_loop():
    """In 2 and 4 tile columns, `encode_sequence_tiles(device="cpu")`
    gives the JAX package's IntraEncoder host loop's bytes and recon
    (its tests hold its shard_map path to that loop, tests/test_tiles.py;
    its own tile-aware mode decision here), and so do the port's host
    loop (reached with the modes given) and the port's IntraEncoder
    device route (the tile batch); both decoders."""
    for n_tiles in (2, 4):
        _tile_batch_equals_jax_host_loop(n_tiles)


def _tile_batch_equals_jax_host_loop(n_tiles):
    w, h = 128, 64
    jcfg, tcfg = _cfgs(width=w, height=h, qp=30, tile_columns=n_tiles)
    frames = [synth_frame(w, h, s) for s in range(2)]
    js, jr = jic.IntraEncoder(jcfg).encode_sequence(frames)
    ts, tr = ttiles.encode_sequence_tiles(tcfg, frames, device="cpu")
    assert ts == js
    _same_recons(jr, tr)
    enc = tic.IntraEncoder(tcfg, device="cpu")
    nals = enc.stream_headers()
    for (y, u, v) in frames:
        fn, _ = enc.encode_frame(y, u, v, modes=enc.decide_modes(y))
        nals += fn
    assert jbs.annexb(nals) == js
    assert tic.IntraEncoder(tcfg, device="cpu").encode_sequence(
        frames)[0] == js
    _decoded_equal(js, 2, jr)


def test_tile_batch_equals_jax_shard_map():
    """The tile batch against the reference's shard_map path itself, at
    tests/test_tiles.py::test_shard_map_tiles_match_host[2]'s 512x128 (2
    tile columns over 2 of the 8 forced host devices; its first
    picture): bytes and recon."""
    jcfg, tcfg = _cfgs(width=512, height=128, qp=30, tile_columns=2)
    frames = [synth_frame(512, 128, 0)]
    js, jr = jtiles.encode_sequence_tiles(jcfg, frames)
    ts, tr = ttiles.encode_sequence_tiles(tcfg, frames, device="cpu")
    assert ts == js
    _same_recons(jr, tr)


def test_tile_batch_state_equals_untiled_columns():
    """The stack's wavefront codes each column as a picture of its own:
    `encode_tiles_dev` without the deblock equals `encode_frame` run on
    each column alone, key by key."""
    w, h, nt = 128, 32, 4
    y, u, v = (torch.from_numpy(np.ascontiguousarray(p))
               for p in synth_frame(w, h, 7))
    bw, bh, tbw = w // 16, h // 16, w // 16 // nt
    st = ttiles.encode_tiles_dev(y, u, v, 31, bw, bh, nt, deblock=False)
    for t in range(nt):
        cols = slice(t * tbw * 16, (t + 1) * tbw * 16)
        ccol = slice(t * tbw * 8, (t + 1) * tbw * 8)
        one = tenc.encode_frame(y[:, cols].contiguous(),
                                u[:, ccol].contiguous(),
                                v[:, ccol].contiguous(), 31, tbw, bh,
                                deblock=False)
        idx = (np.arange(bh)[:, None] * bw + t * tbw +
               np.arange(tbw)[None]).reshape(-1)
        for k in ("levels_y", "levels_cb", "levels_cr"):
            np.testing.assert_array_equal(st[k][idx].numpy(),
                                          one[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(st["cbf"][:, idx].numpy(),
                                      one["cbf"].numpy())
        np.testing.assert_array_equal(st["modes"][:, t * tbw:(t + 1) * tbw]
                                      .numpy(), one["modes"].numpy())
        np.testing.assert_array_equal(st["rec_y"][:, cols].numpy(),
                                      one["rec_y"].numpy())
        np.testing.assert_array_equal(st["rec_u"][:, ccol].numpy(),
                                      one["rec_u"].numpy())


def _jax_intra(jcfg, tcfg, frames):
    """The JAX package's IntraEncoder stream, its host loop given the
    port's modes (held to its own decision in
    test_tile_batch_equals_jax_host_loop and
    tests/test_torch_hevc_host_ldp.py), which spares the reference's
    eager mode sweep a compile a picture size."""
    enc, tenc = jic.IntraEncoder(jcfg), tic.IntraEncoder(tcfg, device="cpu")
    nals, recons = enc.stream_headers(), []
    for (y, u, v) in frames:
        fn, rec = enc.encode_frame(y, u, v, modes=tenc.decide_modes(y))
        nals += fn
        recons.append(rec)
    return jbs.annexb(nals), recons


def test_tiled_intra_encoder_equals_jax():
    """Two tile columns through IntraEncoder: the host CTB loop with the
    full RDOQ, SAO (merge-left stops at the tile edge) and SBH, and the
    device route (the tile batch) with SBH, each the JAX host loop's
    bytes and recon; both decoders hash OK."""
    w, h = 128, 64
    for kw in (dict(rdoq="full", sao=True, sign_data_hiding=True),
               dict(sign_data_hiding=True)):
        jcfg, tcfg = _cfgs(width=w, height=h, qp=30, tile_columns=2, **kw)
        frames = [synth_frame(w, h, s + 3) for s in range(2)]
        js, jr = _jax_intra(jcfg, tcfg, frames)
        ts, tr = tic.IntraEncoder(tcfg, device="cpu").encode_sequence(
            frames)
        assert ts == js
        _same_recons(jr, tr)
        _decoded_equal(js, 2, jr)


def test_wpp_equals_jax_and_decodes():
    """WPP at tests/test_tiles.py's 64x48: the port's IntraEncoder (the
    device route, with SBH, or the host loop with RDOQ-lite and SAO)
    gives the JAX host loop's bytes and recon, and the JAX device path
    with the WPP writer (what scripts/jax_reference_sha1.py --wpp builds;
    QP 32, the program tests/test_encoder_jax.py compiles) the same; the
    port's IntraDecoder and GeneralDecoder hash OK."""
    for kw in (dict(), dict(rdoq="lite", sao=True),
               dict(sign_data_hiding=True)):
        _wpp_equals_jax_and_decodes(kw)


def _wpp_equals_jax_and_decodes(kw):
    w, h = 64, 48
    jcfg, tcfg = _cfgs(width=w, height=h, qp=32, wpp=True, **kw)
    frames = [synth_frame(w, h, s) for s in range(2)]
    js, jr = jic.IntraEncoder(jcfg).encode_sequence(frames)
    ts, tr = tic.IntraEncoder(tcfg, device="cpu").encode_sequence(frames)
    assert ts == js
    _same_recons(jr, tr)
    _decoded_equal(js, 2, jr)
    if not kw:
        import jax
        enc = jic.IntraEncoder(jcfg)
        nals = enc.stream_headers()
        for (y, u, v) in frames:
            st = jax.device_get(jenc.encode_frame_jit(y, u, v, 32, 4, 3))
            cbf, modes = st["cbf"], st["modes"].reshape(-1)
            ctus = [jic.CtuData(
                int(modes[i]), st["levels_y"][i] if cbf[0, i] else None,
                st["levels_cb"][i] if cbf[1, i] else None,
                st["levels_cr"][i] if cbf[2, i] else None)
                for i in range(12)]
            nals += [enc._encode_slice(ctus),
                     enc._hash_sei(st["rec_y"], st["rec_u"], st["rec_v"])]
        assert jbs.annexb(nals) == js


def test_native_writer_refuses_tiles_and_wpp():
    """The native C++ writer writes one substream: the fast path's
    serializer refuses tiles and WPP, which encode_frame writes."""
    for kw in (dict(tile_columns=2), dict(wpp=True)):
        enc = tic.IntraEncoder(theaders.HevcConfig(width=64, height=48,
                                                   **kw), device="cpu")
        with pytest.raises(ValueError):
            enc.serialize_frame({"modes": np.zeros((3, 4), np.int8)})


@pytest.mark.parametrize("kw", [dict(tile_columns=2), dict(wpp=True)],
                         ids=["tiles", "wpp"])
def test_inter_coders_refuse_tiles_and_wpp(kw):
    """The reference's P and B slice writers code one substream while the
    header signals entry points (reference fault 15): the port's host
    LD-P, hierarchical-B and random-access coders raise."""
    cfg = theaders.HevcConfig(width=128, height=48, **kw)
    for cls in (tpc.LowDelayEncoder, tbc.HierarchicalBEncoder,
                tra.RandomAccessEncoder):
        with pytest.raises(ValueError):
            cls(cfg, device="cpu")
    tpc.LowDelayEncoder(theaders.HevcConfig(width=128, height=48),
                        device="cpu")


@pytest.mark.parametrize("log2_ctb", [4, 5], ids=["ctb16", "ctb32"])
def test_quadtree_intra_encoder_equals_jax(log2_ctb):
    """`QuadtreeIntraEncoder` at tests/test_quadtree.py's sizes (64x48 at
    CTB 16, 64x64 at CTB 32; at CTB 32 also with the full RDOQ and SBH):
    the JAX package's NAL units and recon on one picture; the port's
    decoders hash OK."""
    for kw in ([{}] if log2_ctb == 4 else
               [{}, dict(rdoq="full", sign_data_hiding=True)]):
        _quadtree_equals_jax(log2_ctb, kw)


def _quadtree_equals_jax(log2_ctb, kw):
    w, h = 64, 64 if log2_ctb > 4 else 48
    jcfg, tcfg = _cfgs(width=w, height=h, qp=32, log2_min_cb=3,
                       log2_ctb=log2_ctb, log2_max_tb=min(5, log2_ctb),
                       **kw)
    frame = synth_frame(w, h, 0)
    jn, jr = jqc.QuadtreeIntraEncoder(jcfg).encode_frame(*frame)
    enc = tqc.QuadtreeIntraEncoder(tcfg, device="cpu")
    tn, tr = enc.encode_frame(*frame)
    assert tn == jn
    _same_recons([jr], [tr])
    stream = jbs.annexb(enc.stream_headers() + tn)
    _decoded_equal(stream, 1, [tr], tqc.QuadtreeIntraDecoder)


def test_dump_mode_statistics_equals_jax(monkeypatch, capsys):
    """VCT_DUMP_MODES=1: the port prints the reference's leaf lines
    (tests/test_quadtree.py::test_dump_mode_statistics's picture)."""
    monkeypatch.setenv("VCT_DUMP_MODES", "1")
    jcfg, tcfg = _cfgs(width=64, height=64, qp=32, log2_min_cb=3,
                       log2_ctb=5, log2_max_tb=5)
    frame = synth_frame(64, 64, 0)
    jqc.QuadtreeIntraEncoder(jcfg).encode_frame(*frame)
    jout = capsys.readouterr().out
    tqc.QuadtreeIntraEncoder(tcfg, device="cpu").encode_frame(*frame)
    tout = capsys.readouterr().out
    lines = [ln for ln in tout.splitlines() if ln.startswith("absPartIdx=")]
    assert lines and tout == jout
    assert sum(int(ln.split()[3].split("x")[0]) ** 2
               for ln in lines) == 64 * 64


def test_env_registry_equals_jax(monkeypatch):
    """The port's utils/debug in tests/test_debug_tools.py's cases."""
    for mod in (jdebug, tdebug):
        v = mod.register("VCT_TEST_FLAG", "0", "test flag")
        monkeypatch.delenv("VCT_TEST_FLAG", raising=False)
        assert v.value == "0"
        monkeypatch.setenv("VCT_TEST_FLAG", "1")
        assert v.value == "1"
        assert mod.env_flag("VCT_TEST_FLAG", False, "test flag") is True
        assert mod.env_int("VCT_TEST_FLAG", 0, "test flag") == 1
        assert mod.env_str("VCT_NOT_SET", "x", "unset") == "x"
        assert any(e.name == "VCT_TEST_FLAG" for e in mod.registered())
        assert "VCT_TEST_FLAG = 1" in mod.print_env_vars()
    names = {e.name for e in tdebug.registered()}
    assert {"VCT_TRACE", "VCT_FORCE_I4", "VCT_DUMP_MODES"} <= names

    def lines(mod):
        return [ln for ln in mod.print_env_vars().splitlines()
                if ln.split(" = ")[0].strip(" *") in names]
    assert lines(tdebug) == lines(jdebug)


def test_code_blocks_rate_proxy_equals_jax():
    """`_code_blocks_rate` without the full RDOQ (RDOQ-lite and hard
    quantization), at TU 4-32, with and without SBH: levels, recon and
    cbf equal the JAX function's (jitted: one compile a shape, where its
    op-by-op run compiles every operation), and the proxy rate (2 bits a
    nonzero level + 2 log2(1 + |level|), from the levels before SBH)
    equals the reference's rate expression (encoder_jax.py:209-211) run
    op by op, as its function computes it outside jit."""
    f = jax.jit(jenc._code_blocks_rate, static_argnames=(
        "qp", "log2", "sbh", "is_luma", "rdoq", "lam"))
    for log2 in (2, 3, 4, 5):
        for rdoq in ("lite", False):
            n = 1 << log2
            rng = np.random.default_rng(17 * log2 + (rdoq == "lite"))
            orig = rng.integers(0, 256, (64, n, n)).astype(np.int32)
            pred = np.clip(orig + rng.integers(-70, 71, (64, n, n)), 0,
                           255).astype(np.int32)
            pred[:3] = orig[:3]
            for sbh in (False, True):
                got = tenc._code_blocks_rate(
                    torch.from_numpy(orig), torch.from_numpy(pred), 27,
                    log2, sbh=sbh, rdoq=rdoq, lam=31.5)
                want = f(orig, pred, qp=27, log2=log2, sbh=sbh, rdoq=rdoq,
                         lam=31.5)
                for g, w_ in zip(got[:3], want[:3]):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
                if not sbh:
                    a = jnp.abs(want[0])
                    bits = (2.0 * jnp.sum(a > 0, axis=(-2, -1)) +
                            2.0 * jnp.sum(jnp.log2(
                                1.0 + a.astype(jnp.float32)),
                                axis=(-2, -1)))
                np.testing.assert_array_equal(got[3].numpy(),
                                              np.asarray(bits))


def test_entry_points_count_emulation_bytes(monkeypatch):
    """Reference fault 16: the reference's entry points count RBSP bytes.
    On a flat 512x32 picture whose first substreams hold emulation
    prevention bytes (2 tile columns, then WPP), its stream fails a spec
    decoder's hash (the port's copy of its GeneralDecoder); the port's
    (entry points with those bytes, spec 7.4.7.1) decodes hash OK in the
    GeneralDecoder and the port's IntraDecoder, and is the JAX package's
    stream with the port's slice writers swapped in (the JAX host loop
    given the port's modes)."""
    w, h = 512, 32
    y = np.full((h, w), 128, np.uint8)
    c = np.full((h // 2, w // 2), 128, np.uint8)
    frames = [(y, c, c.copy())]
    repaired = []

    def record(name):
        orig = getattr(jic.IntraEncoder, name)

        def both(self, ctus, sao_params=None):
            if name == "_encode_slice_wpp" or not self.cfg.wpp:
                repaired.append(getattr(tic.IntraEncoder, name)(
                    self, ctus, sao_params))
            return orig(self, ctus, sao_params)
        monkeypatch.setattr(jic.IntraEncoder, name, both)

    record("_encode_slice")
    record("_encode_slice_wpp")
    for kw in (dict(tile_columns=2), dict(wpp=True)):
        repaired.clear()
        jcfg, tcfg = _cfgs(width=w, height=h, qp=30, **kw)
        enc = jic.IntraEncoder(jcfg)
        modes = tic.IntraEncoder(tcfg, device="cpu").decide_modes(y)
        js = jbs.annexb(enc.stream_headers() +
                        enc.encode_frame(*frames[0], modes=modes)[0])
        assert len(repaired) == 1
        d = tdec.GeneralDecoder()
        d.decode(js)
        assert d.hash_status == [False]
        ts, tr = tic.IntraEncoder(tcfg, device="cpu").encode_sequence(
            frames)
        assert ts != js
        _decoded_equal(ts, 1, tr)
        nals = jbs.split_annexb(js)
        assert jbs.annexb(nals[:3] + repaired + nals[4:]) == ts
