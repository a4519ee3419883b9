"""The HEVC all-intra quadtree, the RA B-picture and LD-P P-picture
device phases (with the pyramid search and with HM's TZSearch), the tile
batch, WPP and the host quadtree RD encoder on the card against the same
port on the CPU.

Needs an NVIDIA GPU (the `cuda` marker; the cases skip where none is
present).  The card's machine has no JAX, so this file imports nothing
of it; run it there without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_hevc_cuda.py
"""

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.models.hevc import headers
from video_codecs_tpu_torch.models.hevc import quadtree_codec


def _picture(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 11.0) +
                rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
    return y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2 + 32


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,qp,rdoq", [(96, 64, 30, "lite"),
                                         (80, 48, 32, False),
                                         (416, 240, 32, "lite")])
def test_card_equals_cpu(w, h, qp, rdoq):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = headers.HevcConfig(width=w, height=h, qp=qp, log2_ctb=5,
                             log2_min_cb=3, log2_max_tb=5,
                             sign_data_hiding=True, rdoq=rdoq)
    pic = _picture(w, h, seed=w + qp)
    out = {}
    for dev in ("cuda", "cpu"):
        enc = quadtree_codec.QuadtreeFastEncoder(cfg, device=dev)
        st = {k: a.cpu().numpy() for k, a in enc._dispatch(*pic).items()}
        out[dev] = (st, enc.serialize_frame(st)[0])
    (g, gn), (c, cn) = out["cuda"], out["cpu"]
    for k in c:
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    assert gn == cn


def _ra_clip(w, h, n, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + n + 1, w + 2 * n + 1)).astype(np.uint8)
    return [(np.ascontiguousarray(base[f:f + h, 2 * f:2 * f + w]),
             base[f:f + h:2, 2 * f:2 * f + w:2] // 2 + 64,
             base[f + 1:f + h:2, 2 * f:2 * f + w:2] // 2 + 32)
            for f in range(n)]


def _ra_card_vs_cpu(cu8, refs, tmvp, me_method="pyr"):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from video_codecs_tpu_torch.models.hevc import inter_qt
    from video_codecs_tpu_torch.ops import sad_surface as ss
    w, h = 96, 64
    frames = _ra_clip(w, h, 5, seed=3 + cu8)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = headers.HevcConfig(width=w, height=h, qp=32, log2_ctb=5,
                                 log2_min_cb=3, log2_max_tb=5,
                                 reorder_pics=3, sign_data_hiding=True,
                                 rdoq="lite", merge_cands=5,
                                 temporal_mvp=tmvp)
        enc = inter_qt.QtDeviceRandomAccessEncoder(
            cfg, search_range=64, me_method=me_method, cu8=cu8,
            num_refs_active=refs, device=dev)
        dicts = []
        phase = enc._device_phase

        def keep(*a, **kw):
            d = phase(*a, **kw)
            dicts.append(d)
            return d

        enc._device_phase = keep
        n0 = ss.sad_surface.launches
        stream = enc.encode_sequence_ra(frames)[0]
        out[dev] = (dicts, stream, ss.sad_surface.launches - n0)
    (gd, gs, gl), (cd, cs, cl) = out["cuda"], out["cpu"]
    assert cl == 0 and gl > 0            # the kernel ran only on the card
    for i, (g, c) in enumerate(zip(gd, cd)):
        assert set(g) == set(c)
        for k in c:
            np.testing.assert_array_equal(g[k], c[k],
                                          err_msg=f"picture {i}: {k}")
    assert gs == cs
    return gl


@pytest.mark.cuda
@pytest.mark.parametrize("cu8,refs,tmvp", [(False, 1, True), (True, 2, False)])
def test_ra_device_phase_card_equals_cpu(cu8, refs, tmvp):
    """The RA B-picture device phase (encode_b_frame_dev + qt_merge_dev,
    SAD surfaces from the kernel on the card) against the CPU's at
    96x64: every key of every picture's dict, and the stream."""
    _ra_card_vs_cpu(cu8, refs, tmvp)


@pytest.mark.cuda
def test_ra_tz_card_equals_cpu():
    """The same with HM's TZSearch at search range 64 in both trees (the
    CU8 tree's per-8 search too): one surface per search."""
    launches = _ra_card_vs_cpu(True, 1, True, me_method="tz")
    # 4 B/P pictures of a 5-picture GOP-8 run: P at 4 (L0), B at 2, 1, 3
    # (L0 and L1), two trees each
    assert launches == 2 * (1 + 2 + 2 + 2)


def _ldp_card_vs_cpu(me_method):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from chip_smoke import cut_clip
    from video_codecs_tpu_torch.models.hevc import inter_dev
    from video_codecs_tpu_torch.ops import sad_surface as ss
    frames = cut_clip(96, 64, 5)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = headers.HevcConfig(width=96, height=64, qp=32, num_refs=4,
                                 merge_cands=5, temporal_mvp=True,
                                 sign_data_hiding=True)
        enc = inter_dev.DeviceLowDelayEncoder(cfg, search_range=64,
                                              me_method=me_method,
                                              device=dev)
        dicts = []
        phase = enc._device_phase

        def keep(*a, **kw):
            d = phase(*a, **kw)
            dicts.append(d)
            return d

        enc._device_phase = keep
        n0 = ss.sad_surface.launches
        stream = enc.encode_sequence_ldp(frames)[0]
        out[dev] = (dicts, stream, ss.sad_surface.launches - n0)
    (gd, gs, gl), (cd, cs, cl) = out["cuda"], out["cpu"]
    per_search = 3 if me_method == "pyr" else 1
    assert cl == 0 and gl == per_search * (1 + 2 + 3 + 4)
    for i, (g, c) in enumerate(zip(gd, cd)):
        for k in c:
            np.testing.assert_array_equal(g[k], c[k],
                                          err_msg=f"picture {i}: {k}")
    assert sum(int((d["pred_mode"] == 1).sum()) for d in cd) > 0
    assert gs == cs


@pytest.mark.cuda
def test_ldp_card_equals_cpu():
    """The LD-P encoder (flat device IDR, encode_p_frame_dev with SAD
    surfaces from the kernel, the intra wavefront) at bench_ldp_480's
    settings on 96x64: every P picture's dict and the stream equal the
    CPU's, and intra blocks went through the wavefront."""
    _ldp_card_vs_cpu("pyr")


@pytest.mark.cuda
def test_ldp_tz_card_equals_cpu():
    """The same with HM's TZSearch at search range 64: one SAD surface
    per reference."""
    _ldp_card_vs_cpu("tz")


@pytest.mark.cuda
def test_tile_batch_card_equals_cpu():
    """The tile columns as one batch (`parallel.tiles`) at 256x64 in 4
    tile columns, WPP through `IntraEncoder`: the card's streams and
    pictures are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from video_codecs_tpu_torch.models.hevc import intra_codec
    from video_codecs_tpu_torch.parallel import tiles
    frames = [_picture(256, 64, seed=s) for s in (3, 4)]
    cfg = headers.HevcConfig(width=256, height=64, qp=30, tile_columns=4)
    got = {dev: tiles.encode_sequence_tiles(cfg, frames, device=dev)
           for dev in ("cuda", "cpu")}
    assert got["cuda"][0] == got["cpu"][0]
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
    wcfg = headers.HevcConfig(width=256, height=64, qp=30, wpp=True,
                              sign_data_hiding=True)
    streams = [intra_codec.IntraEncoder(wcfg, device=dev).encode_sequence(
        frames)[0] for dev in ("cuda", "cpu")]
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_quadtree_host_encoder_card_equals_cpu():
    """`QuadtreeIntraEncoder` (the host RD encoder; its mode sweeps and
    deblock on the encoder's device) at 64x64, CTB 32, full RDOQ: the
    card's NAL units and picture are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = headers.HevcConfig(width=64, height=64, qp=32, log2_ctb=5,
                             log2_min_cb=3, log2_max_tb=5,
                             sign_data_hiding=True, rdoq="full")
    pic = _picture(64, 64, seed=11)
    out = {dev: quadtree_codec.QuadtreeIntraEncoder(
        cfg, device=dev).encode_frame(*pic) for dev in ("cuda", "cpu")}
    assert out["cuda"][0] == out["cpu"][0]
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_array_equal(a, b)
