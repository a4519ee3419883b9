"""Entry points: one device step of the flagship encoder, and the
multi-device dry run of the random-access engine.

The port of `__graft_entry__.py`.  `entry()` returns the flat CTB16
all-intra frame encoder as a function and its example inputs, as the
reference's does.  `dryrun_multichip(n_devices)` runs the benchmarked
engine, `inter_qt.QtDeviceRandomAccessEncoder` (multiple references, the
CU8 tree, the merge-5 decision, the full RDOQ, the CU32 tree, the TU8
RQT, the deblock), on an n_devices grid of (frame, tile) devices -- the
reference's mesh: 4 tile columns when n_devices is a multiple of 4, else
2 when even, else 1; the rest along the frame axis -- with the device
phase of every B and anchor picture on halo-padded tile columns
(parallel/sharded.py), and checks what the reference checks:

- the per-POC maps of the N-device run (`ShardedQt`, each column on its
  own device, the halos copied between neighbours) equal those of the
  same decomposition run column after column on one device
  (`TiledRefQt`), in coding order;
- so do the two streams and the two reconstructions;
- the untiled engine's stream size is reported, not asserted (its float32
  RD sums run over other shapes);
- with more than one frame row (n_devices > 4, or 2 * odd), the
  top-layer B pictures of the GOP run at once, one per frame row of
  devices, through the tile pipeline from the sequential run's
  references, and each reconstruction must be within 35 dB of the
  sequential one's (the reference's proximity bound; here they are
  equal).

Two faults of the reference's dryrun are repaired, so that every
picture of the stream decodes to the encoder's: its tile pipeline codes
every picture at the base QP (`qp=32`) while the slice header carries the
picture's QP offset, and it deblocks each padded column, so the edge
between a picture edge's column and its replicated halo is filtered.
Here the pipeline takes the picture's QP and the assembled picture is
deblocked once (`inter_qt.deblock_maps`).  The N-device check is not
weakened by either.

It prints one `dryrun_multichip OK: ...` line and returns the streams.
It runs on the card (or the cards, round-robin) unless `devices` names
other devices, e.g. `["cpu"] * n` as the tests do.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from video_codecs_tpu_torch.models.hevc import encoder_dev, headers
from video_codecs_tpu_torch.models.hevc import inter_dev, inter_qt
from video_codecs_tpu_torch.parallel import sharded
from video_codecs_tpu_torch.utils.device import to_device


# __graft_entry__.py:8
def entry(device="cuda"):
    """(fn, example_args): one step of the flagship encoder on `device`
    -- the all-intra HEVC frame encoder (mode sweep + wavefront recon)."""
    w, h = 64, 48
    bw, bh = w // 16, h // 16
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)

    def fn(y, u, v):
        with torch.inference_mode():
            st = encoder_dev.encode_frame(
                *(to_device(p, device) for p in (y, u, v)), 32, bw, bh)
        return st["rec_y"], st["levels_y"], st["modes"]

    return fn, (y, u, v)


def dryrun_clip(w: int, h: int, nf: int = 9):
    """The dry run's moving clip (__graft_entry__.py:120-129): a seeded
    noise field panned 2 columns and 1 row a picture, chroma derived."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (h + 2 * nf + 8, w + 2 * nf + 8), np.uint8)
    frames = []
    for f in range(nf):
        y = base[f:f + h, 2 * f:2 * f + w]
        u = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        v = (y[1::2, ::2] // 2 + 32).astype(np.uint8)
        frames.append((np.ascontiguousarray(y), u, v))
    return frames


def dryrun_cfg(w: int, h: int, qp: int = 32) -> headers.HevcConfig:
    """The dry run's configuration (__graft_entry__.py:115-118)."""
    return headers.HevcConfig(width=w, height=h, qp=qp, log2_ctb=5,
                              log2_min_cb=3, log2_max_tb=5, reorder_pics=3,
                              sign_data_hiding=True, rdoq="lite",
                              merge_cands=5)


def leaf_pocs(enc, n: int) -> list:
    """The first n top-layer (temporal id 3) B pictures an RA run coded:
    mutually independent given their anchors."""
    return [p for p in sorted(enc.qt_log)
            if next(e for e in enc.gop
                    if (p - e.poc) % enc.gop_size == 0).temporal_id == 3][:n]


def leaf_batch(enc, leaves, frames, recons, rows) -> str:
    """The frame axis: the top-layer B pictures `leaves` at once, leaf i
    on the devices of frame row i, each through the tile pipeline from
    the sequential run's references; each reconstruction held within 35
    dB of the sequential run's (__graft_entry__.py:320-409)."""
    cfg = enc.cfg
    base_qp = cfg.qp
    dpb = {0: recons[0]}
    for p in sorted(set(enc.qt_log) - set(leaves)):
        dpb[p] = recons[p]
    psnr_min, equal = 99.0, True
    for p, row in zip(leaves, rows):
        e = next(e for e in enc.gop if (p - e.poc) % enc.gop_size == 0)
        refs_all = sorted(q for q in (p + d for d in e.ref_pics) if q in dpb)
        past = [q for q in refs_all if q < p]
        fut = [q for q in refs_all if q > p]
        na = min(enc.num_refs_active, len(past) + len(fut))
        l0 = (list(reversed(past))[:na] + fut[:na])[:na]
        l1 = (fut[:na] + list(reversed(past))[:na])[:na]

        def stk(lst, c):
            return torch.from_numpy(np.stack(
                [np.asarray(dpb[q][c], np.uint8) for q in lst]))

        cfg.qp = base_qp + e.qp_offset
        try:
            lam = inter_dev._gop_lambda(enc, p)
            args = [stk(l0, 0), stk(l0, 1), stk(l0, 2),
                    stk(l1, 0), stk(l1, 1), stk(l1, 2)]
            out = enc.tile_phase(enc._columns(*frames[p], args, row),
                                 True, lam)
        finally:
            cfg.qp = base_qp
        ref = enc.qt_log[p]
        for k in sharded.KEYS:
            a = out[k]
            assert a.shape == ref[k].shape and a.dtype == ref[k].dtype, \
                (p, k)
            equal &= bool(np.array_equal(a, ref[k]))
        d = out["rec_y"].astype(np.float64) - ref["rec_y"]
        mse = float(np.mean(d * d)) + 1e-12
        psnr = 10 * np.log10(255.0 ** 2 / mse)
        psnr_min = min(psnr_min, psnr)
        assert psnr > 35.0, f"leaf poc{p} recon drifted: {psnr:.1f} dB"
    return (f"{len(leaves)} leaf B pictures over the 'frame' axis run the "
            f"full tile pipeline, one per frame row (recon within "
            f"{psnr_min:.0f} dB of the sequential run; maps "
            f"{'equal' if equal else 'not equal'})")


# __graft_entry__.py:42
def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Shard the benchmarked engine's device phase over an (frame, tile)
    grid of n_devices devices and check it against the same tile
    decomposition on one device (module docstring).  `devices`: the
    grid's devices in row-major order; by default the card, or the
    cards round-robin.  Returns the streams (`stream`: the N-device
    run's; `tiled_stream`, `mono_stream`), the printed line, and the
    N-device encoder, the clip and the one-device run's reconstructions
    (`encoder`, `frames`, `recons`: what `leaf_batch` takes)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA card; pass "
                               "devices=['cpu'] * n to run on the CPU")
        devices = sharded.default_devices(n_devices)
    devices = [torch.device(d) for d in devices]
    assert len(devices) == n_devices, \
        f"need {n_devices} devices, have {len(devices)}"
    t_ax = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    f_ax = n_devices // t_ax
    rows = [devices[i * t_ax:(i + 1) * t_ax] for i in range(f_ax)]

    halo = 32                     # >= sr + frac refine + 8 taps; 32-mult
    sr = 8
    wt = int(os.environ.get("VCT_DRYRUN_WT", "96"))   # per-tile width
    h = int(os.environ.get("VCT_DRYRUN_H", "96"))
    assert wt % 32 == 0 and h % 32 == 0
    w = wt * t_ax
    cfg = dryrun_cfg(w, h)
    frames = dryrun_clip(w, h)
    keys = sharded.KEYS

    # the same tile decomposition run column after column on one device
    enc1 = sharded.TiledRefQt(cfg, search_range=sr, tile_width=wt,
                              halo=halo, device=devices[0])
    stream_1dev, recons_1dev = enc1.encode_sequence_ra(frames)
    # the untiled engine, for the report only
    enc_mono = inter_qt.QtDeviceRandomAccessEncoder(cfg, search_range=sr,
                                                    device=devices[0])
    stream_mono, _ = enc_mono.encode_sequence_ra(frames)
    enc = sharded.ShardedQt(cfg, search_range=sr, tile_width=wt, halo=halo,
                            devices=rows[0], device=devices[0])
    stream_ndev, recons_ndev = enc.encode_sequence_ra(frames)

    # field maps first, in coding order: the first diverging picture is
    # the root cause (later pictures reference its recon)
    report = []
    coding_order = [0] + [e.poc for e in enc1.gop]
    for poc in [p for p in coding_order if p in enc1.qt_log]:
        for k in keys:
            a, b = enc1.qt_log[poc][k], enc.qt_log[poc][k]
            if not np.array_equal(a, b):
                report.append(f"poc{poc} '{k}': {int(np.sum(a != b))}/"
                              f"{a.size} cells at "
                              f"{np.argwhere(a != b)[:4].tolist()}")
    if report:
        raise AssertionError("tile-sharding divergence:\n" +
                             "\n".join(report[:40]))
    assert stream_ndev == stream_1dev, (
        f"tile-sharded bitstream differs: {len(stream_ndev)} vs "
        f"{len(stream_1dev)} bytes")
    for r1, rn in zip(recons_1dev, recons_ndev):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(r1[c]),
                                          np.asarray(rn[c]))
    mono_note = ("tiled == monolithic bytes" if stream_1dev == stream_mono
                 else f"monolithic engine stream differs by "
                      f"{abs(len(stream_mono) - len(stream_1dev))} bytes "
                      f"({len(stream_1dev)} vs {len(stream_mono)}: float32 "
                      f"RD sums over other shapes, both conformant)")

    leaves = leaf_pocs(enc, f_ax)
    if len(leaves) == f_ax and f_ax > 1:
        frame_note = leaf_batch(enc, leaves, frames, recons_1dev, rows)
    else:
        frame_note = "single frame row"

    line = (f"dryrun_multichip OK: engine=inter_qt."
            f"QtDeviceRandomAccessEncoder (multi-ref + CU8 + CU32 tree + "
            f"TU8 RQT + full RDOQ + deblock), grid {{'frame': {f_ax}, "
            f"'tile': {t_ax}}} on {[str(d) for d in devices]}, {w}x{h} "
            f"over {t_ax} tile columns (halo {halo}, halo columns copied "
            f"between the columns' devices; every device stage on the "
            f"columns: ME + decision + residual/RDOQ + CU8/CU32 trees, the "
            f"deblock on the assembled picture); N-device bitstream == "
            f"1-device bitstream ({len(stream_1dev)} bytes), recon "
            f"bit-exact; {frame_note}; {mono_note}")
    print(line)
    return {"stream": stream_ndev, "tiled_stream": stream_1dev,
            "mono_stream": stream_mono, "line": line, "encoder": enc,
            "frames": frames, "recons": recons_1dev}
