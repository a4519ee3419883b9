"""HEVC tiles on one card: the tile columns as one batch.

The port of video_codecs_tpu/parallel/tiles.py.  The reference shards
the flat CTB16 all-intra encoder over a device mesh with one device per
tile column (`shard_map`): each device runs the mode decision and the
reconstruction wavefront on its own column, with no communication, as
tile independence allows.  On one H100 the mesh becomes a leading
dimension: the T uniform tile columns are stacked as [T, H, W / T] and
`encoder_dev.decide_modes_device` and `encoder_dev.encode_frame_device`
run once over the stack, so each anti-diagonal d = bx + 2 by of the
wavefront is one batch of that diagonal's blocks in every tile: a
column of W / (16 T) CTBs has W / (16 T) + 2 (H / 16 - 1) diagonals
(162 at 1920x1072 in 4 columns, against 252 for the untiled picture).
Then the assembled picture is deblocked on the card across the tile
edges (loop_filter_across_tiles), and the per-tile CABAC substreams are
written by the Python slice writer with entry points in the header.
The bytes are the reference's (tests/test_torch_hevc_tiles.py).  The
reference's `mesh` argument has no counterpart; uniform tile widths stay
required, as the reference asserts.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.models.hevc import encoder_dev, headers
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.utils.device import to_device


def encode_tiles_dev(y, u, v, qp: int, bw: int, bh: int, n_tiles: int,
                     deblock: bool = True, sbh: bool = False,
                     rdoq: bool = False) -> dict:
    """`encoder_dev.encode_frame` for a picture of n_tiles uniform tile
    columns (planes [H, W] on the device): the columns stacked as
    [T, H, W / T], one mode sweep and one wavefront over the stack, the
    assembled picture deblocked across the tile edges.  Returns
    `encode_frame`'s dict in picture raster order (rec planes uint8,
    levels int16 [bw * bh, ...], cbf [3, bw * bh], modes int8 [bh, bw])."""
    tbw = bw // n_tiles

    def stack(p, n):               # [H, W] -> [T, H, W / T]
        return p.int().reshape(p.shape[0], n_tiles,
                               tbw * n).transpose(0, 1).contiguous()

    yt, ut, vt = stack(y, 16), stack(u, 8), stack(v, 8)
    modes = encoder_dev.decide_modes_device(yt, qp, tbw, bh)
    st = encoder_dev.encode_frame_device(
        yt, ut, vt, modes, qp, ic.chroma_qp(qp), tbw, bh, sbh=sbh,
        rdoq=rdoq)

    def unstack(p):                # [T, H, W / T] -> [H, W]
        return p.transpose(0, 1).reshape(p.shape[1], -1)

    def raster(a):                 # tile-major blocks -> picture raster
        return a.reshape(n_tiles, bh, tbw, *a.shape[1:]).transpose(
            0, 1).reshape(bw * bh, *a.shape[1:])

    out = {k: unstack(st[k]) for k in ("rec_y", "rec_u", "rec_v")}
    if deblock:
        out["rec_y"], out["rec_u"], out["rec_v"] = deblock_ops.deblock_420(
            out["rec_y"], out["rec_u"], out["rec_v"], qp)
    for k in ("rec_y", "rec_u", "rec_v"):
        out[k] = out[k].to(torch.uint8)
    for k in ("levels_y", "levels_cb", "levels_cr"):
        out[k] = raster(st[k]).clamp(-32768, 32767).to(torch.int16)
    out["cbf"] = raster(st["cbf"].t()).t()
    out["modes"] = unstack(modes).to(torch.int8)
    return out


# video_codecs_tpu/parallel/tiles.py:28
def encode_frame_tiles(cfg: headers.HevcConfig, y, u, v, *, device="cuda"):
    """Encode one all-intra frame with cfg.tile_columns tiles, the columns
    one batch on `device` (the card unless the caller asks for the CPU);
    returns ([slice_nal, sei_nal], recon)."""
    n_tiles = cfg.tile_columns
    bw, bh = cfg.width // 16, cfg.height // 16
    bounds = cfg.tile_col_bounds()
    widths = {tx1 - tx0 for (tx0, tx1) in bounds}
    assert len(widths) == 1, "the tile batch needs uniform tile widths"

    with torch.inference_mode():
        planes = [to_device(np.asarray(p, np.uint8), device)
                  for p in (y, u, v)]
        st = encode_tiles_dev(*planes, cfg.qp, bw, bh, n_tiles,
                              deblock=not cfg.deblocking_disabled)
        st = {k: a.cpu().numpy() for k, a in st.items()}

    modes = st["modes"].reshape(-1)
    cbf = st["cbf"]
    ctus = [ic.CtuData(mode=int(modes[i]),
                       levels_y=st["levels_y"][i] if cbf[0, i] else None,
                       levels_cb=st["levels_cb"][i] if cbf[1, i] else None,
                       levels_cr=st["levels_cr"][i] if cbf[2, i] else None)
            for i in range(bw * bh)]
    rec = tuple(st[k].astype(np.int32) for k in ("rec_y", "rec_u", "rec_v"))
    enc = ic.IntraEncoder(cfg, device=device)
    slice_nal = enc._encode_slice(ctus)
    sei_nal = enc._hash_sei(*rec)
    return [slice_nal, sei_nal], rec


# video_codecs_tpu/parallel/tiles.py:101
def encode_sequence_tiles(cfg: headers.HevcConfig, frames, *,
                          device="cuda"):
    enc = ic.IntraEncoder(cfg, device=device)
    nals = enc.stream_headers()
    recons = []
    for (y, u, v) in frames:
        frame_nals, rec = encode_frame_tiles(cfg, y, u, v, device=device)
        nals.extend(frame_nals)
        recons.append(rec)
    return bs.annexb(nals), recons
