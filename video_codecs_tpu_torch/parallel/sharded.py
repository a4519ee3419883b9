"""The random-access engine's device phase on halo-padded tile columns.

The port of the two encoders that `__graft_entry__.dryrun_multichip`
defines inside itself (`__graft_entry__.py:143-190` and `:203-283`), as
classes of their own.  Both are `inter_qt.QtDeviceRandomAccessEncoder`
with `_device_phase` replaced: the picture is cut into uniform tile
columns of `tile_width` luma samples, each column is widened by `halo`
columns on each side (halo / 2 in chroma), the whole device pipeline
(`inter_dev.encode_b_frame_dev`: ME through the SAD kernel, the merge-5
decision, the full RDOQ through the RDOQ kernel, the CU8 tree; then
`inter_qt.qt_merge_dev`: the CU32 tree and the deblock) runs on the
padded column with the picture's edges given by `gx_blk0` / `pic_bw`,
and each map is cropped back to the column's interior (`_QT_GRAN`) and
the columns joined.  The host half (serializer, hash SEI) is the
engine's own.

- `TiledRefQt` runs the columns one after another on the encoder's
  device, its halos gathered with clamped column indices (picture edges
  repeat their edge column).
- `ShardedQt` puts tile column i on `devices[i]` and builds each halo
  from its neighbours' columns by explicit copies between the devices,
  where the reference exchanges them with `ppermute`; a picture edge
  repeats the column's own edge column (`pad_t`).  Its maps equal
  `TiledRefQt`'s, and so do its bytes.

The decomposition is not the untiled engine's arithmetic: the float32
sums of the RD decisions run over other shapes, so its stream differs
from `QtDeviceRandomAccessEncoder`'s by a few percent, as the
reference's does (the dryrun reports the difference and asserts none).
TMVP has no tiled input in the reference and is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.models.hevc import inter_dev, inter_qt
from video_codecs_tpu_torch.utils.device import to_device

# __graft_entry__.py:29
# qt-dict key -> crop granularity: columns to drop per side = halo/g
# (g in luma pixels per map cell; 0 = chroma pixels).
_QT_GRAN = {
    "merged32": 32, "res32": 32,
    "tusplit": 16, "split8": 16, "pred_mode": 16, "intra_mode": 16,
    "inter_dir": 16, "mv0x": 16, "mv0y": 16, "mv1x": 16, "mv1y": 16,
    "ref0_idx": 16, "ref1_idx": 16, "cbf_y": 16, "cbf_cb": 16,
    "cbf_cr": 16,
    "dir8": 8, "mv0x8": 8, "mv0y8": 8, "mv1x8": 8, "mv1y8": 8,
    "r0_8": 8, "r1_8": 8, "cbf_y8": 8, "cbf_cb4": 8, "cbf_cr4": 8,
    "rec_y": 1, "coef_y": 1,
    "rec_u": 2, "rec_v": 2, "coef_u": 2, "coef_v": 2,
}

KEYS = sorted(_QT_GRAN)
#: the maps `inter_qt.deblock_maps` derives the picture's BS from
_DEBLOCK_KEYS = ("pred_mode", "dir8", "mv0x8", "mv0y8", "mv1x8", "mv1y8",
                 "r0_8", "r1_8", "tusplit", "split8", "cbf_y8", "cbf_y")


def crop_cells(key: str, halo: int) -> int:
    """Map cells of `key` to drop on each side of a padded column
    (`_crop_c`, __graft_entry__.py:109)."""
    g = _QT_GRAN[key]
    return halo // g if g > 2 else (halo if g == 1 else halo // 2)


def default_devices(n: int, device="cuda") -> list:
    """One device per tile column: `device` repeated, or, with more than
    one card, the cards taken round-robin."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() > 1:
        return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]
    return [device] * n


class _TiledQt(inter_qt.QtDeviceRandomAccessEncoder):
    """The qt engine whose device phase runs per tile column; records
    each picture's cropped maps in `qt_log` by POC."""

    def __init__(self, cfg, *args, tile_width: int, halo: int = 32,
                 **kw) -> None:
        if cfg.temporal_mvp:
            raise ValueError(f"{type(self).__name__}: TMVP has no tiled "
                             "device input (the reference's dryrun has none)")
        if tile_width % 32 or halo % 32 or cfg.width % tile_width:
            raise ValueError(
                f"{type(self).__name__}: tile_width {tile_width} and halo "
                f"{halo} must be multiples of 32 and the tile width must "
                f"divide the picture width {cfg.width}")
        super().__init__(cfg, *args, **kw)
        self.tile_width, self.halo = tile_width, halo
        self.n_tiles = cfg.width // tile_width
        self.qt_log = {}
        self._poc = None

    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        self._poc = poc
        return super()._encode_b_frame(frame, poc, refs, is_anchor)

    def _tile_pipeline(self, ti, planes, has_l1, lam) -> dict:
        """The device pipeline on halo-padded column ti (the nine planes
        y, u, v and the two lists' reference stacks, on one device),
        before the deblock; returns the maps cropped to the column's
        interior, on that device."""
        cfg, halo = self.cfg, self.halo
        wp = self.tile_width + 2 * halo
        st16 = inter_dev.encode_b_frame_dev(
            *planes, qp=cfg.qp, w=wp, h=cfg.height, has_l1=has_l1,
            search_range=self.search_range, sbh=cfg.sign_data_hiding,
            rdoq=True, me_method=self.me_method, deblock=False,
            allow_intra=False, merge_eval="best4", lam=lam, rqt=True,
            cu8=self.cu8, gx_blk0=(ti * self.tile_width - halo) // 16,
            pic_bw=cfg.width // 16)
        qt = inter_qt.qt_merge_dev(
            *planes, st16, qp=cfg.qp, w=wp, h=cfg.height, has_l1=has_l1,
            sbh=cfg.sign_data_hiding, rdoq=True, deblock=False, lam=lam)
        return {k: qt[k][:, crop_cells(k, halo):-crop_cells(k, halo)]
                for k in KEYS}

    def tile_phase(self, cols, has_l1, lam) -> dict:
        """The pipeline on every padded column of `cols` (one list of
        nine planes per column), the cropped maps joined into the
        picture's on the encoder's device, then the picture's deblock
        (`inter_qt.deblock_maps`: the loop filter crosses the tile
        edges and stops at the picture's).  Returns numpy maps."""
        with torch.inference_mode():
            outs = [self._tile_pipeline(ti, planes, has_l1, lam)
                    for ti, planes in enumerate(cols)]
            qt = {k: torch.cat([o[k].to(self.device) for o in outs], dim=-1)
                  for k in KEYS}
            if not self.cfg.deblocking_disabled:
                rec = inter_qt.deblock_maps(
                    qt["rec_y"], qt["rec_u"], qt["rec_v"], self.cfg.qp,
                    **{k: qt[k] for k in _DEBLOCK_KEYS})
                for k, r in zip(("rec_y", "rec_u", "rec_v"), rec):
                    qt[k] = r.to(torch.uint8)
            return {k: t.cpu().numpy() for k, t in qt.items()}

    def _device_phase(self, y, u, v, args, has_l1, lam,
                      tmvp_fields=None, no_backward=False):
        full = self.tile_phase(self._columns(y, u, v, args), has_l1, lam)
        self.qt_log[self._poc] = full
        return full


class TiledRefQt(_TiledQt):
    """The tile decomposition run one column after another on the
    encoder's device, each halo gathered from the whole picture with
    clamped column indices (__graft_entry__.py:143-190)."""

    def _columns(self, y, u, v, args) -> list:
        wt, halo = self.tile_width, self.halo
        planes = [to_device(np.asarray(p, np.uint8), self.device)
                  for p in (y, u, v)] + list(args)
        scales = (1, 2, 2) * 3

        def slab(a, scale, ti):
            lo = (ti * wt - halo) // scale
            hi = ((ti + 1) * wt + halo) // scale
            idx = torch.arange(lo, hi, device=a.device).clamp(
                0, a.shape[-1] - 1)
            return a.index_select(-1, idx)

        return [[slab(a, s, ti) for a, s in zip(planes, scales)]
                for ti in range(self.n_tiles)]


class ShardedQt(_TiledQt):
    """Tile column i on `devices[i]`; each column's halos are its
    neighbours' edge columns copied from their devices, a picture edge's
    the column's own edge column repeated (`pad_t`, `tile_pipeline`,
    `ShardedQt`: __graft_entry__.py:203-283)."""

    def __init__(self, cfg, *args, tile_width: int, halo: int = 32,
                 devices=None, **kw) -> None:
        super().__init__(cfg, *args, tile_width=tile_width, halo=halo, **kw)
        self.devices = [torch.device(d) for d in (
            devices or default_devices(self.n_tiles, self.device))]
        if len(self.devices) != self.n_tiles:
            raise ValueError(f"ShardedQt: {self.n_tiles} tile columns need "
                             f"{self.n_tiles} devices, not "
                             f"{len(self.devices)}")

    def _shard(self, a, scale: int, devices) -> list:
        """Tile column i of plane (stack) `a` on devices[i]: the sharded
        input of the reference's shard_map."""
        a = torch.from_numpy(np.asarray(a, np.uint8)) \
            if isinstance(a, np.ndarray) else a
        wt = self.tile_width // scale
        return [a[..., i * wt:(i + 1) * wt].to(d)
                for i, d in enumerate(devices)]

    def _pad(self, shards, ti, hl, dev):
        """`pad_t`: halo columns from the neighbour columns, copied to
        this column's device; a picture edge repeats its own edge
        column."""
        own = shards[ti]
        left = (shards[ti - 1][..., -hl:].to(dev) if ti > 0 else
                own[..., :1].expand(*own.shape[:-1], hl))
        right = (shards[ti + 1][..., :hl].to(dev)
                 if ti < self.n_tiles - 1 else
                 own[..., -1:].expand(*own.shape[:-1], hl))
        return torch.cat([left, own, right], dim=-1)

    def _columns(self, y, u, v, args, devices=None) -> list:
        """The padded columns of one picture, column i on devices[i]
        (the encoder's `devices` unless given: a frame row of the
        dryrun's mesh)."""
        devices = devices or self.devices
        scales = (1, 2, 2) * 3
        shards = [self._shard(a, s, devices)
                  for a, s in zip((y, u, v, *args), scales)]
        return [[self._pad(sh, ti, self.halo // s, d)
                 for sh, s in zip(shards, scales)]
                for ti, d in enumerate(devices)]
