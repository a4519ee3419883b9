"""The card stage of the H.264 host P coder: every integer SAD and every
sub-pel candidate of one reference, made once per P picture.

The reference's host coder (models/h264/inter_codec.py `H264Encoder`)
computes its SADs per call: `_search` builds a (2 sr + 1)^2 surface of
one block with numpy, `_search_epzs` / `_search_umhex` interpolate a
16x16 block per point, and `_subpel_refine` interpolates each of its 16
candidates with `mc_luma_np`.  All of them read the reference only at
coordinates clamped into the picture, so each is a window of a plane
computed once:

- Integer SADs.  Every point the three searches compare lies within
  +-2 sr of its block: EPZS and UMHex clamp their points to +-sr, and the
  full search's window of +-sr is centred on a predictor clamped to
  +-sr.  One `ops/sad_surface.sad_surface` launch at n = 4, r = 2 sr over
  every 4x4 block of the picture, its window cut from the reference
  edge-padded by 2 sr (the clamp), gives them all; the 16x16, 16x8,
  8x16, 8x8, 8x4 and 4x8 surfaces are sums of the 4x4 ones, made on the
  card and copied back in one piece.
- Sub-pel candidates.  `mc_luma_np` computes each sample from its
  integer position and fraction only, so the block at a quarter-pel MV
  is a window of one of the 16 phase planes of the reference, edge-padded
  by `pad` >= 2 sr + 8 (the refinement moves at most 3 quarter pels off
  an integer point within +-2 sr).  The planes are made on the card with
  `ops/h264_dev.mc_luma_dev` over 16x16 tiles of the padded plane and
  copied back as uint8.

On a CUDA device the SADs come from the Hopper kernel; on a CPU tensor
`sad_surface` runs its plain version, so the CPU tests reach this stage.
The decisions stay on the host in the reference's order and types.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.ops import h264_dev as hd
from video_codecs_tpu_torch.ops.sad_surface import sad_surface

# (width, height) of every partition the host coder searches.
SHAPES = ((16, 16), (16, 8), (8, 16), (8, 8), (8, 4), (4, 8), (4, 4))


def sad_surfaces(cur: torch.Tensor, ref: torch.Tensor,
                 sr: int) -> dict[tuple[int, int], torch.Tensor]:
    """uint8 planes [H, W] on one device -> {(pw, ph): int32
    [H // ph, W // pw, 4 sr + 1, 4 sr + 1]}: entry [by, bx, dy + 2 sr,
    dx + 2 sr] is the SAD of the (pw, ph) block at (bx pw, by ph) against
    the reference at displacement (dx, dy), coordinates clamped."""
    h, w = cur.shape
    r = 2 * sr
    span = 2 * r + 1
    dev = cur.device
    ys = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    xs = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    refp = ref[ys][:, xs]
    n = 4 + 2 * r
    win = refp.unfold(0, n, 4).unfold(1, n, 4).reshape(-1, n, n)
    blk = cur.unfold(0, 4, 4).unfold(1, 4, 4).reshape(-1, 4, 4)
    s4 = sad_surface(blk.contiguous(), win.contiguous(), 4, r).reshape(
        h // 4, w // 4, span, span)
    return {(pw, ph): s4.reshape(h // ph, ph // 4, w // pw, pw // 4, span,
                                 span).sum((1, 3), dtype=torch.int32)
            for pw, ph in SHAPES}


def phase_planes(ref: torch.Tensor, pad: int) -> torch.Tensor:
    """int32 plane [H, W] -> the 16 quarter-pel phase planes [4 (fy),
    4 (fx), H + 2 pad, W + 2 pad]: plane [fy, fx, Y + pad, X + pad] is
    sample (0, 0) of `mc_luma_np(ref, X, Y, fx, fy, 1, 1)`."""
    h, w = ref.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    ty, tx = hp // 16, wp // 16
    dev = ref.device
    x0 = (torch.arange(tx, dtype=torch.int32, device=dev) * 16 - pad
          ).repeat(ty)
    y0 = (torch.arange(ty, dtype=torch.int32, device=dev) * 16 - pad
          ).repeat_interleave(tx)
    frac = torch.arange(16, dtype=torch.int32, device=dev
                        ).repeat_interleave(ty * tx)
    blocks = hd.mc_luma_dev(ref, x0.repeat(16), y0.repeat(16), frac & 3,
                            frac >> 2, 16)
    return blocks.reshape(4, 4, ty, tx, 16, 16).permute(
        0, 1, 2, 4, 3, 5).reshape(4, 4, hp, wp)


class RefSearch:
    """Stage (a) and (b) for one reference of one P picture, copied back
    to the host: `sad[(pw, ph)]` (int32 numpy, `sad_surfaces`) and
    `planes` (uint8 numpy, `phase_planes`)."""

    def __init__(self, cur_y, ref_y, sr: int, device) -> None:
        self.sr = sr
        # >= 2 sr + 8, and a multiple of 8 so that the padded planes tile
        # into 16x16 blocks
        self.pad = -(-(2 * sr + 8) // 8) * 8
        with torch.inference_mode():
            cur = torch.from_numpy(np.asarray(cur_y, np.uint8)).to(device)
            ref = torch.from_numpy(np.asarray(ref_y, np.uint8)).to(device)
            sads = sad_surfaces(cur, ref, sr)
            flat = torch.cat([s.reshape(-1) for s in sads.values()]
                             ).cpu().numpy()
            planes = phase_planes(ref.int(), self.pad)
            self.planes = planes.to(torch.uint8).cpu().numpy()
        self.sad, at = {}, 0
        for key, s in sads.items():
            self.sad[key] = flat[at:at + s.numel()].reshape(s.shape)
            at += s.numel()

    def window(self, x: int, y: int, pw: int, ph: int, px: int,
               py: int) -> np.ndarray:
        """The (2 sr + 1)^2 SADs of the (pw, ph) block at (x, y) around
        the integer point (px, py), |px|, |py| <= sr: entry [iy, ix] is
        displacement (px - sr + ix, py - sr + iy), as `_search`'s."""
        sr = self.sr
        s = self.sad[(pw, ph)][y // ph, x // pw]
        return s[py + sr:py + 3 * sr + 1, px + sr:px + 3 * sr + 1]

    def sad16(self, x: int, y: int, fx: int, fy: int) -> int:
        """SAD of the 16x16 block at (x, y) at the integer point (fx, fy),
        |fx|, |fy| <= 2 sr."""
        r = 2 * self.sr
        return int(self.sad[(16, 16)][y // 16, x // 16, fy + r, fx + r])

    def block(self, x: int, y: int, mvx: int, mvy: int, pw: int,
              ph: int) -> np.ndarray:
        """`mc_luma_np(ref_y, x, y, mvx, mvy, pw, ph)` as a window of a
        phase plane (uint8), for an MV whose integer part lies within
        +-`pad` pels (the searches reach 2 sr + 1)."""
        y0 = y + (mvy >> 2) + self.pad
        x0 = x + (mvx >> 2) + self.pad
        return self.planes[mvy & 3, mvx & 3, y0:y0 + ph, x0:x0 + pw]
