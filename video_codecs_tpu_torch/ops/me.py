"""Full-window integer motion search (counterpart of ops/me.py:23-45).

The reference gathers a [B, (2r+1)^2, n, n] patch tensor and reduces it;
here the SAD surface comes from `sad_surface` (the Hopper kernel on CUDA
tensors, which takes the 8-bit samples as they are).  The centre bias and the argmin stay in PyTorch: `torch.argmin`
returns the first minimum, the same rule as `jnp.argmin` over row-major
(dy, dx).
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.ops.interp import gather_window
from video_codecs_tpu_torch.ops.sad_surface import sad_surface
from video_codecs_tpu_torch.utils.device import const

# The 8-neighbour refinement pattern (ops/me.py:249), as (dx, dy).
_OFFS8 = np.array([(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                   (-1, 1), (0, 1), (1, 1)], np.int32)


def integer_search(ref: torch.Tensor, cur: torch.Tensor, x0: torch.Tensor,
                   y0: torch.Tensor, n: int,
                   search_range: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full integer-pel search around (0, 0) for every block.

    ref: [H, W], cur: [B, n, n], both uint8 (or both int32 on the CPU);
    returns (mvx, mvy) int-pel [B]."""
    r = search_range
    span = 2 * r + 1
    win = gather_window(ref, x0 - r, y0 - r, n + 2 * r, n + 2 * r)
    sad = sad_surface(cur.contiguous(), win, n, r)
    # small centre bias like HM's mv-cost: prefer shorter MVs on ties
    d = np.abs(np.arange(span) - r)
    mv_cost = const((d[:, None] + d[None, :]).reshape(-1), ref.device)
    best = torch.argmin(sad.reshape(-1, span * span) + mv_cost[None, :],
                        dim=1).int()
    return best % span - r, best // span - r
