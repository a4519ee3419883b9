"""The HEVC all-intra quadtree on the card against the same port on the CPU.

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
