"""HEVC all-intra CU quadtree: syntax writer, decoder, the host RD
encoder `QuadtreeIntraEncoder` and the device encoder
`QuadtreeFastEncoder` (CTB 32, CUs 32/16/8).

The port's copy of video_codecs_tpu/models/hevc/quadtree_codec.py
(whole); each function keeps its name and a comment gives the
original's line.  `QuadtreeIntraEncoder`, the host RD encoder, decides
each CTB by the reference's recursive trial comparison in numpy, in its
order (`_encode_node`, `_code_leaf`, `code_tb`), with each node's
35-mode prediction on the encoder's device (`_best_mode`: one
`predict_intra` call and one copy back) and the picture deblock there
too (`deblock_420_bs`); VCT_DUMP_MODES=1 prints its leaves
(`dump_mode_statistics`, utils/debug.py).

`QuadtreeFastEncoder` runs its decision, reconstruction and deblocking on
a torch device (models/hevc/encoder_qt_dev.py), on the card unless the
caller passes device="cpu", and serializes with the native C++ CABAC
writer (entropy/native.py); `encode_slice_qt` stays as the plain Python
serializer of the same bytes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, native, residual
from video_codecs_tpu_torch.models.hevc import encoder_qt_dev, headers
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import to_device

DC = 1


# video_codecs_tpu/models/hevc/quadtree_codec.py:38
def z_index(x: int, y: int, w: int, ctb_shift: int) -> int:
    """Global decode order of the minimal 4x4 block containing (x, y):
    CTB raster order, Morton (Z) order inside the CTB, for a plane whose
    CTB size is 1 << ctb_shift."""
    ctb_x, ctb_y = x >> ctb_shift, y >> ctb_shift
    nbits = ctb_shift - 2
    ix, iy = (x >> 2) & ((1 << nbits) - 1), (y >> 2) & ((1 << nbits) - 1)
    morton = 0
    for b in range(nbits):
        morton |= ((ix >> b) & 1) << (2 * b)
        morton |= ((iy >> b) & 1) << (2 * b + 1)
    ctbs_per_row = (w + (1 << ctb_shift) - 1) >> ctb_shift
    return ((ctb_y * ctbs_per_row + ctb_x) << (2 * nbits)) + morton


# video_codecs_tpu/models/hevc/quadtree_codec.py:53
def build_ref_z(plane: np.ndarray, x: int, y: int, n: int,
                w: int, h: int, ctb_shift: int,
                z_floor: int = 0, default: int = 128,
                region4=None, cur_region=None,
                region_scale: int = 1) -> np.ndarray:
    """Reference array with general Z-scan availability (spec 6.4.1).

    z_floor: Z-scan address of the current slice segment's first 4x4 —
    samples of earlier slices are unavailable (prediction never crosses
    regular slice boundaries, spec 6.4.1 availableN).
    region4/cur_region: optional per-4x4 (slice, tile) region map —
    samples in a different region are unavailable (tile boundaries).
    region_scale converts chroma coordinates to the luma-granularity
    map (pass 2 for 4:2:0 chroma planes)."""
    r = 4 * n + 1
    samples = np.zeros(r, np.int32)
    avail = np.zeros(r, bool)
    cur = z_index(x, y, w, ctb_shift)

    def ok(sx: int, sy: int) -> bool:
        if sx < 0 or sy < 0 or sx >= w or sy >= h:
            return False
        if region4 is not None and \
                region4[(sy * region_scale) // 4,
                        (sx * region_scale) // 4] != cur_region:
            return False
        z = z_index(sx, sy, w, ctb_shift)
        return z_floor <= z < cur

    for k in range(2 * n):                 # left column, bottom -> top
        j = 2 * n - 1 - k
        if ok(x - 1, y + j):
            samples[k] = plane[y + j, x - 1]
            avail[k] = True
    if ok(x - 1, y - 1):
        samples[2 * n] = plane[y - 1, x - 1]
        avail[2 * n] = True
    for i in range(2 * n):                 # top row, left -> right
        if ok(x + i, y - 1):
            samples[2 * n + 1 + i] = plane[y - 1, x + i]
            avail[2 * n + 1 + i] = True
    if not avail.any():
        return np.full(r, default, np.int32)
    out = samples.copy()
    if not avail[0]:
        out[0] = samples[np.argmax(avail)]
    for k in range(1, r):
        if not avail[k]:
            out[k] = out[k - 1]
    return out


# video_codecs_tpu/models/hevc/quadtree_codec.py:105
@dataclasses.dataclass
class CuInfo:
    x: int
    y: int
    size: int
    depth: int
    nxn: bool = False
    modes: list[int] = dataclasses.field(default_factory=lambda: [DC])
    levels_y: list = dataclasses.field(default_factory=list)   # per luma TU
    levels_cb: np.ndarray | None = None
    levels_cr: np.ndarray | None = None


# Tree node: ("cu", CuInfo) or ("split", [4 children]).
Node = tuple


# video_codecs_tpu/models/hevc/quadtree_codec.py:122
def dump_mode_statistics(roots: list, ctb_shift: int) -> list[str]:
    """Per-CU-leaf mode dump (hm-12.1-statistic-for-modes parity:
    TEncCu.cpp:1088 xEncodeCU2 printf of absPartIdx, PredMode,
    PartSize, WxH per leaf). Enabled at runtime by VCT_DUMP_MODES=1."""
    lines = []

    def walk(node):
        kind, payload = node
        if kind == "split":
            for ch in payload:
                walk(ch)
            return
        cu = payload
        # absPartIdx: Morton index of the CU's 4x4 origin within its CTB
        nbits = ctb_shift - 2
        ix = (cu.x >> 2) & ((1 << nbits) - 1)
        iy = (cu.y >> 2) & ((1 << nbits) - 1)
        part = 0
        for b_ in range(nbits):
            part |= ((ix >> b_) & 1) << (2 * b_)
            part |= ((iy >> b_) & 1) << (2 * b_ + 1)
        lines.append(f"absPartIdx={part} PredMode=INTRA "
                     f"PartSize={'NxN' if cu.nxn else '2Nx2N'} "
                     f"{cu.size}x{cu.size} modes={cu.modes}")

    for r in roots:
        walk(r)
    return lines


# video_codecs_tpu/models/hevc/quadtree_codec.py:152
class State:
    """Recon planes + neighbor grids (copyable for decision trials)."""

    # video_codecs_tpu/models/hevc/quadtree_codec.py:155
    def __init__(self, w: int, h: int, ctb_shift: int) -> None:
        self.w, self.h = w, h
        self.serial = 0
        self.ctb_shift = ctb_shift
        self.rec_y = np.zeros((h, w), np.int32)
        self.rec_u = np.zeros((h // 2, w // 2), np.int32)
        self.rec_v = np.zeros((h // 2, w // 2), np.int32)
        self.mode = np.full((h // 4, w // 4), DC, np.int32)
        self.intra = np.zeros((h // 4, w // 4), bool)
        self.depth = np.zeros((h // 8, w // 8), np.int32)
        self.cu_id = np.full((h // 8, w // 8), -1, np.int64)

    # video_codecs_tpu/models/hevc/quadtree_codec.py:167
    def copy(self) -> "State":
        s = State.__new__(State)
        s.w, s.h, s.ctb_shift = self.w, self.h, self.ctb_shift
        s.serial = self.serial
        for f in ("rec_y", "rec_u", "rec_v", "mode", "intra", "depth",
                  "cu_id"):
            setattr(s, f, getattr(self, f).copy())
        return s

    # video_codecs_tpu/models/hevc/quadtree_codec.py:176
    def assign(self, o: "State") -> None:
        for f in ("rec_y", "rec_u", "rec_v", "mode", "intra", "depth",
                  "cu_id"):
            getattr(self, f)[:] = getattr(o, f)

    # video_codecs_tpu/models/hevc/quadtree_codec.py:181
    def mpm(self, x: int, y: int) -> list[int]:
        """spec 8.4.2: A = (x-1, y), B = (x, y-1); B outside CTB -> DC."""
        w, h = self.w, self.h
        cur = z_index(x, y, w, self.ctb_shift)

        def mode_at(sx, sy, clamp_ctb):
            if sx < 0 or sy < 0 or sx >= w or sy >= h:
                return DC
            if clamp_ctb and (sy >> self.ctb_shift) != (y >> self.ctb_shift):
                return DC
            if z_index(sx, sy, w, self.ctb_shift) >= cur:
                return DC
            if not self.intra[sy // 4, sx // 4]:
                return DC
            return int(self.mode[sy // 4, sx // 4])

        a = mode_at(x - 1, y, False)
        b = mode_at(x, y - 1, True)
        if a == b:
            if a < 2:
                return [0, 1, 26]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        out = [a, b]
        for third in (0, 1, 26):
            if third not in out:
                out.append(third)
                break
        return out

    # video_codecs_tpu/models/hevc/quadtree_codec.py:210
    def split_ctx(self, x: int, y: int, depth: int) -> int:
        c = 0
        if x > 0 and self.depth[y // 8, (x - 1) // 8] > depth:
            c += 1
        if y > 0 and self.depth[(y - 1) // 8, x // 8] > depth:
            c += 1
        return c

    # video_codecs_tpu/models/hevc/quadtree_codec.py:218
    def set_cu(self, cu: CuInfo, cu_serial: int) -> None:
        gx, gy = cu.x // 4, cu.y // 4
        s4 = cu.size // 4
        if cu.nxn:
            half = s4 // 2
            for p, m in enumerate(cu.modes):
                px, py = gx + (p & 1) * half, gy + (p >> 1) * half
                self.mode[py:py + half, px:px + half] = m
        else:
            self.mode[gy:gy + s4, gx:gx + s4] = cu.modes[0]
        self.intra[gy:gy + s4, gx:gx + s4] = True
        dx, dy = cu.x // 8, cu.y // 8
        s8 = max(cu.size // 8, 1)
        self.depth[dy:dy + s8, dx:dx + s8] = cu.depth
        self.cu_id[dy:dy + s8, dx:dx + s8] = cu_serial


# video_codecs_tpu/models/hevc/quadtree_codec.py:235
def code_tb(orig, pred, qp, log2, dst, rdoq, sbh, is_luma=True, mode=DC):
    res = orig.astype(np.int32) - pred
    coeff = tr_ops.forward_transform_np(res, log2, dst=dst)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    if rdoq == "full":
        from video_codecs_tpu_torch.ops import rdoq as rdoq_ops
        levels = rdoq_ops.rdoq_np(coeff, qp, log2, lam=lam, is_luma=is_luma)
    elif rdoq:
        levels = quant_ops.rdoq_lite_np(coeff, qp, log2, lam=lam)
    else:
        levels = quant_ops.quantize_np(coeff, qp, log2)
    if sbh and levels.any():
        levels = quant_ops.apply_sbh_np(
            levels, log2, coeff, qp,
            scan_type=rom.intra_scan_type(log2, mode, is_luma))
    if not levels.any():
        return levels, pred.astype(np.int32)
    dq = quant_ops.dequantize_np(levels, qp, log2)
    r = tr_ops.inverse_transform_np(dq, log2, dst=dst)
    return levels, np.clip(pred + r, 0, 255).astype(np.int32)


# video_codecs_tpu/models/hevc/quadtree_codec.py:257
def bs_maps_from_cu_ids(cu_id: np.ndarray, w: int, h: int):
    """All-intra BS maps on the 8-px grid: an edge is filtered (BS 2) iff
    the adjacent 8-blocks belong to different CUs (CU == TU here except
    NxN's 4x4 TUs, whose internal edges are off the 8 grid)."""
    n_ve, n_he = w // 8 - 1, h // 8 - 1
    rows8, cols8 = h // 8, w // 8
    bs_ver = np.zeros((n_ve, rows8), np.int32)
    bs_hor = np.zeros((n_he, cols8), np.int32)
    for k in range(n_ve):
        diff = cu_id[:, k] != cu_id[:, k + 1]
        bs_ver[k, :] = 2 * diff
    for k in range(n_he):
        diff = cu_id[k, :] != cu_id[k + 1, :]
        bs_hor[k, :] = 2 * diff
    return bs_ver, bs_hor


# video_codecs_tpu/models/hevc/quadtree_codec.py:274
class QuadtreeIntraEncoder(ic.IntraEncoder):
    """All-intra encoder with a full CU quadtree (CTB 16/32/64 -> CU8/PU4)."""

    # video_codecs_tpu/models/hevc/quadtree_codec.py:277
    def __init__(self, cfg: headers.HevcConfig, *, device="cuda") -> None:
        assert cfg.log2_min_cb == 3, "quadtree build uses min CU 8"
        assert cfg.tile_columns == 1, "tiles + quadtree: round 2"
        super(ic.IntraEncoder, self).__init__()
        ctb = 1 << cfg.log2_ctb
        assert cfg.width % ctb == 0 and cfg.height % ctb == 0, \
            "pad the input to the CTB size"
        self.cfg = cfg
        self._serial = 0
        self.device = torch.device(device)

    # video_codecs_tpu/models/hevc/quadtree_codec.py:287
    def encode_frame(self, y, u, v, modes=None):
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        qp, qp_c = cfg.qp, ic.chroma_qp(cfg.qp)
        self._orig = tuple(p.astype(np.int32) for p in (y, u, v))
        st = State(w, h, cfg.log2_ctb)
        sl = math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))
        self._qp, self._qp_c, self._sl = qp, qp_c, sl

        ctb = 1 << cfg.log2_ctb
        roots = []
        for cy in range(0, h, ctb):
            for cx in range(0, w, ctb):
                _, node = self._encode_node(st, cx, cy, cfg.log2_ctb, 0)
                roots.append(node)

        rec_y, rec_u, rec_v = st.rec_y, st.rec_u, st.rec_v
        from video_codecs_tpu_torch.utils import debug
        if debug.env_flag("VCT_DUMP_MODES", False,
                          "print per-CU/MB mode decisions"):
            print("\n".join(dump_mode_statistics(roots, cfg.log2_ctb)))
        if not cfg.deblocking_disabled:
            bs_ver, bs_hor = bs_maps_from_cu_ids(st.cu_id, w, h)
            with torch.inference_mode():
                out = deblock_ops.deblock_420_bs(
                    *(to_device(p, self.device)
                      for p in (rec_y, rec_u, rec_v)), qp, bs_ver, bs_hor,
                    block=8)
                rec_y, rec_u, rec_v = (o.cpu().numpy() for o in out)
        slice_nal = self._encode_slice_qt(roots)
        sei_nal = self._hash_sei(rec_y, rec_u, rec_v)
        return [slice_nal, sei_nal], (rec_y, rec_u, rec_v)

    # ---- decision + reconstruction (recursive) ----

    # video_codecs_tpu/models/hevc/quadtree_codec.py:318
    def _encode_node(self, st: State, x, y, log2, depth):
        """Choose split vs unsplit for this node; mutates st with the
        winner's reconstruction.  Returns (cost, tree node)."""
        cfg = self.cfg
        size = 1 << log2
        force_split = log2 > 5  # keep TUs <= 32 (encoder choice)
        can_split = log2 > 3

        best = None
        if not force_split:
            trial = st.copy()
            cost_u = self._code_leaf(trial, x, y, log2, depth)
            cost_u += round(self._sl * (1 if can_split else 0))
            best = (cost_u, ("cu", self._last_cu), trial)
        if can_split:
            trial = st.copy()
            half = size // 2
            cost_s = round(self._sl * 1)
            children = []
            for q in range(4):
                c, node = self._encode_node(
                    trial, x + (q & 1) * half, y + (q >> 1) * half,
                    log2 - 1, depth + 1)
                # children recurse on `trial` via a nested call that itself
                # copies; _encode_node mutates its st argument with the win
                children.append(node)
                cost_s += c
            if best is None or cost_s < best[0]:
                best = (cost_s, ("split", children), trial)
        cost, node, winner = best
        st.assign(winner)
        return cost, node

    # video_codecs_tpu/models/hevc/quadtree_codec.py:351
    def _code_leaf(self, st: State, x, y, log2, depth) -> int:
        """Code one CU (2Nx2N, or NxN when 8x8 and it wins); returns cost."""
        size = 1 << log2
        qp, qp_c, sl = self._qp, self._qp_c, self._sl
        cfg = self.cfg
        orig_y = self._orig[0]

        mode, c2n, _ = self._best_mode(st, x, y, size)
        if size == 8:
            cnxn = round(sl * 2)
            modes4 = []
            for p in range(4):
                px, py = x + (p & 1) * 4, y + (p >> 1) * 4
                m4, c4, _ = self._best_mode(st, px, py, 4)
                modes4.append(m4)
                cnxn += c4
            nxn = cnxn < c2n
        else:
            nxn = False
        cu = CuInfo(x, y, size, depth, nxn,
                    modes4 if nxn else [mode])
        self._reconstruct_cu(st, cu)
        d = int(np.abs(st.rec_y[y:y + size, x:x + size].astype(np.int64) -
                       orig_y[y:y + size, x:x + size]).sum())
        self._last_cu = cu
        return d + round(sl * 3)

    # video_codecs_tpu/models/hevc/quadtree_codec.py:378
    def _best_mode(self, st: State, x, y, n):
        ref = build_ref_z(st.rec_y, x, y, n, st.w, st.h, st.ctb_shift)
        orig = self._orig[0][y:y + n, x:x + n]
        log2 = n.bit_length() - 1
        with torch.inference_mode():
            preds = intra_ops.predict_intra(
                to_device(ref[None], self.device),
                torch.arange(35, dtype=torch.int32,
                             device=self.device)[None], log2)[0].cpu().numpy()
        d = np.abs(preds.astype(np.int64) -
                   orig[None]).reshape(35, -1).sum(axis=1)
        mpm = st.mpm(x, y)
        bits = np.full(35, 6.0)
        bits[mpm[0]] = 2.0
        bits[mpm[1]] = 3.0
        bits[mpm[2]] = 3.0
        cost = d + np.round(self._sl * bits).astype(np.int64)
        mode = int(np.argmin(cost))
        return mode, int(cost[mode]), preds[mode]

    # video_codecs_tpu/models/hevc/quadtree_codec.py:396
    def _reconstruct_cu(self, st: State, cu: CuInfo) -> None:
        cfg = self.cfg
        qp, qp_c = self._qp, self._qp_c
        rdoq, sbh = cfg.rdoq, cfg.sign_data_hiding
        x, y, size = cu.x, cu.y, cu.size
        yv, uv, vv = self._orig
        if cu.nxn:
            for p in range(4):
                px, py = x + (p & 1) * 4, y + (p >> 1) * 4
                ref = build_ref_z(st.rec_y, px, py, 4, st.w, st.h,
                                  st.ctb_shift)
                pred = intra_ops.predict_intra_np(ref, cu.modes[p], 2)
                lv, rec = code_tb(yv[py:py + 4, px:px + 4], pred, qp, 2,
                                  True, rdoq, sbh, mode=cu.modes[p])
                cu.levels_y.append(lv if lv.any() else None)
                st.rec_y[py:py + 4, px:px + 4] = rec
        else:
            log2 = size.bit_length() - 1
            ref = build_ref_z(st.rec_y, x, y, size, st.w, st.h, st.ctb_shift)
            pred = intra_ops.predict_intra_np(ref, cu.modes[0], log2)
            lv, rec = code_tb(yv[y:y + size, x:x + size], pred, qp, log2,
                              False, rdoq, sbh, mode=cu.modes[0])
            cu.levels_y.append(lv if lv.any() else None)
            st.rec_y[y:y + size, x:x + size] = rec
        cs = max(size // 2, 4)
        clog2 = cs.bit_length() - 1
        cx, cy = x // 2, y // 2
        for comp, (po, pr) in enumerate(((uv, st.rec_u), (vv, st.rec_v))):
            refc = build_ref_z(pr, cx, cy, cs, st.w // 2, st.h // 2,
                               st.ctb_shift - 1)
            predc = intra_ops.predict_intra_np(refc, cu.modes[0], clog2,
                                               is_luma=False)
            lvc, recc = code_tb(po[cy:cy + cs, cx:cx + cs], predc, qp_c,
                                clog2, False, rdoq, sbh, is_luma=False,
                                mode=cu.modes[0])
            if comp == 0:
                cu.levels_cb = lvc if lvc.any() else None
            else:
                cu.levels_cr = lvc if lvc.any() else None
            pr[cy:cy + cs, cx:cx + cs] = recc
        self._serial += 1
        st.set_cu(cu, self._serial)

    # ---- CABAC ----

    # video_codecs_tpu/models/hevc/quadtree_codec.py:441
    def _encode_slice_qt(self, roots) -> bytes:
        return encode_slice_qt(self.cfg, roots)


# video_codecs_tpu/models/hevc/quadtree_codec.py:445
def encode_slice_qt(cfg: headers.HevcConfig, roots) -> bytes:
    """Serialize a quadtree I slice from per-CTB trees ("split"/"cu" nodes).

    Boundary CTBs use the spec's implicit split (7.4.9.4): no split flag
    when the CU does not fit the picture, children entirely outside are
    skipped (the tree carries None for them).
    """
    w = headers.write_slice_header(cfg, bs.NAL_IDR_W_RADL,
                                   sao_flags=False)
    enc = cabac.CabacEncoder(w, ctx.init_states(ctx.I, cfg.qp))
    st = State(cfg.width, cfg.height, cfg.log2_ctb)
    n = len(roots)
    ctb = 1 << cfg.log2_ctb
    i = 0
    for cy in range(0, cfg.height, ctb):
        for cx in range(0, cfg.width, ctb):
            _encode_node_syntax(enc, st, cfg, roots[i], cx, cy,
                                cfg.log2_ctb, 0)
            i += 1
            enc.encode_terminate(1 if i == n else 0)
    enc.finish_slice()
    return bs.nal_unit(bs.NAL_IDR_W_RADL, w.data())


# video_codecs_tpu/models/hevc/quadtree_codec.py:469
def _encode_node_syntax(enc, st: State, cfg, node, x, y, log2, depth):
    kind, payload = node
    size = 1 << log2
    inside = (x + size <= st.w) and (y + size <= st.h)
    if inside and log2 > 3:
        sctx = st.split_ctx(x, y, depth)
        enc.encode_bin(ctx.off("split_cu_flag", sctx),
                       1 if kind == "split" else 0)
    else:
        assert inside or kind == "split", "boundary CU must be split"
    if kind == "split":
        half = 1 << (log2 - 1)
        for q, child in enumerate(payload):
            cx = x + (q & 1) * half
            cy = y + (q >> 1) * half
            if cx >= st.w or cy >= st.h:
                assert child is None
                continue
            _encode_node_syntax(enc, st, cfg, child, cx, cy,
                                log2 - 1, depth + 1)
        return
    _encode_cu_syntax(enc, st, payload, cfg.sign_data_hiding)


# video_codecs_tpu/models/hevc/quadtree_codec.py:493
def _encode_cu_syntax(enc, st: State, cu: CuInfo, sbh: bool):
    if cu.size == 8:
        enc.encode_bin(ctx.off("part_size"), 0 if cu.nxn else 1)
    pus = 4 if cu.nxn else 1
    half = cu.size // 2
    flags = []
    for p in range(pus):
        px = cu.x + (p & 1) * (half if cu.nxn else 0)
        py = cu.y + (p >> 1) * (half if cu.nxn else 0)
        mpm = st.mpm(px, py)
        mode = cu.modes[p]
        flags.append((mode in mpm, mpm, mode))
        enc.encode_bin(ctx.off("prev_intra_luma_pred"),
                       1 if mode in mpm else 0)
        _set_pu_mode(st, cu, p)
    for in_mpm, mpm, mode in flags:
        if in_mpm:
            idx = mpm.index(mode)
            enc.encode_bypass(0 if idx == 0 else 1)
            if idx:
                enc.encode_bypass(idx - 1)
        else:
            rem = mode
            for c in sorted(mpm, reverse=True):
                if mode > c:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
    enc.encode_bin(ctx.off("chroma_pred_mode"), 0)  # DM

    cbf_cb = cu.levels_cb is not None
    cbf_cr = cu.levels_cr is not None
    enc.encode_bin(ctx.off("cbf_chroma"), 1 if cbf_cb else 0)
    enc.encode_bin(ctx.off("cbf_chroma"), 1 if cbf_cr else 0)
    if cu.nxn:
        for p in range(4):
            lv = cu.levels_y[p]
            enc.encode_bin(ctx.off("cbf_luma", 0), 0 if lv is None else 1)
            if lv is not None:
                stype = rom.intra_scan_type(2, cu.modes[p], True)
                residual.encode_residual(enc, lv, 2, stype, True,
                                         sign_hiding=sbh)
    else:
        lv = cu.levels_y[0]
        enc.encode_bin(ctx.off("cbf_luma", 1), 0 if lv is None else 1)
        if lv is not None:
            log2 = cu.size.bit_length() - 1
            stype = rom.intra_scan_type(log2, cu.modes[0], True)
            residual.encode_residual(enc, lv, log2, stype, True,
                                     sign_hiding=sbh)
    cs = max(cu.size // 2, 4)
    clog2 = cs.bit_length() - 1
    cst = rom.intra_scan_type(clog2, cu.modes[0], False)
    if cbf_cb:
        residual.encode_residual(enc, cu.levels_cb, clog2, cst, False,
                                 sign_hiding=sbh)
    if cbf_cr:
        residual.encode_residual(enc, cu.levels_cr, clog2, cst, False,
                                 sign_hiding=sbh)
    st.serial += 1
    st.set_cu(cu, st.serial)


# video_codecs_tpu/models/hevc/quadtree_codec.py:555
def _set_pu_mode(st: State, cu: CuInfo, p: int):
    half = cu.size // 2 if cu.nxn else cu.size
    px = cu.x + (p & 1) * (half if cu.nxn else 0)
    py = cu.y + (p >> 1) * (half if cu.nxn else 0)
    s4 = half // 4 if cu.nxn else cu.size // 4
    gx, gy = px // 4, py // 4
    st.mode[gy:gy + s4, gx:gx + s4] = cu.modes[p]
    st.intra[gy:gy + s4, gx:gx + s4] = True


# video_codecs_tpu/models/hevc/quadtree_codec.py:565
class QuadtreeIntraDecoder(ic.IntraDecoder):
    """Decoder for the quadtree all-intra streams (log2_min_cb == 3)."""

    # video_codecs_tpu/models/hevc/quadtree_codec.py:568
    def _decode_slice(self, rbsp: bytes, nal_type: int):
        cfg, pps = self.cfg, self.pps
        info = headers.parse_slice_header(rbsp, nal_type, pps,
                                          sps_sao=cfg.sao)
        qp = info.qp
        qp_c = ic.chroma_qp(qp)
        w, h = cfg.width, cfg.height
        data = rbsp[info.data_offset_bits // 8:]
        dec = cabac.CabacDecoder(bs.BitReader(data),
                                 ctx.init_states(ctx.I, qp))
        st = State(w, h, cfg.log2_ctb)
        self._serial = 0
        sbh = pps.sign_data_hiding
        ctb = 1 << cfg.log2_ctb
        n_ctbs = ((w + ctb - 1) // ctb) * ((h + ctb - 1) // ctb)
        i = 0
        for cy in range(0, h, ctb):
            for cx in range(0, w, ctb):
                self._decode_node(dec, st, cx, cy, cfg.log2_ctb, 0, qp,
                                  qp_c, sbh)
                i += 1
                end = dec.decode_terminate()
                assert end == (1 if i == n_ctbs else 0)
        rec_y, rec_u, rec_v = st.rec_y, st.rec_u, st.rec_v
        if not pps.deblocking_disabled:
            bs_ver, bs_hor = bs_maps_from_cu_ids(st.cu_id, w, h)
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs_np(
                rec_y, rec_u, rec_v, qp, bs_ver, bs_hor, block=8)
        return rec_y, rec_u, rec_v

    # video_codecs_tpu/models/hevc/quadtree_codec.py:598
    def _decode_node(self, dec, st: State, x, y, log2, depth, qp, qp_c, sbh):
        size = 1 << log2
        if x + size <= st.w and y + size <= st.h:
            split = False
            if log2 > 3:
                sctx = st.split_ctx(x, y, depth)
                split = bool(dec.decode_bin(ctx.off("split_cu_flag", sctx)))
        else:
            split = True   # implicit split at the picture boundary (7.4.9.4)
        if split:
            half = 1 << (log2 - 1)
            for q in range(4):
                cx = x + (q & 1) * half
                cy = y + (q >> 1) * half
                if cx >= st.w or cy >= st.h:
                    continue   # child entirely outside: not coded
                self._decode_node(dec, st, cx, cy, log2 - 1, depth + 1,
                                  qp, qp_c, sbh)
            return
        self._decode_cu(dec, st, x, y, 1 << log2, depth, qp, qp_c, sbh)

    # video_codecs_tpu/models/hevc/quadtree_codec.py:619
    def _decode_cu(self, dec, st: State, x, y, size, depth, qp, qp_c, sbh):
        w, h = st.w, st.h
        nxn = False
        if size == 8:
            nxn = dec.decode_bin(ctx.off("part_size")) == 0
        pus = 4 if nxn else 1
        half = size // 2
        prev_flags = [dec.decode_bin(ctx.off("prev_intra_luma_pred"))
                      for _ in range(pus)]
        modes = []
        for p in range(pus):
            px = x + (p & 1) * (half if nxn else 0)
            py = y + (p >> 1) * (half if nxn else 0)
            mpm = st.mpm(px, py)
            if prev_flags[p]:
                idx = 0 if dec.decode_bypass() == 0 else 1 + dec.decode_bypass()
                mode = mpm[idx]
            else:
                rem = dec.decode_bypass_bins(5)
                for c in sorted(mpm):
                    if rem >= c:
                        rem += 1
                mode = rem
            modes.append(mode)
            cu_tmp = CuInfo(x, y, size, depth, nxn, list(modes))
            _set_pu_mode(st, cu_tmp, p)
        assert dec.decode_bin(ctx.off("chroma_pred_mode")) == 0
        cbf_cb = dec.decode_bin(ctx.off("cbf_chroma"))
        cbf_cr = dec.decode_bin(ctx.off("cbf_chroma"))

        if nxn:
            for p in range(4):
                px, py = x + (p & 1) * 4, y + (p >> 1) * 4
                cbf = dec.decode_bin(ctx.off("cbf_luma", 0))
                lv = None
                if cbf:
                    stype = rom.intra_scan_type(2, modes[p], True)
                    lv = residual.decode_residual(dec, 2, stype, True,
                                                  sign_hiding=sbh)
                ref = build_ref_z(st.rec_y, px, py, 4, w, h, st.ctb_shift)
                pred = intra_ops.predict_intra_np(ref, modes[p], 2)
                st.rec_y[py:py + 4, px:px + 4] = _recon(pred, lv, qp, 2, True)
        else:
            log2 = size.bit_length() - 1
            cbf = dec.decode_bin(ctx.off("cbf_luma", 1))
            lv = None
            if cbf:
                stype = rom.intra_scan_type(log2, modes[0], True)
                lv = residual.decode_residual(dec, log2, stype, True,
                                              sign_hiding=sbh)
            ref = build_ref_z(st.rec_y, x, y, size, w, h, st.ctb_shift)
            pred = intra_ops.predict_intra_np(ref, modes[0], log2)
            st.rec_y[y:y + size, x:x + size] = _recon(pred, lv, qp, log2,
                                                      False)

        cs = max(size // 2, 4)
        clog2 = cs.bit_length() - 1
        cst = rom.intra_scan_type(clog2, modes[0], False)
        cx, cy = x // 2, y // 2
        for cbf_c, plane in ((cbf_cb, st.rec_u), (cbf_cr, st.rec_v)):
            lvc = None
            if cbf_c:
                lvc = residual.decode_residual(dec, clog2, cst, False,
                                               sign_hiding=sbh)
            refc = build_ref_z(plane, cx, cy, cs, w // 2, h // 2,
                               st.ctb_shift - 1)
            predc = intra_ops.predict_intra_np(refc, modes[0], clog2,
                                               is_luma=False)
            plane[cy:cy + cs, cx:cx + cs] = _recon(predc, lvc, qp_c, clog2,
                                                   False)
        self._serial += 1
        cu = CuInfo(x, y, size, depth, nxn, modes)
        st.set_cu(cu, self._serial)


# video_codecs_tpu/models/hevc/quadtree_codec.py:694
def _recon(pred, lv, qp, log2, dst):
    if lv is None:
        return pred.astype(np.int32)
    dq = quant_ops.dequantize_np(lv, qp, log2)
    r = tr_ops.inverse_transform_np(dq, log2, dst=dst)
    return np.clip(pred + r, 0, 255).astype(np.int32)


# video_codecs_tpu/models/hevc/quadtree_codec.py:706
def build_qt_tree(cfg: headers.HevcConfig, depth8, m8, m16, m32,
                  coef_y, coef_u, coef_v) -> list:
    """Per-CTB trees from the device outputs (depth map + mode maps +
    coefficient planes).  Children entirely outside the picture are None."""
    w, h = cfg.width, cfg.height
    mode_maps = {3: m8, 4: m16, 5: m32}

    def leaf(x, y, log2):
        size = 1 << log2
        mode = int(mode_maps[log2][y // size, x // size])
        cu = CuInfo(x, y, size, cfg.log2_ctb - log2, False, [mode])
        lv = np.asarray(coef_y[y:y + size, x:x + size], np.int32)
        cu.levels_y = [lv if lv.any() else None]
        cs = max(size // 2, 4)
        cx, cy = x // 2, y // 2
        for name, plane in (("levels_cb", coef_u), ("levels_cr", coef_v)):
            lvc = np.asarray(plane[cy:cy + cs, cx:cx + cs], np.int32)
            setattr(cu, name, lvc if lvc.any() else None)
        return ("cu", cu)

    def rec(x, y, log2):
        size = 1 << log2
        fits = x + size <= w and y + size <= h
        if fits and int(depth8[y // 8, x // 8]) == cfg.log2_ctb - log2:
            return leaf(x, y, log2)
        half = size // 2
        children = []
        for q in range(4):
            cx, cy = x + (q & 1) * half, y + (q >> 1) * half
            children.append(None if (cx >= w or cy >= h)
                            else rec(cx, cy, log2 - 1))
        return ("split", children)

    ctb = 1 << cfg.log2_ctb
    return [rec(cx, cy, cfg.log2_ctb)
            for cy in range(0, h, ctb) for cx in range(0, w, ctb)]


# video_codecs_tpu/models/hevc/quadtree_codec.py:744
class QuadtreeFastEncoder:
    """All-intra encoder at the quality operating point, on a torch device.

    Device (encoder_qt_dev): batched per-size mode sweeps + trial-coded
    tree-DP decision, Z-availability wavefront recon, RDOQ-lite, SBH,
    CU-boundary deblocking.  Host: the native quadtree CABAC serializer
    and the picture-hash SEI.  Pictures need not be CTB multiples
    (implicit boundary splits).

    The work runs on the card unless the caller passes device="cpu".  The
    configurations the device quadtree does not build (other CTB, min CU
    or max TB sizes, tiles, WPP) raise ValueError, as the reference's
    asserts refuse them.
    """

    # video_codecs_tpu/models/hevc/quadtree_codec.py:754
    def __init__(self, cfg: headers.HevcConfig, *, device="cuda") -> None:
        if not (cfg.log2_ctb == 5 and cfg.log2_min_cb == 3):
            raise ValueError("device quadtree build is CTB32 / min CU 8")
        if cfg.log2_max_tb != 5:
            raise ValueError("TU tree is CU-aligned (max TB 32)")
        if cfg.width % 8 or cfg.height % 8:
            raise ValueError("picture dims must be multiples of 8")
        if cfg.tile_columns != 1 or cfg.wpp:
            raise ValueError("tiles/WPP on the quadtree device path")
        # cfg.sao allowed: the IDR slice writes slice_sao flags 0
        self.cfg = cfg
        self.device = torch.device(device)

    stream_headers = ic.IntraEncoder.stream_headers
    _hash_sei = ic.IntraEncoder._hash_sei

    # video_codecs_tpu/models/hevc/quadtree_codec.py:768
    def _dispatch(self, y, u, v) -> dict:
        """Upload the 8-bit planes and run the device encoder; returns
        its dict of tensors on the device (not synchronised)."""
        cfg = self.cfg
        with torch.inference_mode():
            planes = [to_device(np.asarray(p, np.uint8), self.device)
                      for p in (y, u, v)]
            return encoder_qt_dev.encode_frame_qt(
                *planes, cfg.qp, cfg.width, cfg.height,
                deblock=not cfg.deblocking_disabled,
                sbh=cfg.sign_data_hiding, rdoq=bool(cfg.rdoq),
                lam_scale=float(getattr(self, "lam_scale", 1.0)))

    # video_codecs_tpu/models/hevc/quadtree_codec.py:778
    def serialize_frame(self, st):
        st = {k: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a)) for k, a in st.items()}
        slice_nal = self._serialize_slice(st)
        rec = (st["rec_y"].astype(np.int32), st["rec_u"].astype(np.int32),
               st["rec_v"].astype(np.int32))
        sei_nal = self._hash_sei(*rec)
        return [slice_nal, sei_nal], rec

    # video_codecs_tpu/models/hevc/quadtree_codec.py:788
    def _serialize_slice(self, st) -> bytes:
        payload = native.encode_slice_qt_native(self.cfg, st)
        h0 = bs.NAL_IDR_W_RADL << 1
        return bytes([h0, 1]) + payload

    # video_codecs_tpu/models/hevc/quadtree_codec.py:802
    def encode_frame_fast(self, y, u, v):
        return self.serialize_frame(self._dispatch(y, u, v))

    # video_codecs_tpu/models/hevc/quadtree_codec.py:805
    def encode_sequence(self, frames) -> tuple[bytes, list]:
        """All pictures are dispatched first, then each state is copied
        back and serialized."""
        nals = self.stream_headers()
        states = [self._dispatch(y, u, v) for (y, u, v) in frames]
        states = [{k: a.cpu() for k, a in st.items()} for st in states]
        recons = []
        for st in states:
            frame_nals, rec = self.serialize_frame(st)
            nals.extend(frame_nals)
            recons.append(rec)
        return bs.annexb(nals), recons
