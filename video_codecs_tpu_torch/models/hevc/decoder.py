"""General HEVC Main-profile decoder: the hash-OK gate of the port's
inter streams.

The port's copy of video_codecs_tpu/models/hevc/decoder.py, function by
function (each keeps its name and a comment gives the original's line):
CTU 16/32/64 with any CU quadtree, inter PUs 2Nx2N/2NxN/Nx2N/NxN + the
four AMP shapes, skip/merge/AMVP with the full spec candidate derivation
(motion_hm.py), TMVP, bi-prediction, the full RQT on both prediction
modes, all 35 luma + 5 chroma intra modes, sign data hiding, strong
intra smoothing, motion-aware deblocking (ops/deblock.py, 4-sample BS
segments), sample adaptive offset (SAO: the sao() syntax per CTB and
the offsets applied after deblocking, each EO class's category map
computed once per plane with `ops/sao.apply_ctus`, where the reference
recomputes it for every CTB) and decoded-picture-hash verification.

Long-term reference pictures (the low-delay P encoder's long-term IDR)
are parsed from the SPS and the slice header, resolved to POCs by
`_lt_pocs` and kept in the DPB past its window; SEI other than the
picture hash (the HRD timing messages) is skipped.  Explicit weighted
prediction (`pred_weight_table`, `WpTable`) and cu_qp_delta (the QP
groups, `_maybe_qp_delta` and the per-4x4 QP map that sets the deblock's
edge QPs) decode the host low-delay P coder's streams.  HM's parallel
and conformance tools as the reference decodes them: tiles (uniform or
explicit grids of columns and rows, one CABAC substream per tile in
tile-scan order) and WPP (one substream per CTB row, the contexts
carried from the second CTB of the row above), their entry points
converted from EBSP to RBSP offsets (`_strip_ep_with_pos`); scaling
lists (the default tables and `scaling_list_data` in the SPS or PPS);
PCM CUs (`_decode_pcm_cu`); transform skip.

Parity references: hm-16.5rc1/source/Lib/TLibDecoder/TDecCAVLC.cpp
(parameter-set and slice-header parsing), TDecTop.cpp:820 (picture
dispatch, POC derivation), TComSlice.cpp setRefPicList (8.3.4 list
construction), TDecEntropy.cpp:372 xDecodeTransform (RQT recursion and
cbf inheritance), TDecSbac.cpp, TDecCu.cpp:410 xReconInter / :653
xReconIntraQT, TComPattern.cpp:209 (strong intra smoothing),
TComLoopFilter.cpp xGetBoundaryStrength.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, residual
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.models.hevc import motion_hm
from video_codecs_tpu_torch.models.hevc.quadtree_codec import (build_ref_z,
                                                              z_index)
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops import sao as sao_ops
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.utils import rom

DC = 1
DM_CHROMA = 36  # sentinel: derive from luma


# ---------------------------------------------------------------------------
# Parameter sets (general parse; spec 7.3.2.2-7.3.2.3, TDecCAVLC.cpp)
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/decoder.py:55
@dataclasses.dataclass
class Sps:
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    log2_ctb: int = 6
    log2_min_cb: int = 3
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_tr_depth_intra: int = 1
    max_tr_depth_inter: int = 1
    sao: bool = False
    amp: bool = False
    pcm: bool = False
    temporal_mvp: bool = False
    strong_intra_smoothing: bool = False
    pcm_bd_luma: int = 8
    pcm_bd_chroma: int = 8
    log2_min_ipcm: int = 3
    log2_max_ipcm: int = 3
    pcm_loop_filter_disabled: bool = False
    log2_max_poc_lsb: int = 8
    conf_win: tuple = (0, 0, 0, 0)
    rps_list: list = dataclasses.field(default_factory=list)
    lt_present: bool = False
    scaling_list_enabled: bool = False
    scaling_lists: list | None = None


# video_codecs_tpu/models/hevc/decoder.py:84
@dataclasses.dataclass
class StRps:
    """Short-term RPS: lists of (delta_poc, used_by_curr) with S0
    (negative, decreasing) and S1 (positive, increasing) ordering."""
    neg: list = dataclasses.field(default_factory=list)
    pos: list = dataclasses.field(default_factory=list)

    # video_codecs_tpu/models/hevc/decoder.py:91
    @property
    def num_delta_pocs(self):
        return len(self.neg) + len(self.pos)


# video_codecs_tpu/models/hevc/decoder.py:96
def parse_st_rps(r: bs.BitReader, idx: int, prev: list,
                 slice_header: bool = False) -> StRps:
    """st_ref_pic_set(idx) (spec 7.3.7 + 7.4.8 derivation)."""
    out = StRps()
    pred = bool(r.flag()) if idx > 0 else False
    if pred:
        delta_idx = (r.ue() + 1) if slice_header else 1
        ref = prev[idx - delta_idx]
        sign = r.flag()
        abs_delta = r.ue() + 1
        delta_rps = (1 - 2 * sign) * abs_delta
        flags = []
        for _ in range(ref.num_delta_pocs + 1):
            used = bool(r.flag())
            use_delta = True if used else bool(r.flag())
            flags.append((used, use_delta))
        # derivation (spec 7.4.8): S0 from ref S1 desc, deltaRps, ref S0 asc
        ref_neg = [d for d, _ in ref.neg]
        ref_pos = [d for d, _ in ref.pos]
        n_neg = len(ref_neg)
        for j in range(len(ref_pos) - 1, -1, -1):
            d = ref_pos[j] + delta_rps
            if d < 0 and flags[n_neg + j][1]:
                out.neg.append((d, flags[n_neg + j][0]))
        if delta_rps < 0 and flags[ref.num_delta_pocs][1]:
            out.neg.append((delta_rps, flags[ref.num_delta_pocs][0]))
        for j in range(n_neg):
            d = ref_neg[j] + delta_rps
            if d < 0 and flags[j][1]:
                out.neg.append((d, flags[j][0]))
        out.neg.sort(key=lambda t: -t[0])
        for j in range(n_neg - 1, -1, -1):
            d = ref_neg[j] + delta_rps
            if d > 0 and flags[j][1]:
                out.pos.append((d, flags[j][0]))
        if delta_rps > 0 and flags[ref.num_delta_pocs][1]:
            out.pos.append((delta_rps, flags[ref.num_delta_pocs][0]))
        for j in range(len(ref_pos)):
            d = ref_pos[j] + delta_rps
            if d > 0 and flags[n_neg + j][1]:
                out.pos.append((d, flags[n_neg + j][0]))
        out.pos.sort(key=lambda t: t[0])
        return out
    n_neg = r.ue()
    n_pos = r.ue()
    poc = 0
    for _ in range(n_neg):
        poc -= r.ue() + 1
        out.neg.append((poc, bool(r.flag())))
    poc = 0
    for _ in range(n_pos):
        poc += r.ue() + 1
        out.pos.append((poc, bool(r.flag())))
    return out


# Default quantization matrices (spec Tables 7-5/7-6; HM TComRom
# g_quantIntraDefault8x8 / g_quantInterDefault8x8) — spec constants.
_SL_INTRA8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32).reshape(8, 8)
_SL_INTER8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32).reshape(8, 8)


# video_codecs_tpu/models/hevc/decoder.py:174
def _sl_default(size_id: int, matrix_id: int):
    """(base matrix raster, dc) default entry (spec 7.4.5)."""
    if size_id == 0:
        return np.full((4, 4), 16, np.int32), 16
    return (_SL_INTRA8 if matrix_id < 3 else _SL_INTER8).copy(), 16


# video_codecs_tpu/models/hevc/decoder.py:181
def _diag_scan_ungrouped(n: int) -> np.ndarray:
    """Up-right diagonal scan -> raster index, UNGROUPED (spec 6.5.3;
    scaling_list_data uses this, unlike the CG-grouped residual scan)."""
    out = []
    for d in range(2 * n - 1):
        for y in range(min(d, n - 1), -1, -1):
            x = d - y
            if x < n:
                out.append(y * n + x)
    return np.array(out, np.int32)


# video_codecs_tpu/models/hevc/decoder.py:193
def parse_scaling_list_data(r: bs.BitReader) -> list:
    """scaling_list_data() (spec 7.3.4; TDecCAVLC parseScalingList).

    Returns sl[size_id][matrix_id] = (base NxN raster matrix, dc)."""
    sl = [[None] * 6 for _ in range(4)]
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, step):
            if not r.flag():            # scaling_list_pred_mode_flag
                delta = r.ue()
                if delta == 0:
                    sl[size_id][matrix_id] = _sl_default(size_id,
                                                         matrix_id)
                else:
                    sl[size_id][matrix_id] = sl[size_id][
                        matrix_id - delta * step]
            else:
                n = 4 if size_id == 0 else 8
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                dc = 16
                next_coef = 8
                if size_id > 1:
                    dc = 8 + r.se()
                    next_coef = dc     # DC seeds the DPCM (spec 7.3.4)
                scan = _diag_scan_ungrouped(n)
                vals = np.zeros(n * n, np.int32)
                for i in range(coef_num):
                    next_coef = (next_coef + r.se() + 256) % 256
                    vals[scan[i]] = next_coef
                m = vals.reshape(n, n)
                sl[size_id][matrix_id] = (
                    m, dc if size_id > 1 else int(m[0, 0]))
        if size_id == 3:                # unsignalled chroma 32 slots
            sl[3][1] = sl[3][2] = sl[3][0]
            sl[3][4] = sl[3][5] = sl[3][3]
    return sl



# video_codecs_tpu/models/hevc/decoder.py:231
@dataclasses.dataclass
class Pps:
    init_qp: int = 26
    constrained_intra: bool = False
    transform_skip: bool = False
    cu_qp_delta: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass: bool = False
    tiles: bool = False
    entropy_sync: bool = False
    tile_cols: int = 1
    tile_rows: int = 1
    tile_uniform: bool = True
    tile_col_widths: list | None = None    # CTUs, first n-1 columns
    tile_row_heights: list | None = None
    loop_filter_across_slices: bool = True
    deblocking_control: bool = False
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_l0_default: int = 1
    num_ref_l1_default: int = 1
    lists_modification: bool = False
    log2_parallel_merge_level: int = 2
    output_flag_present: bool = False
    num_extra_bits: int = 0
    scaling_lists: list | None = None


# video_codecs_tpu/models/hevc/decoder.py:268
def _skip_profile_tier_level(r: bs.BitReader, max_sub_layers: int) -> None:
    r.read(2 + 1 + 5)
    r.read(32)
    r.read(4)       # progressive/interlaced/non-packed/frame-only
    r.read(32)      # reserved 43 bits + ...
    r.read(11)
    r.read(1)
    r.read(8)       # level idc
    flags = [(r.flag(), r.flag()) for _ in range(max_sub_layers)]
    if max_sub_layers > 0:
        for _ in range(8 - max_sub_layers):
            r.read(2)
    for prof, lev in flags:
        if prof:
            r.read(32)
            r.read(32)
            r.read(24)
        if lev:
            r.read(8)


# video_codecs_tpu/models/hevc/decoder.py:289
def parse_sps(rbsp: bytes) -> Sps:
    r = bs.BitReader(rbsp)
    r.read(4)                   # sps_video_parameter_set_id
    max_sub_layers = r.read(3)
    r.flag()                    # temporal_id_nesting
    _skip_profile_tier_level(r, max_sub_layers)
    r.ue()                      # sps_seq_parameter_set_id
    chroma = r.ue()
    assert chroma == 1, "only 4:2:0 supported"
    s = Sps()
    s.width = r.ue()
    s.height = r.ue()
    if r.flag():                # conformance_window_flag
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    s.bit_depth = 8 + r.ue()
    assert 8 + r.ue() == s.bit_depth, "chroma bit depth must match"
    assert 8 <= s.bit_depth <= 10, "Main / Main10 profiles only"
    s.log2_max_poc_lsb = 4 + r.ue()
    sub_layer_ordering = r.flag()
    for _ in range((max_sub_layers + 1) if sub_layer_ordering else 1):
        r.ue(), r.ue(), r.ue()  # dpb size / reorder / latency
    s.log2_min_cb = 3 + r.ue()
    s.log2_ctb = s.log2_min_cb + r.ue()
    s.log2_min_tb = 2 + r.ue()
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_tr_depth_inter = r.ue()
    s.max_tr_depth_intra = r.ue()
    s.scaling_list_enabled = bool(r.flag())
    if s.scaling_list_enabled:
        if r.flag():                # sps_scaling_list_data_present
            s.scaling_lists = parse_scaling_list_data(r)
        else:
            s.scaling_lists = [[_sl_default(sz, m) for m in range(6)]
                               for sz in range(4)]
    s.amp = bool(r.flag())
    s.sao = bool(r.flag())
    s.pcm = bool(r.flag())
    if s.pcm:
        s.pcm_bd_luma = 1 + r.read(4)
        s.pcm_bd_chroma = 1 + r.read(4)
        s.log2_min_ipcm = 3 + r.ue()
        s.log2_max_ipcm = s.log2_min_ipcm + r.ue()
        s.pcm_loop_filter_disabled = bool(r.flag())
        assert not s.pcm_loop_filter_disabled, \
            "pcm_loop_filter_disabled: later"
    s.rps_list = []
    num_rps = r.ue()
    for i in range(num_rps):
        s.rps_list.append(parse_st_rps(r, i, s.rps_list))
    s.lt_present = bool(r.flag())   # long_term_ref_pics_present
    s.lt_refs = []                  # [(poc_lsb, used_by_curr)] SPS-signalled
    if s.lt_present:
        for _ in range(r.ue()):
            s.lt_refs.append((r.read(s.log2_max_poc_lsb), bool(r.flag())))
    s.temporal_mvp = bool(r.flag())
    s.strong_intra_smoothing = bool(r.flag())
    if r.flag():                # vui_parameters_present
        pass                    # ignored (display metadata only)
    # sps_extension flags ignored
    return s


# video_codecs_tpu/models/hevc/decoder.py:351
def parse_pps(rbsp: bytes) -> Pps:
    r = bs.BitReader(rbsp)
    p = Pps()
    r.ue(), r.ue()              # pps id, sps id
    assert not r.flag(), "dependent slice segments not supported"
    p.output_flag_present = bool(r.flag())
    p.num_extra_bits = r.read(3)
    p.sign_data_hiding = bool(r.flag())
    p.cabac_init_present = bool(r.flag())
    p.num_ref_l0_default = 1 + r.ue()
    p.num_ref_l1_default = 1 + r.ue()
    p.init_qp = 26 + r.se()
    p.constrained_intra = bool(r.flag())
    assert not p.constrained_intra, "constrained intra not supported"
    p.transform_skip = bool(r.flag())
    p.cu_qp_delta = bool(r.flag())
    if p.cu_qp_delta:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets = bool(r.flag())
    p.weighted_pred = bool(r.flag())
    p.weighted_bipred = bool(r.flag())
    p.transquant_bypass = bool(r.flag())
    assert not p.transquant_bypass, "transquant bypass not supported"
    p.tiles = bool(r.flag())
    p.entropy_sync = bool(r.flag())
    assert not (p.tiles and p.entropy_sync), \
        "tiles + WPP combined: unsupported"
    if p.tiles:
        p.tile_cols = 1 + r.ue()
        p.tile_rows = 1 + r.ue()
        p.tile_uniform = bool(r.flag())
        if not p.tile_uniform:
            p.tile_col_widths = [1 + r.ue()
                                 for _ in range(p.tile_cols - 1)]
            p.tile_row_heights = [1 + r.ue()
                                  for _ in range(p.tile_rows - 1)]
        assert r.flag(), \
            "loop_filter_across_tiles disabled: unsupported"
    p.loop_filter_across_slices = bool(r.flag())
    p.deblocking_control = bool(r.flag())
    if p.deblocking_control:
        p.deblocking_override_enabled = bool(r.flag())
        p.deblocking_disabled = bool(r.flag())
        if not p.deblocking_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.flag():                    # pps_scaling_list_data_present
        p.scaling_lists = parse_scaling_list_data(r)
    p.lists_modification = bool(r.flag())
    p.log2_parallel_merge_level = 2 + r.ue()
    r.flag()                    # slice_segment_header_extension_present
    return p


B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


# video_codecs_tpu/models/hevc/decoder.py:410
@dataclasses.dataclass
class WpTable:
    """pred_weight_table (spec 7.3.6.3): per-list per-ref weights as
    (w, o) pairs for luma/cb/cr; log2 denominators shared."""
    luma_denom: int = 0
    chroma_denom: int = 0
    # weights[list][ref] = ((wy, oy), (wcb, ocb), (wcr, ocr)) with the
    # default (1 << denom, 0) filled in for unsignalled entries
    weights: list = dataclasses.field(default_factory=lambda: [[], []])


# video_codecs_tpu/models/hevc/decoder.py:421
def parse_pred_weight_table(r: bs.BitReader, h: "SliceHeader") -> WpTable:
    wp = WpTable()
    wp.luma_denom = r.ue()
    wp.chroma_denom = wp.luma_denom + r.se()
    n_lists = 2 if h.slice_type == B_SLICE else 1
    for lx in range(n_lists):
        n = h.num_ref_idx[lx]
        lflags = [bool(r.flag()) for _ in range(n)]
        cflags = [bool(r.flag()) for _ in range(n)]
        for i in range(n):
            wy, oy = 1 << wp.luma_denom, 0
            wcb = wcr = 1 << wp.chroma_denom
            ocb = ocr = 0
            if lflags[i]:
                wy = (1 << wp.luma_denom) + r.se()
                oy = r.se()
            if cflags[i]:
                cw = []
                for _ in range(2):
                    w_ = (1 << wp.chroma_denom) + r.se()
                    d_ = r.se()
                    # spec 7.4.7.3: offset = Clip3(-128, 127,
                    #   d + 128 - ((128 * w) >> denom))
                    o_ = max(-128, min(127,
                                       d_ + 128 - ((128 * w_)
                                                   >> wp.chroma_denom)))
                    cw.append((w_, o_))
                (wcb, ocb), (wcr, ocr) = cw
            wp.weights[lx].append(((wy, oy), (wcb, ocb), (wcr, ocr)))
    return wp


# video_codecs_tpu/models/hevc/decoder.py:453
@dataclasses.dataclass
class SliceHeader:
    slice_type: int = 2         # 0 B, 1 P, 2 I
    nal_type: int = 0
    first_slice: bool = True
    slice_address: int = 0
    temporal_id: int = 0
    poc_lsb: int = 0
    poc: int = 0
    rps: StRps | None = None
    sao_luma: bool = False
    sao_chroma: bool = False
    qp: int = 26
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    data_offset_bits: int = 0
    num_ref_idx: tuple = (0, 0)
    list_mod: tuple = (None, None)     # explicit list_entry_lX or None
    tmvp: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    max_merge: int = 5
    cabac_init: bool = False
    mvd_l1_zero: bool = False
    wp: WpTable | None = None
    entry_points: list = dataclasses.field(default_factory=list)
    #: long-term pics: [(poc_lsb, used, msb_present, delta_poc_msb_cycle)]
    lt_entries: list = dataclasses.field(default_factory=list)


# video_codecs_tpu/models/hevc/decoder.py:484
def parse_slice_header(rbsp: bytes, nal_type: int, sps: Sps,
                       pps: Pps) -> SliceHeader:
    """General slice_segment_header parse (spec 7.3.6.1; TDecCAVLC
    parseSliceHeader) for the single-slice-per-picture toolset."""
    r = bs.BitReader(rbsp)
    h = SliceHeader()
    h.nal_type = nal_type
    h.first_slice = bool(r.flag())
    if 16 <= nal_type <= 23:    # IRAP
        r.flag()                # no_output_of_prior_pics
    r.ue()                      # slice_pic_parameter_set_id
    if not h.first_slice:
        ctb = 1 << sps.log2_ctb
        n_ctbs = ((sps.width + ctb - 1) // ctb) * \
            ((sps.height + ctb - 1) // ctb)
        h.slice_address = r.read(max(1, (n_ctbs - 1).bit_length()))
    for _ in range(pps.num_extra_bits):
        r.flag()                # slice_reserved_flag
    h.slice_type = r.ue()
    if pps.output_flag_present:
        r.flag()                # pic_output_flag
    if nal_type not in (bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP):
        h.poc_lsb = r.read(sps.log2_max_poc_lsb)
        if r.flag():                      # short_term_ref_pic_set_sps_flag
            n = len(sps.rps_list)
            idx = 0
            if n > 1:
                idx = r.read(max(1, (n - 1).bit_length()))
            h.rps = sps.rps_list[idx]
        else:
            h.rps = parse_st_rps(r, len(sps.rps_list), sps.rps_list,
                                 slice_header=True)
        if sps.lt_present:
            # lt section (spec 7.3.6.1): SPS-indexed entries first, then
            # slice-signalled ones; delta_poc_msb_cycle_lt is delta-coded
            # within each group (spec 7.4.7.1 DeltaPocMsbCycleLt)
            n_sps = r.ue() if sps.lt_refs else 0
            n_pics = r.ue()
            prev_cycle = 0
            for i in range(n_sps + n_pics):
                if i < n_sps:
                    idx = 0
                    if len(sps.lt_refs) > 1:
                        idx = r.read((len(sps.lt_refs) - 1).bit_length())
                    lsb, used = sps.lt_refs[idx]
                else:
                    lsb = r.read(sps.log2_max_poc_lsb)
                    used = bool(r.flag())
                msb_present = bool(r.flag())
                d = r.ue() if msb_present else 0
                # TDecCAVLC: the msb-cycle chain advances every entry,
                # restarting at the first slice-signalled one
                cycle = d if i in (0, n_sps) else d + prev_cycle
                prev_cycle = cycle
                h.lt_entries.append((lsb, used, msb_present, cycle))
        if sps.temporal_mvp:
            h.tmvp = bool(r.flag())
    else:
        h.rps = StRps()
    if sps.sao:
        h.sao_luma = bool(r.flag())
        h.sao_chroma = bool(r.flag())
    if h.slice_type in (P_SLICE, B_SLICE):
        n0, n1 = pps.num_ref_l0_default, pps.num_ref_l1_default
        if r.flag():            # num_ref_idx_active_override
            n0 = 1 + r.ue()
            if h.slice_type == B_SLICE:
                n1 = 1 + r.ue()
        h.num_ref_idx = (n0, n1 if h.slice_type == B_SLICE else 0)
        npc = (sum(u for _, u in h.rps.neg) + sum(u for _, u in h.rps.pos) +
               sum(1 for _, u, _, _ in h.lt_entries if u))
        if pps.lists_modification and npc > 1:
            nbits = max(1, (npc - 1).bit_length())
            mods = []
            for nl in (n0, n1 if h.slice_type == B_SLICE else 0):
                if nl and r.flag():
                    mods.append([r.read(nbits) for _ in range(nl)])
                else:
                    mods.append(None)
            h.list_mod = tuple(mods)
        if h.slice_type == B_SLICE:
            h.mvd_l1_zero = bool(r.flag())
        if pps.cabac_init_present:
            h.cabac_init = bool(r.flag())
        if h.tmvp:
            if h.slice_type == B_SLICE:
                h.collocated_from_l0 = bool(r.flag())
            if (h.collocated_from_l0 and n0 > 1) or \
                    (not h.collocated_from_l0 and n1 > 1):
                h.collocated_ref_idx = r.ue()
        if (pps.weighted_pred and h.slice_type == P_SLICE) or \
                (pps.weighted_bipred and h.slice_type == B_SLICE):
            h.wp = parse_pred_weight_table(r, h)
        h.max_merge = 5 - r.ue()
    h.qp = pps.init_qp + r.se()
    if pps.slice_chroma_qp_offsets:
        r.se(), r.se()
    h.deblocking_disabled = pps.deblocking_disabled
    h.beta_offset_div2 = pps.beta_offset_div2
    h.tc_offset_div2 = pps.tc_offset_div2
    if pps.deblocking_control and pps.deblocking_override_enabled:
        if r.flag():            # deblocking_filter_override_flag
            h.deblocking_disabled = bool(r.flag())
            if not h.deblocking_disabled:
                h.beta_offset_div2 = r.se()
                h.tc_offset_div2 = r.se()
    if pps.loop_filter_across_slices and (h.sao_luma or h.sao_chroma or
                                          not h.deblocking_disabled):
        r.flag()                # slice_loop_filter_across_slices
    if pps.tiles or pps.entropy_sync:
        n_entry = r.ue()        # num_entry_point_offsets
        if n_entry:
            olen = 1 + r.ue()   # offset_len_minus1 + 1
            h.entry_points = [1 + r.read(olen) for _ in range(n_entry)]
    # byte_alignment(): alignment_bit_equal_to_one is ALWAYS present, even
    # when the header already ends on a byte boundary (spec 7.3.2.10)
    one = r.flag()
    assert one == 1, "alignment_bit_equal_to_one"
    r.byte_align()
    h.data_offset_bits = r.bit_pos()
    return h


# ---------------------------------------------------------------------------
# Strong intra smoothing + filtered-reference selection
# ---------------------------------------------------------------------------

# video_codecs_tpu/models/hevc/decoder.py:611
def filtered_ref(ref: np.ndarray, n: int, strong: bool,
                 bit_depth: int = 8) -> np.ndarray:
    """1-2-1 smoothed reference; bilinear when strong smoothing applies
    (TComPattern.cpp:209-292; 32x32 luma only)."""
    ref = ref.astype(np.int64)
    if strong and n == 32:
        thr = 1 << (bit_depth - 5)
        bl, tl, tr = ref[0], ref[2 * n], ref[4 * n]
        if (abs(bl + tl - 2 * ref[n]) < thr and
                abs(tl + tr - 2 * ref[3 * n]) < thr):
            out = ref.copy()
            shift = n.bit_length() + 1   # log2(2n) + 1? no: log2(2n)=6 for 32
            shift = (2 * n).bit_length() - 1
            for k in range(1, 2 * n):
                out[k] = ((2 * n - k) * bl + k * tl + n) >> shift
                out[2 * n + k] = ((2 * n - k) * tl + k * tr + n) >> shift
            return out
    mid = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
    return np.concatenate([ref[:1], mid, ref[-1:]])


# video_codecs_tpu/models/hevc/decoder.py:632
def predict_intra_general(ref: np.ndarray, mode: int, log2: int,
                          is_luma: bool, strong: bool,
                          bit_depth: int = 8) -> np.ndarray:
    """predict_intra_np with HM's strong-intra-smoothing reference."""
    n = 1 << log2
    if not (is_luma and strong and n == 32 and
            intra_ops.filter_flag(mode, log2, is_luma)):
        return intra_ops.predict_intra_np(ref, mode, log2, is_luma=is_luma,
                                          bit_depth=bit_depth)
    # Rebuild a raw ref whose internal 1-2-1 smoothing we bypass by calling
    # the weight machinery directly with the strong-filtered array.
    w, bias, s_common = intra_ops._mode_weights(log2, is_luma)
    fref = filtered_ref(ref, n, True, bit_depth)
    ref2 = np.concatenate([ref.astype(np.int64), fref])
    pred = ((w[mode].astype(np.int64) @ ref2 + int(bias[mode])) >> s_common)
    return np.clip(pred.reshape(n, n), 0,
                   (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

CHROMA_CANDS = (0, 26, 10, 1)   # planar, ver, hor, DC; DM coded separately

# nal_type values of sub-layer non-reference + RADL/RASL pictures: these
# never become prevTid0Pic in the POC derivation (spec 8.3.1)
_NOT_TID0_ANCHOR = {0, 2, 4, 6, 7, 8, 9}


# video_codecs_tpu/models/hevc/decoder.py:662
def _wrap16(v: int) -> int:
    """MVs are 16-bit two's-complement (spec 7.4.9.9)."""
    return ((v + 32768) & 65535) - 32768


# video_codecs_tpu/models/hevc/decoder.py:667
def _strip_ep_with_pos(payload: bytes):
    """Emulation-prevention strip that also records, for each removed
    0x03 byte, the RBSP index of the byte that followed it — needed to
    convert signalled entry_point_offsets (EBSP bytes, spec 7.4.7.1)
    into RBSP positions (HM TDecSlice 'adjust for emulation bytes')."""
    out = bytearray()
    pos = []
    i, n = 0, len(payload)
    while i < n:
        if i + 2 < n and payload[i] == 0 and payload[i + 1] == 0 \
                and payload[i + 2] == 3:
            out += payload[i:i + 2]
            pos.append(len(out))
            i += 3
        else:
            out.append(payload[i])
            i += 1
    return bytes(out), pos

# video_codecs_tpu/models/hevc/decoder.py:687
def _tile_grid(pps: Pps, cw: int, ch: int):
    """Tile CTU column/row boundaries (spec 6.5.1)."""
    nc, nr = pps.tile_cols, pps.tile_rows
    if pps.tile_uniform:
        cols = [(i * cw) // nc for i in range(nc + 1)]
        rows = [(i * ch) // nr for i in range(nr + 1)]
    else:
        cols, rows = [0], [0]
        for w_ in pps.tile_col_widths:
            cols.append(cols[-1] + w_)
        cols.append(cw)
        for h_ in pps.tile_row_heights:
            rows.append(rows[-1] + h_)
        rows.append(ch)
    return cols, rows


# video_codecs_tpu/models/hevc/decoder.py:704
class GeneralDecoder:
    """Decodes conformant HEVC Main streams (incl. HM output): all-intra,
    low-delay P/B and random-access hierarchical-B toolsets."""

    # video_codecs_tpu/models/hevc/decoder.py:708
    def __init__(self) -> None:
        self.sps: Sps | None = None
        self.pps: Pps | None = None
        self.hash_status: list[bool] = []
        self.frames: list = []          # decode order
        self._keys: list = []           # (epoch, poc) per decoded frame
        self.dpb: dict = {}             # poc -> (planes, PicMotion)
        self._epoch = 0
        self._prev_tid0_poc = 0

    # video_codecs_tpu/models/hevc/decoder.py:718
    def decode(self, stream: bytes):
        """Returns frames in OUTPUT (display) order; self.frames holds
        decode order (hash_status is indexed in decode order)."""
        self.frames, self._keys = [], []
        self.hash_status = []
        self.dpb = {}
        for nal in bs.split_annexb(stream):
            nal_type = (nal[0] >> 1) & 0x3F
            tid = (nal[1] & 0x07) - 1
            rbsp = bs.strip_emulation_prevention(nal[2:])
            if nal_type == bs.NAL_SPS:
                self.sps = parse_sps(rbsp)
            elif nal_type == bs.NAL_PPS:
                self.pps = parse_pps(rbsp)
            elif nal_type <= 21:        # coded slice (TRAIL..CRA)
                if self.pps.tiles or self.pps.entropy_sync:
                    rbsp, self._cur_emu = _strip_ep_with_pos(nal[2:])
                else:
                    self._cur_emu = []
                self._decode_picture(rbsp, nal_type, tid)
            elif nal_type in (bs.NAL_PREFIX_SEI, bs.NAL_SUFFIX_SEI):
                self._check_hash(rbsp)
        order = sorted(range(len(self.frames)),
                       key=lambda i: self._keys[i])
        return [self.frames[i] for i in order]

    # ---- POC derivation (spec 8.3.1 / TDecTop xActivateParameterSets) --

    # video_codecs_tpu/models/hevc/decoder.py:746
    def _derive_poc(self, nal_type: int, tid: int, lsb: int) -> int:
        if nal_type in (bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP):
            poc = 0
            self._epoch += 1
            self._prev_tid0_poc = 0
            self.dpb = {}               # no reference crosses an IDR
            return poc
        max_lsb = 1 << self.sps.log2_max_poc_lsb
        prev = self._prev_tid0_poc
        prev_lsb = prev & (max_lsb - 1)
        prev_msb = prev - prev_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        poc = msb + lsb
        if tid == 0 and nal_type not in _NOT_TID0_ANCHOR:
            self._prev_tid0_poc = poc
        return poc

    # ---- reference picture lists (spec 8.3.4 / TComSlice setRefPicList) -

    # video_codecs_tpu/models/hevc/decoder.py:770
    def _lt_pocs(self, h: SliceHeader) -> list[int]:
        """Resolve used long-term entries to full POCs (spec 8.3.2
        PocLtCurr): msb-signalled entries by arithmetic, the rest by
        matching poc lsb against the DPB."""
        max_lsb = 1 << self.sps.log2_max_poc_lsb
        out = []
        for lsb, used, msb_present, cycle in h.lt_entries:
            if not used:
                continue
            if msb_present:
                out.append(h.poc - cycle * max_lsb -
                           (h.poc & (max_lsb - 1)) + lsb)
            else:
                cand = [p for p in self.dpb if (p & (max_lsb - 1)) == lsb]
                assert cand, f"long-term ref lsb {lsb} not in DPB"
                out.append(max(cand))
        return out

    # video_codecs_tpu/models/hevc/decoder.py:788
    def _ref_lists(self, h: SliceHeader) -> list[list[int]]:
        before = [h.poc + d for d, u in h.rps.neg if u]
        after = [h.poc + d for d, u in h.rps.pos if u]
        lt = self._lt_pocs(h) if h.lt_entries else []
        self._lt_protect = set(lt)
        lists = []
        for lx, order in ((0, before + after + lt),
                          (1, after + before + lt)):
            n = h.num_ref_idx[lx]
            if n == 0 or not order:
                lists.append([])
                continue
            tmp = [order[i % len(order)] for i in range(max(n, len(order)))]
            ent = h.list_mod[lx]
            lst = [tmp[e] for e in ent] if ent is not None else tmp[:n]
            lists.append(lst)
        return lists

    # video_codecs_tpu/models/hevc/decoder.py:806
    def _check_hash(self, rbsp: bytes) -> None:
        r = bs.BitReader(rbsp)
        ptype = r.read(8)
        psize = r.read(8)
        if ptype != 132 or psize != 49:
            return
        if r.read(8) != 0:      # hash type MD5
            return
        md5s = [bytes(r.read(8) for _ in range(16)) for _ in range(3)]
        if not self.frames:
            return
        f = self.frames[-1]
        # >8-bit samples hash as 2 bytes little-endian (HM TComPicYuv
        # MD5 per-component, 8-bit streams one byte per sample)
        if self.sps.bit_depth > 8:
            ok = all(hashlib.md5(
                f[i].astype('<u2').tobytes()).digest() == md5s[i]
                for i in range(3))
        else:
            ok = all(hashlib.md5(f[i].astype(np.uint8).tobytes()).digest()
                     == md5s[i] for i in range(3))
        self.hash_status.append(ok)

    # ---- picture decode ----

    # video_codecs_tpu/models/hevc/decoder.py:831
    def _decode_picture(self, rbsp: bytes, nal_type: int, tid: int):
        sps, pps = self.sps, self.pps
        h = parse_slice_header(rbsp, nal_type, sps, pps)
        h.temporal_id = tid
        w, hgt = sps.width, sps.height
        ctb = 1 << sps.log2_ctb
        cw = (w + ctb - 1) // ctb
        ch = (hgt + ctb - 1) // ctb
        if h.first_slice:
            h.poc = self._derive_poc(nal_type, tid, h.poc_lsb)
        else:
            # continuation slice segment of the current picture
            return self._decode_slice_segment(rbsp, h, resume=True)

        # reference lists + TMVP source (inter slices)
        ref_pocs: list = [[], []]
        ref_pics: list = [[], []]
        col = None
        if h.slice_type != I_SLICE:
            ref_pocs = self._ref_lists(h)
            for lx in (0, 1):
                for p in ref_pocs[lx]:
                    assert p in self.dpb, f"reference POC {p} not in DPB"
                    ref_pics[lx].append(self.dpb[p][0])
            col_lx = 0 if h.collocated_from_l0 else 1
            if h.tmvp and ref_pocs[col_lx]:
                col = self.dpb[ref_pocs[col_lx][h.collocated_ref_idx]][1]
        no_backward = all(p <= h.poc for lst in ref_pocs for p in lst)
        mctx = motion_hm.SliceMotionCtx(
            h.poc, ref_pocs, h.slice_type == B_SLICE, h.max_merge,
            h.tmvp and col is not None, col, h.collocated_from_l0,
            no_backward)

        st = _PicState(sps, pps, h)
        st.ref_pics = ref_pics
        st.mctx = mctx
        sao_params = [[sao_ops.SaoParam()] * 3 for _ in range(cw * ch)]
        self._cur_pic = dict(st=st, sao=sao_params, h0=h, slice_idx=0,
                             ctb_slice=np.full(cw * ch, -1, np.int32))
        return self._decode_slice_segment(rbsp, h, resume=False)

    # video_codecs_tpu/models/hevc/decoder.py:872
    def _decode_slice_segment(self, rbsp: bytes, h: SliceHeader,
                              resume: bool):
        """CTB loop of one (independent) slice segment; finalizes the
        picture after its last CTB (spec 7.3.6.1 multi-slice pictures;
        TDecSlice substream handling for the single-substream case)."""
        sps, pps = self.sps, self.pps
        cp = self._cur_pic
        st = cp["st"]
        sao_params = cp["sao"]
        w, hgt = sps.width, sps.height
        ctb = 1 << sps.log2_ctb
        cw = (w + ctb - 1) // ctb
        ch = (hgt + ctb - 1) // ctb
        if resume:
            h.poc = cp["h0"].poc
            assert h.qp == cp["h0"].qp, \
                "per-slice QP differences: later round"
            cp["slice_idx"] += 1
            st.h = h
            # per-slice reference lists (headers repeat the RPS)
            ref_pocs: list = [[], []]
            ref_pics: list = [[], []]
            col = None
            if h.slice_type != I_SLICE:
                ref_pocs = self._ref_lists(h)
                for lx in (0, 1):
                    for p in ref_pocs[lx]:
                        ref_pics[lx].append(self.dpb[p][0])
                col_lx = 0 if h.collocated_from_l0 else 1
                if h.tmvp and ref_pocs[col_lx]:
                    col = self.dpb[ref_pocs[col_lx]
                                   [h.collocated_ref_idx]][1]
            no_backward = all(p <= h.poc for lst in ref_pocs
                              for p in lst)
            st.ref_pics = ref_pics
            st.mctx = motion_hm.SliceMotionCtx(
                h.poc, ref_pocs, h.slice_type == B_SLICE, h.max_merge,
                h.tmvp and col is not None, col, h.collocated_from_l0,
                no_backward)

        # availability "region" id: slice index in the high bits, tile
        # index low — one equality test covers the same-slice AND
        # same-tile requirements of spec 6.4.1 at every gating site
        # (intra refs, merge/AMVP, CABAC ctx neighbors, SAO merges)
        region0 = cp["slice_idx"] << 12
        st.z_floor = h.slice_address * (1 << (2 * (sps.log2_ctb - 2)))
        st.pm.slice4 = st.slice4

        init_type = h.slice_type
        if h.cabac_init and h.slice_type != I_SLICE:
            init_type = B_SLICE if h.slice_type == P_SLICE else P_SLICE
        base = h.data_offset_bits // 8
        # signalled entry offsets are EBSP bytes; convert to RBSP
        # positions by discounting the emulation bytes in each span
        emu = getattr(self, "_cur_emu", [])
        starts, acc = [base], 0
        for off_ in h.entry_points:
            acc += off_
            s = base + acc
            while True:
                c = sum(1 for r_ in emu if base < r_ <= s)
                s2 = base + acc - c
                if s2 == s:
                    break
                s = s2
            starts.append(s)

        def fresh_dec(k, states=None):
            return cabac.CabacDecoder(
                bs.BitReader(rbsp[starts[k]:]),
                ctx.init_states(init_type, h.qp)
                if states is None else states)

        def decode_ctu(dec, i, region):
            cx = (i % cw) * ctb
            cy = (i // cw) * ctb
            st.cur_slice = region
            st.pm.cur_slice = region
            cp["ctb_slice"][i] = region
            st.slice4[cy // 4:min(cy + ctb, hgt) // 4,
                      cx // 4:min(cx + ctb, w) // 4] = region
            if h.sao_luma or h.sao_chroma:
                self._decode_sao(dec, sao_params, i, cx // ctb,
                                 cy // ctb, cw, h,
                                 ctb_slice=cp["ctb_slice"])
            self._decode_cqt(dec, st, cx, cy, sps.log2_ctb, 0)
            return dec.decode_terminate()

        if pps.tiles:
            assert h.first_slice and h.slice_address == 0, \
                "tiles with multiple slices: unsupported"
            cols, rows = _tile_grid(pps, cw, ch)
            k = 0
            for tr in range(len(rows) - 1):
                for tc in range(len(cols) - 1):
                    dec = fresh_dec(k)
                    st.qp = st.qp_prev = h.qp   # QG chain restarts
                    for ty in range(rows[tr], rows[tr + 1]):
                        for tx in range(cols[tc], cols[tc + 1]):
                            decode_ctu(dec, ty * cw + tx, region0 | k)
                    k += 1
            i = cw * ch
        elif pps.entropy_sync:
            assert h.first_slice and h.slice_address == 0, \
                "WPP with multiple slices: unsupported"
            snap = None
            for row in range(ch):
                dec = fresh_dec(row, None if row == 0 or snap is None
                                else snap.copy())
                st.qp = st.qp_prev = h.qp   # QG chain restarts per row
                for col in range(cw):
                    decode_ctu(dec, row * cw + col, region0)
                    if col == min(1, cw - 1):
                        # context storage after the 2nd CTU of the row
                        # (spec 9.3.1 sync process)
                        snap = dec.states.copy()
            i = cw * ch
        else:
            dec = fresh_dec(0)
            i = h.slice_address
            while i < cw * ch:
                end = decode_ctu(dec, i, region0)
                i += 1
                if end:
                    break
        if i < cw * ch:
            return None                 # more slices follow
        st.pm.cur_slice = None          # whole-picture motion hereafter
        h = cp["h0"]
        rec_y, rec_u, rec_v = st.rec_y, st.rec_u, st.rec_v
        if not h.deblocking_disabled:
            bs_ver, bs_hor = _bs_maps_general(st)
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs_np(
                rec_y, rec_u, rec_v, h.qp, bs_ver, bs_hor, block=8,
                bit_depth=self.sps.bit_depth,
                qp_map=st.qp4 if pps.cu_qp_delta else None, seg4=True,
                beta_off=h.beta_offset_div2, tc_off=h.tc_offset_div2,
                cb_qp_off=pps.cb_qp_offset, cr_qp_off=pps.cr_qp_offset)
        if h.sao_luma or h.sao_chroma:
            # the reference's apply_ctu loop, with each EO class's map
            # computed once per plane instead of once per CTB
            bd = self.sps.bit_depth
            if h.sao_luma:
                rec_y = sao_ops.apply_ctus(
                    rec_y, [p3[0] for p3 in sao_params], ctb, cw, bd)
            if h.sao_chroma:
                half = ctb // 2
                rec_u = sao_ops.apply_ctus(
                    rec_u, [p3[1] for p3 in sao_params], half, cw, bd)
                rec_v = sao_ops.apply_ctus(
                    rec_v, [p3[2] for p3 in sao_params], half, cw, bd)
        frame = (rec_y, rec_u, rec_v)
        self.frames.append(frame)
        self._keys.append((self._epoch, h.poc))
        self.dpb[h.poc] = (frame, st.pm)
        if len(self.dpb) > 32:      # bound memory; RPS windows are small
            keep = getattr(self, "_lt_protect", set())
            for p in sorted(self.dpb)[:len(self.dpb) - 32]:
                if p not in keep:   # long-term pics survive the window
                    del self.dpb[p]
        return frame

    # video_codecs_tpu/models/hevc/decoder.py:1039
    def _decode_sao(self, dec, params, i, bx, by, cw, h: SliceHeader,
                    ctb_slice=None):
        """sao() syntax (spec 7.3.8.3) with per-component slice enables;
        merge flags are only present when the neighbor CTB is in the
        same slice segment (spec 7.3.8.3 leftCtbInSliceSeg)."""
        def same(j):
            return ctb_slice is None or ctb_slice[j] == ctb_slice[i]

        if bx > 0 and same(i - 1) and dec.decode_bin(ctx.off("sao_merge")):
            params[i] = list(params[i - 1])
            return
        if by > 0 and same(i - cw) and \
                dec.decode_bin(ctx.off("sao_merge")):
            params[i] = list(params[i - cw])
            return
        out = [sao_ops.SaoParam()] * 3
        for c in range(3):
            if c == 0 and not h.sao_luma:
                continue
            if c > 0 and not h.sao_chroma:
                continue
            if c < 2:
                if dec.decode_bin(ctx.off("sao_type")):
                    type_idx = (sao_ops.SAO_EO if dec.decode_bypass()
                                else sao_ops.SAO_BO)
                else:
                    type_idx = sao_ops.SAO_OFF
            else:
                type_idx = out[1].type_idx
            if type_idx == sao_ops.SAO_OFF:
                continue
            # sao_offset_abs TR cMax = (1 << (min(bd,10) - 5)) - 1
            # (spec 7.4.9.3): 7 at 8-bit, 31 at 10-bit
            cmax = (1 << (min(self.sps.bit_depth, 10) - 5)) - 1
            mags = []
            for _ in range(4):
                m = 0
                while m < cmax and dec.decode_bypass():
                    m += 1
                mags.append(m)
            if type_idx == sao_ops.SAO_BO:
                offs = []
                for k in range(4):
                    if mags[k]:
                        neg = dec.decode_bypass()
                        offs.append(-mags[k] if neg else mags[k])
                    else:
                        offs.append(0)
                pos = dec.decode_bypass_bins(5)
                out[c] = sao_ops.SaoParam(sao_ops.SAO_BO, 0, pos, tuple(offs))
            else:
                ec = (dec.decode_bypass_bins(2) if c < 2 else out[1].eo_class)
                out[c] = sao_ops.SaoParam(sao_ops.SAO_EO, ec, 0, tuple(mags))
        params[i] = out

    # ---- coding quadtree ----

    # video_codecs_tpu/models/hevc/decoder.py:1096
    def _qg_reset(self, st, x, y):
        """New quantization group (spec 7.3.8.4 / 8.6.1): reset the
        delta-coded flag and derive qPY_PRED from the left/above CUs
        (same CTB + same region) with the previous-QG fallback."""
        sps = self.sps
        ctb = 1 << sps.log2_ctb
        st.qp_prev, prev = st.qp, st.qp

        def nb(nx, ny):
            if nx < 0 or ny < 0:
                return None
            if nx // ctb != x // ctb or ny // ctb != y // ctb:
                return None             # other CTB: unavailable
            if st.slice4[ny // 4, nx // 4] != st.cur_slice:
                return None
            return int(st.qp4[ny // 4, nx // 4])

        qa = nb(x - 1, y)
        qb = nb(x, y - 1)
        st.qp = ((prev if qa is None else qa)
                 + (prev if qb is None else qb) + 1) >> 1
        st.qg_coded = False

    # video_codecs_tpu/models/hevc/decoder.py:1119
    def _maybe_qp_delta(self, dec, st, any_cbf):
        """cu_qp_delta_abs/sign at the first coded TU of the QG
        (7.3.8.10; HM TDecSbac parseDeltaQP: TU-5 + EG0 + sign)."""
        if st.qg_coded or not any_cbf:
            return
        st.qg_coded = True
        a = 0
        if dec.decode_bin(ctx.off("dqp", 0)):
            a = 1
            while a < 5 and dec.decode_bin(ctx.off("dqp", 1)):
                a += 1
        if a == 5:
            k = 0
            while dec.decode_bypass():
                k += 1
            suf = 0
            for _ in range(k):
                suf = (suf << 1) | dec.decode_bypass()
            a += (1 << k) - 1 + suf
        if a and dec.decode_bypass():
            a = -a
        bdo = 6 * (self.sps.bit_depth - 8)
        st.qp = ((st.qp + a + 52 + 2 * bdo) % (52 + bdo)) - bdo

    # video_codecs_tpu/models/hevc/decoder.py:1143
    def _decode_cqt(self, dec, st, x, y, log2, depth):
        sps = self.sps
        size = 1 << log2
        if self.pps.cu_qp_delta and \
                log2 >= sps.log2_ctb - self.pps.diff_cu_qp_delta_depth:
            self._qg_reset(st, x, y)
        if x + size <= sps.width and y + size <= sps.height:
            split = False
            if log2 > sps.log2_min_cb:
                sctx = st.split_ctx(x, y, depth)
                split = bool(dec.decode_bin(ctx.off("split_cu_flag", sctx)))
        else:
            split = True
        if split:
            half = size // 2
            for q in range(4):
                cx, cy = x + (q & 1) * half, y + (q >> 1) * half
                if cx >= sps.width or cy >= sps.height:
                    continue
                self._decode_cqt(dec, st, cx, cy, log2 - 1, depth + 1)
            return
        self._decode_cu(dec, st, x, y, log2, depth)

    # video_codecs_tpu/models/hevc/decoder.py:1166
    def _decode_cu(self, dec, st, x, y, log2, depth):
        """coding_unit (spec 7.3.8.5): skip / pred-mode dispatch."""
        h = st.h
        size = 1 << log2
        try:
            if h.slice_type != I_SLICE:
                c = st.skip_ctx_nb(x, y)
                if dec.decode_bin(ctx.off("skip_flag", c)):
                    st.set_cu(x, y, size, depth)
                    self._decode_skip_cu(dec, st, x, y, log2)
                    return
                is_intra = bool(dec.decode_bin(ctx.off("pred_mode")))
            else:
                is_intra = True
            if is_intra:
                st.pm.set_intra(x, y, size)
                self._decode_intra_cu(dec, st, x, y, log2, depth)
            else:
                st.set_cu(x, y, size, depth)
                self._decode_inter_cu(dec, st, x, y, log2, depth)
        finally:
            if self.pps.cu_qp_delta:
                # final QpY of the CU (prediction + any coded delta)
                # feeds deblock edge QPs and later QG predictions
                st.qp4[y // 4:(y + size) // 4,
                       x // 4:(x + size) // 4] = st.qp

    # ---- inter CUs ----

    # video_codecs_tpu/models/hevc/decoder.py:1195
    def _decode_skip_cu(self, dec, st, x, y, log2):
        h, sps = st.h, self.sps
        size = 1 << log2
        midx = self._parse_merge_idx(dec, h.max_merge)
        cands = motion_hm.merge_candidates_pu(
            st.pm, st.mctx, x, y, size, size, "2Nx2N", 0, sps.log2_ctb)
        self._apply_pu(st, x, y, size, size, cands[midx], skip=True)
        st.mark_pu(x, y, size, size)
        st.mark_tu4(x, y, size, size, False)

    # video_codecs_tpu/models/hevc/decoder.py:1205
    def _decode_inter_cu(self, dec, st, x, y, log2, depth):
        sps, h = self.sps, st.h
        size = 1 << log2
        part = self._parse_part_mode_inter(dec, log2)
        merge0 = False
        for pi, (ox, oy, pw, ph) in enumerate(_part_pus(part, size)):
            px, py = x + ox, y + oy
            merge = bool(dec.decode_bin(ctx.off("merge_flag")))
            if pi == 0:
                merge0 = merge
            if merge:
                midx = self._parse_merge_idx(dec, h.max_merge)
                cands = motion_hm.merge_candidates_pu(
                    st.pm, st.mctx, px, py, pw, ph, part, pi,
                    sps.log2_ctb)
                m = cands[midx]
                if pw + ph == 12 and m.pf[0] and m.pf[1]:
                    # small PUs are uni-L0 only (spec 8.5.3.2.3)
                    m = motion_hm.Motion(
                        [True, False], [m.mv[0], (0, 0)],
                        [m.ref_idx[0], -1], [m.ref_poc[0], 0])
            else:
                m = self._parse_pu_amvp(dec, st, px, py, pw, ph, depth)
            self._apply_pu(st, px, py, pw, ph, m, skip=False)
            st.mark_pu(px, py, pw, ph)
        root_cbf = True
        if not (part == "2Nx2N" and merge0):
            root_cbf = bool(dec.decode_bin(ctx.off("qt_root_cbf")))
        if not root_cbf:
            st.mark_tu4(x, y, size, size, False)
            return
        self._decode_tt_inter(dec, st, part, x, y, log2, 0, True, True)

    # video_codecs_tpu/models/hevc/decoder.py:1238
    def _parse_part_mode_inter(self, dec, log2):
        """part_mode for inter CUs (spec 9.3.3.7 binarization; TDecSbac
        parsePartSize inter branch + AMP refinement)."""
        sps = self.sps
        if dec.decode_bin(ctx.off("part_size", 0)):
            return "2Nx2N"
        at_min = log2 == sps.log2_min_cb
        hor = bool(dec.decode_bin(ctx.off("part_size", 1)))
        if at_min:
            if hor:
                return "2NxN"
            if log2 == 3:            # 8x8 CU: no NxN inter (4x4 PUs)
                return "Nx2N"
            if dec.decode_bin(ctx.off("part_size", 2)):
                return "Nx2N"
            return "NxN"
        base = "2NxN" if hor else "Nx2N"
        if sps.amp:
            if dec.decode_bin(ctx.off("amp")):
                return base
            second = dec.decode_bypass()
            if hor:
                return "2NxnD" if second else "2NxnU"
            return "nRx2N" if second else "nLx2N"
        return base

    # video_codecs_tpu/models/hevc/decoder.py:1264
    @staticmethod
    def _parse_merge_idx(dec, max_merge: int) -> int:
        """TR binarization: first bin ctx, rest bypass (TDecSbac
        parseMergeIndex)."""
        if max_merge <= 1:
            return 0
        if not dec.decode_bin(ctx.off("merge_idx")):
            return 0
        idx = 1
        while idx < max_merge - 1 and dec.decode_bypass():
            idx += 1
        return idx

    # video_codecs_tpu/models/hevc/decoder.py:1277
    @staticmethod
    def _parse_ref_idx(dec, nref: int) -> int:
        """TR: bins 0/1 ctx-coded, rest bypass (TDecSbac
        parseRefFrmIdx)."""
        if nref <= 1:
            return 0
        if not dec.decode_bin(ctx.off("ref_idx", 0)):
            return 0
        idx = 1
        for k in range(1, nref - 1):
            b = (dec.decode_bin(ctx.off("ref_idx", 1)) if k == 1
                 else dec.decode_bypass())
            if not b:
                break
            idx += 1
        return idx

    # video_codecs_tpu/models/hevc/decoder.py:1294
    @staticmethod
    def _parse_mvd(dec) -> tuple[int, int]:
        """mvd_coding (spec 7.3.8.9; TDecSbac parseMvd)."""
        from video_codecs_tpu_torch.models.hevc.inter_codec import _read_eg1
        g0 = [dec.decode_bin(ctx.off("mvd", 0)) for _ in range(2)]
        g1 = [dec.decode_bin(ctx.off("mvd", 1)) if g0[c] else 0
              for c in range(2)]
        out = []
        for c in range(2):
            v = 0
            if g0[c]:
                v = 2 + _read_eg1(dec) if g1[c] else 1
                if dec.decode_bypass():
                    v = -v
            out.append(v)
        return (out[0], out[1])

    # video_codecs_tpu/models/hevc/decoder.py:1311
    def _parse_pu_amvp(self, dec, st, px, py, pw, ph, cu_depth):
        """Explicit-MV PU: inter_pred_idc + per-list refIdx/MVD/mvp
        (spec 7.3.8.6 prediction_unit)."""
        h, sps = st.h, self.sps
        if h.slice_type == B_SLICE:
            if pw + ph != 12 and \
                    dec.decode_bin(ctx.off("inter_dir", cu_depth)):
                idc = 3
            else:
                idc = 2 if dec.decode_bin(ctx.off("inter_dir", 4)) else 1
        else:
            idc = 1
        m = motion_hm.Motion.none()
        for lx in (0, 1):
            if not (idc & (1 << lx)):
                continue
            ridx = self._parse_ref_idx(dec, h.num_ref_idx[lx])
            if lx == 1 and h.mvd_l1_zero and idc == 3:
                mvd = (0, 0)
            else:
                mvd = self._parse_mvd(dec)
            mvp = dec.decode_bin(ctx.off("mvp_idx"))
            amvp = motion_hm.amvp_candidates_pu(
                st.pm, st.mctx, px, py, pw, ph, lx, ridx, sps.log2_ctb)
            p = amvp[mvp]
            m.pf[lx] = True
            m.mv[lx] = (_wrap16(p[0] + mvd[0]), _wrap16(p[1] + mvd[1]))
            m.ref_idx[lx] = ridx
            m.ref_poc[lx] = st.mctx.ref_pocs[lx][ridx]
        return m

    # video_codecs_tpu/models/hevc/decoder.py:1342
    def _apply_pu(self, st, px, py, pw, ph, m, skip: bool):
        """Store PU motion + motion-compensate into the rec planes
        (TDecCu xReconInter; TComWeightPrediction for WP slices)."""
        h = st.h
        st.pm.set_pu(px, py, pw, ph, m)
        if skip:
            st.pm.skip[py // 4:(py + ph) // 4, px // 4:(px + pw) // 4] = True
        bd = self.sps.bit_depth
        sh2 = 14 - bd          # uni final shift (spec 8.5.3.3.3.2)
        osc = bd - 8           # WP offset scale (HM setWpScaling)
        p14 = [[None] * 3, [None] * 3]
        for lx in (0, 1):
            if not m.pf[lx]:
                continue
            ry, ru, rv = st.ref_pics[lx][m.ref_idx[lx]]
            mvx, mvy = m.mv[lx]
            p14[lx][0] = interp.mc_luma14_rect_np(ry, px, py, mvx, mvy,
                                                  pw, ph, bit_depth=bd)
            p14[lx][1] = interp.mc_chroma14_rect_np(
                ru, px // 2, py // 2, mvx, mvy, pw // 2, ph // 2,
                bit_depth=bd)
            p14[lx][2] = interp.mc_chroma14_rect_np(
                rv, px // 2, py // 2, mvx, mvy, pw // 2, ph // 2,
                bit_depth=bd)
        bi = m.pf[0] and m.pf[1]
        wp = h.wp
        for c, (plane, cx, cy, cw_, ch_) in enumerate((
                (st.rec_y, px, py, pw, ph),
                (st.rec_u, px // 2, py // 2, pw // 2, ph // 2),
                (st.rec_v, px // 2, py // 2, pw // 2, ph // 2))):
            if bi:
                if wp is not None:
                    w0, o0 = wp.weights[0][m.ref_idx[0]][c]
                    w1, o1 = wp.weights[1][m.ref_idx[1]][c]
                    denom = wp.luma_denom if c == 0 else wp.chroma_denom
                    sh = denom + sh2
                    out = (p14[0][c] * w0 + p14[1][c] * w1 +
                           (((o0 << osc) + (o1 << osc) + 1)
                            << sh)) >> (sh + 1)
                else:
                    out = (p14[0][c] + p14[1][c] +
                           (1 << sh2)) >> (sh2 + 1)
            else:
                lx = 0 if m.pf[0] else 1
                if wp is not None:
                    w_, o_ = wp.weights[lx][m.ref_idx[lx]][c]
                    denom = wp.luma_denom if c == 0 else wp.chroma_denom
                    sh = denom + sh2
                    out = ((p14[lx][c] * w_ + (1 << (sh - 1))) >> sh) \
                        + (o_ << osc)
                else:
                    out = (p14[lx][c] + (1 << (sh2 - 1))) >> sh2
            plane[cy:cy + ch_, cx:cx + cw_] = np.clip(out, 0,
                                                      (1 << bd) - 1)

    # ---- inter RQT ----

    # video_codecs_tpu/models/hevc/decoder.py:1399
    def _decode_tt_inter(self, dec, st, part, x, y, log2, trdepth,
                         parent_cbf_cb, parent_cbf_cr):
        """transform_tree for inter CUs (spec 7.3.8.8)."""
        sps = self.sps
        max_depth = sps.max_tr_depth_inter
        inter_split = (max_depth == 0 and part != "2Nx2N" and
                       trdepth == 0)
        if (log2 <= sps.log2_max_tb and log2 > sps.log2_min_tb and
                trdepth < max_depth and not inter_split):
            subdiv = bool(dec.decode_bin(ctx.off("trans_subdiv",
                                                 5 - log2)))
        else:
            subdiv = (log2 > sps.log2_max_tb) or inter_split

        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2 > 2:
            if trdepth == 0 or parent_cbf_cb:
                cbf_cb = bool(dec.decode_bin(ctx.off("cbf_chroma",
                                                     trdepth)))
            else:
                cbf_cb = False
            if trdepth == 0 or parent_cbf_cr:
                cbf_cr = bool(dec.decode_bin(ctx.off("cbf_chroma",
                                                     trdepth)))
            else:
                cbf_cr = False

        if subdiv:
            half = 1 << (log2 - 1)
            for q in range(4):
                self._decode_tt_inter(dec, st, part, x + (q & 1) * half,
                                      y + (q >> 1) * half, log2 - 1,
                                      trdepth + 1, cbf_cb, cbf_cr)
            return
        n = 1 << log2
        if trdepth == 0 and not cbf_cb and not cbf_cr:
            cbf_y = True            # inferred: rqt_root_cbf was 1
        else:
            cbf_y = bool(dec.decode_bin(
                ctx.off("cbf_luma", 1 if trdepth == 0 else 0)))
        st.mark_tu4(x, y, n, n, cbf_y)
        self._decode_tu_inter(dec, st, x, y, log2, cbf_y, cbf_cb, cbf_cr)

    # video_codecs_tpu/models/hevc/decoder.py:1442
    def _decode_tu_inter(self, dec, st, x, y, log2, cbf_y, cbf_cb,
                         cbf_cr):
        pps = self.pps
        n = 1 << log2
        if pps.cu_qp_delta:
            tu_chroma = log2 > 2 or ((x & 7) and (y & 7))
            self._maybe_qp_delta(dec, st, cbf_y or (
                tu_chroma and (cbf_cb or cbf_cr)))
        if cbf_y:
            ts = False
            if pps.transform_skip and log2 == 2:
                ts = bool(dec.decode_bin(ctx.off("transform_skip", 0)))
            lv = residual.decode_residual(dec, log2, rom.SCAN_DIAG, True,
                                          sign_hiding=pps.sign_data_hiding)
            pred = st.rec_y[y:y + n, x:x + n]
            st.rec_y[y:y + n, x:x + n] = _recon_tb(
                pred, lv, st.qp, log2, dst=False, ts=ts,
                m=self._sl_m(log2, 3), bit_depth=self.sps.bit_depth)
        if log2 > 2:
            self._decode_tu_chroma_inter(dec, st, x, y, log2 - 1,
                                         cbf_cb, cbf_cr)
        elif (x & 7) and (y & 7):   # 4th 4x4 luma TU of the 8x8 group
            self._decode_tu_chroma_inter(dec, st, x - 4, y - 4, 2,
                                         cbf_cb, cbf_cr)

    # video_codecs_tpu/models/hevc/decoder.py:1467
    def _decode_tu_chroma_inter(self, dec, st, x, y, clog2, cbf_cb,
                                cbf_cr):
        pps = self.pps
        cs = 1 << clog2
        cx, cy = x // 2, y // 2
        for comp, (cbf, plane, qp_off) in enumerate((
                (cbf_cb, st.rec_u, pps.cb_qp_offset),
                (cbf_cr, st.rec_v, pps.cr_qp_offset))):
            if not cbf:
                continue
            ts = False
            if pps.transform_skip and clog2 == 2:
                ts = bool(dec.decode_bin(ctx.off("transform_skip", 1)))
            lv = residual.decode_residual(dec, clog2, rom.SCAN_DIAG,
                                          False,
                                          sign_hiding=pps.sign_data_hiding)
            qp_c = ic.chroma_qp(st.qp + qp_off)
            pred = plane[cy:cy + cs, cx:cx + cs]
            plane[cy:cy + cs, cx:cx + cs] = _recon_tb(
                pred, lv, qp_c, clog2, dst=False, ts=ts,
                m=self._sl_m(clog2, 4 + comp),
                bit_depth=self.sps.bit_depth)

    # ---- intra CUs ----

    # video_codecs_tpu/models/hevc/decoder.py:1492
    def _decode_intra_cu(self, dec, st, x, y, log2, depth):
        sps, pps = self.sps, self.pps
        size = 1 << log2
        nxn = False
        if log2 == sps.log2_min_cb:
            nxn = dec.decode_bin(ctx.off("part_size")) == 0
        if (sps.pcm and not nxn and
                sps.log2_min_ipcm <= log2 <= sps.log2_max_ipcm and
                dec.decode_terminate()):
            self._decode_pcm_cu(dec, st, x, y, log2, depth)
            return
        # luma intra modes: all prev flags first, then all idx/rem
        pus = 4 if nxn else 1
        half = size // 2
        prev = [dec.decode_bin(ctx.off("prev_intra_luma_pred"))
                for _ in range(pus)]
        modes = []
        for p in range(pus):
            px = x + (p & 1) * (half if nxn else 0)
            py = y + (p >> 1) * (half if nxn else 0)
            mpm = st.mpm(px, py)
            if prev[p]:
                idx = 0 if dec.decode_bypass() == 0 else 1 + dec.decode_bypass()
                mode = mpm[idx]
            else:
                rem = dec.decode_bypass_bins(5)
                for c in sorted(mpm):
                    if rem >= c:
                        rem += 1
                mode = rem
            modes.append(mode)
            st.set_pu_mode(px, py, half if nxn else size, mode)
            st.mark_pu(px, py, half if nxn else size,
                       half if nxn else size)
        # chroma mode (one per CU at 4:2:0)
        if dec.decode_bin(ctx.off("chroma_pred_mode")) == 0:
            chroma_mode = modes[0]          # DM
        else:
            idx = dec.decode_bypass_bins(2)
            chroma_mode = CHROMA_CANDS[idx]
            if chroma_mode == modes[0]:
                chroma_mode = 34
        st.set_cu(x, y, size, depth)

        # transform tree + recon
        cu = _CuCtx(x, y, log2, nxn, modes, chroma_mode)
        min_tu_log2 = self._min_tu_log2(log2, nxn)
        self._decode_tt(dec, st, cu, x, y, log2, 0, min_tu_log2, True, True)

    # video_codecs_tpu/models/hevc/decoder.py:1541
    def _sl_m(self, log2: int, list_type: int):
        """Upsampled per-coefficient scaling matrix for (TB size, list
        type 0..5 = intra Y/Cb/Cr, inter Y/Cb/Cr), or None when scaling
        lists are off (HM getDequantCoeff / processScalingListDec)."""
        sps = self.sps
        if not sps.scaling_list_enabled:
            return None
        key = (log2, list_type)
        cache = getattr(self, "_sl_cache", None)
        if cache is None:
            cache = self._sl_cache = {}
        if key not in cache:
            sl = self.pps.scaling_lists or sps.scaling_lists
            size_id = log2 - 2
            mid = list_type
            if size_id == 3:
                mid = 0 if list_type < 3 else 3
            base, dc = sl[size_id][mid]
            ratio = (1 << log2) // base.shape[0]
            m = base
            if ratio > 1:
                m = np.repeat(np.repeat(base, ratio, 0), ratio, 1).copy()
                m[0, 0] = dc
            cache[key] = m
        return cache[key]


    # video_codecs_tpu/models/hevc/decoder.py:1567
    def _decode_pcm_cu(self, dec, st, x, y, log2, depth):
        """pcm_sample (spec 7.3.8.7): raw samples at the PCM bit depth,
        shifted up to the picture bit depth; the arithmetic engine
        restarts after them (TDecSbac parseIPCMInfo + TDecBinCABAC
        byte-wise positioning)."""
        sps = self.sps
        n = 1 << log2
        dec.begin_pcm()
        br = dec.br
        sh_l = 8 - sps.pcm_bd_luma
        st.rec_y[y:y + n, x:x + n] = np.array(
            [[br.read(sps.pcm_bd_luma) << sh_l for _ in range(n)]
             for _ in range(n)], np.int32)
        cx, cy, cn = x // 2, y // 2, n // 2
        sh_c = 8 - sps.pcm_bd_chroma
        for plane in (st.rec_u, st.rec_v):
            plane[cy:cy + cn, cx:cx + cn] = np.array(
                [[br.read(sps.pcm_bd_chroma) << sh_c for _ in range(cn)]
                 for _ in range(cn)], np.int32)
        dec.reinit()
        st.set_cu(x, y, n, depth)
        st.pm.set_intra(x, y, n)
        st.set_pu_mode(x, y, n, DC)        # neighbor contexts read DC
        st.mark_pu(x, y, n, n)
        st.mark_tu4(x, y, n, n, False)

    # video_codecs_tpu/models/hevc/decoder.py:1593
    def _min_tu_log2(self, log2_cb, nxn):
        sps = self.sps
        max_depth = sps.max_tr_depth_intra + 1   # SPS codes depth-1
        intra_split = 1 if nxn else 0
        if log2_cb < sps.log2_min_tb + max_depth - 1 + intra_split:
            return sps.log2_min_tb
        out = log2_cb - (max_depth - 1 + intra_split)
        return min(out, sps.log2_max_tb)

    # video_codecs_tpu/models/hevc/decoder.py:1602
    def _decode_tt(self, dec, st, cu, x, y, log2, trdepth, min_tu_log2,
                   parent_cbf_cb, parent_cbf_cr):
        """transform_tree (spec 7.3.8.8; TDecEntropy xDecodeTransform)."""
        sps, pps = self.sps, self.pps
        if cu.nxn and trdepth == 0:
            subdiv = True
        elif log2 > sps.log2_max_tb:
            subdiv = True
        elif log2 == sps.log2_min_tb or log2 == min_tu_log2:
            subdiv = False
        else:
            subdiv = bool(dec.decode_bin(ctx.off("trans_subdiv", 5 - log2)))

        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2 > 2:
            if trdepth == 0 or parent_cbf_cb:
                cbf_cb = bool(dec.decode_bin(ctx.off("cbf_chroma", trdepth)))
            else:
                cbf_cb = False
            if trdepth == 0 or parent_cbf_cr:
                cbf_cr = bool(dec.decode_bin(ctx.off("cbf_chroma", trdepth)))
            else:
                cbf_cr = False

        if subdiv:
            half = 1 << (log2 - 1)
            for q in range(4):
                self._decode_tt(dec, st, cu, x + (q & 1) * half,
                                y + (q >> 1) * half, log2 - 1, trdepth + 1,
                                min_tu_log2, cbf_cb, cbf_cr)
                if log2 - 1 == 2 and q == 3:
                    pass  # chroma coded with last child below
            return

        # leaf TU
        cbf_y = bool(dec.decode_bin(
            ctx.off("cbf_luma", 1 if trdepth == 0 else 0)))
        st.mark_tu4(x, y, 1 << log2, 1 << log2, cbf_y)
        self._decode_tu(dec, st, cu, x, y, log2, cbf_y, cbf_cb, cbf_cr)

    # video_codecs_tpu/models/hevc/decoder.py:1642
    def _decode_tu(self, dec, st, cu, x, y, log2, cbf_y, cbf_cb, cbf_cr):
        """transform_unit: residuals + reconstruction, TU decode order."""
        sps, pps = self.sps, self.pps
        n = 1 << log2
        # luma
        mode = cu.mode_at(x, y)
        lv = None
        ts = False
        if pps.cu_qp_delta:
            tu_chroma = log2 > 2 or ((x & 7) and (y & 7))
            self._maybe_qp_delta(dec, st, cbf_y or (
                tu_chroma and (cbf_cb or cbf_cr)))
        if cbf_y:
            if pps.transform_skip and log2 == 2:
                ts = bool(dec.decode_bin(ctx.off("transform_skip", 0)))
            stype = rom.intra_scan_type(log2, mode, True)
            lv = residual.decode_residual(dec, log2, stype, True,
                                          sign_hiding=pps.sign_data_hiding)
        ref = build_ref_z(st.rec_y, x, y, n, sps.width, sps.height,
                          sps.log2_ctb, z_floor=st.z_floor,
                          default=1 << (sps.bit_depth - 1),
                          region4=st.slice4, cur_region=st.cur_slice)
        pred = predict_intra_general(ref, mode, log2, True,
                                     sps.strong_intra_smoothing,
                                     bit_depth=sps.bit_depth)
        st.rec_y[y:y + n, x:x + n] = _recon_tb(
            pred, lv, st.qp, log2, dst=(log2 == 2), ts=ts,
            m=self._sl_m(log2, 0), bit_depth=sps.bit_depth)

        # chroma: at this node when log2 > 2; when log2 == 2, with the
        # fourth 4x4 luma TU of the enclosing 8x8 area (spec 7.3.8.10)
        if log2 > 2:
            self._decode_tu_chroma(dec, st, cu, x, y, log2 - 1,
                                   cbf_cb, cbf_cr)
        elif (x & 7) and (y & 7):       # blkIdx == 3 of the 8x8 group
            self._decode_tu_chroma(dec, st, cu, x - 4, y - 4, 2,
                                   cbf_cb, cbf_cr)

    # video_codecs_tpu/models/hevc/decoder.py:1680
    def _decode_tu_chroma(self, dec, st, cu, x, y, clog2, cbf_cb, cbf_cr):
        sps, pps = self.sps, self.pps
        cs = 1 << clog2
        cx, cy = x // 2, y // 2
        cmode = cu.chroma_mode
        stype = rom.intra_scan_type(clog2, cmode, False)
        for comp, (cbf, plane, qp_off) in enumerate((
                (cbf_cb, st.rec_u, pps.cb_qp_offset),
                (cbf_cr, st.rec_v, pps.cr_qp_offset))):
            lv = None
            ts = False
            if cbf:
                if pps.transform_skip and clog2 == 2:
                    ts = bool(dec.decode_bin(ctx.off("transform_skip", 1)))
                lv = residual.decode_residual(
                    dec, clog2, stype, False,
                    sign_hiding=pps.sign_data_hiding)
            refc = build_ref_z(plane, cx, cy, cs, sps.width // 2,
                               sps.height // 2, sps.log2_ctb - 1,
                               z_floor=st.z_floor >> 2,
                               default=1 << (sps.bit_depth - 1),
                               region4=st.slice4,
                               cur_region=st.cur_slice, region_scale=2)
            predc = intra_ops.predict_intra_np(refc, cmode, clog2,
                                               is_luma=False,
                                               bit_depth=sps.bit_depth)
            qp_c = ic.chroma_qp(st.qp + qp_off)
            plane[cy:cy + cs, cx:cx + cs] = _recon_tb(
                predc, lv, qp_c, clog2, dst=False, ts=ts,
                m=self._sl_m(clog2, 1 + comp),
                bit_depth=sps.bit_depth)


# video_codecs_tpu/models/hevc/decoder.py:1713
def _recon_tb(pred, lv, qp, log2, dst, ts=False, m=None, bit_depth=8):
    """Dequant + inverse transform + add.  m: per-coefficient scaling
    matrix (spec 8.6.3 with scaling lists; HM TComTrQuant::xDeQuant
    enableScalingLists branch, rightShift += LOG2_SCALING_LIST_NEUTRAL
    and dequantCoeff = invQuantScales * m).  Scaling lists never apply
    to transform-skip blocks (HM getUseScalingList)."""
    if lv is None:
        return pred.astype(np.int32)
    # scaling uses the DERIVED QP: Qp' = Qp + QpBdOffset = Qp + 6*(bd-8)
    # (spec 8.6.1; zero at 8-bit).  Deblocking keeps the unoffset QpY.
    qp = qp + 6 * (bit_depth - 8)
    if m is not None:
        per, rem = qp // 6, qp % 6
        right = rom.IQUANT_SHIFT - \
            (quant_ops.transform_shift(log2, bit_depth) + per) + 4
        scale = int(rom.INV_QUANT_SCALES[rem])
        lim = 1 << rom.MAX_TR_DYNAMIC_RANGE
        q = np.clip(lv.astype(np.int64), -32768, 32767)
        dqc = q * (scale * m.astype(np.int64))
        if right > 0:
            c = (dqc + (1 << (right - 1))) >> right
        else:
            c = dqc << (-right)
        dq = np.clip(c, -lim, lim - 1).astype(np.int32)
    else:
        dq = quant_ops.dequantize_np(lv, qp, log2, bit_depth=bit_depth)
    if ts:
        shift = quant_ops.transform_shift(log2, bit_depth)
        r = (dq + (1 << (shift - 1))) >> shift
    else:
        r = tr_ops.inverse_transform_np(dq, log2, bit_depth=bit_depth,
                                        dst=dst)
    return np.clip(pred + r, 0, (1 << bit_depth) - 1).astype(np.int32)


# video_codecs_tpu/models/hevc/decoder.py:1748
class _CuCtx:
    # video_codecs_tpu/models/hevc/decoder.py:1749
    def __init__(self, x, y, log2, nxn, modes, chroma_mode):
        self.x, self.y, self.log2, self.nxn = x, y, log2, nxn
        self.modes = modes
        self.chroma_mode = chroma_mode

    # video_codecs_tpu/models/hevc/decoder.py:1754
    def mode_at(self, x, y):
        if not self.nxn:
            return self.modes[0]
        half = 1 << (self.log2 - 1)
        p = (1 if (x - self.x) >= half else 0) + \
            (2 if (y - self.y) >= half else 0)
        return self.modes[p]


# video_codecs_tpu/models/hevc/decoder.py:1763
def _part_pus(part: str, s: int) -> list[tuple[int, int, int, int]]:
    """PU offsets + sizes per partition mode (spec 6.4; decode order)."""
    h, q = s // 2, s // 4
    return {
        "2Nx2N": [(0, 0, s, s)],
        "2NxN": [(0, 0, s, h), (0, h, s, h)],
        "Nx2N": [(0, 0, h, s), (h, 0, h, s)],
        "NxN": [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)],
        "2NxnU": [(0, 0, s, q), (0, q, s, s - q)],
        "2NxnD": [(0, 0, s, s - q), (0, s - q, s, q)],
        "nLx2N": [(0, 0, q, s), (q, 0, s - q, s)],
        "nRx2N": [(0, 0, s - q, s), (s - q, 0, q, s)],
    }[part]


# video_codecs_tpu/models/hevc/decoder.py:1778
class _PicState:
    """Recon planes + neighbor grids + 4x4 PU/TU/motion maps for
    deblocking and candidate derivation."""

    # video_codecs_tpu/models/hevc/decoder.py:1782
    def __init__(self, sps: Sps, pps: Pps, h: SliceHeader):
        w, hgt = sps.width, sps.height
        self.sps = sps
        self.h = h
        self.qp = h.qp
        # cu_qp_delta state: per-4x4 final luma QP (deblock edge QPs +
        # spatial QP prediction), previous-QG QP, per-QG coded flag
        self.qp4 = np.full((hgt // 4, w // 4), h.qp, np.int32)
        self.qp_prev = h.qp
        self.qg_coded = True      # no delta expected unless enabled
        self.rec_y = np.zeros((hgt, w), np.int32)
        self.rec_u = np.zeros((hgt // 2, w // 2), np.int32)
        self.rec_v = np.zeros((hgt // 2, w // 2), np.int32)
        self.mode = np.full((hgt // 4, w // 4), DC, np.int32)
        self.intra = np.zeros((hgt // 4, w // 4), bool)
        self.depth = np.zeros((hgt // 8, w // 8), np.int32)
        self.pm = motion_hm.PicMotion(w, hgt, h.poc)
        self.pu_id = np.full((hgt // 4, w // 4), -1, np.int64)
        self.tu_id4 = np.full((hgt // 4, w // 4), -1, np.int64)
        self.cbf4 = np.zeros((hgt // 4, w // 4), bool)
        self.ref_pics: list = [[], []]
        self.mctx = None
        self._serial = 0
        self._pu_serial = 0
        self._tu_serial = 0
        # multi-slice: per-4x4 slice index, the active slice, and the
        # Z-scan floor of the active slice segment (spec 6.4.1)
        # -1 = not yet decoded: region ids start at 0, and tile 0 of
        # slice 0 must not alias with undecoded area (tile scan order
        # decodes the picture out of raster order)
        self.slice4 = np.full((hgt // 4, w // 4), -1, np.int32)
        self.cur_slice = 0
        self.z_floor = 0

    # video_codecs_tpu/models/hevc/decoder.py:1816
    def same_slice(self, sx, sy):
        return self.slice4[sy // 4, sx // 4] == self.cur_slice

    # video_codecs_tpu/models/hevc/decoder.py:1819
    def mark_pu(self, x, y, w, h):
        self._pu_serial += 1
        self.pu_id[y // 4:(y + h) // 4, x // 4:(x + w) // 4] = \
            self._pu_serial

    # video_codecs_tpu/models/hevc/decoder.py:1824
    def mark_tu4(self, x, y, w, h, cbf_y):
        self._tu_serial += 1
        sy, sx = y // 4, x // 4
        self.tu_id4[sy:(y + h) // 4, sx:(x + w) // 4] = self._tu_serial
        self.cbf4[sy:(y + h) // 4, sx:(x + w) // 4] = cbf_y

    # video_codecs_tpu/models/hevc/decoder.py:1830
    def skip_ctx_nb(self, x, y):
        """cu_skip_flag ctx from left/above CU skip flags (spec
        9.3.4.2.2)."""
        c = 0
        gx, gy = x // 4, y // 4
        if x > 0 and self.pm.decoded[gy, gx - 1] and \
                self.same_slice(x - 4, y) and self.pm.skip[gy, gx - 1]:
            c += 1
        if y > 0 and self.pm.decoded[gy - 1, gx] and \
                self.same_slice(x, y - 4) and self.pm.skip[gy - 1, gx]:
            c += 1
        return c

    # video_codecs_tpu/models/hevc/decoder.py:1843
    def mpm(self, x, y):
        sps = self.sps
        w, hgt = sps.width, sps.height
        cur = z_index(x, y, w, sps.log2_ctb)

        def mode_at(sx, sy, clamp_ctb):
            if sx < 0 or sy < 0 or sx >= w or sy >= hgt:
                return DC
            if clamp_ctb and (sy >> sps.log2_ctb) != (y >> sps.log2_ctb):
                return DC
            if z_index(sx, sy, w, sps.log2_ctb) >= cur:
                return DC
            if not self.same_slice(sx, sy):
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

    # video_codecs_tpu/models/hevc/decoder.py:1874
    def split_ctx(self, x, y, depth):
        c = 0
        if x > 0 and self.same_slice(x - 8, y) and \
                self.depth[y // 8, (x - 1) // 8] > depth:
            c += 1
        if y > 0 and self.same_slice(x, y - 8) and \
                self.depth[(y - 1) // 8, x // 8] > depth:
            c += 1
        return c

    # video_codecs_tpu/models/hevc/decoder.py:1884
    def set_pu_mode(self, x, y, size, mode):
        gx, gy, s4 = x // 4, y // 4, size // 4
        self.mode[gy:gy + s4, gx:gx + s4] = mode
        self.intra[gy:gy + s4, gx:gx + s4] = True

    # video_codecs_tpu/models/hevc/decoder.py:1889
    def set_cu(self, x, y, size, depth):
        dx, dy = x // 8, y // 8
        s8 = max(size // 8, 1)
        self.depth[dy:dy + s8, dx:dx + s8] = depth


# video_codecs_tpu/models/hevc/decoder.py:1895
def _bs_maps_general(st: _PicState):
    """Boundary strengths at 4-sample segments on the 8-grid (spec
    8.7.2.4; TComLoopFilter xGetBoundaryStrength): 2 across intra,
    1 on coded-TU edges or motion discontinuities, 0 elsewhere.

    Returns bs_ver [W/8-1, H/4] and bs_hor [H/8-1, W/4]."""
    pm = st.pm
    h4, w4 = pm.intra.shape

    def compute(pi, qi):
        intra2 = pm.intra[pi] | pm.intra[qi]
        tu_edge = st.tu_id4[pi] != st.tu_id4[qi]
        pu_edge = st.pu_id[pi] != st.pu_id[qi]
        edge = tu_edge | pu_edge
        cbf1 = tu_edge & (st.cbf4[pi] | st.cbf4[qi])

        pf_p0, pf_p1 = pm.pf[0][pi], pm.pf[1][pi]
        pf_q0, pf_q1 = pm.pf[0][qi], pm.pf[1][qi]
        cnt_p = pf_p0.astype(np.int32) + pf_p1
        cnt_q = pf_q0.astype(np.int32) + pf_q1
        cnt_diff = cnt_p != cnt_q

        def mvdiff(a, b):
            return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
                   (np.abs(a[..., 1] - b[..., 1]) >= 4)

        mvp0, mvp1 = pm.mv[0][pi], pm.mv[1][pi]
        mvq0, mvq1 = pm.mv[0][qi], pm.mv[1][qi]
        rp0, rp1 = pm.ref_poc[0][pi], pm.ref_poc[1][pi]
        rq0, rq1 = pm.ref_poc[0][qi], pm.ref_poc[1][qi]

        # uni vs uni: the single used hypothesis of each side
        mvp_u = np.where(pf_p0[..., None], mvp0, mvp1)
        mvq_u = np.where(pf_q0[..., None], mvq0, mvq1)
        rp_u = np.where(pf_p0, rp0, rp1)
        rq_u = np.where(pf_q0, rq0, rq1)
        uni_mis = (rp_u != rq_u) | mvdiff(mvp_u, mvq_u)

        # bi vs bi: same reference pair (in either order) required; when
        # both refs are the same picture, both pairings must pass
        straight = mvdiff(mvp0, mvq0) | mvdiff(mvp1, mvq1)
        cross = mvdiff(mvp0, mvq1) | mvdiff(mvp1, mvq0)
        refs_same = ((rp0 == rq0) & (rp1 == rq1)) | \
                    ((rp0 == rq1) & (rp1 == rq0))
        bi_mis = np.where(~refs_same, True,
                          np.where(rp0 == rp1, straight & cross,
                                   np.where(rp0 == rq0, straight, cross)))
        both_uni = (cnt_p == 1) & (cnt_q == 1)
        both_bi = (cnt_p == 2) & (cnt_q == 2)
        mv_mis = cnt_diff | (both_uni & uni_mis) | (both_bi & bi_mis)

        one = cbf1 | mv_mis
        return np.where(~edge, 0,
                        np.where(intra2, 2,
                                 np.where(one, 1, 0))).astype(np.int32)

    bs_ver = compute((slice(None), slice(1, w4 - 1, 2)),
                     (slice(None), slice(2, w4, 2))).T
    bs_hor = compute((slice(1, h4 - 1, 2), slice(None)),
                     (slice(2, h4, 2), slice(None)))
    return bs_ver, bs_hor


# Backwards-compatible name: the general decoder subsumes the round-2
# intra-only decoder
GeneralIntraDecoder = GeneralDecoder
