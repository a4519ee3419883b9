"""HEVC parameter set and slice-header syntax (write + parse).

The port's copy of video_codecs_tpu/models/hevc/headers.py, whole and as
it is; each function keeps its name and a comment gives the original's
line.

Parity references: hm-16.5rc1/source/Lib/TLibEncoder/TEncCavlc.cpp
(codeVPS/codeSPS/codePPS/codeSliceHeader), TLibDecoder/TDecCAVLC.cpp
(parse side), spec 7.3.2-7.3.6.

Only the toolset of the current encoder build is emitted (4:2:0 8-bit,
no SAO/deblock/scaling lists/PCM/AMP yet); parsers accept the same space
and assert on tools we do not support yet, so unsupported golden streams
fail loudly instead of decoding garbage.
"""

from __future__ import annotations

import dataclasses

from video_codecs_tpu_torch.entropy.bitstream import BitReader, BitWriter


# video_codecs_tpu/models/hevc/headers.py:20
@dataclasses.dataclass
class HevcConfig:
    """Static coding configuration (the SPS/PPS content we emit)."""
    width: int = 416
    height: int = 240
    qp: int = 32
    bit_depth: int = 8
    #: emit a decoded-picture-hash SEI after every picture (conformance
    #: checking; OFF for rate measurements - HM only writes it when
    #: SEIDecodedPictureHash is requested)
    hash_sei: bool = True
    log2_ctb: int = 4          # 16x16 CTBs (CU == CTB in the current build)
    log2_min_cb: int = 4
    log2_min_tb: int = 2
    log2_max_tb: int = 4
    level_idc: int = 123       # level 4.1
    deblocking_disabled: bool = False
    sign_data_hiding: bool = False
    tile_columns: int = 1      # uniform tile columns (1 = no tiles)
    sao: bool = False
    rdoq: bool | str = False   # False | "lite" | "full" (encoder-only)
    reorder_pics: int = 0      # DPB reorder depth (1 for hierarchical B)
    wpp: bool = False          # entropy_coding_sync (WPP substreams)
    weighted_pred: bool = False  # explicit WP for P slices (TComWeightPrediction)
    num_refs: int = 1          # active L0 references (P slices)
    cu_qp_delta: bool = False  # CTU-level QP (rate control dQP signalling)
    merge_cands: int = 1       # MaxNumMergeCand (1..5)
    temporal_mvp: bool = False  # sps/slice temporal MVP (TMVP candidate)
    tt_depth_inter: int = 0    # max_transform_hierarchy_depth_inter
    #: P slices reference the IDR as a long-term picture (spec 7.4.3.2
    #: long_term_ref_pics_present; TComSlice long-term RPS machinery)
    long_term_idr: bool = False
    #: write VUI timing + NAL HRD params and emit buffering-period /
    #: pic-timing SEI (TEncGOP xCreateBufferingPeriodSEI / PictureTiming)
    timing_sei: bool = False
    frame_rate: float = 30.0
    hrd_bitrate_bps: int = 1_000_000   # NAL HRD BitRate[0]
    hrd_cpb_bits: int = 2_000_000      # NAL HRD CpbSize[0]

    # video_codecs_tpu/models/hevc/headers.py:59
    @property
    def tiles_enabled(self) -> bool:
        return self.tile_columns > 1

    # video_codecs_tpu/models/hevc/headers.py:63
    def tile_col_bounds(self) -> list[tuple[int, int]]:
        """[(first_ctb_x, last_ctb_x+1)] per tile column, uniform spacing
        (TComPicSym tile maps; spec 6.5.1 uniform_spacing rule)."""
        n, cols = self.tile_columns, self.ctbs_x
        edges = [(i * cols) // n for i in range(n + 1)]
        return [(edges[i], edges[i + 1]) for i in range(n)]

    # video_codecs_tpu/models/hevc/headers.py:70
    @property
    def ctbs_x(self) -> int:
        return (self.width + (1 << self.log2_ctb) - 1) >> self.log2_ctb

    # video_codecs_tpu/models/hevc/headers.py:74
    @property
    def ctbs_y(self) -> int:
        return (self.height + (1 << self.log2_ctb) - 1) >> self.log2_ctb


# video_codecs_tpu/models/hevc/headers.py:79
def _profile_tier_level(w: BitWriter, cfg: HevcConfig) -> None:
    w.write(0, 2)   # general_profile_space
    w.flag(0)       # general_tier_flag
    w.write(1, 5)   # general_profile_idc = Main
    for i in range(32):
        w.flag(1 if i in (1, 2) else 0)  # compatibility: Main + Main10
    w.flag(1)       # general_progressive_source_flag
    w.flag(0)       # general_interlaced_source_flag
    w.flag(0)       # general_non_packed_constraint_flag
    w.flag(1)       # general_frame_only_constraint_flag
    w.write(0, 32)  # reserved 44 bits
    w.write(0, 12)
    w.write(cfg.level_idc, 8)


# video_codecs_tpu/models/hevc/headers.py:94
def _parse_profile_tier_level(r: BitReader) -> int:
    r.read(2 + 1)
    profile_idc = r.read(5)
    r.read(32)
    r.read(4)
    r.read(32)
    r.read(12)
    return r.read(8)  # level_idc; profile flags ignored


# video_codecs_tpu/models/hevc/headers.py:104
def write_vps(cfg: HevcConfig) -> bytes:
    w = BitWriter()
    w.write(0, 4)   # vps_video_parameter_set_id
    w.write(3, 2)   # base_layer_internal/available (reserved_three_2bits)
    w.write(0, 6)   # vps_max_layers_minus1
    w.write(0, 3)   # vps_max_sub_layers_minus1
    w.flag(1)       # vps_temporal_id_nesting_flag
    w.write(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    _profile_tier_level(w, cfg)
    w.flag(1)       # vps_sub_layer_ordering_info_present_flag
    w.ue(2 + cfg.reorder_pics)  # vps_max_dec_pic_buffering_minus1
    w.ue(cfg.reorder_pics)      # vps_max_num_reorder_pics
    w.ue(0)         # vps_max_latency_increase_plus1
    w.write(0, 6)   # vps_max_layer_id
    w.ue(0)         # vps_num_layer_sets_minus1
    w.flag(0)       # vps_timing_info_present_flag
    w.flag(0)       # vps_extension_flag
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/hevc/headers.py:125
def write_sps(cfg: HevcConfig) -> bytes:
    w = BitWriter()
    w.write(0, 4)   # sps_video_parameter_set_id
    w.write(0, 3)   # sps_max_sub_layers_minus1
    w.flag(1)       # sps_temporal_id_nesting_flag
    _profile_tier_level(w, cfg)
    w.ue(0)         # sps_seq_parameter_set_id
    w.ue(1)         # chroma_format_idc = 4:2:0
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.flag(0)       # conformance_window_flag (dims are multiples of min CB)
    w.ue(cfg.bit_depth - 8)
    w.ue(cfg.bit_depth - 8)
    w.ue(4)         # log2_max_pic_order_cnt_lsb_minus4 -> 8-bit POC lsb
    w.flag(1)       # sps_sub_layer_ordering_info_present_flag
    w.ue(max(2, cfg.num_refs) + cfg.reorder_pics)  # sps_max_dec_pic_buffering_minus1
    w.ue(cfg.reorder_pics)      # sps_max_num_reorder_pics
    w.ue(0)         # sps_max_latency_increase_plus1
    w.ue(cfg.log2_min_cb - 3)
    w.ue(cfg.log2_ctb - cfg.log2_min_cb)
    w.ue(cfg.log2_min_tb - 2)
    w.ue(cfg.log2_max_tb - cfg.log2_min_tb)
    w.ue(cfg.tt_depth_inter)  # max_transform_hierarchy_depth_inter
    w.ue(0)         # max_transform_hierarchy_depth_intra
    w.flag(0)       # scaling_list_enabled_flag
    w.flag(0)       # amp_enabled_flag
    w.flag(1 if cfg.sao else 0)  # sample_adaptive_offset_enabled_flag
    w.flag(0)       # pcm_enabled_flag
    w.ue(0)         # num_short_term_ref_pic_sets
    w.flag(1 if cfg.long_term_idr else 0)  # long_term_ref_pics_present_flag
    if cfg.long_term_idr:
        w.ue(0)     # num_long_term_ref_pics_sps (slice-signalled lt pics)
    w.flag(1 if cfg.temporal_mvp else 0)  # sps_temporal_mvp_enabled_flag
    w.flag(0)       # strong_intra_smoothing_enabled_flag
    w.flag(1 if cfg.timing_sei else 0)  # vui_parameters_present_flag
    if cfg.timing_sei:
        _write_vui(w, cfg)
    w.flag(0)       # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/hevc/headers.py:167
def _write_vui(w: BitWriter, cfg: HevcConfig) -> None:
    """VUI with timing info + single-CPB NAL HRD (spec E.2.1/E.2.2;
    TEncCavlc codeVUI/codeHrdParameters).  24-bit HRD delay lengths to
    match the sei.BufferingPeriod / PictureTiming writers."""
    w.flag(0)       # aspect_ratio_info_present_flag
    w.flag(0)       # overscan_info_present_flag
    w.flag(0)       # video_signal_type_present_flag
    w.flag(0)       # chroma_loc_info_present_flag
    w.flag(0)       # neutral_chroma_indication_flag
    w.flag(0)       # field_seq_flag
    w.flag(1)       # frame_field_info_present_flag (pic_struct in PT SEI)
    w.flag(0)       # default_display_window_flag
    w.flag(1)       # vui_timing_info_present_flag
    w.write(1000, 32)                          # vui_num_units_in_tick
    w.write(int(round(cfg.frame_rate * 1000)), 32)  # vui_time_scale
    w.flag(0)       # vui_poc_proportional_to_timing_flag
    w.flag(1)       # vui_hrd_parameters_present_flag
    # hrd_parameters(1, 0): NAL HRD only, no sub-pic CPB, one CPB
    w.flag(1)       # nal_hrd_parameters_present_flag
    w.flag(0)       # vcl_hrd_parameters_present_flag
    w.flag(0)       # sub_pic_hrd_params_present_flag
    w.write(0, 4)   # bit_rate_scale (BitRate units of 2^6)
    w.write(0, 4)   # cpb_size_scale (CpbSize units of 2^4)
    w.write(23, 5)  # initial_cpb_removal_delay_length_minus1 -> 24 bits
    w.write(23, 5)  # au_cpb_removal_delay_length_minus1 -> 24 bits
    w.write(23, 5)  # dpb_output_delay_length_minus1 -> 24 bits
    # sub-layer 0
    w.flag(1)       # fixed_pic_rate_general_flag
    w.ue(0)         # elemental_duration_in_tc_minus1
    w.ue(0)         # cpb_cnt_minus1
    w.ue(max(0, (cfg.hrd_bitrate_bps >> 6) - 1))  # bit_rate_value_minus1
    w.ue(max(0, (cfg.hrd_cpb_bits >> 4) - 1))     # cpb_size_value_minus1
    w.flag(0)       # cbr_flag
    w.flag(0)       # bitstream_restriction_flag


# video_codecs_tpu/models/hevc/headers.py:203
def parse_sps(rbsp: bytes) -> HevcConfig:
    r = BitReader(rbsp)
    r.read(4)
    assert r.read(3) == 0, "multi-sublayer streams unsupported"
    r.flag()
    _parse_profile_tier_level(r)
    assert r.ue() == 0
    assert r.ue() == 1, "only 4:2:0 supported"
    width, height = r.ue(), r.ue()
    if r.flag():  # conformance window
        r.ue(), r.ue(), r.ue(), r.ue()
    bd_l, bd_c = r.ue() + 8, r.ue() + 8
    assert bd_l == 8 and bd_c == 8, "only 8-bit supported"
    r.ue()  # log2_max_poc_lsb_minus4
    if r.flag():
        r.ue(), r.ue(), r.ue()
    log2_min_cb = r.ue() + 3
    log2_ctb = log2_min_cb + r.ue()
    log2_min_tb = r.ue() + 2
    log2_max_tb = log2_min_tb + r.ue()
    depth_inter = r.ue()
    depth_intra = r.ue()
    assert depth_intra == 0, "TU quadtree depth > 0 not yet supported"
    assert not r.flag(), "scaling lists unsupported"
    r.flag()  # amp (inter only; irrelevant for now)
    sao = bool(r.flag())
    assert not r.flag(), "PCM unsupported"
    assert r.ue() == 0, "RPS unsupported (all-intra build)"
    lt_present = bool(r.flag())     # long_term_ref_pics_present
    if lt_present:
        assert r.ue() == 0, "SPS-signalled long-term pics unsupported"
    tmvp = bool(r.flag())  # temporal mvp
    assert not r.flag(), "strong intra smoothing unsupported"
    # ignore VUI/extensions
    return HevcConfig(width=width, height=height, log2_ctb=log2_ctb,
                      log2_min_cb=log2_min_cb, log2_min_tb=log2_min_tb,
                      log2_max_tb=log2_max_tb, sao=sao, temporal_mvp=tmvp,
                      tt_depth_inter=depth_inter, long_term_idr=lt_present)


# video_codecs_tpu/models/hevc/headers.py:243
def write_pps(cfg: HevcConfig) -> bytes:
    w = BitWriter()
    w.ue(0)         # pps_pic_parameter_set_id
    w.ue(0)         # pps_seq_parameter_set_id
    w.flag(0)       # dependent_slice_segments_enabled_flag
    w.flag(0)       # output_flag_present_flag
    w.write(0, 3)   # num_extra_slice_header_bits
    w.flag(1 if cfg.sign_data_hiding else 0)
    w.flag(0)       # cabac_init_present_flag
    w.ue(0)         # num_ref_idx_l0_default_active_minus1
    w.ue(0)         # num_ref_idx_l1_default_active_minus1
    w.se(0)         # init_qp_minus26
    w.flag(0)       # constrained_intra_pred_flag
    w.flag(0)       # transform_skip_enabled_flag
    w.flag(1 if cfg.cu_qp_delta else 0)  # cu_qp_delta_enabled_flag
    if cfg.cu_qp_delta:
        w.ue(0)     # diff_cu_qp_delta_depth (QG = CTB)
    w.se(0)         # pps_cb_qp_offset
    w.se(0)         # pps_cr_qp_offset
    w.flag(0)       # pps_slice_chroma_qp_offsets_present_flag
    w.flag(1 if cfg.weighted_pred else 0)  # weighted_pred_flag
    w.flag(0)       # weighted_bipred_flag
    w.flag(0)       # transquant_bypass_enabled_flag
    w.flag(1 if cfg.tiles_enabled else 0)  # tiles_enabled_flag
    w.flag(1 if cfg.wpp else 0)  # entropy_coding_sync_enabled_flag
    if cfg.tiles_enabled:
        w.ue(cfg.tile_columns - 1)  # num_tile_columns_minus1
        w.ue(0)                     # num_tile_rows_minus1
        w.flag(1)                   # uniform_spacing_flag
        w.flag(1)                   # loop_filter_across_tiles_enabled_flag
    w.flag(1)       # pps_loop_filter_across_slices_enabled_flag
    w.flag(1)       # deblocking_filter_control_present_flag
    w.flag(0)       # deblocking_filter_override_enabled_flag
    w.flag(1 if cfg.deblocking_disabled else 0)  # pps_deblocking_filter_disabled_flag
    if not cfg.deblocking_disabled:
        w.se(0)     # pps_beta_offset_div2
        w.se(0)     # pps_tc_offset_div2
    w.flag(0)       # pps_scaling_list_data_present_flag
    w.flag(0)       # lists_modification_present_flag
    w.ue(0)         # log2_parallel_merge_level_minus2
    w.flag(0)       # slice_segment_header_extension_present_flag
    w.flag(0)       # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return w.data()


# video_codecs_tpu/models/hevc/headers.py:289
@dataclasses.dataclass
class PpsInfo:
    sign_data_hiding: bool = False
    init_qp: int = 26
    deblocking_disabled: bool = False
    tile_columns: int = 1
    wpp: bool = False
    weighted_pred: bool = False
    cu_qp_delta: bool = False


# video_codecs_tpu/models/hevc/headers.py:300
def parse_pps(rbsp: bytes) -> PpsInfo:
    r = BitReader(rbsp)
    assert r.ue() == 0 and r.ue() == 0
    assert not r.flag(), "dependent slices unsupported"
    assert not r.flag()
    assert r.read(3) == 0
    sdh = bool(r.flag())
    assert not r.flag(), "cabac_init unsupported"
    r.ue(), r.ue()
    init_qp = 26 + r.se()
    assert not r.flag(), "constrained intra pred unsupported"
    assert not r.flag(), "transform skip unsupported"
    cu_dqp = bool(r.flag())
    if cu_dqp:
        assert r.ue() == 0, "QG below CTB depth unsupported"
    assert r.se() == 0 and r.se() == 0, "chroma QP offsets unsupported"
    assert not r.flag()
    wp = bool(r.flag())        # weighted_pred_flag
    assert not r.flag(), "weighted bipred unsupported"
    assert not r.flag(), "transquant bypass unsupported"
    tiles_on = bool(r.flag())  # tiles_enabled_flag
    wpp = bool(r.flag())       # entropy_coding_sync_enabled_flag
    tile_columns = 1
    if tiles_on:
        tile_columns = r.ue() + 1
        assert r.ue() == 0, "tile rows unsupported"
        assert r.flag() == 1, "non-uniform tiles unsupported"
        r.flag()  # loop_filter_across_tiles
    r.flag()
    dbf_disabled = True
    if r.flag():  # deblocking_filter_control_present
        assert not r.flag(), "deblocking override unsupported"
        dbf_disabled = bool(r.flag())
        if not dbf_disabled:
            r.se(), r.se()
    return PpsInfo(sign_data_hiding=sdh, init_qp=init_qp,
                   deblocking_disabled=dbf_disabled,
                   tile_columns=tile_columns, wpp=wpp, weighted_pred=wp,
                   cu_qp_delta=cu_dqp)


# video_codecs_tpu/models/hevc/headers.py:341
def write_slice_header(cfg: HevcConfig, nal_type: int,
                       entry_points: list[int] | None = None,
                       sao_flags: bool | None = None) -> BitWriter:
    """I-slice segment header; returns the writer so slice data appends.

    entry_points: byte sizes of all but the last tile substream.
    sao_flags: slice_sao_luma/chroma value (default: SPS flag) — lets a
    slice opt out of SAO while the SPS enables it."""
    w = BitWriter()
    w.flag(1)       # first_slice_segment_in_pic_flag
    if 16 <= nal_type <= 23:  # IRAP
        w.flag(0)   # no_output_of_prior_pics_flag
    w.ue(0)         # slice_pic_parameter_set_id
    w.ue(2)         # slice_type = I
    if cfg.sao:
        on = cfg.sao if sao_flags is None else sao_flags
        w.flag(1 if on else 0)   # slice_sao_luma_flag
        w.flag(1 if on else 0)   # slice_sao_chroma_flag
    w.se(cfg.qp - 26)  # slice_qp_delta (init_qp_minus26 = 0)
    if not cfg.deblocking_disabled:
        # present when pps_loop_filter_across_slices_enabled_flag &&
        # (SAO on || !slice_deblocking_filter_disabled_flag)
        w.flag(1)   # slice_loop_filter_across_slices_enabled_flag
    if cfg.tiles_enabled or cfg.wpp:
        eps = entry_points or []
        w.ue(len(eps))  # num_entry_point_offsets
        if eps:
            nbits = max(e - 1 for e in eps).bit_length() or 1
            w.ue(nbits - 1)  # offset_len_minus1
            for e in eps:
                w.write(e - 1, nbits)
    w.byte_alignment()
    return w


# video_codecs_tpu/models/hevc/headers.py:376
@dataclasses.dataclass
class SliceInfo:
    slice_type: int
    qp: int
    data_offset_bits: int
    entry_points: list[int] = dataclasses.field(default_factory=list)


# video_codecs_tpu/models/hevc/headers.py:384
def parse_slice_header(rbsp: bytes, nal_type: int, pps: PpsInfo,
                       sps_sao: bool = False) -> SliceInfo:
    r = BitReader(rbsp)
    assert r.flag() == 1, "multi-slice pictures unsupported"
    if 16 <= nal_type <= 23:
        r.flag()
    assert r.ue() == 0
    slice_type = r.ue()
    assert slice_type == 2, "only I slices supported"
    if sps_sao:
        assert r.flag() == 1 and r.flag() == 1, \
            "per-slice SAO disable unsupported"
    qp = pps.init_qp + r.se()
    if not pps.deblocking_disabled:
        r.flag()  # slice_loop_filter_across_slices_enabled_flag
    entry_points = []
    if pps.tile_columns > 1 or pps.wpp:
        n = r.ue()
        if n:
            nbits = r.ue() + 1
            entry_points = [r.read(nbits) + 1 for _ in range(n)]
    # byte_alignment: consume up to the next byte boundary
    one = r.flag()
    assert one == 1
    r.byte_align()
    return SliceInfo(slice_type=slice_type, qp=qp,
                     data_offset_bits=r.bit_pos(),
                     entry_points=entry_points)

