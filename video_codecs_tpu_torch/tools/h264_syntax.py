"""Permissive field-complete H.264 syntax parsers for the analyzer.

The port's copy of video_codecs_tpu/tools/h264_syntax.py, whole: each
function under its own name, with a comment giving the original's line.

Unlike the decoder's parsers (models/h264/intra_codec.py) which assert
on tools outside the supported coding toolset, these read EVERY syntax
element of SPS (incl. VUI/HRD), PPS (incl. FMO maps and the High-profile
tail), and slice headers (incl. ref-list reordering, prediction-weight
tables and MMCO commands) and record them as name->value dicts — the
analyzer must describe any stream, not just ones we can decode.

Parity: bsanalyzer/h264bitstream-0.1.9/h264_stream.cpp read_seq_parameter_set_rbsp
:116, read_pic_parameter_set_rbsp :272, read_slice_header :478,
read_ref_pic_list_reordering :576, read_pred_weight_table :614,
read_dec_ref_pic_marking :661, read_vui_parameters :188, read_hrd :244.
"""

from __future__ import annotations

from video_codecs_tpu_torch.entropy.bitstream import BitReader

SLICE_TYPES = {0: "P", 1: "B", 2: "I", 3: "SP", 4: "SI",
               5: "P", 6: "B", 7: "I", 8: "SP", 9: "SI"}

PROFILES = {66: "Baseline", 77: "Main", 88: "Extended", 100: "High",
            110: "High10", 122: "High422", 244: "High444", 44: "CAVLC444"}

_HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139,
                  134, 135)


# video_codecs_tpu/tools/h264_syntax.py:30
def _scaling_list(r: BitReader, size: int) -> dict:
    """scaling_list() (spec 7.3.2.1.1.1); returns summary not contents."""
    last, nxt, n_read = 8, 8, 0
    use_default = False
    for j in range(size):
        if nxt != 0:
            delta = r.se()
            n_read += 1
            nxt = (last + delta + 256) % 256
            if j == 0 and nxt == 0:
                use_default = True
        if nxt != 0:
            last = nxt
    return {"deltas": n_read, "use_default": use_default}


# video_codecs_tpu/tools/h264_syntax.py:46
def _hrd(r: BitReader) -> dict:
    cpb_cnt = r.ue() + 1
    out = {"cpb_cnt": cpb_cnt,
           "bit_rate_scale": r.read(4), "cpb_size_scale": r.read(4)}
    rates, sizes, cbr = [], [], []
    for _ in range(cpb_cnt):
        rates.append(r.ue() + 1)
        sizes.append(r.ue() + 1)
        cbr.append(r.flag())
    out["bit_rate_value"] = rates
    out["cpb_size_value"] = sizes
    out["cbr_flag"] = cbr
    out["initial_cpb_removal_delay_length"] = r.read(5) + 1
    out["cpb_removal_delay_length"] = r.read(5) + 1
    out["dpb_output_delay_length"] = r.read(5) + 1
    out["time_offset_length"] = r.read(5)
    return out


# video_codecs_tpu/tools/h264_syntax.py:65
def _vui(r: BitReader) -> dict:
    out: dict = {}
    if r.flag():                               # aspect_ratio_info_present
        idc = r.read(8)
        out["aspect_ratio_idc"] = idc
        if idc == 255:                         # Extended_SAR
            out["sar"] = (r.read(16), r.read(16))
    if r.flag():                               # overscan_info_present
        out["overscan_appropriate"] = r.flag()
    if r.flag():                               # video_signal_type_present
        out["video_format"] = r.read(3)
        out["video_full_range"] = r.flag()
        if r.flag():                           # colour_description_present
            out["colour_primaries"] = r.read(8)
            out["transfer_characteristics"] = r.read(8)
            out["matrix_coefficients"] = r.read(8)
    if r.flag():                               # chroma_loc_info_present
        out["chroma_sample_loc"] = (r.ue(), r.ue())
    if r.flag():                               # timing_info_present
        out["num_units_in_tick"] = r.read(32)
        out["time_scale"] = r.read(32)
        out["fixed_frame_rate"] = r.flag()
    nal_hrd = r.flag()
    if nal_hrd:
        out["nal_hrd"] = _hrd(r)
    vcl_hrd = r.flag()
    if vcl_hrd:
        out["vcl_hrd"] = _hrd(r)
    if nal_hrd or vcl_hrd:
        out["low_delay_hrd"] = r.flag()
    out["pic_struct_present"] = r.flag()
    if r.flag():                               # bitstream_restriction
        out["motion_vectors_over_pic_boundaries"] = r.flag()
        out["max_bytes_per_pic_denom"] = r.ue()
        out["max_bits_per_mb_denom"] = r.ue()
        out["log2_max_mv_length_horizontal"] = r.ue()
        out["log2_max_mv_length_vertical"] = r.ue()
        out["num_reorder_frames"] = r.ue()
        out["max_dec_frame_buffering"] = r.ue()
    return out


# video_codecs_tpu/tools/h264_syntax.py:107
def parse_sps_full(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    s: dict = {}
    s["profile_idc"] = p = r.read(8)
    s["profile"] = PROFILES.get(p, str(p))
    s["constraint_set_flags"] = r.read(8)
    s["level_idc"] = r.read(8)
    s["seq_parameter_set_id"] = r.ue()
    chroma_format_idc = 1
    if p in _HIGH_PROFILES:
        s["chroma_format_idc"] = chroma_format_idc = r.ue()
        if chroma_format_idc == 3:
            s["separate_colour_plane"] = r.flag()
        s["bit_depth_luma"] = r.ue() + 8
        s["bit_depth_chroma"] = r.ue() + 8
        s["qpprime_y_zero_transform_bypass"] = r.flag()
        if r.flag():                           # seq_scaling_matrix_present
            n = 8 if chroma_format_idc != 3 else 12
            lists = []
            for i in range(n):
                if r.flag():
                    lists.append(_scaling_list(r, 16 if i < 6 else 64))
                else:
                    lists.append(None)
            s["seq_scaling_lists"] = sum(x is not None for x in lists)
    s["log2_max_frame_num"] = r.ue() + 4
    s["pic_order_cnt_type"] = poc_type = r.ue()
    if poc_type == 0:
        s["log2_max_pic_order_cnt_lsb"] = r.ue() + 4
    elif poc_type == 1:
        s["delta_pic_order_always_zero"] = r.flag()
        s["offset_for_non_ref_pic"] = r.se()
        s["offset_for_top_to_bottom_field"] = r.se()
        n = r.ue()
        s["offset_for_ref_frame"] = [r.se() for _ in range(n)]
    s["max_num_ref_frames"] = r.ue()
    s["gaps_in_frame_num_value_allowed"] = r.flag()
    wmb = r.ue() + 1
    hmb = r.ue() + 1
    s["pic_width_in_mbs"] = wmb
    frame_mbs_only = r.flag()
    s["frame_mbs_only"] = frame_mbs_only
    s["pic_height_in_map_units"] = hmb
    if not frame_mbs_only:
        s["mb_adaptive_frame_field"] = r.flag()
    s["width"] = wmb * 16
    s["height"] = hmb * 16 * (1 if frame_mbs_only else 2)
    s["direct_8x8_inference"] = r.flag()
    if r.flag():                               # frame_cropping
        s["crop"] = (r.ue(), r.ue(), r.ue(), r.ue())
    if r.flag():                               # vui_parameters_present
        s["vui"] = _vui(r)
    return s


# video_codecs_tpu/tools/h264_syntax.py:162
def parse_pps_full(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    s: dict = {}
    s["pic_parameter_set_id"] = r.ue()
    s["seq_parameter_set_id"] = r.ue()
    s["entropy_coding_mode"] = "cabac" if r.flag() else "cavlc"
    s["bottom_field_pic_order_in_frame_present"] = r.flag()
    s["num_slice_groups"] = n_groups = r.ue() + 1
    if n_groups > 1:                           # FMO (fmo.c map types 0-6)
        s["slice_group_map_type"] = t = r.ue()
        if t == 0:
            s["run_length"] = [r.ue() + 1 for _ in range(n_groups)]
        elif t == 2:
            s["top_left_bottom_right"] = [
                (r.ue(), r.ue()) for _ in range(n_groups - 1)]
        elif t in (3, 4, 5):
            s["slice_group_change_direction"] = r.flag()
            s["slice_group_change_rate"] = r.ue() + 1
        elif t == 6:
            n = r.ue() + 1
            bits = max(1, (n_groups - 1).bit_length())
            s["slice_group_id"] = [r.read(bits) for _ in range(n)]
    s["num_ref_idx_l0_default_active"] = r.ue() + 1
    s["num_ref_idx_l1_default_active"] = r.ue() + 1
    s["weighted_pred"] = r.flag()
    s["weighted_bipred_idc"] = r.read(2)
    s["pic_init_qp"] = 26 + r.se()
    s["pic_init_qs"] = 26 + r.se()
    s["chroma_qp_index_offset"] = r.se()
    s["deblocking_filter_control_present"] = r.flag()
    s["constrained_intra_pred"] = r.flag()
    s["redundant_pic_cnt_present"] = r.flag()
    if r.bits_left() > 8 or (r.bits_left() and
                             r._data[-1] != (0x80 >> ((r.bit_pos()) % 8))):
        # more_rbsp_data: High-profile PPS tail
        try:
            s["transform_8x8_mode"] = r.flag()
            if r.flag():                       # pic_scaling_matrix_present
                n = 6 + 2 * s.get("transform_8x8_mode", 0)
                cnt = 0
                for i in range(n):
                    if r.flag():
                        _scaling_list(r, 16 if i < 6 else 64)
                        cnt += 1
                s["pic_scaling_lists"] = cnt
            s["second_chroma_qp_index_offset"] = r.se()
        except IndexError:
            pass
    return s


# video_codecs_tpu/tools/h264_syntax.py:213
def _ref_pic_list_reordering(r: BitReader, slice_type: int) -> dict:
    out: dict = {}
    for lst in ([0] if slice_type % 5 != 1 else [0, 1]):
        cmds = []
        if r.flag():                           # ref_pic_list_reordering_flag
            while True:
                op = r.ue()                    # reordering_of_pic_nums_idc
                if op == 3:
                    break
                if op in (0, 1):
                    cmds.append((op, r.ue() + 1))   # abs_diff_pic_num
                else:
                    cmds.append((op, r.ue()))       # long_term_pic_num
        if cmds:
            out[f"reorder_l{lst}"] = cmds
    return out


# video_codecs_tpu/tools/h264_syntax.py:231
def _pred_weight_table(r: BitReader, slice_type: int, n_l0: int,
                       n_l1: int, chroma: bool) -> dict:
    out: dict = {"luma_log2_weight_denom": r.ue()}
    if chroma:
        out["chroma_log2_weight_denom"] = r.ue()
    for lst, n in (("l0", n_l0), ("l1", n_l1)):
        if lst == "l1" and slice_type % 5 != 1:
            break
        weights = []
        for _ in range(n):
            w: dict = {}
            if r.flag():
                w["luma"] = (r.se(), r.se())
            if chroma and r.flag():
                w["chroma"] = [(r.se(), r.se()) for _ in range(2)]
            weights.append(w)
        if any(weights):
            out[f"weights_{lst}"] = weights
    return out


# video_codecs_tpu/tools/h264_syntax.py:252
def _dec_ref_pic_marking(r: BitReader, idr: bool) -> dict:
    out: dict = {}
    if idr:
        out["no_output_of_prior_pics"] = r.flag()
        out["long_term_reference"] = r.flag()
    else:
        if r.flag():                           # adaptive_ref_pic_marking
            mmco = []
            while True:
                op = r.ue()                    # memory_management_control_op
                if op == 0:
                    break
                args = []
                if op in (1, 3):
                    args.append(r.ue() + 1)    # difference_of_pic_nums
                if op == 2:
                    args.append(r.ue())        # long_term_pic_num
                if op in (3, 6):
                    args.append(r.ue())        # long_term_frame_idx
                if op == 4:
                    args.append(r.ue())        # max_long_term_frame_idx + 1
                mmco.append((op, *args))
            out["mmco"] = mmco
    return out


# video_codecs_tpu/tools/h264_syntax.py:278
def parse_slice_header_full(rbsp: bytes, nal_type: int, nal_ref_idc: int,
                            sps_map: dict, pps_map: dict) -> dict:
    """Field-complete slice_header() parse (spec 7.3.3). Needs the
    active parameter sets, keyed by id in sps_map / pps_map (as parsed
    by parse_sps_full / parse_pps_full)."""
    r = BitReader(rbsp)
    s: dict = {}
    idr = nal_type == 5
    s["first_mb_in_slice"] = r.ue()
    st = r.ue()
    s["slice_type"] = SLICE_TYPES.get(st, str(st))
    s["pic_parameter_set_id"] = pps_id = r.ue()
    pps = pps_map.get(pps_id, {})
    sps = sps_map.get(pps.get("seq_parameter_set_id", 0), {})
    s["frame_num"] = r.read(sps.get("log2_max_frame_num", 4))
    field_pic = 0
    if not sps.get("frame_mbs_only", 1):
        s["field_pic_flag"] = field_pic = r.flag()
        if field_pic:
            s["bottom_field_flag"] = r.flag()
    if idr:
        s["idr_pic_id"] = r.ue()
    poc_type = sps.get("pic_order_cnt_type", 2)
    if poc_type == 0:
        s["pic_order_cnt_lsb"] = r.read(
            sps.get("log2_max_pic_order_cnt_lsb", 4))
        if pps.get("bottom_field_pic_order_in_frame_present") and \
                not field_pic:
            s["delta_pic_order_cnt_bottom"] = r.se()
    elif poc_type == 1 and not sps.get("delta_pic_order_always_zero", 0):
        s["delta_pic_order_cnt"] = [r.se()]
        if pps.get("bottom_field_pic_order_in_frame_present") and \
                not field_pic:
            s["delta_pic_order_cnt"].append(r.se())
    if pps.get("redundant_pic_cnt_present"):
        s["redundant_pic_cnt"] = r.ue()
    stype = st % 5
    n_l0 = pps.get("num_ref_idx_l0_default_active", 1)
    n_l1 = pps.get("num_ref_idx_l1_default_active", 1)
    if stype == 1:                             # B
        s["direct_spatial_mv_pred"] = r.flag()
    if stype in (0, 1, 3):                     # P/B/SP
        if r.flag():                           # num_ref_idx_override
            n_l0 = r.ue() + 1
            if stype == 1:
                n_l1 = r.ue() + 1
            s["num_ref_idx_active"] = (n_l0, n_l1) if stype == 1 else n_l0
        s.update(_ref_pic_list_reordering(r, st))
    chroma = sps.get("chroma_format_idc", 1) != 0
    if (pps.get("weighted_pred") and stype in (0, 3)) or \
            (pps.get("weighted_bipred_idc") == 1 and stype == 1):
        s["pred_weight_table"] = _pred_weight_table(r, st, n_l0, n_l1,
                                                    chroma)
    if nal_ref_idc:
        m = _dec_ref_pic_marking(r, idr)
        if m:
            s["dec_ref_pic_marking"] = m
    if pps.get("entropy_coding_mode") == "cabac" and stype != 2:
        s["cabac_init_idc"] = r.ue()
    s["slice_qp_delta"] = r.se()
    s["slice_qp"] = pps.get("pic_init_qp", 26) + s["slice_qp_delta"]
    if stype in (3, 4):                        # SP/SI
        if stype == 3:
            s["sp_for_switch"] = r.flag()
        s["slice_qs_delta"] = r.se()
    if pps.get("deblocking_filter_control_present"):
        s["disable_deblocking_filter_idc"] = idc = r.ue()
        if idc != 1:
            s["slice_alpha_c0_offset"] = r.se() * 2
            s["slice_beta_offset"] = r.se() * 2
    if pps.get("num_slice_groups", 1) > 1 and \
            pps.get("slice_group_map_type", 0) in (3, 4, 5):
        pic_size = sps.get("pic_width_in_mbs", 1) * \
            sps.get("pic_height_in_map_units", 1)
        rate = pps.get("slice_group_change_rate", 1)
        bits = max(1, (pic_size // rate).bit_length())
        s["slice_group_change_cycle"] = r.read(bits)
    s["header_bits"] = r.bit_pos()
    return s


# video_codecs_tpu/tools/h264_syntax.py:359
def parse_avcc(data: bytes) -> dict:
    """AVCDecoderConfigurationRecord (ISO 14496-15 5.2.4.1; bsanalyzer
    h264_avcc.cpp read_avcc): the MP4 'avcC' extradata box carrying
    SPS/PPS as length-prefixed NALs.

    Returns the header fields plus parsed SPS/PPS dicts and
    `annexb` — the parameter sets rewrapped as an Annex-B byte stream
    (start codes) for tools that only consume Annex B."""
    out: dict = {}
    out["configurationVersion"] = data[0]
    out["AVCProfileIndication"] = data[1]
    out["profile_compatibility"] = data[2]
    out["AVCLevelIndication"] = data[3]
    out["lengthSizeMinusOne"] = data[4] & 3
    pos = 5
    n_sps = data[pos] & 0x1F
    pos += 1
    sps_list, pps_list, annexb = [], [], bytearray()
    for _ in range(n_sps):
        ln = (data[pos] << 8) | data[pos + 1]
        pos += 2
        nal = data[pos:pos + ln]
        pos += ln
        annexb += b"\x00\x00\x00\x01" + nal
        sps_list.append(parse_sps_full(_strip_ep(nal[1:])))
    n_pps = data[pos]
    pos += 1
    for _ in range(n_pps):
        ln = (data[pos] << 8) | data[pos + 1]
        pos += 2
        nal = data[pos:pos + ln]
        pos += ln
        annexb += b"\x00\x00\x00\x01" + nal
        pps_list.append(parse_pps_full(_strip_ep(nal[1:])))
    out["sps"] = sps_list
    out["pps"] = pps_list
    out["annexb"] = bytes(annexb)
    return out


# video_codecs_tpu/tools/h264_syntax.py:399
def _strip_ep(rbsp: bytes) -> bytes:
    from video_codecs_tpu_torch.models.h264.intra_codec import \
        strip_emulation_prevention
    return strip_emulation_prevention(rbsp)


# video_codecs_tpu/tools/h264_syntax.py:405
def write_avcc(sps_nal: bytes, pps_nal: bytes) -> bytes:
    """Build an avcC record from raw SPS/PPS NALs (header byte included),
    the inverse of parse_avcc (h264_avcc.cpp write_avcc)."""
    sps_rbsp = _strip_ep(sps_nal[1:])
    r = BitReader(sps_rbsp)
    profile = r.read(8)
    compat = r.read(8)
    level = r.read(8)
    out = bytearray([1, profile, compat, level, 0xFF, 0xE0 | 1])
    out += len(sps_nal).to_bytes(2, "big") + sps_nal
    out += bytes([1]) + len(pps_nal).to_bytes(2, "big") + pps_nal
    return bytes(out)
