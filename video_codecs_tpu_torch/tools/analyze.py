"""Bitstream analyzer: NAL / header / SEI field dump for HEVC and H.264.

The port's copy of video_codecs_tpu/tools/analyze.py, whole: each
function and class under its own name, with a comment giving the
original's line.  `sniff_codec` also serves tools/decoder_app.py.

Parity reference: bsanalyzer/ — bs.h bit reader + h264_stream.cpp
read_nal_unit (h264_stream.h:374), read_seq_parameter_set_rbsp :116,
read_slice_header :478 (full-field dumps incl. reordering / weight
tables / MMCO via tools/h264_syntax.py) + h264_analyze.cpp:63 CLI; HM
utils/annexBbytecount.cpp for the byte accounting.

CLI:  python -m video_codecs_tpu_torch.tools.analyze <stream>
          [--codec hevc|h264] [-v] [--json]

Default output is one row per NAL with key fields; -v dumps every
parsed syntax element of SPS/PPS/slice headers/SEI (the analyzer keeps
parameter-set context across the stream like the reference tool).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from video_codecs_tpu_torch.entropy import bitstream as bs

HEVC_NAL_NAMES = {
    0: "TRAIL_N", 1: "TRAIL_R", 2: "TSA_N", 3: "TSA_R", 4: "STSA_N",
    5: "STSA_R", 6: "RADL_N", 7: "RADL_R", 8: "RASL_N", 9: "RASL_R",
    16: "BLA_W_LP", 17: "BLA_W_RADL", 18: "BLA_N_LP", 19: "IDR_W_RADL",
    20: "IDR_N_LP", 21: "CRA_NUT", 32: "VPS", 33: "SPS", 34: "PPS",
    35: "AUD", 36: "EOS", 37: "EOB", 38: "FD", 39: "PREFIX_SEI",
    40: "SUFFIX_SEI",
}

H264_NAL_NAMES = {
    1: "SLICE_NON_IDR", 2: "DPA", 3: "DPB", 4: "DPC", 5: "SLICE_IDR",
    6: "SEI", 7: "SPS", 8: "PPS", 9: "AUD", 10: "EOSEQ", 11: "EOSTREAM",
    12: "FILLER",
}


# video_codecs_tpu/tools/analyze.py:41
def sniff_codec(stream: bytes) -> str:
    """Guess codec from the first NAL header."""
    nals = bs.split_annexb(stream)
    if not nals:
        return "unknown"
    b0 = nals[0][0]
    # HEVC: forbidden_zero(1) + type(6) + layer(6) + tid(3) => 2-byte header,
    # H.264: forbidden_zero(1) + ref_idc(2) + type(5) => 1 byte.
    h264_type = b0 & 0x1F
    hevc_type = (b0 >> 1) & 0x3F
    if h264_type in (7,) and (b0 >> 5) != 0:
        return "h264"
    if hevc_type in (32, 33, 34, 19, 20, 21, 1, 0, 39, 40):
        return "hevc"
    return "h264" if h264_type in H264_NAL_NAMES else "hevc"


# video_codecs_tpu/tools/analyze.py:58
class _HevcCtx:
    """Active parameter sets while walking an HEVC stream."""

    # video_codecs_tpu/tools/analyze.py:61
    def __init__(self) -> None:
        self.sps = None
        self.pps = None


# video_codecs_tpu/tools/analyze.py:66
def analyze(stream: bytes, codec: str | None = None,
            verbose: bool = False) -> list[dict]:
    codec = codec or sniff_codec(stream)
    rows = []
    hctx = _HevcCtx()
    sps_map: dict = {}
    pps_map: dict = {}
    for nal in bs.split_annexb(stream):
        if codec == "hevc":
            ntype = (nal[0] >> 1) & 0x3F
            tid = (nal[1] & 7) - 1
            row = {"codec": "hevc", "type": ntype,
                   "name": HEVC_NAL_NAMES.get(ntype, f"RSV{ntype}"),
                   "temporal_id": tid, "bytes": len(nal)}
            rbsp = bs.strip_emulation_prevention(nal[2:])
            row.update(_hevc_details(ntype, rbsp, hctx, verbose))
        else:
            ntype = nal[0] & 0x1F
            ref_idc = nal[0] >> 5
            row = {"codec": "h264", "type": ntype,
                   "name": H264_NAL_NAMES.get(ntype, f"RSV{ntype}"),
                   "ref_idc": ref_idc, "bytes": len(nal)}
            rbsp = bs.strip_emulation_prevention(nal[1:])
            row.update(_h264_details(ntype, ref_idc, rbsp, sps_map,
                                     pps_map, verbose))
        rows.append(row)
    return rows


# video_codecs_tpu/tools/analyze.py:95
def _asdict_brief(obj, keys: tuple) -> dict:
    d = dataclasses.asdict(obj)
    return {k: d[k] for k in keys if k in d}


# video_codecs_tpu/tools/analyze.py:100
def _hevc_details(ntype: int, rbsp: bytes, ctx: _HevcCtx,
                  verbose: bool) -> dict:
    from video_codecs_tpu_torch.models.hevc import decoder as hdec
    from video_codecs_tpu_torch.models.hevc import sei as hsei
    try:
        if ntype == 33:
            ctx.sps = hdec.parse_sps(rbsp)
            if verbose:
                return {"fields": dataclasses.asdict(ctx.sps)}
            return _asdict_brief(
                ctx.sps, ("width", "height", "log2_ctb", "bit_depth",
                          "chroma_format_idc", "amp", "sao", "pcm",
                          "strong_intra_smoothing", "scaling_list"))
        if ntype == 34:
            ctx.pps = hdec.parse_pps(rbsp)
            if verbose:
                return {"fields": dataclasses.asdict(ctx.pps)}
            return _asdict_brief(
                ctx.pps, ("init_qp", "tiles", "entropy_sync",
                          "cu_qp_delta", "sign_data_hiding",
                          "weighted_pred", "weighted_bipred",
                          "transform_skip"))
        if ntype in (39, 40):
            msgs = hsei.parse_sei_rbsp(rbsp)
            out = {"messages": [type(m).__name__ for m in msgs]}
            if verbose:
                out["fields"] = [dataclasses.asdict(m)
                                 if dataclasses.is_dataclass(m) else repr(m)
                                 for m in msgs]
            return out
        if ntype <= 21 and ctx.sps is not None and ctx.pps is not None:
            h = hdec.parse_slice_header(rbsp, ntype, ctx.sps, ctx.pps)
            if verbose:
                d = dataclasses.asdict(h)
                d.pop("wp", None)
                return {"fields": d}
            out = {"slice_type": "BPI"[h.slice_type], "qp": h.qp,
                   "poc": h.poc}
            if h.slice_type != 2:
                out["n_refs"] = h.num_ref_idx
            return out
        if ntype <= 21:                 # slice before parameter sets
            r = bs.BitReader(rbsp)
            first = r.flag()
            if 16 <= ntype <= 23:
                r.flag()
            return {"first_slice": first, "pps_id": r.ue(),
                    "slice_type": "BPI"[r.ue()]}
    except Exception as e:  # header uses unsupported tools: still report NAL
        return {"note": f"parse: {e}"}
    return {}


# video_codecs_tpu/tools/analyze.py:153
def _h264_details(ntype: int, ref_idc: int, rbsp: bytes, sps_map: dict,
                  pps_map: dict, verbose: bool) -> dict:
    from video_codecs_tpu_torch.models.h264 import sei as h264_sei
    from video_codecs_tpu_torch.tools import h264_syntax as syn
    try:
        if ntype == 7:
            s = syn.parse_sps_full(rbsp)
            sps_map[s["seq_parameter_set_id"]] = s
            if verbose:
                return {"fields": s}
            return {k: s[k] for k in
                    ("profile", "level_idc", "width", "height",
                     "max_num_ref_frames", "pic_order_cnt_type")
                    if k in s}
        if ntype == 8:
            p = syn.parse_pps_full(rbsp)
            pps_map[p["pic_parameter_set_id"]] = p
            if verbose:
                return {"fields": p}
            return {k: p[k] for k in
                    ("entropy_coding_mode", "pic_init_qp",
                     "num_slice_groups", "weighted_pred",
                     "transform_8x8_mode")
                    if k in p}
        if ntype == 6:
            msgs = h264_sei.parse_sei_rbsp(rbsp)
            out = {"messages": [type(m).__name__ for m in msgs]}
            if verbose:
                out["fields"] = [dataclasses.asdict(m)
                                 if dataclasses.is_dataclass(m) else repr(m)
                                 for m in msgs]
            return out
        if ntype in (1, 2, 5):
            s = syn.parse_slice_header_full(rbsp, ntype, ref_idc,
                                            sps_map, pps_map)
            if verbose:
                return {"fields": s}
            out = {"slice_type": s["slice_type"],
                   "frame_num": s["frame_num"], "qp": s["slice_qp"]}
            for k in ("reorder_l0", "reorder_l1"):
                if k in s:
                    out[k] = s[k]
            if "dec_ref_pic_marking" in s and \
                    "mmco" in s["dec_ref_pic_marking"]:
                out["mmco"] = s["dec_ref_pic_marking"]["mmco"]
            if "pred_weight_table" in s:
                out["wp"] = True
            return out
    except Exception as e:
        return {"note": f"parse: {e}"}
    return {}


# video_codecs_tpu/tools/analyze.py:206
def _fmt(v, depth=0):
    if isinstance(v, dict):
        pad = "    " * (depth + 2)
        return "\n" + "\n".join(f"{pad}{k}: {_fmt(x, depth + 1)}"
                                for k, x in v.items())
    return str(v)


# video_codecs_tpu/tools/analyze.py:214
def main() -> None:
    ap = argparse.ArgumentParser(description="HEVC/H.264 bitstream analyzer")
    ap.add_argument("stream")
    ap.add_argument("--codec", choices=["hevc", "h264"])
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="dump every parsed syntax element")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per NAL")
    args = ap.parse_args()
    data = open(args.stream, "rb").read()
    rows = analyze(data, args.codec, verbose=args.verbose)
    if args.json:
        for row in rows:
            print(json.dumps(row))
        return
    total = 0
    for i, row in enumerate(rows):
        extras = {k: v for k, v in row.items()
                  if k not in ("codec", "type", "name", "bytes", "fields")}
        print(f"{i:4d}  {row['name']:<14} {row['bytes']:7d} B  "
              + " ".join(f"{k}={v}" for k, v in extras.items()))
        if "fields" in row:
            f = row["fields"]
            if isinstance(f, list):
                for x in f:
                    print("      " + _fmt(x, 0))
            else:
                for k, v in f.items():
                    print(f"        {k}: {_fmt(v)}")
        total += row["bytes"]
    print(f"total: {len(rows)} NAL units, {total} payload bytes "
          f"({len(data)} with start codes)")


if __name__ == "__main__":
    main()
