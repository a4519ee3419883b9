"""HM-compatible configuration system (program_options_lite parity).

The port's copy of video_codecs_tpu/utils/config.py, which the encoder
CLI (tools/encoder_app.py) reads HM's cfg files with; each function keeps
its name and a comment gives the original's line.  `to_encoder_settings`
parses the GOPEntry table with the port's `ra_codec.parse_gop_entries`.

Parity reference: hm-16.5rc1/source/Lib/TAppCommon/program_options_lite.cpp
(`Name : value  # comment` cfg lines, stacked `-c cfgA -c cfgB` with later
files overriding earlier, `--Name=value` command-line overrides applied
last) and TAppEncCfg.cpp option names.  The JCT-VC cfg files under
hm-16.5rc1/cfg/ parse unchanged.
"""

from __future__ import annotations

import dataclasses


# video_codecs_tpu/utils/config.py:15
def parse_cfg_file(path: str) -> dict[str, str]:
    opts: dict[str, str] = {}
    for raw in open(path, encoding="utf-8", errors="replace"):
        line = raw.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        name, value = line.split(":", 1)
        opts[name.strip()] = value.strip()
    return opts


# video_codecs_tpu/utils/config.py:26
def load_config(cfg_files: list[str],
                overrides: dict[str, str] | None = None) -> dict[str, str]:
    """Stack cfg files in order (later wins), then CLI overrides."""
    opts: dict[str, str] = {}
    for f in cfg_files:
        opts.update(parse_cfg_file(f))
    if overrides:
        opts.update(overrides)
    return opts


# video_codecs_tpu/utils/config.py:37
@dataclasses.dataclass
class EncoderSettings:
    """The subset of TAppEncCfg options the current builds implement,
    mapped from HM names."""
    input_file: str = ""
    bitstream_file: str = "str.bin"
    recon_file: str = ""
    width: int = 416
    height: int = 240
    frame_rate: float = 30.0
    frames: int = 1
    frame_skip: int = 0
    qp: int = 32
    intra_period: int = 1          # 1 = all intra, -1 = first frame only
    gop_size: int = 1
    sign_data_hiding: bool = False
    deblocking_disabled: bool = False
    tile_columns: int = 1
    sao: bool = False
    rdoq: bool | str = False
    search_range: int = 64         # HM SearchRange default
    me_method: str = "auto"        # FastSearch: 0=full, 1=tz
    target_bitrate: int = 0        # 0 = rate control off
    merge_cands: int = 1           # MaxNumMergeCand
    temporal_mvp: bool = False     # TMVPMode
    num_refs: int = 1              # L0 refs (from GOPEntry actives)
    gop_entries: tuple = ()        # parsed FrameN lines (RA/LD tables)
    unsupported: dict[str, str] = dataclasses.field(default_factory=dict)


# video_codecs_tpu/utils/config.py:67
_SUPPORTED = {
    "InputFile", "BitstreamFile", "ReconFile", "SourceWidth", "SourceHeight",
    "FrameRate", "FramesToBeEncoded", "FrameSkip", "QP", "IntraPeriod",
    "GOPSize", "SignHideFlag", "LoopFilterDisable", "NumTileColumnsMinus1",
    "RateControl", "TargetBitrate", "InputBitDepth", "InputChromaFormat",
    "Profile", "Level", "SAO", "RDOQ", "SearchRange", "FastSearch",
    "MaxNumMergeCand", "TMVPMode", "DecodingRefreshType",
}


# video_codecs_tpu/utils/config.py:77
def to_encoder_settings(opts: dict[str, str]) -> EncoderSettings:
    s = EncoderSettings()
    g = opts.get
    s.input_file = g("InputFile", s.input_file)
    s.bitstream_file = g("BitstreamFile", s.bitstream_file)
    s.recon_file = g("ReconFile", s.recon_file)
    s.width = int(g("SourceWidth", s.width))
    s.height = int(g("SourceHeight", s.height))
    s.frame_rate = float(g("FrameRate", s.frame_rate))
    s.frames = int(g("FramesToBeEncoded", s.frames))
    s.frame_skip = int(g("FrameSkip", s.frame_skip))
    s.qp = int(float(g("QP", s.qp)))
    s.intra_period = int(g("IntraPeriod", s.intra_period))
    s.gop_size = int(g("GOPSize", s.gop_size))
    s.sign_data_hiding = g("SignHideFlag", "0") not in ("0", "false")
    s.deblocking_disabled = g("LoopFilterDisable", "0") not in ("0", "false")
    s.tile_columns = int(g("NumTileColumnsMinus1", "0")) + 1
    s.sao = g("SAO", "0") not in ("0", "false")
    rdoq = g("RDOQ", "0")
    # HM's RDOQ:1 is the full CG/last-pos algorithm; "lite" selects the
    # vectorized soft-decision variant (our addition).
    s.rdoq = False if rdoq in ("0", "false") else (
        "lite" if rdoq == "lite" else "full")
    s.search_range = int(g("SearchRange", s.search_range))
    fs = g("FastSearch", "1")
    s.me_method = "full" if fs == "0" else ("tz" if fs == "1" else "auto")
    if g("RateControl", "0") not in ("0", "false"):
        s.target_bitrate = int(g("TargetBitrate", "0"))
    s.merge_cands = int(g("MaxNumMergeCand", "1"))
    s.temporal_mvp = g("TMVPMode", "0") not in ("0", "false")
    # GOPEntry tables (FrameN lines) drive the RA/LD coding structure
    frame_lines = [f"Frame{k}: {opts[f'Frame{k}']}"
                   for k in range(1, 65) if f"Frame{k}" in opts]
    if frame_lines:
        from video_codecs_tpu_torch.models.hevc import ra_codec
        s.gop_entries = tuple(
            ra_codec.parse_gop_entries("\n".join(frame_lines)))
        s.num_refs = max(e.num_ref_pics_active for e in s.gop_entries)
    if g("InputBitDepth", "8") != "8":
        s.unsupported["InputBitDepth"] = opts["InputBitDepth"]
    if g("InputChromaFormat", "420") != "420":
        s.unsupported["InputChromaFormat"] = opts["InputChromaFormat"]
    # Record the tool requests this build does not implement yet, so the
    # caller can warn instead of silently ignoring them.
    for name, value in opts.items():
        if name.startswith("Frame") and name[5:].isdigit():
            continue
        if name not in _SUPPORTED and value not in ("", "0", "false"):
            s.unsupported.setdefault(name, value)
    return s


# video_codecs_tpu/utils/config.py:129
def parse_cli(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    """program_options_lite CLI conventions: -c cfg (repeatable),
    --Name=value, and the common short options of TAppEncoder."""
    cfgs: list[str] = []
    overrides: dict[str, str] = {}
    short = {"-i": "InputFile", "-b": "BitstreamFile", "-o": "ReconFile",
             "-wdt": "SourceWidth", "-hgt": "SourceHeight", "-q": "QP",
             "-f": "FramesToBeEncoded", "-fr": "FrameRate",
             "-ip": "IntraPeriod"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-c":
            cfgs.append(argv[i + 1])
            i += 2
        elif a.startswith("--") and "=" in a:
            name, value = a[2:].split("=", 1)
            overrides[name] = value
            i += 1
        elif a in short:
            overrides[short[a]] = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown option {a}")
    return cfgs, overrides
