"""Per-syntax-class coding statistics (decoder-analyser mode).

Parity: HM's TComCodingStatistics (TComCodingStatistics.h:198) — the
`TAppDecoderAnalyser` build counts bits/bins per syntax-element class
while decoding, to validate entropy coding and find rate waste; JM has
dec_statistics.c. Here: `start()` activates collection, the H.264
CABAC engines are wrapped at creation (same hook points as the syntax
trace), and `stop()` returns a `CodingStats` whose `report()` prints
the HM-style table. Bin counts are exact; the bits column is the
bitstream-position delta around each element (the arithmetic decoder's
9-bit pipeline smears boundaries by <2 bytes total).

The port's copy of video_codecs_tpu/utils/coding_stats.py, whole; each
function and method keeps its name and a comment gives the original's
line.  The HEVC hooks patch the port's `entropy/cabac.CabacDecoder`.
"""

from __future__ import annotations


# video_codecs_tpu/utils/coding_stats.py:17
class CodingStats:
    # video_codecs_tpu/utils/coding_stats.py:18
    def __init__(self) -> None:
        self.rows: dict[str, dict] = {}
        self.current: str | None = None
        self.depth = 0

    # video_codecs_tpu/utils/coding_stats.py:23
    def _row(self, name: str) -> dict:
        return self.rows.setdefault(
            name, {"count": 0, "bins": 0, "bypass": 0, "bits": 0})

    # video_codecs_tpu/utils/coding_stats.py:27
    def add_element(self, name: str, bits: int) -> None:
        r = self._row(name)
        r["count"] += 1
        r["bits"] += bits

    # video_codecs_tpu/utils/coding_stats.py:32
    def add_bin(self, bypass: bool = False) -> None:
        r = self._row(self.current or "(other)")
        r["bins"] += 1
        if bypass:
            r["bypass"] += 1

    # video_codecs_tpu/utils/coding_stats.py:38
    def report(self) -> str:
        lines = [f"{'syntax class':<26}{'count':>8}{'bins':>9}"
                 f"{'bypass':>8}{'bits':>9}"]
        total = {"count": 0, "bins": 0, "bypass": 0, "bits": 0}
        for name in sorted(self.rows):
            r = self.rows[name]
            lines.append(f"{name:<26}{r['count']:>8}{r['bins']:>9}"
                         f"{r['bypass']:>8}{r['bits']:>9}")
            for k in total:
                total[k] += r[k]
        lines.append(f"{'TOTAL':<26}{total['count']:>8}{total['bins']:>9}"
                     f"{total['bypass']:>8}{total['bits']:>9}")
        return "\n".join(lines)


_active: CodingStats | None = None


# video_codecs_tpu/utils/coding_stats.py:56
def start() -> None:
    global _active
    _active = CodingStats()
    install_hevc_hooks()


# video_codecs_tpu/utils/coding_stats.py:62
def stop() -> CodingStats:
    global _active
    s, _active = _active or CodingStats(), None
    remove_hevc_hooks()
    return s


# video_codecs_tpu/utils/coding_stats.py:69
def active() -> bool:
    return _active is not None


_ELEMENTS = ("mb_skip_flag_p", "mb_type_i", "mb_type_p", "ref_idx", "mvd",
             "cbp", "mb_qp_delta", "intra4x4_pred_mode",
             "intra_chroma_pred_mode", "residual_block", "final")


# video_codecs_tpu/utils/coding_stats.py:78
def wrap_stats(engine):
    """Wrap a CABAC engine (encoder or decoder) so element counts and
    bin counts accrue to the active CodingStats. No-op when inactive."""
    stats = _active
    if stats is None:
        return engine

    core = getattr(engine, "core", None)
    if core is not None:
        # element naming is handled here; the HEVC class-level hooks
        # must not re-attribute this engine's bins
        core._stats_external = True
    reader = getattr(core, "br", None)
    writer = getattr(core, "bw", None)

    def bitpos() -> int:
        if reader is not None:
            return reader.bit_pos()
        if writer is not None:
            return writer.num_bits()
        return 0

    for name in _ELEMENTS:
        orig = getattr(engine, name, None)
        if orig is None:
            continue

        def make(name=name, orig=orig):
            def wrapped(*a, **k):
                outer = stats.depth == 0
                if outer:
                    stats.current = name
                    p0 = bitpos()
                stats.depth += 1
                try:
                    return orig(*a, **k)
                finally:
                    stats.depth -= 1
                    if outer:
                        stats.add_element(name, bitpos() - p0)
                        stats.current = None
            return wrapped

        setattr(engine, name, make())

    if core is not None:
        for binname, bypass in (("decode_bin", False), ("encode_bin", False),
                                ("decode_bypass", True),
                                ("encode_bypass", True),
                                ("decode_terminate", False),
                                ("encode_terminate", False)):
            borig = getattr(core, binname, None)
            if borig is None:
                continue

            def bmake(borig=borig, bypass=bypass):
                def bwrapped(*a, **k):
                    stats.add_bin(bypass)
                    return borig(*a, **k)
                return bwrapped

            setattr(core, binname, bmake())
    return engine


# ---------------------------------------------------------------------------
# HEVC decoder-analyser hooks: classify bins by CABAC context name
# (TComCodingStatistics / TAppDecoderAnalyser parity for the HEVC builds)
# ---------------------------------------------------------------------------

_hevc_saved: dict | None = None


# video_codecs_tpu/utils/coding_stats.py:151
def install_hevc_hooks() -> None:
    """Patch the HEVC CabacDecoder so every decoded bin accrues to the
    syntax class owning its context (bypass/terminate bins accrue to the
    most recent context class).  Installed by start(), removed by stop()."""
    global _hevc_saved
    if _hevc_saved is not None:
        return
    import bisect

    from video_codecs_tpu_torch.entropy import cabac
    from video_codecs_tpu_torch.entropy import ctx as ctx_mod

    pairs = sorted(ctx_mod.OFFSETS.items(), key=lambda kv: kv[1])
    starts = [v for _, v in pairs]
    labels = [k for k, _ in pairs]

    def name_of(i: int) -> str:
        return labels[bisect.bisect_right(starts, i) - 1]

    saved = dict(
        decode_bin=cabac.CabacDecoder.decode_bin,
        decode_bypass=cabac.CabacDecoder.decode_bypass,
        decode_terminate=cabac.CabacDecoder.decode_terminate,
    )

    def decode_bin(self, c):
        st = _active
        if st is not None and not getattr(self, "_stats_external", False):
            name = name_of(c)
            if name != st.current:
                st.current = name
                st._row(name)["count"] += 1
            st.add_bin(False)
        return saved["decode_bin"](self, c)

    def decode_bypass(self):
        if _active is not None and not getattr(self, "_stats_external",
                                               False):
            _active.add_bin(True)
        return saved["decode_bypass"](self)

    def decode_terminate(self):
        st = _active
        if st is not None and not getattr(self, "_stats_external", False):
            st.current = "end_of_slice"
            st.add_bin(False)
        return saved["decode_terminate"](self)

    cabac.CabacDecoder.decode_bin = decode_bin
    cabac.CabacDecoder.decode_bypass = decode_bypass
    cabac.CabacDecoder.decode_terminate = decode_terminate
    _hevc_saved = saved


# video_codecs_tpu/utils/coding_stats.py:205
def remove_hevc_hooks() -> None:
    global _hevc_saved
    if _hevc_saved is None:
        return
    from video_codecs_tpu_torch.entropy import cabac
    for k, v in _hevc_saved.items():
        setattr(cabac.CabacDecoder, k, v)
    _hevc_saved = None
