"""The port's GeneralDecoder on HM's parallel and conformance tools against
the JAX package's decoder: tile grids (uniform and explicit, with tile
rows) and WPP in the parameter sets, scaling lists, PCM and transform
skip.

No encoder of either package writes scaling lists, PCM or transform
skip, so the streams are made here: a JAX stream whose SPS or PPS is
rewritten with scaling lists (the residual syntax is unchanged, so both
decoders must give equal pictures and equal hash results), and a CTB16
stream written with the JAX package's header and CABAC writers plus a
small writer here for the PCM CUs (pcm_flag, the aligned raw samples,
the engine's restart) and the transform_skip_flag bins.  Tolerance 0.
"""

import dataclasses
import functools

import numpy as np
import pytest

from test_intra_codec import synth_frame
from video_codecs_tpu.entropy import bitstream as jbs
from video_codecs_tpu.entropy import cabac as jcabac
from video_codecs_tpu.entropy import ctx as jctx
from video_codecs_tpu.entropy import residual as jres
from video_codecs_tpu.models.hevc import decoder as jdec
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import intra_codec as jic
from video_codecs_tpu.models.hevc import quadtree_codec as jqc
from video_codecs_tpu.utils import rom
from video_codecs_tpu_torch.models.hevc import decoder as tdec
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import intra_codec as tic

DC = 1


# ---- parameter sets written here ---------------------------------------

def _write_sl(w, sl):
    """scaling_list_data() (spec 7.3.4) of sl[size_id][matrix_id]: an
    ("pred", delta) entry or an ("explicit", NxN raster matrix, dc)."""
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, step):
            e = sl[size_id][matrix_id]
            if e[0] == "pred":
                w.flag(0)
                w.ue(e[1])
                continue
            w.flag(1)
            m, dc = e[1], e[2]
            n = 4 if size_id == 0 else 8
            nxt = 8
            if size_id > 1:
                w.se(dc - 8)
                nxt = dc
            for i in jdec._diag_scan_ungrouped(n):
                v = int(m.reshape(-1)[i])
                w.se((v - nxt + 128) % 256 - 128)
                nxt = v


def _sps(cfg, sl=None, pcm=None):
    """headers.write_sps's SPS (without VUI) with scaling lists ("default"
    or a `_write_sl` table) and PCM (luma / chroma bit depth, log2 min /
    max size) when asked."""
    w = jbs.BitWriter()
    w.write(0, 4)
    w.write(0, 3)
    w.flag(1)
    jheaders._profile_tier_level(w, cfg)
    w.ue(0)
    w.ue(1)
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.flag(0)
    w.ue(cfg.bit_depth - 8)
    w.ue(cfg.bit_depth - 8)
    w.ue(4)
    w.flag(1)
    w.ue(max(2, cfg.num_refs) + cfg.reorder_pics)
    w.ue(cfg.reorder_pics)
    w.ue(0)
    w.ue(cfg.log2_min_cb - 3)
    w.ue(cfg.log2_ctb - cfg.log2_min_cb)
    w.ue(cfg.log2_min_tb - 2)
    w.ue(cfg.log2_max_tb - cfg.log2_min_tb)
    w.ue(cfg.tt_depth_inter)
    w.ue(0)
    w.flag(sl is not None)                     # scaling_list_enabled_flag
    if sl is not None:
        w.flag(sl != "default")                # sps_scaling_list_data_present
        if sl != "default":
            _write_sl(w, sl)
    w.flag(0)
    w.flag(1 if cfg.sao else 0)
    w.flag(pcm is not None)                    # pcm_enabled_flag
    if pcm is not None:
        bd_l, bd_c, lo, hi = pcm
        w.write(bd_l - 1, 4)
        w.write(bd_c - 1, 4)
        w.ue(lo - 3)
        w.ue(hi - lo)
        w.flag(0)                              # pcm_loop_filter_disabled
    w.ue(0)
    w.flag(0)
    w.flag(1 if cfg.temporal_mvp else 0)
    w.flag(0)
    w.flag(0)
    w.flag(0)
    w.rbsp_trailing_bits()
    return w.data()


def _pps(cfg, ts=False, sl=None, tiles=None, wpp=False, across=True):
    """headers.write_pps's PPS with transform skip, PPS scaling lists and
    a tile grid (cols, rows, uniform, col widths, row heights) or WPP."""
    w = jbs.BitWriter()
    w.ue(0)
    w.ue(0)
    w.flag(0)
    w.flag(0)
    w.write(0, 3)
    w.flag(1 if cfg.sign_data_hiding else 0)
    w.flag(0)
    w.ue(0)
    w.ue(0)
    w.se(0)
    w.flag(0)
    w.flag(ts)                                 # transform_skip_enabled
    w.flag(0)
    w.se(0)
    w.se(0)
    w.flag(0)
    w.flag(0)
    w.flag(0)
    w.flag(0)
    w.flag(tiles is not None)
    w.flag(wpp)
    if tiles is not None:
        cols, rows, uniform, widths, heights = tiles
        w.ue(cols - 1)
        w.ue(rows - 1)
        w.flag(uniform)
        if not uniform:
            for v in widths:
                w.ue(v - 1)
            for v in heights:
                w.ue(v - 1)
        w.flag(across)                         # loop filter across tiles
    w.flag(1)
    w.flag(1)
    w.flag(0)
    w.flag(1 if cfg.deblocking_disabled else 0)
    if not cfg.deblocking_disabled:
        w.se(0)
        w.se(0)
    w.flag(sl is not None)                     # pps_scaling_list_data
    if sl is not None:
        _write_sl(w, sl)
    w.flag(0)
    w.ue(0)
    w.flag(0)
    w.flag(0)
    w.rbsp_trailing_bits()
    return w.data()


def _swap(stream, sps=None, pps=None):
    """The stream with its SPS / PPS NAL units replaced."""
    out = []
    for nal in jbs.split_annexb(stream):
        t = (nal[0] >> 1) & 0x3F
        if t == jbs.NAL_SPS and sps is not None:
            nal = jbs.nal_unit(jbs.NAL_SPS, sps)
        elif t == jbs.NAL_PPS and pps is not None:
            nal = jbs.nal_unit(jbs.NAL_PPS, pps)
        out.append(nal)
    return jbs.annexb(out)


def _jax_intra(jcfg, frames):
    """The JAX package's IntraEncoder stream (its host CTB loop), given
    the port's mode decisions (held to its own elsewhere), which spares
    the reference's eager mode sweep."""
    enc = jic.IntraEncoder(jcfg)
    tenc = tic.IntraEncoder(theaders.HevcConfig(**dataclasses.asdict(jcfg)),
                            device="cpu")
    nals, recons = enc.stream_headers(), []
    for (y, u, v) in frames:
        fn, rec = enc.encode_frame(y, u, v, modes=tenc.decide_modes(y))
        nals += fn
        recons.append(rec)
    return jbs.annexb(nals), recons


def _both(stream):
    """Both GeneralDecoders on stream: equal pictures (decode and output
    order) and hash results; returns the port's (pictures, hashes)."""
    jd, td = jdec.GeneralDecoder(), tdec.GeneralDecoder()
    jout, tout = jd.decode(stream), td.decode(stream)
    assert td.hash_status == jd.hash_status
    assert len(tout) == len(jout)
    for a, b in zip(jout, tout):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(a[c]), b[c])
    return tout, td.hash_status


# ---- tiles and WPP in the PPS --------------------------------------------

def test_writers_give_the_reference_parameter_sets():
    cfg = jheaders.HevcConfig(width=64, height=48, qp=30, sao=True,
                              sign_data_hiding=True)
    assert _sps(cfg) == jheaders.write_sps(cfg)
    assert _pps(cfg) == jheaders.write_pps(cfg)


@pytest.mark.parametrize("tiles,wpp", [
    ((3, 2, True, [], []), False),
    ((2, 3, False, [2], [1, 3]), False),
    ((4, 1, False, [1, 5, 2], []), False),
    (None, True)], ids=["uniform-3x2", "explicit-2x3", "explicit-4x1",
                        "wpp"])
def test_parse_pps_and_tile_grid_equal(tiles, wpp):
    """Hand-written PPSs with uniform and explicit tile grids, tile rows
    and WPP: both parsers give the same fields, and both `_tile_grid`s
    the same column and row boundaries on a 9x5-CTB picture."""
    cfg = jheaders.HevcConfig(width=144, height=80)
    rbsp = _pps(cfg, tiles=tiles, wpp=wpp)
    jp, tp = jdec.parse_pps(rbsp), tdec.parse_pps(rbsp)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.tiles == (tiles is not None) and tp.entropy_sync == wpp
    if tiles is not None:
        assert tdec._tile_grid(tp, 9, 5) == jdec._tile_grid(jp, 9, 5)
        assert tdec._tile_grid(tp, 9, 5)[0][-1] == 9


@pytest.mark.parametrize("kw", [
    dict(tiles=(2, 1, True, [], []), wpp=True),
    dict(tiles=(2, 1, True, [], []), across=False)],
    ids=["tiles-and-wpp", "no-filter-across-tiles"])
def test_parse_pps_refusals_equal(kw):
    """The reference's asserts: tiles with WPP, and tiles without the loop
    filter across them."""
    rbsp = _pps(jheaders.HevcConfig(width=144, height=80), **kw)
    for mod in (jdec, tdec):
        with pytest.raises(AssertionError):
            mod.parse_pps(rbsp)


def test_general_decoder_on_jax_tile_and_wpp_streams():
    """The JAX package's tile and WPP streams (its host loop at 64x48 with
    SAO): both GeneralDecoders give the same pictures, every hash OK."""
    for kw in (dict(tile_columns=2), dict(wpp=True)):
        cfg = jheaders.HevcConfig(width=64, height=48, qp=32, sao=True,
                                  **kw)
        stream, recons = _jax_intra(
            cfg, [synth_frame(64, 48, s + 5) for s in range(2)])
        pics, hashes = _both(stream)
        assert hashes == [True, True]
        for r, p in zip(recons, pics):
            np.testing.assert_array_equal(r[0], p[0])


# ---- scaling lists --------------------------------------------------------

def _sl_table(seed, preds=True):
    """A scaling_list_data table: explicit matrices of seeded factors
    (8..80), with pred-mode entries (a default, copies of earlier
    matrices) where `preds`, and the two 32x32 lists."""
    rng = np.random.default_rng(seed)
    sl = [[None] * 6 for _ in range(4)]
    for size_id in range(4):
        n = 4 if size_id == 0 else 8
        step = 3 if size_id == 3 else 1
        for k, matrix_id in enumerate(range(0, 6, step)):
            if preds and k == 1:
                sl[size_id][matrix_id] = ("pred", 1)       # copy the last
            elif preds and size_id < 3 and k == 4:
                sl[size_id][matrix_id] = ("pred", 0)       # the default
            else:
                m = rng.integers(8, 81, (n, n))
                sl[size_id][matrix_id] = ("explicit", m,
                                          int(rng.integers(8, 81)))
    return sl


@pytest.mark.parametrize("seed,preds", [(1, True), (2, False)])
def test_parse_scaling_list_data_equal(seed, preds):
    w = jbs.BitWriter()
    _write_sl(w, _sl_table(seed, preds))
    w.rbsp_trailing_bits()
    got = tdec.parse_scaling_list_data(jbs.BitReader(w.data()))
    want = jdec.parse_scaling_list_data(jbs.BitReader(w.data()))
    for size_id in range(4):
        for m in range(6):
            np.testing.assert_array_equal(got[size_id][m][0],
                                          want[size_id][m][0])
            assert got[size_id][m][1] == want[size_id][m][1]


@functools.lru_cache(maxsize=None)
def _jax_streams():
    """Two JAX all-intra streams: the flat CTB16 coder at 64x48 (TB 16 /
    8) and the host quadtree coder at 64x64, CTB 32 (TBs 32 to 4); with
    each, the port's pictures of it (made once a process)."""
    cfg = jheaders.HevcConfig(width=64, height=48, qp=30)
    flat, _ = _jax_intra(cfg, [synth_frame(64, 48, s) for s in range(2)])
    qcfg = jheaders.HevcConfig(width=64, height=64, qp=27, log2_min_cb=3,
                               log2_ctb=5, log2_max_tb=5)
    enc = jqc.QuadtreeIntraEncoder(qcfg)
    nals, _ = enc.encode_frame(*synth_frame(64, 64, 3))
    qt = jbs.annexb(enc.stream_headers() + nals)
    return tuple((c, st, _both(st)[0]) for c, st in ((cfg, flat), (qcfg, qt)))


def test_scaling_lists_decode_equal():
    """Each JAX stream with its SPS (default lists, or explicit ones) or
    its PPS (explicit lists over the SPS's defaults) rewritten: both
    decoders give equal pictures and hash results, and the lists took
    effect (the pictures differ from the unscaled decode)."""
    for where in ("sps-default", "sps-explicit", "pps-explicit"):
        _scaling_lists_decode_equal(where)


def _scaling_lists_decode_equal(where):
    for cfg, stream, plain in _jax_streams():
        sl = _sl_table(7)
        if where == "sps-default":
            new = _swap(stream, sps=_sps(cfg, sl="default"))
        elif where == "sps-explicit":
            new = _swap(stream, sps=_sps(cfg, sl=sl))
        else:
            new = _swap(stream, sps=_sps(cfg, sl="default"),
                        pps=_pps(cfg, sl=sl))
        pics, _ = _both(new)
        assert any(not np.array_equal(a[0], b[0])
                   for a, b in zip(plain, pics))


# ---- PCM and transform skip ------------------------------------------------

def _pcm_ts_stream(seed, pcm_bd, deblock):
    """A 64x48 IDR at CTB 16, every CU 8x8: per CU a PCM CU (raw samples
    at pcm_bd bits), an NxN CU (four 4x4 luma TBs) or a 2Nx2N CU, each
    coded TB of 4x4 with a seeded transform_skip_flag, seeded sparse
    levels.  Returns (stream, {(x, y): (luma, cb, cr) PCM samples})."""
    rng = np.random.default_rng(seed)
    cfg = jheaders.HevcConfig(width=64, height=48, qp=30, log2_ctb=4,
                              log2_min_cb=3, log2_max_tb=4,
                              deblocking_disabled=not deblock)
    w = jheaders.write_slice_header(cfg, jbs.NAL_IDR_W_RADL,
                                    sao_flags=False)
    enc = jcabac.CabacEncoder(w, jctx.init_states(jctx.I, cfg.qp))
    st = jqc.State(64, 48, 4)
    pcm_out = {}

    def levels(n):
        lv = rng.integers(-3, 4, (n, n)) * (rng.random((n, n)) < 0.3)
        lv[0, 0] = lv[0, 0] or 1
        return lv.astype(np.int32)

    def tb(lv, log2, stype, is_luma):
        if log2 == 2:
            enc.encode_bin(jctx.off("transform_skip", 0 if is_luma else 1),
                           int(rng.integers(0, 2)))
        jres.encode_residual(enc, lv, log2, stype, is_luma)

    n_ctb = 4 * 3
    for i in range(n_ctb):
        cx, cy = (i % 4) * 16, (i // 4) * 16
        enc.encode_bin(jctx.off("split_cu_flag", st.split_ctx(cx, cy, 0)),
                       1)
        for q in range(4):
            x, y = cx + (q & 1) * 8, cy + (q >> 1) * 8
            kind = ("pcm", "nxn", "2n")[int(rng.integers(0, 3))]
            if kind == "pcm":
                enc.encode_bin(jctx.off("part_size"), 1)
                enc.encode_terminate(1)                # pcm_flag
                if w.num_bits() & 7:                   # pcm_alignment_zero
                    w.write(0, 8 - (w.num_bits() & 7))
                bl, bc = pcm_bd
                sam = (rng.integers(0, 1 << bl, (8, 8)),
                       rng.integers(0, 1 << bc, (4, 4)),
                       rng.integers(0, 1 << bc, (4, 4)))
                for plane, bd in zip(sam, (bl, bc, bc)):
                    for v in plane.reshape(-1):
                        w.write(int(v), bd)
                pcm_out[(x, y)] = (sam[0] << (8 - bl), sam[1] << (8 - bc),
                                   sam[2] << (8 - bc))
                enc = jcabac.CabacEncoder(w, enc.states)   # restart
                cu = jqc.CuInfo(x, y, 8, 1, False, [DC])
                jqc._set_pu_mode(st, cu, 0)        # neighbours read DC
                st.serial += 1
                st.set_cu(cu, st.serial)
                continue
            nxn = kind == "nxn"
            modes = [int(m) for m in rng.integers(0, 35, 4 if nxn else 1)]
            cu = jqc.CuInfo(x, y, 8, 1, nxn, modes)
            enc.encode_bin(jctx.off("part_size"), 0 if nxn else 1)
            if not nxn:
                enc.encode_terminate(0)                # pcm_flag
            flags = []
            for p in range(len(modes)):
                px, py = x + (p & 1) * 4 * nxn, y + (p >> 1) * 4 * nxn
                mpm = st.mpm(px, py)
                flags.append((modes[p] in mpm, mpm, modes[p]))
                enc.encode_bin(jctx.off("prev_intra_luma_pred"),
                               int(modes[p] in mpm))
                jqc._set_pu_mode(st, cu, p)
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
            enc.encode_bin(jctx.off("chroma_pred_mode"), 0)        # DM
            cbf_c = [int(rng.integers(0, 2)) for _ in range(2)]
            for c in cbf_c:
                enc.encode_bin(jctx.off("cbf_chroma", 0), c)
            for p in range(4 if nxn else 1):
                cbf = int(rng.integers(0, 2))
                enc.encode_bin(jctx.off("cbf_luma", 0 if nxn else 1), cbf)
                if cbf:
                    log2 = 2 if nxn else 3
                    tb(levels(1 << log2), log2,
                       rom.intra_scan_type(log2, modes[p], True), True)
            cst = rom.intra_scan_type(2, modes[0], False)
            for c in cbf_c:
                if c:
                    tb(levels(4), 2, cst, False)
            st.serial += 1
            st.set_cu(cu, st.serial)
        enc.encode_terminate(1 if i == n_ctb - 1 else 0)
    enc.finish_slice()
    stream = jbs.annexb([
        jbs.nal_unit(jbs.NAL_VPS, jheaders.write_vps(cfg)),
        jbs.nal_unit(jbs.NAL_SPS, _sps(cfg, pcm=(*pcm_bd, 3, 3))),
        jbs.nal_unit(jbs.NAL_PPS, _pps(cfg, ts=True)),
        jbs.nal_unit(jbs.NAL_IDR_W_RADL, w.data())])
    return stream, pcm_out


def test_pcm_and_transform_skip_decode_equal():
    """The streams written here (PCM at 8 / 8, 7 / 5 and 8 / 6 bits, the
    last deblocked) decode to equal pictures in both decoders; without
    the deblock, every PCM CU holds its samples shifted up to 8 bits."""
    for seed, pcm_bd, deblock in ((0, (8, 8), False), (1, (7, 5), False),
                                  (2, (8, 6), True)):
        _pcm_and_transform_skip(seed, pcm_bd, deblock)


def _pcm_and_transform_skip(seed, pcm_bd, deblock):
    stream, pcm = _pcm_ts_stream(seed, pcm_bd, deblock)
    assert pcm
    pics, _ = _both(stream)
    (y, u, v), = pics
    if not deblock:
        for (x, yy), (sy, su, sv) in pcm.items():
            np.testing.assert_array_equal(y[yy:yy + 8, x:x + 8], sy)
            np.testing.assert_array_equal(u[yy // 2:yy // 2 + 4,
                                            x // 2:x // 2 + 4], su)
            np.testing.assert_array_equal(v[yy // 2:yy // 2 + 4,
                                            x // 2:x // 2 + 4], sv)
