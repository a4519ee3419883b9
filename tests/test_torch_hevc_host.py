"""The port's own HEVC intra host stack against the JAX package's.

The port carries a copy of the reference's HEVC host code (spec tables,
CABAC engine and contexts, residual coding, parameter sets and slice
headers, the intra and quadtree syntax writers and decoders, the native
C++ quadtree serializer) so that it imports nothing of
`video_codecs_tpu`.  These tests hold the copy to the original: source
text function by function (the device functions the port rewrote for
torch keep the original's name and carry its line), then bytes, levels
and decoded pictures on seeded inputs, with tolerance 0.
"""

import ast
import pathlib
import re

import numpy as np
import pytest

from video_codecs_tpu.entropy import bitstream as jbs
from video_codecs_tpu.entropy import cabac as jcabac
from video_codecs_tpu.entropy import ctx as jctx
from video_codecs_tpu.entropy import residual as jres
from video_codecs_tpu.models.hevc import headers as jheaders
from video_codecs_tpu.models.hevc import intra_codec as jic
from video_codecs_tpu.models.hevc import quadtree_codec as jqc
from video_codecs_tpu_torch.entropy import bitstream as tbs
from video_codecs_tpu_torch.entropy import cabac as tcabac
from video_codecs_tpu_torch.entropy import ctx as tctx
from video_codecs_tpu_torch.entropy import native as tnative
from video_codecs_tpu_torch.entropy import residual as tres
from video_codecs_tpu_torch.models.hevc import headers as theaders
from video_codecs_tpu_torch.models.hevc import intra_codec as tic
from video_codecs_tpu_torch.models.hevc import quadtree_codec as tqc
from video_codecs_tpu_torch.ops import quant as tquant

REPO = pathlib.Path(__file__).resolve().parents[1]

# port module -> (original module, functions whose text the port changed
# (the branches behind options it rejects were cut, or host-only
# plumbing changed), device functions rewritten for torch under the
# original's name, functions only the port has).  Every other function
# and method must be the original's text exactly.
_COPIES = {
    "utils/rom.py": ("utils/rom.py", set(), set(), set()),
    "entropy/cabac.py": ("entropy/cabac.py", set(), set(), set()),
    "entropy/ctx.py": ("entropy/ctx.py", set(), set(), set()),
    "entropy/residual.py": ("entropy/residual.py", set(), set(), set()),
    "entropy/native.py": ("entropy/native.py",
                          {"_load", "encode_slice_native",
                           "encode_slice_qt_native"}, set(), set()),
    "models/hevc/headers.py": ("models/hevc/headers.py", set(), set(),
                               set()),
    "ops/transform.py": ("ops/transform.py", set(),
                         {"_stage", "forward_transform", "inverse_transform"},
                         set()),
    "ops/quant.py": ("ops/quant.py", {"apply_sbh_np"},
                     {"quantize", "dequantize", "rdoq_lite", "_sbh_fix_cgs",
                      "apply_sbh", "apply_sbh_scan"},
                     {"fma32", "log_xla", "log2_xla", "log_1p_tables"}),
    "ops/intra.py": ("ops/intra.py", set(),
                     {"substitute_unavailable", "smooth_reference",
                      "predict_intra", "use_filtered_ref"}, {"_weights_dev"}),
    "ops/deblock.py": ("ops/deblock.py", set(),
                       {"_filter_ver_edges_luma", "_filter_ver_edges_chroma",
                        "deblock_420", "deblock_420_np", "deblock_420_bs",
                        "deblock_420_bs_np"},
                       {"_edge_qps"}),
    "ops/rdoq.py": ("ops/rdoq.py", set(), set(), set()),
    "ops/rdoq_dev.py": ("ops/rdoq_jax.py", set(),
                        {"_tables_dev", "_floor_log2", "_rate_level_dev",
                         "rdoq_dev"}, {"_seq_sum", "_row_sum", "_cumsum",
                                       "_quant_params", "_quant_scalars",
                                       "_kernel_scalars", "rdoq_dev_ref",
                                       "build", "_load", "_kernel_tables"}),
    "models/hevc/encoder_dev.py": ("models/hevc/encoder_jax.py", set(),
                                   {"gather_refs", "_extract_blocks",
                                    "decide_modes_device", "_code_blocks",
                                    "_code_blocks_rate",
                                    "_predict_single_mode",
                                    "encode_frame_device"},
                                   {"encode_frame", "_put_blocks",
                                    "_tile_schedule", "_proxy_sum",
                                    "encode_frame_device_ref",
                                    "flat_lambdas"}),
    "models/hevc/encoder_qt_dev.py": (
        "models/hevc/encoder_jax_qt.py", set(),
        {"z_index_dev", "gather_refs_z", "_grid", "_mode_sweep",
         "_level_rate_bits", "_trial_cost", "_sum2x2", "decide_qt_device",
         "_scatter", "_scan_type_dev", "_code_tb_batch",
         "encode_frame_qt_device", "bs_maps_from_depth"},
        {"_pad_edge", "encode_frame_qt", "encode_frame_qt_device_ref"}),
    "models/hevc/intra_codec.py": (
        "models/hevc/intra_codec.py",
        {"code_tb_np", "IntraEncoder.__init__", "IntraEncoder.encode_frame",
         "IntraEncoder._sao_decide_apply", "IntraEncoder._encode_slice",
         "IntraEncoder._encode_slice_wpp", "IntraEncoder._encode_ctu",
         "IntraDecoder.decode",
         "IntraEncoder.encode_frame_fast", "IntraEncoder.serialize_frame",
         "IntraEncoder.encode_sequence", "IntraDecoder._decode_slice",
         "IntraDecoder._decode_slice_wpp", "IntraDecoder._decode_ctu"},
        {"IntraEncoder.decide_modes"},
        {"IntraEncoder._dispatch", "IntraEncoder._encode_frame_host",
         "entry_point_offsets", "substream_starts"}),
    "ops/interp.py": (
        "ops/interp.py", set(),
        {"_taps_dev", "mc_luma", "mc_chroma", "_gather_window_multi",
         "_mc_luma14_core", "mc_luma14_multi", "mc_luma_multi",
         "_mc_chroma14_core", "mc_chroma14_multi", "mc_chroma_multi",
         "bi_average", "mc_luma_np", "mc_chroma_np", "_mc_luma14_np",
         "_mc_chroma14_np"},
        {"gather_window", "_filter2", "_inter_pred", "mc_luma14_multi_ref",
         "mc_chroma14_multi_ref", "bi_average_ref"}),
    "ops/me.py": ("ops/me.py", set(),
                  {"integer_search", "_sad_at_points", "tz_search",
                   "_sad_best_around", "_pool4", "pyramid_search",
                   "_refine", "motion_search"},
                  {"_u8", "_span_offsets", "_pick"}),
    "models/hevc/inter_dev.py": (
        "models/hevc/inter_jax.py",
        {"_device_b_frame", "DeviceHierarchicalBEncoder.__init__",
         "DeviceHierarchicalBEncoder.encode_frame",
         "DeviceRandomAccessEncoder.__init__",
         "DeviceRandomAccessEncoder.encode_frame"},
        {"scale_mv_dev", "mvd_bits_dev", "_shift_grid", "_scatter_blocks",
         "_intra_wavefront", "encode_p_frame_dev", "b_me_one",
         "encode_b_frame_dev", "DeviceLowDelayEncoder.__init__",
         "DeviceLowDelayEncoder.encode_p_frame",
         "DeviceLowDelayEncoder.encode_frame"},
        {"_i32", "_round_cost", "_round_const", "_persum", "_sum2x2",
         "_to4", "_from4", "_ssef", "DeviceLowDelayEncoder._device_phase",
         "bs_maps_b_dev", "_check_flat_b", "_b_device_phase",
         "_intra_wavefront_ref"}),
    "models/hevc/motion.py": ("models/hevc/motion.py", {"amvp_candidates"},
                              set(), set()),
    "models/hevc/motion_hm.py": ("models/hevc/motion_hm.py", set(), set(),
                                 set()),
    "models/hevc/inter_codec.py": (
        "models/hevc/inter_codec.py",
        {"LowDelayEncoder.__init__", "LowDelayEncoder.encode_frames",
         "LowDelayDecoder.decode", "LowDelayDecoder._store", "LowDelayDecoder._decode_p_slice",
         "LowDelayDecoder._decode_p_ctu"},
        {"LowDelayEncoder.encode_p_frame", "_satd8"},
        {"LowDelayEncoder._p_pass1", "LowDelayEncoder._p_raster",
         "LowDelayEncoder._p_deblock"}),
    "models/hevc/checkpoint.py": ("models/hevc/checkpoint.py", set(), set(),
                                  set()),
    "models/hevc/bframe_codec.py": (
        "models/hevc/bframe_codec.py",
        {"HierarchicalBDecoder.decode", "HierarchicalBDecoder._decode_b_slice"},
        {"HierarchicalBEncoder._encode_b_frame"},
        {"check_flat_b", "HierarchicalBEncoder.__init__",
         "HierarchicalBEncoder._b_raster"}),
    "models/hevc/ra_codec.py": ("models/hevc/ra_codec.py",
                                {"RandomAccessEncoder.__init__",
                                 "RandomAccessDecoder.decode",
                                 "RandomAccessDecoder._decode_b_body"},
                                set(), set()),
    "models/hevc/inter_qt.py": (
        "models/hevc/inter_qt.py",
        {"QtDeviceRandomAccessEncoder.__init__",
         "QtDeviceRandomAccessEncoder._encode_b_frame",
         "QtDeviceRandomAccessEncoder._tmvp_fields",
         "QtDeviceRandomAccessEncoder._device_phase",
         "QtDeviceRandomAccessEncoder._sao_decide_qt"},
        {"_sse_blocks", "_coef_bits_blocks", "_pred_cand", "qt_merge_dev"},
        {"_sao_stats", "deblock_maps"}),
    "models/hevc/decoder.py": (
        "models/hevc/decoder.py",
        {"GeneralDecoder._decode_slice_segment", "GeneralDecoder._parse_mvd"},
        set(), set()),
    "ops/sao.py": ("ops/sao.py", set(), set(),
                   {"build", "_load", "sao_stats_ref", "sao_stats",
                    "apply_ctus"}),
    "models/hevc/quadtree_codec.py": (
        "models/hevc/quadtree_codec.py",
        {"QuadtreeFastEncoder.__init__", "QuadtreeFastEncoder._dispatch",
         "QuadtreeFastEncoder.serialize_frame",
         "QuadtreeFastEncoder._serialize_slice",
         "QuadtreeFastEncoder.encode_sequence", "code_tb",
         "QuadtreeIntraEncoder.__init__", "QuadtreeIntraEncoder.encode_frame"},
        {"QuadtreeIntraEncoder._best_mode"}, set()),
    "parallel/tiles.py": ("parallel/tiles.py", set(),
                          {"encode_frame_tiles", "encode_sequence_tiles"},
                          {"encode_tiles_dev"}),
    "utils/debug.py": ("utils/debug.py", set(), set(), set()),
}


def _defs(path):
    """Qualified name -> (first line incl. decorators, source text) of
    the module-level functions and the methods of module-level classes."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef):
            subs = [(f"{node.name}.{s.name}", s) for s in node.body
                    if isinstance(s, ast.FunctionDef)]
        elif isinstance(node, ast.FunctionDef):
            subs = [(node.name, node)]
        else:
            continue
        for name, fn in subs:
            first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
            out[name] = (first, ast.get_source_segment(text, fn))
    return out, text.split("\n")


@pytest.mark.parametrize("mod", sorted(_COPIES))
def test_copy_matches_original_source(mod):
    orig_mod, trimmed, rewritten, added = _COPIES[mod]
    port, lines = _defs(REPO / "video_codecs_tpu_torch" / mod)
    orig, _ = _defs(REPO / "video_codecs_tpu" / orig_mod)
    tag = re.compile(r"#\s*video_codecs_tpu/" + re.escape(orig_mod) +
                     r":(\d+)$")
    assert added <= set(port)
    assert (trimmed | rewritten) <= set(port)
    for name, (first, src) in port.items():
        if name in added:
            continue
        assert name in orig, f"{mod}: {name} has no original"
        m = tag.search(lines[first - 2].strip())
        assert m, f"{mod}: {name} lacks its provenance comment"
        assert int(m.group(1)) == orig[name][0], f"{mod}: {name} line"
        if name not in trimmed and name not in rewritten:
            assert src == orig[name][1], f"{mod}: {name} differs"


def test_native_source_is_a_byte_copy():
    assert (REPO / "video_codecs_tpu_torch/csrc/cabac_enc.cpp").read_bytes() \
        == (REPO / "csrc/cabac_enc.cpp").read_bytes()


# ---- CABAC engine and residual coding ------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cabac_roundtrip_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    qp = int(rng.integers(22, 38))
    ops = []
    for _ in range(3000):
        k = int(rng.integers(0, 10))
        if k < 7:
            ops.append(("bin", int(rng.integers(0, len(tctx.init_states(
                tctx.I, qp)))), int(rng.random() < 0.3)))
        elif k < 9:
            ops.append(("bypass", int(rng.integers(0, 2))))
        else:
            ops.append(("bins", int(rng.integers(0, 32)), 5))
    ops.append(("term", 1))
    outs = []
    for cab, bsm, cx in ((tcabac, tbs, tctx), (jcabac, jbs, jctx)):
        w = bsm.BitWriter()
        enc = cab.CabacEncoder(w, cx.init_states(cx.I, qp))
        for op in ops:
            if op[0] == "bin":
                enc.encode_bin(op[1], op[2])
            elif op[0] == "bypass":
                enc.encode_bypass(op[1])
            elif op[0] == "bins":
                enc.encode_bypass_bins(op[1], op[2])
            else:
                enc.encode_terminate(op[1])
        enc.finish_slice()
        outs.append(w.data())
    assert outs[0] == outs[1]
    dec = tcabac.CabacDecoder(tbs.BitReader(outs[0]),
                              tctx.init_states(tctx.I, qp))
    for op in ops:
        if op[0] == "bin":
            assert dec.decode_bin(op[1]) == op[2]
        elif op[0] == "bypass":
            assert dec.decode_bypass() == op[1]
        elif op[0] == "bins":
            assert dec.decode_bypass_bins(op[2]) == op[1]
        else:
            assert dec.decode_terminate() == op[1]


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_residual_coding_equal(log2):
    rng = np.random.default_rng(40 + log2)
    n = 1 << log2
    blocks = []
    for i in range(12):
        lv = np.where(rng.random((n, n)) < 0.25,
                      rng.integers(-12, 13, (n, n)), 0).astype(np.int32)
        lv[0, 0] = 1 + i
        st, sbh = int(rng.integers(0, 3)) if log2 < 4 else 0, bool(i % 3)
        if sbh:         # the writer wants the parity prepared
            lv = tquant.apply_sbh_np(lv, log2, scan_type=st)
        blocks.append((lv, st, bool(i % 2), sbh))
    outs = []
    for cab, bsm, cx, res in ((tcabac, tbs, tctx, tres),
                              (jcabac, jbs, jctx, jres)):
        w = bsm.BitWriter()
        enc = cab.CabacEncoder(w, cx.init_states(cx.I, 32))
        for lv, st, luma, sbh in blocks:
            res.encode_residual(enc, lv, log2, st, luma, sign_hiding=sbh)
        enc.encode_terminate(1)
        enc.finish_slice()
        outs.append(w.data())
    assert outs[0] == outs[1]
    dec = tcabac.CabacDecoder(tbs.BitReader(outs[0]),
                              tctx.init_states(tctx.I, 32))
    for lv, st, luma, sbh in blocks:
        got = tres.decode_residual(dec, log2, st, luma, sign_hiding=sbh)
        np.testing.assert_array_equal(got, lv)


# ---- parameter sets and slice headers ------------------------------------

_HDR_CFGS = [dict(width=96, height=64, qp=30, log2_ctb=5, log2_min_cb=3,
                  log2_max_tb=5, sign_data_hiding=True, rdoq="lite"),
             dict(width=1920, height=1072, qp=32, log2_ctb=5, log2_min_cb=3,
                  log2_max_tb=5, sign_data_hiding=True, rdoq="lite"),
             dict(width=416, height=240, qp=27),
             dict(width=80, height=48, qp=37, deblocking_disabled=True,
                  sao=True, hash_sei=False)]


@pytest.mark.parametrize("kw", _HDR_CFGS, ids=lambda k: f"{k['width']}x"
                         f"{k['height']}-qp{k['qp']}")
def test_header_nals_equal(kw):
    tcfg, jcfg = theaders.HevcConfig(**kw), jheaders.HevcConfig(**kw)
    for fn in ("write_vps", "write_sps", "write_pps"):
        assert getattr(theaders, fn)(tcfg) == getattr(jheaders, fn)(jcfg)
    for sao in (None, False):
        a = theaders.write_slice_header(tcfg, tbs.NAL_IDR_W_RADL,
                                        sao_flags=sao)
        b = jheaders.write_slice_header(jcfg, jbs.NAL_IDR_W_RADL,
                                        sao_flags=sao)
        assert a.data() == b.data()
    sps = theaders.parse_sps(theaders.write_sps(tcfg))
    assert vars(sps) == vars(jheaders.parse_sps(jheaders.write_sps(jcfg)))
    pps = theaders.parse_pps(theaders.write_pps(tcfg))
    assert vars(pps) == vars(jheaders.parse_pps(jheaders.write_pps(jcfg)))
    enc = tqc.QuadtreeFastEncoder.__new__(tqc.QuadtreeFastEncoder)
    enc.cfg = tcfg
    jenc = jqc.QuadtreeFastEncoder.__new__(jqc.QuadtreeFastEncoder)
    jenc.cfg = jcfg
    assert enc.stream_headers() == jenc.stream_headers()
    planes = [np.full((8, 8), 7, np.int32)] * 3
    assert enc._hash_sei(*planes) == jenc._hash_sei(*planes)


# ---- quadtree serializers ------------------------------------------------

def _random_state(w, h, seed):
    """A seeded quadtree state dict in the device encoder's layout: a
    depth map that respects the boundary splits, modes on every grid and
    sparse level planes."""
    rng = np.random.default_rng(seed)
    pw, ph = -(-w // 32) * 32, -(-h // 32) * 32
    d32 = rng.integers(0, 3, (ph // 32, pw // 32))
    depth8 = np.repeat(np.repeat(d32, 4, 0), 4, 1).astype(np.int8)
    d16 = rng.integers(1, 3, (ph // 16, pw // 16))
    up16 = np.repeat(np.repeat(d16, 2, 0), 2, 1)
    depth8 = np.where(depth8 == 0, 0, up16).astype(np.int8)
    for y8 in range(ph // 8):
        for x8 in range(pw // 8):
            d = int(depth8[y8, x8])
            size = 32 >> d
            x0, y0 = (x8 * 8) // size * size, (y8 * 8) // size * size
            if x0 + size > w or y0 + size > h:
                depth8[y8, x8] = 2 if size == 16 else max(d, 1)
    # re-derive: a 32 that does not fit splits, a 16 that does not fit
    # splits to 8s
    for y8 in range(ph // 8):
        for x8 in range(pw // 8):
            x, y = x8 * 8, y8 * 8
            if depth8[y8, x8] == 0 and (x // 32 * 32 + 32 > w or
                                        y // 32 * 32 + 32 > h):
                depth8[y8, x8] = 1
            if depth8[y8, x8] == 1 and (x // 16 * 16 + 16 > w or
                                        y // 16 * 16 + 16 > h):
                depth8[y8, x8] = 2

    def lv(shape, p):
        return np.where(rng.random(shape) < p,
                        rng.integers(-20, 21, shape), 0).astype(np.int16)

    return dict(depth8=depth8,
                m8=rng.integers(0, 35, (ph // 8, pw // 8)).astype(np.int8),
                m16=rng.integers(0, 35, (ph // 16, pw // 16)).astype(np.int8),
                m32=rng.integers(0, 35, (ph // 32, pw // 32)).astype(np.int8),
                coef_y=lv((h, w), 0.08), coef_u=lv((h // 2, w // 2), 0.05),
                coef_v=lv((h // 2, w // 2), 0.05))


@pytest.mark.parametrize("w,h,qp,source", [(96, 64, 32, "encoder"),
                                            (80, 48, 30, "encoder"),
                                            (80, 48, 27, "random"),
                                            (96, 64, 35, "random")])
def test_qt_serializers_give_reference_bytes(w, h, qp, source):
    """The port's native and Python quadtree serializers against the JAX
    package's Python serializer, for the same state dict: the port's
    encoder's (CPU, sign-data hiding on), or a random one (hiding off, as
    its levels have no prepared parity)."""
    sbh = source == "encoder"
    kw = dict(width=w, height=h, qp=qp, log2_ctb=5, log2_min_cb=3,
              log2_max_tb=5, sign_data_hiding=sbh, rdoq="lite")
    tcfg, jcfg = theaders.HevcConfig(**kw), jheaders.HevcConfig(**kw)
    if sbh:
        rng = np.random.default_rng(w + qp)
        yy, xx = np.mgrid[0:h, 0:w]
        y = np.clip(128 + 50 * np.sin(xx / 6.0) * np.cos(yy / 9.0) +
                    rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
        enc = tqc.QuadtreeFastEncoder(tcfg, device="cpu")
        st = {k: a.numpy() for k, a in enc._dispatch(
            y, y[::2, ::2] // 2 + 64, y[1::2, ::2] // 2 + 32).items()}
    else:
        st = _random_state(w, h, seed=w + qp)
    keys = ("depth8", "m8", "m16", "m32", "coef_y", "coef_u", "coef_v")
    want = jqc.encode_slice_qt(jcfg, jqc.build_qt_tree(
        jcfg, *(st[k] for k in keys)))
    py = tqc.encode_slice_qt(tcfg, tqc.build_qt_tree(
        tcfg, *(st[k] for k in keys)))
    assert py == want
    enc = tqc.QuadtreeFastEncoder(tcfg, device="cpu")
    assert enc._serialize_slice(st) == want
    h0 = tbs.NAL_IDR_W_RADL << 1
    assert bytes([h0, 1]) + tnative.encode_slice_qt_native(tcfg, st) == want


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "cabac_enc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError):
        tnative._load()


# ---- decoding the JAX package's streams ----------------------------------

def test_port_decoder_decodes_reference_streams():
    """The reference's host RD quadtree encoder (CUs down to 8x8 with
    NxN 4x4 PUs and DST) and its device quadtree encoder's serializer:
    the port's QuadtreeIntraDecoder decodes both with hash OK and the
    reference's pictures.  Deblocking is off here: the reference runs
    its deblocking eagerly, ~10 s a picture on the CPU, and the port's
    decoder deblocks in tests/test_torch_hevc_intra.py."""
    rng = np.random.default_rng(17)
    w, h = 64, 32
    yy, xx = np.mgrid[0:h, 0:w]
    # stripes whose direction changes every 4 samples: some 8x8 CUs code
    # as four 4x4 PUs at QP 22
    y = (128 + 90 * np.sign(np.sin((xx * ((yy // 4) % 3 + 1) +
                                    yy * ((xx // 4) % 2)) / 1.3))
         ).clip(0, 255).astype(np.uint8)
    u = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
    cfg = jheaders.HevcConfig(width=w, height=h, qp=22, log2_ctb=5,
                              log2_min_cb=3, log2_max_tb=5,
                              sign_data_hiding=True, rdoq="lite",
                              deblocking_disabled=True)
    enc = jqc.QuadtreeIntraEncoder(cfg)
    leaves = []
    serialize = enc._encode_slice_qt

    def spy(roots):
        leaves.extend(jqc.dump_mode_statistics(roots, cfg.log2_ctb))
        return serialize(roots)

    enc._encode_slice_qt = spy
    nals = jic.IntraEncoder(cfg).stream_headers()
    frame_nals, rec = enc.encode_frame(y, u, v)
    assert any("PartSize=NxN" in line for line in leaves), leaves
    stream = jbs.annexb(nals + frame_nals)
    dec = tqc.QuadtreeIntraDecoder()
    out = dec.decode(stream)
    assert dec.hash_status == [True]
    for a, b in zip(out[0], rec):
        np.testing.assert_array_equal(a, np.asarray(b))

    # a device-quadtree stream of the reference, from a random state dict
    w, h = 80, 48
    kw = dict(width=w, height=h, qp=30, log2_ctb=5, log2_min_cb=3,
              log2_max_tb=5, sign_data_hiding=False, rdoq="lite",
              deblocking_disabled=True)
    jcfg = jheaders.HevcConfig(**kw)
    st = _random_state(w, h, seed=5)
    keys = ("depth8", "m8", "m16", "m32", "coef_y", "coef_u", "coef_v")
    slice_nal = jqc.encode_slice_qt(jcfg, jqc.build_qt_tree(
        jcfg, *(st[k] for k in keys)))
    jdec = jqc.QuadtreeIntraDecoder()
    want = jdec.decode(jbs.annexb(
        jic.IntraEncoder(jcfg).stream_headers() + [slice_nal]))
    got = tqc.QuadtreeIntraDecoder().decode(jbs.annexb(
        jic.IntraEncoder(jcfg).stream_headers() + [slice_nal]))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
