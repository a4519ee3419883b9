"""The intra reconstruction wavefront kernels (csrc/intra_wavefront.cu).

`encoder_qt_dev.encode_frame_qt_device`, `encoder_dev.encode_frame_device`
and `inter_dev._intra_wavefront` launch the hand-written Hopper kernels of
`ops/intra_wavefront.py` for CUDA tensors and run their plain versions
(`..._ref`) for CPU tensors.

On the CPU:
  - the order the kernels rely on: one CTB's whole Z order at a time
    (quadtree) and one 16x16 block at a time on a flat diagonal, written
    as a plain torch loop, equals the JAX package's wavefronts fed the
    same decision maps (`encode_frame_qt_jit` / `encode_frame_jit`, the
    programs tests/test_torch_hevc_intra.py and tests/test_torch_hevc_ldp.py
    compile), and the port's plain version on a 2-tile stack;
  - CPU tensors run the plain versions and launch nothing;
  - a build failure raises; the table buffer's layout is the kernel
    source's, and the RDOQ-lite lambdas are `quant.rdoq_lite`'s;
  - the wrapper's device tables are cached per card and lambda value, and
    `_intra_wavefront`'s CUDA branch reads nothing back to the host.
On the card (`cuda`, skipped here) each kernel equals its plain version on
the same CUDA tensors, max abs error 0, in one launch per call: picture
edges that are not multiples of 32, all 35 modes at every CU size, SBH
and RDOQ-lite on and off, a 2-tile stack, P pictures with a sparse, an
empty and a full intra grid, one-unit pictures, one-CTB rows and columns,
and 1080p pictures whose units outnumber the resident CTAs (the ticket
order's forward progress):

    python -m pytest --noconftest -m cuda tests/test_torch_intra_wavefront.py

JAX is imported only inside the CPU tests that compare with it, so the
`cuda` cases run where JAX is not installed.  Tolerance 0 throughout.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from video_codecs_tpu_torch.models.hevc import encoder_dev as ted
from video_codecs_tpu_torch.models.hevc import encoder_qt_dev as tqt
from video_codecs_tpu_torch.models.hevc import inter_dev as tinter
from video_codecs_tpu_torch.models.hevc.intra_codec import chroma_qp
from video_codecs_tpu_torch.ops import deblock as tdbk
from video_codecs_tpu_torch.ops import intra as tintra
from video_codecs_tpu_torch.ops import intra_wavefront as iw
from video_codecs_tpu_torch.ops import quant as tquant
from video_codecs_tpu_torch.ops import sad_surface as tss
from video_codecs_tpu_torch.utils import rom

torch.set_grad_enabled(False)
REPO = Path(__file__).resolve().parents[1]


def synth(w, h, seed):
    """Seeded 4:2:0 planes (tests/test_torch_hevc_intra.py's picture):
    waves and a ramp, a flat object and mild noise, so the quadtree
    mixes 32, 16 and 8 CUs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 7.0 + seed) * np.cos(yy / 11.0)
            + 0.8 * (xx - yy))
    base[h // 3:h // 2, w // 4:w // 2] = 200
    y = np.clip(base + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(y[::2, ::2] // 2 + 64 + rng.normal(0, 3, (h // 2, w // 2)),
                0, 255).astype(np.uint8)
    v = np.clip(y[1::2, ::2] // 2 + 32 + rng.normal(0, 3, (h // 2, w // 2)),
                0, 255).astype(np.uint8)
    return y, u, v


def _padded(planes, w, h, device="cpu"):
    pw, ph = tqt._ceil_to(w, 32), tqt._ceil_to(h, 32)
    y, u, v = (torch.from_numpy(p).to(device) for p in planes)
    return (tqt._pad_edge(y, ph, pw), tqt._pad_edge(u, ph // 2, pw // 2),
            tqt._pad_edge(v, ph // 2, pw // 2))


def _equal(got: dict, want: dict, what):
    assert set(got) == set(want), what
    bad = {k: int((got[k].cpu() != want[k].cpu()).sum()) for k in want
           if not torch.equal(got[k].cpu(), want[k].cpu())}
    assert not bad, (what, bad)


# ---- the CTB-major order, as plain torch loops -----------------------------

def ctb_major_qt(y, u, v, depth8, m8, m16, m32, qp, qp_c, w, h, sbh, rdoq):
    """`encode_frame_qt_device` with each CTB of a diagonal coded alone,
    its CUs in Z order, one CU at a time (the kernel's order)."""
    ph, pw = y.shape
    st = {k: torch.zeros(((ph, pw) if k[-1] == "y" else (ph // 2, pw // 2)),
                         dtype=torch.int32)
          for k in ("rec_y", "rec_u", "rec_v", "coef_y", "coef_u", "coef_v")}
    depth = depth8.numpy()
    coords, valid, steps, _ = ted._wavefront_schedule(pw // 32, ph // 32)

    def code_cu(x, yy, n, mode_map, want):
        if x >= w or yy >= h or depth[yy // 8, x // 8] != want:
            return
        xs = torch.tensor([x], dtype=torch.int32)
        ys = torch.tensor([yy], dtype=torch.int32)
        log2 = n.bit_length() - 1
        modes = mode_map[yy // n, x // n].reshape(1).int()
        refs = tqt.gather_refs_z(st["rec_y"], xs, ys, n, 5, w, h)
        pred = tintra.predict_intra(refs, modes[:, None], log2)[:, 0]
        oblk = ted._extract_blocks(y, xs, ys, n)
        scan_t = tqt._scan_type_dev(modes) if log2 == 3 else None
        lv, rec = tqt._code_tb_batch(oblk, pred, qp, log2, sbh, rdoq, scan_t)
        tqt._scatter(st["rec_y"], rec, xs, ys, n)
        tqt._scatter(st["coef_y"], lv, xs, ys, n)
        cs = max(n // 2, 4)
        clog2 = cs.bit_length() - 1
        cscan = tqt._scan_type_dev(modes) if clog2 == 2 else None
        for orig, rk, ck in ((u, "rec_u", "coef_u"), (v, "rec_v", "coef_v")):
            refc = tqt.gather_refs_z(st[rk], xs // 2, ys // 2, cs, 4, w // 2,
                                     h // 2)
            predc = tintra.predict_intra(refc, modes[:, None], clog2,
                                         is_luma=False)[:, 0]
            oc = ted._extract_blocks(orig, xs // 2, ys // 2, cs)
            lvc, recc = tqt._code_tb_batch(oc, predc, qp_c, clog2, sbh, rdoq,
                                           cscan)
            tqt._scatter(st[rk], recc, xs // 2, ys // 2, cs)
            tqt._scatter(st[ck], lvc, xs // 2, ys // 2, cs)

    for d in range(steps):
        for cx, cy in coords[d][valid[d]]:
            x0, y0 = int(cx) * 32, int(cy) * 32
            code_cu(x0, y0, 32, m32, 0)
            for q in range(4):
                qx, qy = x0 + (q & 1) * 16, y0 + (q >> 1) * 16
                code_cu(qx, qy, 16, m16, 1)
                for s in range(4):
                    code_cu(qx + (s & 1) * 8, qy + (s >> 1) * 8, 8, m8, 2)
    return st


def block_major_flat(y, u, v, modes, qp, qp_c, bw, bh, sbh, rdoq):
    """`encode_frame_device` with each 16x16 block of a diagonal coded
    alone (the kernel's order); y [H, W] or a tile stack [T, H, W]."""
    nt = y.shape[0] if y.dim() == 3 else 0
    lead = (nt,) if nt else ()
    h, w = y.shape[-2:]
    b = bw * bh * max(nt, 1)
    st = dict(rec_y=torch.zeros(lead + (h, w), dtype=torch.int32),
              rec_u=torch.zeros(lead + (h // 2, w // 2), dtype=torch.int32),
              rec_v=torch.zeros(lead + (h // 2, w // 2), dtype=torch.int32),
              levels_y=torch.zeros((b, 16, 16), dtype=torch.int32),
              levels_cb=torch.zeros((b, 8, 8), dtype=torch.int32),
              levels_cr=torch.zeros((b, 8, 8), dtype=torch.int32),
              cbf=torch.zeros((3, b), dtype=torch.bool))
    coords, valid, steps, _ = ted._wavefront_schedule(bw, bh)
    modes_flat = modes.reshape(-1)
    planes = (("rec_y", "levels_y", y, 16, qp), ("rec_u", "levels_cb", u, 8,
                                                  qp_c),
              ("rec_v", "levels_cr", v, 8, qp_c))
    for d in range(steps):
        for t in range(max(nt, 1)):
            for bx, by in coords[d][valid[d]]:
                bidx = t * bw * bh + int(by) * bw + int(bx)
                tt = torch.tensor([t]) if nt else None
                for comp, (rk, lk, orig, n, qpp) in enumerate(planes):
                    x0 = torch.tensor([int(bx) * n], dtype=torch.int32)
                    y0 = torch.tensor([int(by) * n], dtype=torch.int32)
                    log2 = n.bit_length() - 1
                    refs = ted.gather_refs(st[rk], x0, y0, n, tt)
                    pred = ted._predict_single_mode(
                        refs, modes_flat[bidx].reshape(1), log2, comp == 0)
                    ob = ted._extract_blocks(orig, x0, y0, n, tt)
                    lv, rec, cbf = ted._code_blocks(ob, pred, qpp, log2,
                                                    sbh=sbh, rdoq=rdoq)
                    ted._put_blocks(st[rk], rec, x0, y0, n, tt)
                    st[lk][bidx] = lv[0]
                    st["cbf"][comp, bidx] = cbf[0]
    return st


def test_ctb_major_order_equals_jax_quadtree():
    """One CTB's whole Z order at a time, fed the JAX encoder's decision
    maps, gives the JAX wavefront's levels and (deblocked) recon: 80x48
    (partial CTBs at the right and bottom edges), QP 32, RDOQ-lite, SBH."""
    import jax

    from video_codecs_tpu.models.hevc import headers as jheaders
    from video_codecs_tpu.models.hevc import quadtree_codec as jqc

    w, h, qp = 80, 48, 32
    planes = synth(w, h, seed=w + h + qp)
    cfg = jheaders.HevcConfig(width=w, height=h, qp=qp, log2_ctb=5,
                              log2_min_cb=3, log2_max_tb=5,
                              sign_data_hiding=True, rdoq="lite")
    jst = {k: np.asarray(a) for k, a in jax.device_get(
        jqc.QuadtreeFastEncoder(cfg)._dispatch(*planes)).items()}
    maps = [torch.from_numpy(jst[k].astype(np.int32))
            for k in ("depth8", "m8", "m16", "m32")]
    assert len(np.unique(jst["depth8"][:h // 8, :w // 8])) >= 2
    yi, ui, vi = _padded(planes, w, h)
    st = ctb_major_qt(yi, ui, vi, *maps, qp, chroma_qp(qp), w, h, True,
                      True)
    for k, s in (("coef_y", 1), ("coef_u", 2), ("coef_v", 2)):
        np.testing.assert_array_equal(st[k][:h // s, :w // s].numpy(),
                                      jst[k], err_msg=k)
    bs_v, bs_h = tqt.bs_maps_from_depth(maps[0], w, h)
    rec = tdbk.deblock_420_bs(st["rec_y"][:h, :w],
                              st["rec_u"][:h // 2, :w // 2],
                              st["rec_v"][:h // 2, :w // 2], qp, bs_v, bs_h,
                              block=8)
    for got, key in zip(rec, ("rec_y", "rec_u", "rec_v")):
        np.testing.assert_array_equal(got.numpy(), jst[key], err_msg=key)
    # and the port's plain version on the same maps
    _equal(st, tqt.encode_frame_qt_device(yi, ui, vi, *maps, qp,
                                          chroma_qp(qp), w, h, True, True),
           "plain")


def test_block_major_order_equals_jax_flat():
    """One 16x16 block at a time on each diagonal, fed the JAX encoder's
    modes, gives `encode_frame_jit`'s levels, cbf and deblocked recon
    (96x64, QP 32, RDOQ-lite, SBH; tests/test_torch_hevc_ldp.py's IDR)."""
    from bench import synth_clip

    from video_codecs_tpu.models.hevc import encoder_jax as jenc

    w, h, qp = 96, 64, 32
    bw, bh = w // 16, h // 16
    y, u, v = synth_clip(w, h, 1)[0]
    want = {k: np.asarray(a) for k, a in jenc.encode_frame_jit(
        y, u, v, qp, bw, bh, deblock=True, sbh=True, rdoq=True).items()}
    modes = torch.from_numpy(want["modes"].astype(np.int32))
    yi, ui, vi = (torch.from_numpy(p.astype(np.int32)) for p in (y, u, v))
    st = block_major_flat(yi, ui, vi, modes, qp, chroma_qp(qp), bw, bh,
                          True, True)
    rec = tdbk.deblock_420(st["rec_y"], st["rec_u"], st["rec_v"], qp)
    for got, key in zip(rec, ("rec_y", "rec_u", "rec_v")):
        np.testing.assert_array_equal(got.numpy(), want[key], err_msg=key)
    for k in ("levels_y", "levels_cb", "levels_cr"):
        np.testing.assert_array_equal(st[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(st["cbf"].numpy(), want["cbf"])
    assert want["cbf"].any()


@pytest.mark.parametrize("sbh,rdoq", [(True, True), (False, False)])
def test_block_major_order_tile_stack(sbh, rdoq):
    """The same order on a stack of 2 tile columns (each its own picture
    edge) equals the plain version's diagonal batches."""
    w, h, qp, nt = 128, 64, 31, 2
    bw, bh = w // 16 // nt, h // 16

    def stack(p, n):
        return torch.from_numpy(p.astype(np.int32)).reshape(
            p.shape[0], nt, bw * n).transpose(0, 1).contiguous()

    y, u, v = synth(w, h, seed=21)
    yt, ut, vt = stack(y, 16), stack(u, 8), stack(v, 8)
    modes = ted.decide_modes_device(yt, qp, bw, bh)
    st = block_major_flat(yt, ut, vt, modes, qp, chroma_qp(qp), bw, bh, sbh,
                          rdoq)
    _equal(st, ted.encode_frame_device(yt, ut, vt, modes, qp, chroma_qp(qp),
                                       bw, bh, sbh=sbh, rdoq=rdoq), "tiles")


# ---- routing, build, tables ---------------------------------------------------

def _count(monkeypatch, mod, name):
    calls = []
    ref = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


def _intra_case(w, h, seed, device="cpu"):
    """An inter picture's planes and cbfs with a sparse intra grid."""
    bw, bh = w // 16, h // 16
    rng = np.random.default_rng(seed)
    y, u, v = (torch.from_numpy(p.astype(np.int32)).to(device)
               for p in synth(w, h, seed))
    grid = rng.random((bh, bw)) < 0.2
    grid[0, 0] = grid[-1, -1] = True
    planes = tuple(torch.from_numpy(a.astype(np.int32)).to(device) for a in (
        rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h // 2, w // 2)),
        rng.integers(0, 256, (h // 2, w // 2)), rng.integers(-9, 10, (h, w)),
        rng.integers(-9, 10, (h // 2, w // 2)),
        rng.integers(-9, 10, (h // 2, w // 2))))
    cbfs = tuple(torch.from_numpy(rng.random(bw * bh) < 0.5).to(device)
                 for _ in range(3))
    modes = torch.from_numpy(rng.integers(0, 35, (bh, bw)).astype(
        np.int32)).to(device)
    return (y, u, v, torch.from_numpy(grid).to(device), modes, planes,
            cbfs), bw, bh


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    monkeypatch.setattr(iw.qt_wavefront, "launches", 0)
    monkeypatch.setattr(iw.flat_wavefront, "launches", 0)
    qt_calls = _count(monkeypatch, tqt, "encode_frame_qt_device_ref")
    flat_calls = _count(monkeypatch, ted, "encode_frame_device_ref")
    iw_calls = _count(monkeypatch, tinter, "_intra_wavefront_ref")
    w, h, qp = 64, 48, 32
    yi, ui, vi = _padded(synth(w, h, 3), w, h)
    maps = tqt.decide_qt_device(yi, qp, w, h, True)
    st = tqt.encode_frame_qt_device(yi, ui, vi, *maps, qp, chroma_qp(qp), w,
                                    h, True, True)
    assert st["rec_y"].device.type == "cpu"
    y, u, v = (torch.from_numpy(p.astype(np.int32)) for p in synth(w, h, 4))
    modes = ted.decide_modes_device(y, qp, w // 16, h // 16)
    ted.encode_frame_device(y, u, v, modes, qp, chroma_qp(qp), w // 16,
                            h // 16, sbh=True, rdoq="full")
    args, bw, bh = _intra_case(w, h, 5)
    tinter._intra_wavefront(*args, qp, chroma_qp(qp), True, True, bw, bh)
    assert (qt_calls, flat_calls, iw_calls) == ([1], [1], [1])
    assert iw.qt_wavefront.launches == iw.flat_wavefront.launches == 0


def test_wrappers_refuse_what_they_do_not_take():
    t = torch.zeros((32, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        iw.qt_wavefront(t, t[:16, :16], t[:16, :16], t[:4, :4], t[:4, :4],
                        t[:2, :2], t[:1, :1], 32, 32, 32, 32, True, True,
                        (1.0, 1.0), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        iw.flat_wavefront(t, t, t, t, (t,) * 3, (t,) * 3, (t,) * 3, 32, 32,
                          2, 2, True, True, (1.0, 1.0), 2.0)
    with pytest.raises(ValueError, match="full"):
        iw._rdoq_mode("full")
    assert (iw._rdoq_mode(False), iw._rdoq_mode(True),
            iw._rdoq_mode("lite")) == (0, 1, 1)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source nvcc refuses (or no nvcc) raises at the first load."""
    bad = tmp_path / "intra_wavefront.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(iw, "_SRC", bad)
    monkeypatch.setattr(tss, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(iw, "_LIB", None)
    with pytest.raises(RuntimeError):
        iw._load()


def test_table_layout_is_the_sources():
    """tables_np holds the port's rom tables at the offsets the kernel
    source's `Tab` names."""
    src = (REPO / "video_codecs_tpu_torch/csrc/intra_wavefront.cu").read_text()
    sizes = dict(re.findall(r"static constexpr int k(\w+) = [^;]*;\s*//\s*"
                            r"([\d,]+)", src))
    assert {k: int(v.replace(",", "")) for k, v in sizes.items()} == dict(
        Dct=1360, Scan=4080, Angle=35, InvAngle=35, QuantScale=6,
        InvQuantScale=6)
    assert "kScan = 1360;" in src and "kAngle = kScan + 4080;" in src
    tab = iw.tables_np()
    assert tab.size == iw.TAB_SIZE == 1360 + 4080 + 35 + 35 + 6 + 6
    o = 0
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        np.testing.assert_array_equal(tab[o:o + n * n].reshape(n, n),
                                      rom.dct_matrix(n))
        o += n * n
    for log2 in (2, 3, 4, 5):
        for st in (rom.SCAN_DIAG, rom.SCAN_HOR, rom.SCAN_VER):
            nn = 1 << (2 * log2)
            np.testing.assert_array_equal(tab[o:o + nn],
                                          rom.scan_order(log2, st))
            o += nn
    assert o == iw.TAB_ANGLE
    np.testing.assert_array_equal(tab[o + 2:o + 35], rom.INTRA_PRED_ANGLES)
    np.testing.assert_array_equal(tab[iw.TAB_INV_ANGLE + 11:
                                      iw.TAB_INV_ANGLE + 26],
                                  -rom.INTRA_INV_ANGLES)
    np.testing.assert_array_equal(tab[iw.TAB_QUANT_SCALE:
                                      iw.TAB_QUANT_SCALE + 6],
                                  rom.QUANT_SCALES)
    np.testing.assert_array_equal(tab[iw.TAB_INV_QUANT_SCALE:],
                                  rom.INV_QUANT_SCALES)


@pytest.mark.parametrize("lam_scale", [1.0, 2.0])
def test_lite_lambdas_are_rdoq_lites(lam_scale):
    """The float32 lam_td the kernels read equals, bit for bit, the one
    `quant.rdoq_lite` forms for the same lambda and scale (the quadtree's
    lambdas at scale 1.0, `_code_blocks`' at rdoq_lite's default)."""
    assert ted.LITE_LAM_SCALE == 2.0
    for qp in range(52):
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        got = iw.lite_lambdas(lam, lam * 1.5, lam_scale)
        for row, lm in enumerate((lam, lam * 1.5)):
            for j, log2 in enumerate((2, 3, 4, 5)):
                want = torch.tensor(float(lam_scale) * float(lm) * float(
                    4 ** (15 - 8 - log2)), dtype=torch.float32)
                assert got[row, j].view(np.int32) == \
                    want.view(torch.int32).item()
    # the kernel's RDOQ-lite reads the rates rdoq_lite reads
    assert tquant.log_1p_tables()[1].dtype == np.float32


def test_device_tables_cached_per_card_and_lambda(monkeypatch):
    """Two calls with equal lambdas get the same tensors, and neither
    hashes a table through `utils.device.const`."""
    def refuse(*a, **kw):
        raise AssertionError("const called")

    monkeypatch.setattr("video_codecs_tpu_torch.utils.device.const", refuse)
    iw._consts.cache_clear()
    dev = torch.device("cpu")
    lam = ted.flat_lambdas(32, chroma_qp(32))
    a = iw._consts(dev, lam, ted.LITE_LAM_SCALE)
    b = iw._consts(dev, tuple(float(x) for x in lam), ted.LITE_LAM_SCALE)
    assert all(x is y for x, y in zip(a, b))
    c = iw._consts(dev, (lam[0] * 2, lam[1]), ted.LITE_LAM_SCALE)
    assert c[0] is a[0] and c[1] is a[1] and c[2] is not a[2]
    np.testing.assert_array_equal(
        a[2].numpy(), iw.lite_lambdas(*lam, ted.LITE_LAM_SCALE))
    np.testing.assert_array_equal(a[0].numpy(), iw.tables_np())
    iw._consts.cache_clear()


@pytest.mark.parametrize("cbf_layout", ["blocks", "grid"])
def test_intra_wavefront_cuda_branch_reads_nothing_back(monkeypatch,
                                                        cbf_layout):
    """`_intra_wavefront`'s CUDA branch, run on CPU tensors with the
    library, the stream and the device check patched (the kernel a no-op
    that reports its grid), calls no .cpu(), .item(), .numpy(), .tolist()
    and no bool() of a tensor; it launches once and returns clones of the
    shapes it was given: cbfs as [B] (the P and B pictures) or as
    [bh, bw] (the RA quadtree's `qt_merge_dev`)."""
    import ctypes
    import inspect

    calls = []

    def fake_flat(*args):
        calls.append(args)
        ctypes.cast(args[-2], ctypes.POINTER(ctypes.c_int))[0] = 3
        return 0

    fake_flat.__name__ = "vct_intra_flat_wavefront"
    lib = type("Lib", (), {"vct_intra_flat_wavefront":
                           staticmethod(fake_flat)})
    monkeypatch.setattr(iw, "_device", lambda y: y.device)
    monkeypatch.setattr(iw, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(iw, "_load", lambda: lib)
    monkeypatch.setattr(iw.flat_wavefront, "launches", 0)
    monkeypatch.setattr(iw.flat_wavefront, "last_grid", 0)
    src = inspect.getsource(tinter._intra_wavefront).replace(
        'yi.device.type == "cpu"', 'yi.device.type == "card"')
    assert src.count('"card"') == 1
    ns = dict(tinter._intra_wavefront.__globals__)
    exec(src, ns)
    args, bw, bh = _intra_case(64, 48, 5)
    if cbf_layout == "grid":
        args = args[:6] + (tuple(c.reshape(bh, bw) for c in args[6]),)
    tquant.log_1p_tables()          # host tables, built once per process
    iw.tables_np()

    def refuse(*a, **kw):
        raise AssertionError("a host read on the card's path")

    for name in ("cpu", "item", "numpy", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    planes, cbfs = ns["_intra_wavefront"](*args, 32, chroma_qp(32), True,
                                          True, bw, bh)
    launches, grid = iw.flat_wavefront.launches, iw.flat_wavefront.last_grid
    monkeypatch.undo()
    assert len(calls) == 1 and launches == 1 and grid == 3
    for got, orig in zip(planes + cbfs, args[5] + args[6]):
        assert got is not orig and torch.equal(got, orig)
        assert got.shape == orig.shape
    assert calls[0][4] is not None                 # the intra map, on the card


# ---- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


def _qt_inputs(w, h, qp, rdoq, seed, forced_depth=None):
    planes = _padded(synth(w, h, seed), w, h, "cuda")
    maps = tqt.decide_qt_device(planes[0], qp, w, h, rdoq)
    if forced_depth is not None:
        ph, pw = planes[0].shape
        maps = (torch.full((ph // 8, pw // 8), forced_depth, dtype=torch.int32,
                           device="cuda"),) + tuple(
            torch.arange(m.numel(), device="cuda").remainder(35).reshape(
                m.shape).int() for m in maps[1:])
    return planes, maps


def _qt_check(planes, maps, qp, w, h, sbh, rdoq):
    l0 = iw.qt_wavefront.launches
    got = tqt.encode_frame_qt_device(*planes, *maps, qp, chroma_qp(qp), w, h,
                                     sbh, rdoq)
    torch.cuda.synchronize()
    ph, pw = planes[0].shape
    assert iw.qt_wavefront.launches - l0 == 1
    assert 1 <= iw.qt_wavefront.last_grid <= (ph // 32) * (pw // 32)
    want = tqt.encode_frame_qt_device_ref(*planes, *maps, qp, chroma_qp(qp),
                                          w, h, sbh, rdoq)
    _equal(got, want, (w, h, qp, sbh, rdoq))


@pytest.mark.cuda
@pytest.mark.parametrize("sbh,rdoq", [(True, True), (True, False),
                                      (False, True), (False, False)])
def test_qt_kernel_edges_not_multiples_of_32(sbh, rdoq):
    _need_card()
    w, h, qp = 200, 120, 30
    planes, maps = _qt_inputs(w, h, qp, rdoq, 7)
    assert len(torch.unique(maps[0][:h // 8, :w // 8])) == 3
    _qt_check(planes, maps, qp, w, h, sbh, rdoq)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_qt_kernel_all_35_modes_at_every_cu_size(depth):
    """Every CU of the picture at one size, the modes 0..34 in turn."""
    _need_card()
    w, h = 224, 160
    for qp, sbh, rdoq in ((27, True, True), (37, False, False)):
        planes, maps = _qt_inputs(w, h, qp, rdoq, 11 + depth, depth)
        _qt_check(planes, maps, qp, w, h, sbh, rdoq)


@pytest.mark.cuda
@pytest.mark.parametrize("sbh,rdoq,nt", [(True, True, 0), (False, False, 0),
                                         (True, "lite", 2),
                                         (False, False, 2)])
def test_flat_kernel_picture_and_tile_stack(sbh, rdoq, nt):
    _need_card()
    w, h, qp = 224, 160, 32
    bw, bh = w // 16, h // 16
    y, u, v = (torch.from_numpy(p.astype(np.int32)).cuda()
               for p in synth(w, h, 13))
    if nt:
        bw //= nt

        def stack(p, n):
            return p.reshape(p.shape[0], nt, bw * n).transpose(
                0, 1).contiguous()

        y, u, v = stack(y, 16), stack(u, 8), stack(v, 8)
    modes = ted.decide_modes_device(y, qp, bw, bh)
    modes[..., 0, :] = torch.arange(bw, device="cuda").remainder(35).int()
    l0 = iw.flat_wavefront.launches
    got = ted.encode_frame_device(y, u, v, modes, qp, chroma_qp(qp), bw, bh,
                                  sbh=sbh, rdoq=rdoq)
    torch.cuda.synchronize()
    assert iw.flat_wavefront.launches - l0 == 1
    want = ted.encode_frame_device_ref(y, u, v, modes, qp, chroma_qp(qp), bw,
                                       bh, sbh=sbh, rdoq=rdoq)
    _equal(got, want, (sbh, rdoq, nt))
    assert want["cbf"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("qp,sbh,rdoq", [(32, True, True), (27, False,
                                                            False)])
def test_flat_kernel_p_picture_sparse_intra(qp, sbh, rdoq):
    _need_card()
    args, bw, bh = _intra_case(208, 128, 17, "cuda")
    l0 = iw.flat_wavefront.launches
    gp, gc = tinter._intra_wavefront(*args, qp, chroma_qp(qp), sbh, rdoq, bw,
                                     bh)
    torch.cuda.synchronize()
    assert iw.flat_wavefront.launches - l0 == 1
    wp, wc = tinter._intra_wavefront_ref(*args, qp, chroma_qp(qp), sbh, rdoq,
                                         bw, bh)
    for g, w_ in zip(gp + gc, wp + wc):
        assert (g.long() - w_.long()).abs().max().item() == 0
    assert not torch.equal(gp[0], args[5][0])      # the intra blocks changed


@pytest.mark.cuda
def test_cuda_calls_never_reach_the_plain_versions(monkeypatch):
    _need_card()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA call reached a plain version")

    for mod, name in ((tqt, "encode_frame_qt_device_ref"),
                      (ted, "encode_frame_device_ref"),
                      (tinter, "_intra_wavefront_ref")):
        monkeypatch.setattr(mod, name, refuse)
    w, h, qp = 96, 64, 32
    planes, maps = _qt_inputs(w, h, qp, True, 3)
    tqt.encode_frame_qt_device(*planes, *maps, qp, chroma_qp(qp), w, h, True,
                               True)
    y, u, v = (torch.from_numpy(p.astype(np.int32)).cuda()
               for p in synth(w, h, 4))
    modes = ted.decide_modes_device(y, qp, w // 16, h // 16)
    ted.encode_frame_device(y, u, v, modes, qp, chroma_qp(qp), w // 16,
                            h // 16, sbh=True, rdoq=True)
    args, bw, bh = _intra_case(w, h, 5, "cuda")
    tinter._intra_wavefront(*args, qp, chroma_qp(qp), True, True, bw, bh)
    with pytest.raises(ValueError, match="full"):
        ted.encode_frame_device(y, u, v, modes, qp, chroma_qp(qp), w // 16,
                                h // 16, sbh=True, rdoq="full")
    torch.cuda.synchronize()


def _flat_check(w, h, qp, sbh, rdoq, seed):
    """The flat kernel on a w x h picture against its plain version."""
    bw, bh = w // 16, h // 16
    y, u, v = (torch.from_numpy(p.astype(np.int32)).cuda()
               for p in synth(w, h, seed))
    modes = ted.decide_modes_device(y, qp, bw, bh)
    l0 = iw.flat_wavefront.launches
    got = ted.encode_frame_device(y, u, v, modes, qp, chroma_qp(qp), bw, bh,
                                  sbh=sbh, rdoq=rdoq)
    torch.cuda.synchronize()
    assert iw.flat_wavefront.launches - l0 == 1
    assert 1 <= iw.flat_wavefront.last_grid <= bw * bh
    want = ted.encode_frame_device_ref(y, u, v, modes, qp, chroma_qp(qp), bw,
                                       bh, sbh=sbh, rdoq=rdoq)
    _equal(got, want, (w, h, qp))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "all"])
def test_flat_kernel_p_picture_no_and_all_intra(kind):
    """A P picture with no intra block (planes and cbfs come back
    unchanged, in one launch that codes nothing) and one whose blocks are
    all intra."""
    _need_card()
    args, bw, bh = _intra_case(208, 128, 19, "cuda")
    args = list(args)
    args[3] = (torch.zeros_like if kind == "none" else torch.ones_like)(
        args[3])
    for qp, sbh, rdoq in ((32, True, True), (27, False, False)):
        l0 = iw.flat_wavefront.launches
        gp, gc = tinter._intra_wavefront(*args, qp, chroma_qp(qp), sbh, rdoq,
                                         bw, bh)
        torch.cuda.synchronize()
        assert iw.flat_wavefront.launches - l0 == 1
        wp, wc = tinter._intra_wavefront_ref(*args, qp, chroma_qp(qp), sbh,
                                             rdoq, bw, bh)
        for g, w_ in zip(gp + gc, wp + wc):
            assert (g.long() - w_.long()).abs().max().item() == 0
        if kind == "none":
            for g, orig in zip(gp + gc, args[5] + args[6]):
                assert torch.equal(g, orig)
        else:
            assert not torch.equal(gp[0], args[5][0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,w,h", [("qt", 32, 32), ("flat", 16, 16),
                                        ("qt", 1920, 32), ("qt", 32, 1088),
                                        ("flat", 1920, 32),
                                        ("flat", 32, 1088)])
def test_one_unit_pictures_rows_and_columns(kernel, w, h):
    """One CTB (32x32) and one block (16x16); a one-CTB row (1920x32) and
    a one-CTB column (32x1088), where each unit waits on one neighbour."""
    _need_card()
    qp = 32
    if kernel == "qt":
        planes, maps = _qt_inputs(w, h, qp, True, 23)
        _qt_check(planes, maps, qp, w, h, True, True)
    else:
        _flat_check(w, h, qp, True, True, 23)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["qt", "flat"])
def test_1080p_more_units_than_resident_ctas(kernel):
    """At 1920x1080 the units (2,040 CTBs, 8,040 blocks) outnumber the
    CTAs the card holds at once, so the persistent grid is smaller than
    the unit count and each CTA codes many units in ticket order."""
    _need_card()
    w, h, qp = 1920, 1080, 32
    if kernel == "qt":
        planes, maps = _qt_inputs(w, h, qp, True, 29)
        _qt_check(planes, maps, qp, w, h, True, True)
        assert iw.qt_wavefront.last_grid < 60 * 34
    else:
        _flat_check(w, 1072, qp, True, True, 29)
        assert iw.flat_wavefront.last_grid < 120 * 67


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [0.2, 0.5])
def test_flat_kernel_p_picture_more_units_than_ctas(frac):
    """An 832x480 P picture (1,560 blocks, more than the CTAs the card
    holds at once) with a seeded fraction of intra blocks: CTAs mix the
    blocks they code with the ones they pass over."""
    _need_card()
    args, bw, bh = _intra_case(832, 480, 31, "cuda")
    args = list(args)
    rng = np.random.default_rng(int(frac * 100))
    args[3] = torch.from_numpy(rng.random((bh, bw)) < frac).cuda()
    l0 = iw.flat_wavefront.launches
    gp, gc = tinter._intra_wavefront(*args, 32, chroma_qp(32), True, True,
                                     bw, bh)
    torch.cuda.synchronize()
    assert iw.flat_wavefront.launches - l0 == 1
    assert iw.flat_wavefront.last_grid < bw * bh
    wp, wc = tinter._intra_wavefront_ref(*args, 32, chroma_qp(32), True,
                                         True, bw, bh)
    for g, w_ in zip(gp + gc, wp + wc):
        assert (g.long() - w_.long()).abs().max().item() == 0
