"""Time the RDOQ and SAO-statistics kernels against an older tree's, on
the card.

    python scripts/bench_torch_rdoq.py [--parent DIR] [--rounds K]

At the nine RDOQ calls of chip_smoke.phase_rdoq_kernel (the 1080p RA B
picture's, the 1080p IDR's trials and the LD-P P picture's) and the three
padded planes of a 1080p picture's SAO statistics it
  - builds this tree's csrc/rdoq.cu and csrc/sao_stats.cu and prints what
    `-Xptxas -v` says (registers, shared memory, spills);
  - with --parent, builds an older tree's two sources too (DIR is an
    unpacked tree, e.g. `git archive <commit> | tar -x -C .work/parent`)
    and prints the same;
  - holds every kernel against its plain version (`rdoq_dev_ref`: levels
    max abs err 0 and rates bitwise; `sao_stats_ref`: all four outputs);
  - times them in turns (old, new, new, old; K rounds), all called through
    the same bare ctypes launcher with the outputs allocated once: each
    kernel's device time from torch.profiler (median of 21 launches);
  - times one call of the Python wrappers `rdoq_dev` and `sao_stats` with
    CUDA events (the host's cost shows there when it exceeds the kernel's);
  - measures the RDOQ chain's latency floor: the kernel at B = 32, one warp
    alone on the card, per transform size, in us and SM cycles (at the
    card's maximum SM clock) per position;
and prints each time beside the bound (chip_smoke.rdoq_bound, sao_bound).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from video_codecs_tpu_torch.ops import rdoq_dev as rdoq_ops  # noqa: E402
from video_codecs_tpu_torch.ops import sao as sao_ops  # noqa: E402
from video_codecs_tpu_torch.ops.sad_surface import build_library  # noqa: E402

RDOQ_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 +
             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
             [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
SAO_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def build(src: Path, stem: str, who: str):
    so, secs, log = build_library(src, stem)
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem")):
            print(f"[build {who}] {line.strip()}")
    print(f"[build {who}] {so.name}: nvcc {secs:.2f} s (0 = cached)")
    return ctypes.CDLL(str(so))


def load_tree(root: Path, who: str):
    """(vct_rdoq, vct_sao_stats_u8) of the tree at root, argtypes set.
    This tree's libraries are the ones its wrappers load."""
    csrc = root / "video_codecs_tpu_torch" / "csrc"
    tag = "" if who == "new" else "_parent"
    rdoq = build(csrc / "rdoq.cu", f"vct_rdoq{tag}", who).vct_rdoq
    sao = build(csrc / "sao_stats.cu", f"vct_sao_stats{tag}",
                who).vct_sao_stats_u8
    for fn, args in ((rdoq, RDOQ_ARGS), (sao, SAO_ARGS)):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return rdoq, sao


def rdoq_launcher(fn, co, log2, luma, st, rate, qp, who):
    """One bare launch of fn on co, into outputs allocated once."""
    b, n = co.shape[0], 1 << log2
    tab, rl = rdoq_ops._kernel_tables(qp, log2, luma, st, 0, co.device)
    q_bits, scale, lam_bits, es, inv = rdoq_ops._kernel_scalars(
        qp, log2, chip_smoke.rdoq_lam(qp), 8)
    out = torch.empty((b, n, n), dtype=torch.int32, device=co.device)
    bits = torch.empty(b, dtype=torch.float32, device=co.device) \
        if rate else None
    args = (co.data_ptr(), *co.stride(), out.data_ptr(),
            None if bits is None else bits.data_ptr(), b, log2,
            tab.data_ptr(), rl.data_ptr(), q_bits, scale, lam_bits, es, inv,
            int(luma), 1, torch.cuda.current_stream().cuda_stream)

    def run():
        err = fn(*args)
        if err:
            sys.exit(f"{who} RDOQ kernel launch failed: cudaError {err}")
        return out, bits
    return run


def sao_launcher(fn, to, tr, ctb, who):
    h, w = to.shape
    m = (h // ctb) * (w // ctb)
    outs = [torch.empty(20 * m, dtype=torch.int32, device="cuda"),
            torch.empty(20 * m, dtype=torch.float32, device="cuda"),
            torch.empty(32 * m, dtype=torch.int32, device="cuda"),
            torch.empty(32 * m, dtype=torch.float32, device="cuda")]
    args = (to.data_ptr(), tr.data_ptr(), *[o.data_ptr() for o in outs], h,
            w, ctb, torch.cuda.current_stream().cuda_stream)

    def run():
        err = fn(*args)
        if err:
            sys.exit(f"{who} SAO kernel launch failed: cudaError {err}")
        return outs
    return run


def device_ms(fn, name: str) -> float:
    """chip_smoke.kernel_device_ms, asked again where a profiler session
    recorded no kernel of that name (it happens now and then)."""
    for _ in range(3):
        ms = chip_smoke.kernel_device_ms(fn, name)
        if ms is not None:
            return ms
    sys.exit(f"torch.profiler recorded no {name} in three tries")


def same_rdoq(got, want, rate) -> bool:
    (g, gb), (w, wb) = got, (want if rate else (want, None))
    return torch.equal(g, w) and (not rate or torch.equal(
        gb.view(torch.int32), wb.view(torch.int32)))


def same_sao(got, want) -> bool:
    return all(torch.equal(g, w.reshape(-1)) for g, w in zip(got, want))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of old, new, new, old with --parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(clk.stdout.split()[0])
    print(f"[clock] maximum SM clock {mhz:.0f} MHz")
    torch.set_grad_enabled(False)

    trees = {"new": load_tree(Path(__file__).resolve().parents[1], "new")}
    if args.parent:
        trees["old"] = load_tree(Path(args.parent).resolve(), "old")

    # the inputs, the plain versions' outputs and the bounds
    rq = []
    for what, co, log2, luma, st, rate, qp in chip_smoke.rdoq_shapes():
        kw = dict(lam=chip_smoke.rdoq_lam(qp), is_luma=luma, slice_type=st,
                  return_rate=rate)
        want = rdoq_ops.rdoq_dev_ref(co, qp, log2, **kw)
        tab, rl = rdoq_ops._kernel_tables(qp, log2, luma, st, 0, co.device)
        bound = chip_smoke.rdoq_bound(co.shape[0], log2, rate, 4 * (
            tab.numel() + rl.numel()))[0]
        run = {who: rdoq_launcher(fns[0], co, log2, luma, st, rate, qp, who)
               for who, fns in trees.items()}
        for who, fn in run.items():
            if not same_rdoq(fn(), want, rate):
                sys.exit(f"{who} RDOQ kernel != plain at {what}")
        wrapper = chip_smoke.cuda_ms(
            lambda: rdoq_ops.rdoq_dev(co, qp, log2, **kw), reps=21)
        rq.append(dict(what=what, b=co.shape[0], run=run, bound=bound,
                       wrapper=wrapper, co=co, log2=log2, luma=luma, st=st,
                       rate=rate, qp=qp))
    sq = []
    for what, to, tr, ctb, timed in chip_smoke.sao_planes():
        if not timed:
            continue
        want = sao_ops.sao_stats_ref(to, tr, ctb)
        run = {who: sao_launcher(fns[1], to, tr, ctb, who)
               for who, fns in trees.items()}
        for who, fn in run.items():
            if not same_sao(fn(), want):
                sys.exit(f"{who} SAO kernel != plain at {what}")
        wrapper = chip_smoke.cuda_ms(lambda: sao_ops.sao_stats(to, tr, ctb),
                                     reps=21)
        sq.append(dict(what=what, run=run, bound=chip_smoke.sao_bound(
            *to.shape, ctb)[0], wrapper=wrapper))
    print("[check] every kernel equals its plain version at every shape "
          "(RDOQ levels max abs err 0, rates bitwise; SAO all four "
          "outputs)")

    order = ("old", "new", "new", "old") * args.rounds if args.parent \
        else ("new",) * args.rounds
    times = collections.defaultdict(list)
    for who in order:
        for row in rq:
            ms = device_ms(row["run"][who], "rdoq_kernel")
            times[(who, row["what"])].append(ms)
        pic = 0.0
        for row in sq:
            ms = device_ms(row["run"][who], "sao_stats_kernel")
            times[(who, row["what"])].append(ms)
            pic += ms
        times[(who, "sao per picture")].append(pic)
        per_b = sum(chip_smoke.RA_B_RDOQ_CALLS.get(r["what"], 0) *
                    times[(who, r["what"])][-1] for r in rq)
        times[(who, "rdoq per B picture")].append(per_b)
        print(f"[turn {who}] RDOQ per RA B picture {per_b:.4f} ms, SAO per "
              f"1080p picture {pic:.4f} ms")

    def med(who, what):
        return statistics.median(times[(who, what)])

    whos = [w for w in ("old", "new") if w in trees]
    for row in rq:
        cells = "; ".join(
            f"{who} {med(who, row['what']):.4f} ms (min "
            f"{min(times[(who, row['what'])]):.4f}, max "
            f"{max(times[(who, row['what'])]):.4f})" for who in whos)
        new = med("new", row["what"])
        print(f"[rdoq] {row['what']} B={row['b']}: {cells}; bound "
              f"{row['bound']:.4f} ms, new {row['bound'] / new:.2%} of it"
              + (f", {med('old', row['what']) / new:.1f}x faster than old"
                 if "old" in trees else "")
              + f"; new wrapper call {row['wrapper']:.4f} ms (CUDA events)")
    for row in sq:
        cells = "; ".join(f"{who} {med(who, row['what']):.4f} ms"
                          for who in whos)
        print(f"[sao] {row['what']}: {cells}; bound {row['bound']:.4f} ms; "
              f"new wrapper call {row['wrapper']:.4f} ms (CUDA events)")
    for what in ("rdoq per B picture", "sao per picture"):
        cells = "; ".join(f"{who} median {med(who, what):.4f} ms over "
                          f"{len(times[(who, what)])} turns" for who in whos)
        print(f"[turns] {what}: {cells}")

    # the chain's latency floor: one warp alone on the card
    seen = set()
    for row in rq:
        if row["log2"] in seen or not row["rate"]:
            continue
        seen.add(row["log2"])
        co = row["co"][:32]
        fn = rdoq_launcher(trees["new"][0], co, row["log2"], row["luma"],
                           row["st"], True, row["qp"], "new")
        ms = device_ms(fn, "rdoq_kernel")
        nn = 1 << (2 * row["log2"])
        us = ms * 1e3 / nn
        print(f"[floor] TU{1 << row['log2']} ({row['what']}'s first 32 "
              f"blocks, B=32): {ms:.4f} ms, {us:.4f} us = "
              f"{us * mhz:.0f} SM cycles per position (all four passes)")


if __name__ == "__main__":
    main()
