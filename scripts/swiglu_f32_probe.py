#!/usr/bin/env python3
"""Probe the fused SwiGLU's f32 CUDA-core kernel (``cuda_core``,
``experts_cuda_core``) on one CUDA card.

Run from the root of a checkout::

    python3 scripts/swiglu_f32_probe.py
    python3 scripts/swiglu_f32_probe.py --earlier build/parent   # and another checkout's
    python3 scripts/swiglu_f32_probe.py --earlier build/parent --earlier-only

At the two f32 shapes the kernel is reported at (M 512, D 2048, F 5632; the
experts E 64, M 120, D 2048, F 1408) and at M 8, D 2048, F 5632 (the
small-M class), the whole call (CUDA events, median of 20, L2 flushed
before each), after holding the output against ``swiglu_ref`` /
``swiglu_experts_ref`` (1e-4 + 2e-2·|ref|, as ``chip_smoke.py``) and two
launches against each other bit for bit; beside it cuBLAS's
``F.silu(x @ wg) * (x @ wu)`` (``bmm`` for the experts) with TF32 off,
timed the same way.  Once as built and once from each attribution copy,
timed only (their outputs are wrong by design):

- (b) the k-loop skips its global loads: the shared-memory reads and the
  FFMAs run on whatever shared memory holds, the ceiling of those two;
- (c) the k-loop loads and never multiplies: the ceiling of the loads;

each skipped step sits behind a condition that is false at run time
(``M < 0``), so that the compiler keeps what the step would have read or
written.  More copies of this checkout's kernel time the design's
alternatives: the fast path's copy loops rolled, 16 k rows a stage, every
M > 16 on the 64-row tile class, and the 128-row class with double-buffered
fragments at 2 CTAs an SM.

Each copy's ``-Xptxas -v`` registers, spills and stack of the CUDA-core
kernel's instantiations are printed beside its times.  ``--earlier DIR``
times DIR's kernel (a checkout unpacked with ``git archive``, e.g. the
parent commit's) and its own attribution copies the same way, and says
whether its outputs equal this checkout's bit for bit; ``--earlier-only``
times DIR's copies alone.  Every copy builds at once, one ``nvcc`` each;
the cases then run one copy at a time, each in a child process.

The copies live under ``build/swiglu_f32_probe/`` (listed in
``.gitignore``), each building its own library there; the results go to
``build/swiglu_f32_probe/probe.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

from probe_copies import ROOT, copy_with, run_child

WORK = os.path.join(ROOT, "build", "swiglu_f32_probe")
CSRC = os.path.join("repro_torch", "csrc", "swiglu_matmul.cu")
RETURN_CLASS = ("return cost(R64::BM, R64::BN, R64::CTAS) < cost(R128::BM, R128::BN, R128::CTAS) "
                "? 1 : 2;")

# copies of this checkout's kernel: (name, [(text in csrc/swiglu_matmul.cu,
# its replacement)]); a name with "(" is an attribution copy, timed only
VARIANTS = {
    "as built": [],
    # (b) no global loads: the ring's stages are never filled (behind a
    # condition false at run time, so the compiler keeps the reads)
    "(b) no loads": [("if (s < nk) load<C, FAST>(", "if (M < 0) load<C, FAST>("),
                     ("if (i + C::STAGES - 1 < nk)", "if (M < 0)")],
    # (c) the loads, no FFMAs (behind a condition false at run time, so the
    # compiler keeps the copies into shared memory)
    "(c) no FFMAs": [("fma_frag<C>(acc, frag[q & 1]);", "if (M < 0) fma_frag<C>(acc, frag[q & 1]);"),
                     ("fma_tile<C>(acc[0], a, b);", "if (M < 0) fma_tile<C>(acc[0], a, b);"),
                     ("fma_tile<C>(acc[1], a, b);", "if (M < 0) fma_tile<C>(acc[1], a, b);")],
    # (b') no loads, and each k group's fragments read from one k row a
    # stage: the FFMAs' own ceiling, with 1/8 of the shared-memory reads
    "(b') FFMAs alone": [("if (s < nk) load<C, FAST>(", "if (M < 0) load<C, FAST>("),
                         ("if (i + C::STAGES - 1 < nk)", "if (M < 0)"),
                         ("frag_x<C>(a, cur, kg0 + q, ty);", "frag_x<C>(a, cur, kg0, ty);"),
                         ("frag_w<C>(b, cur, kg0 + q, tx, 0);", "frag_w<C>(b, cur, kg0, tx, 0);"),
                         ("frag_w<C>(b, cur, kg0 + q, tx, 1);", "frag_w<C>(b, cur, kg0, tx, 1);")],
    # 16 k rows a stage on the 128-row class (half the barriers and copy
    # loops an FFMA; 66 KB of ring a CTA)
    "128-row, 16 k rows a stage": [("using R128 = Cls<128, 64, 8, 8, 8, 1, 4, 3, false>;",
                                    "using R128 = Cls<128, 64, 16, 8, 8, 1, 4, 3, false>;")],
    # the fast path's copy loops rolled, as the general path's are
    "copy loops rolled": [("#pragma unroll\n    for (int c = 0; c < C::BK / 8; ++c) {",
                           "#pragma unroll 1\n    for (int c = 0; c < C::BK / 8; ++c) {"),
                          ("#pragma unroll\n      for (int j = 0; j < C::BM / XR; ++j) {",
                           "#pragma unroll 1\n      for (int j = 0; j < C::BM / XR; ++j) {"),
                          ("#pragma unroll\n    for (int t = 0; t < WN; ++t) {\n",
                           "#pragma unroll 1\n    for (int t = 0; t < WN; ++t) {\n")],
    # the design's alternatives: every M > 16 on the 64-row class; the
    # 128-row class with double-buffered fragments at 2 CTAs an SM (255
    # registers a thread) in place of 3 CTAs and 168 registers
    "always 64-row tiles": [(RETURN_CLASS, "return 1;")],
    "128-row, fragments double-buffered, 2 CTAs an SM": [
        ("using R128 = Cls<128, 64, 8, 8, 8, 1, 4, 3, false>;",
         "using R128 = Cls<128, 64, 8, 8, 8, 1, 4, 2, true>;"), (RETURN_CLASS, "return 2;")],
}
# the same attribution of the earlier kernel (64 x 64 x 16 tiles, scalar
# global loads and two __syncthreads a k-step), for --earlier
EARLIER_FFMA = ("          accg[i][j] = fmaf(a[i], bg[j], accg[i][j]);\n"
                "          accu[i][j] = fmaf(a[i], bu[j], accu[i][j]);\n")
EARLIER_VARIANTS = {
    "earlier": [],
    "earlier (b) no loads": [
        ("      xs[kk][r] = (m < M && kd < D) ? to_f32(x[(long long)m * D + kd]) : 0.f;\n",
         "      if (M < 0) xs[kk][r] = (m < M && kd < D) ? to_f32(x[(long long)m * D + kd]) : 0.f;\n"),
        ("      gs[kk][c] = in ? to_f32(wg[g]) : 0.f;\n      us[kk][c] = in ? to_f32(wu[g]) : 0.f;\n",
         "      if (M < 0) gs[kk][c] = in ? to_f32(wg[g]) : 0.f;\n"
         "      if (M < 0) us[kk][c] = in ? to_f32(wu[g]) : 0.f;\n")],
    "earlier (c) no FFMAs": [(EARLIER_FFMA, "          if (M < 0) {\n" + EARLIER_FFMA + "          }\n")],
}
# (key, E or None, M, D, F): the reported f32 shapes and the small-M class
CASES = [("m512", None, 512, 2048, 5632), ("experts", 64, 120, 2048, 1408),
         ("m8", None, 8, 2048, 5632)]
ATOL, RTOL = 1e-4, 2e-2
KERNEL_NAME = re.compile(r"swiglu_(?:cuda_core_)?kernelI(.+?)EEv")


def ptxas_summary(src: str) -> list:
    """-Xptxas -v of the copy's CUDA-core kernel instantiations, from the
    build log of its library (named, as ``kernels/_build.py`` names it, by a
    hash of the source and the shared headers): (template arguments,
    registers, spill stores, stack frame bytes)."""
    csrc = os.path.join(src, "repro_torch", "csrc")
    h = hashlib.sha256(open(os.path.join(csrc, "swiglu_matmul.cu"), "rb").read())
    for header in sorted(f for f in os.listdir(csrc) if f.endswith(".cuh")):
        h.update(open(os.path.join(csrc, header), "rb").read())
    log = os.path.join(os.path.dirname(src), "build", "repro_torch_kernels",
                       f"swiglu_matmul-{h.hexdigest()[:16]}.log")
    if not os.path.exists(log):
        return []
    out, name, spill, stack = [], None, 0, 0
    for line in open(log):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            t = KERNEL_NAME.search(name)
            if t:
                args = t.group(1)
                kind = "bf16" if "bfloat16" in args else "f32"
                nums = re.findall(r"L[ib](\d+)E", args + "E")
                out.append(("/".join([kind, *nums]), int(m.group(1)), spill, stack))
            name = None
    return out


def build(srcs) -> None:
    """Build each copy's library, all at once."""
    procs = [(src, subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", src],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for src in srcs]
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"building {src} failed:\n{out[-3000:]}")


def child(src: str, checked: bool) -> None:
    """Inside one copy: every case, checked (when ``checked``) and timed,
    and cuBLAS's time of the same function."""
    sys.path.insert(0, src)
    import importlib
    import threading
    import time

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ref import swiglu_experts_ref, swiglu_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # cuBLAS in full f32, as the kernel
    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    build_all([sw.LIBRARY])
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(scale)

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            flush.zero_()
            torch.cuda._sleep(400_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[reps // 2]

    def clocks(fn, seconds=2.0):
        """The card's SM clock (MHz) and power draw (W), the medians of
        nvidia-smi samples taken while ``fn`` runs back to back."""
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                      "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True).stdout.split(",")
                samples.append((float(out[0]), float(out[1])))
                time.sleep(0.1)
        th = threading.Thread(target=sample)
        t0 = time.time()
        th.start()
        while time.time() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        stop.set()
        th.join()
        return [sorted(s[i] for s in samples)[len(samples) // 2] for i in (0, 1)]

    res = {}
    for key, E, M, D, Fd in CASES:
        lead = () if E is None else (E,)
        x = randn(*lead, M, D)
        wg, wu = (randn(*lead, D, Fd, scale=D ** -0.5) for _ in range(2))
        if E is None:
            fn, ref = (lambda: sw._launch(x, wg, wu)), swiglu_ref
            lib = lambda: F.silu(x @ wg) * (x @ wu)  # noqa: E731
        else:
            fn, ref = (lambda: sw._launch(x, wg, wu)), swiglu_experts_ref
            lib = lambda: F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)  # noqa: E731
        before = dict(sw.LIBRARY.counts)
        got, again = fn(), fn()
        moved = {v for v in sw.LIBRARY.counts if sw.LIBRARY.counts[v] != before[v]}
        r = {"variant": sorted(moved), "same_bits": torch.equal(got, again),
             "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        if checked:
            want = ref(x, wg, wu)
            r["max_abs_err"] = float((got - want).abs().max())
            r["within"] = bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
            assert not torch.backends.cuda.matmul.allow_tf32
            r["lib_ms"] = ms(lib)
            del want
        del got, again
        r["ms"] = ms(fn)
        if checked and key == "m512":
            r["clocks"], r["lib_clocks"] = clocks(fn), clocks(lib)
        res[key] = r
        del x, wg, wu
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(res), flush=True)


def main() -> None:
    if len(sys.argv) > 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3] == "checked")
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--build":
        sys.path.insert(0, sys.argv[2])
        from repro_torch.kernels import SWIGLU_LIBRARY
        from repro_torch.kernels._build import build_all

        build_all([SWIGLU_LIBRARY])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="another checkout whose kernel to time the same way")
    ap.add_argument("--earlier-only", action="store_true",
                    help="time only the --earlier checkout's copies")
    args = ap.parse_args()
    if args.earlier_only and not args.earlier:
        ap.error("--earlier-only needs --earlier")
    import torch

    if not torch.cuda.is_available():
        print("swiglu_f32_probe: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    srcs = {}
    if not args.earlier_only:
        srcs.update({name: copy_with(WORK, CSRC, name, subs) if subs else os.path.join(ROOT, "src")
                     for name, subs in VARIANTS.items()})
    if args.earlier:
        root = os.path.abspath(args.earlier)
        srcs.update({name: copy_with(WORK, CSRC, name, subs, root=root) if subs
                     else os.path.join(root, "src") for name, subs in EARLIER_VARIANTS.items()})
    build(srcs.values())
    # a copy that fails is reported; the others still run
    runs = {name: run_child(__file__, src, "timed" if "(" in name else "checked", check=False)
            for name, src in srcs.items()}
    for name, src in srcs.items():
        runs[name]["ptxas"] = ptxas_summary(src)
    bad = []
    for name, res in runs.items():
        if "error" in res:
            print(f"{name}: failed\n{res['error']}", flush=True)
            bad.append(name)
            continue
        print(f"{name} (ms, L2 flushed; ptxas: BM/BN/BK/TM/TN/KSPLIT/CTAS/DB/FAST/EXPERTS, "
              f"the earlier kernel's BM/BN/BK/TM/TN/EXPERTS):", flush=True)
        for inst, regs, spill, stack in res["ptxas"]:
            print(f"  ptxas {inst}: {regs} registers, {spill} bytes spilled, {stack} bytes of "
                  f"stack", flush=True)
        for key, *_ in CASES:
            r = res[key]
            line = f"  {key:8} {r['ms']:.4f}  {r['variant']}  same bits {r['same_bits']}"
            if "within" in r:
                line += (f"  max abs err {r['max_abs_err']:.3g}, within tol {r['within']}"
                         f"  (cuBLAS {r['lib_ms']:.4f})")
                if not (r["within"] and r["same_bits"]):
                    bad.append(f"{name} {key}")
            print(line, flush=True)
            if "clocks" in r:
                print(f"  m512 run back to back: SM clock {r['clocks'][0]:.0f} MHz, "
                      f"{r['clocks'][1]:.0f} W (cuBLAS: {r['lib_clocks'][0]:.0f} MHz, "
                      f"{r['lib_clocks'][1]:.0f} W)", flush=True)
    if "as built" in runs and "earlier" in runs and not any(
            "error" in runs[n] for n in ("as built", "earlier")):
        same = {key: runs["as built"][key]["digest"] == runs["earlier"][key]["digest"]
                for key, *_ in CASES}
        print(f"outputs bit for bit equal to the earlier checkout's: {same}", flush=True)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "probe.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    if bad:
        print(f"swiglu_f32_probe: failed, outside tolerance or not bit-stable: {bad}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
