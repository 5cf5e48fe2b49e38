#!/usr/bin/env python3
"""Probe flash attention's f32 CUDA-core kernel (``cuda_core``) on one CUDA
card.

Run from the root of a checkout::

    python3 scripts/flash_f32_probe.py
    python3 scripts/flash_f32_probe.py --earlier build/parent   # and another checkout's
    python3 scripts/flash_f32_probe.py --earlier build/parent --earlier-only

At the three f32 shapes the kernel is reported at, one for each tile class
a path's head dims reach (BH 32, S 1024, D 64; BH 32, S 1024, D 128; MLA's
BH 16, S 1024, D 192, Dv 128; all causal), the whole call (CUDA events,
median of 20, L2 flushed before each), after holding the output against
``flash_attention_ref`` (2e-5 + 1e-2·|ref|, as ``chip_smoke.py``) and two
launches against each other bit for bit; beside it PyTorch's SDPA on 4-D
views under the memory-efficient backend, timed the same way.  Where Dv !=
D the yardstick follows ``chip_smoke.py::sdpa_value_dim_call``: the first
of the flash, cuDNN and memory-efficient backends that takes the call, or
none.  Once as built and once from each attribution copy, timed only
(their outputs are wrong by design):

- (b) the K/V tile loads skipped: the products and the softmax on whatever
  shared memory holds;
- (c) the softmax pass skipped, P = S (the scaled scores);
- (d) the FFMAs of both products skipped, so the loads (and the softmax)
  run alone; (e) and (f) those of P V or of Q Kᵀ alone;
- (g) the barrier a step skipped (this checkout's kernel);
- (b') the loads skipped and each product's fragments read once every 4
  steps (this checkout's kernel): the FFMAs' own ceiling;

each skipped step sits behind a condition that is false at run time
(``Sq < 0``), so that the compiler keeps what the step would have read or
written.  More copies of this checkout's kernel time the design's
alternatives (``VARIANTS``), and a non-causal D 64 case shows the kernel
with every warp busy to the end.

Each copy's ``-Xptxas -v`` registers, spills and stack of the CUDA-core
kernel's instantiations are printed beside its times.  ``--earlier DIR``
times DIR's kernel (a checkout unpacked with ``git archive``, e.g. the
parent commit's) and its own attribution copies the same way, and says
whether its outputs equal this checkout's bit for bit; ``--earlier-only``
times DIR's copies alone.  Every copy builds at once, one ``nvcc`` each;
the cases then run one copy at a time, each in a child process.

The copies live under ``build/flash_f32_probe/`` (listed in
``.gitignore``), each building its own library there; the results go to
``build/flash_f32_probe/probe.json``.  Exits non-zero without a card.
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

WORK = os.path.join(ROOT, "build", "flash_f32_probe")
CSRC = os.path.join("repro_torch", "csrc", "flash_attention.cu")

# copies of this checkout's kernel: (name, [(text in csrc/flash_attention.cu,
# its replacement)]); a name with "(" is an attribution copy, timed only
VARIANTS = {
    "as built": [],
    # (b) no K/V loads: the ring's slots are never filled after the first
    "(b) no K/V loads": [("if (h + C::NS - 1 < nh)  // into the slot",
                          "if (Sq < 0)  // into the slot")],
    # (c) no softmax: P = the scaled scores, no max, no exp2, no rescale
    "(c) no softmax": [("// the online softmax on the score registers\n      {",
                        "// the online softmax on the score registers\n      if (Sq < 0) {")],
    # (d) no FFMAs: both products' loops run no step
    "(d) no FFMAs": [("for (int d = 0; d < C::DP; d += 4) {",
                      "for (int d = 0; d < (Sq < 0 ? C::DP : 0); d += 4) {"),
                     ("for (int kk = 0; kk < C::BK; ++kk) {",
                      "for (int kk = 0; kk < (Sq < 0 ? C::BK : 0); ++kk) {")],
    # (e) no P V, (f) no Q Kᵀ: one product's FFMAs skipped
    "(e) no PV FFMAs": [("for (int kk = 0; kk < C::BK; ++kk) {",
                         "for (int kk = 0; kk < (Sq < 0 ? C::BK : 0); ++kk) {")],
    "(f) no QK FFMAs": [("for (int d = 0; d < C::DP; d += 4) {",
                         "for (int d = 0; d < (Sq < 0 ? C::DP : 0); d += 4) {")],
    # (g) no barrier a step (the halves' warps run apart; reads race the
    # copies, so the outputs are wrong)
    "(g) no barriers": [("hopper::named_sync(1 + half, C::NT / 2);",
                         "if (Sq < 0) hopper::named_sync(1 + half, C::NT / 2);")],
    # (b') no K/V loads, and each product's fragments read once every 4
    # steps (a quarter of the shared-memory reads): the FFMAs' own ceiling
    "(b') FFMAs alone": [("if (h + C::NS - 1 < nh)  // into the slot",
                          "if (Sq < 0)  // into the slot"),
                         ("put4(a[e], qw + (d + e) * C::QLD);", "put4(a[e], qw + d * C::QLD);"),
                         ("put4(a[e] + 4, qw + (d + e) * C::QLD + 16);",
                          "put4(a[e] + 4, qw + d * C::QLD + 16);"),
                         ("put4(a, pr + kk * C::PLD);", "put4(a, pr + (kk & ~3) * C::PLD);"),
                         ("put4(a + 4, pr + kk * C::PLD + 16);",
                          "put4(a + 4, pr + (kk & ~3) * C::PLD + 16);"),
                         ("put4(b + 4 * g, vw + kk * C::DVP + 32 * g);",
                          "put4(b + 4 * g, vw + (kk & ~3) * C::DVP + 32 * g);")],
    # the products' loops unrolled half or twice as deep: 4 or 16 d of Q Kᵀ
    # and 4 or 16 keys of P V an iteration in place of 8 (wholly unrolled,
    # ~4,400 instructions a product at D 64, the first build of this kernel
    # ran 3.2x slower, out of the instruction cache)
    **{f"products unrolled {n}": [
        ("#pragma unroll 2\n      for (int d = 0; d < C::DP; d += 4) {",
         f"#pragma unroll {n // 4}\n      for (int d = 0; d < C::DP; d += 4) {{"),
        ("#pragma unroll 8\n      for (int kk = 0; kk < C::BK; ++kk) {",
         f"#pragma unroll {n}\n      for (int kk = 0; kk < C::BK; ++kk) {{")] for n in (4, 16)},
}
# the same attribution of the earlier kernel (one CTA of 256 threads per 64
# query rows, 4 x 4 scores a thread, scalar loads between four
# __syncthreads a 64-key tile), for --earlier
EARLIER_VARIANTS = {
    "earlier": [],
    "earlier (b) no K/V loads": [
        ("for (int i = tid; i < BK * DMAX; i += NT) {",
         "for (int i = tid; i < (Sq < 0 ? BK * DMAX : 0); i += NT) {"),
        ("for (int i = tid; i < BK * DVMAX; i += NT) {",
         "for (int i = tid; i < (Sq < 0 ? BK * DVMAX : 0); i += NT) {")],
    "earlier (c) no softmax": [("for (int rr = 0; rr < BQ / 8; ++rr) {",
                                "for (int rr = 0; rr < (Sq < 0 ? BQ / 8 : 0); ++rr) {")],
    "earlier (d) no FFMAs": [("for (int d = 0; d < DMAX; ++d) {",
                              "for (int d = 0; d < (Sq < 0 ? DMAX : 0); ++d) {"),
                             ("for (int kk = 0; kk < BK; ++kk) {",
                              "for (int kk = 0; kk < (Sq < 0 ? BK : 0); ++kk) {")],
}
# (key, BH, S, D, Dv, causal): one shape for each tile class a path's head
# dims reach, and D 64 without the mask (every warp busy to the end)
CASES = [("d64", 32, 1024, 64, 64, True), ("d128", 32, 1024, 128, 128, True),
         ("mla", 16, 1024, 192, 128, True), ("d64 non-causal", 32, 1024, 64, 64, False)]
ATOL, RTOL = 2e-5, 1e-2
KERNEL_NAME = re.compile(r"(flash_fwd_kernel|flash_cuda_core_kernel)I(.+?)EEv")


def ptxas_summary(src: str) -> list:
    """-Xptxas -v of the copy's CUDA-core kernel instantiations, from the
    build log of its library (named, as ``kernels/_build.py`` names it, by a
    hash of the source and the shared headers): (template arguments,
    registers, spill stores, stack frame bytes)."""
    csrc = os.path.join(src, "repro_torch", "csrc")
    h = hashlib.sha256(open(os.path.join(csrc, "flash_attention.cu"), "rb").read())
    for header in sorted(f for f in os.listdir(csrc) if f.endswith(".cuh")):
        h.update(open(os.path.join(csrc, header), "rb").read())
    log = os.path.join(os.path.dirname(src), "build", "repro_torch_kernels",
                       f"flash_attention-{h.hexdigest()[:16]}.log")
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
                args = t.group(2)
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


def library_call(torch, q, k, v, causal):
    """(call, name) of the yardstick: SDPA on 4-D views under the
    memory-efficient backend, or for Dv != D the first of the flash, cuDNN
    and memory-efficient backends that takes the call; (None, "none") if
    none does."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.view(1, *t.shape) for t in (q, k, v))
    backends = ([(SDPBackend.EFFICIENT_ATTENTION, "sdpa[efficient]")]
                if q.shape[-1] == v.shape[-1] else
                [(SDPBackend.FLASH_ATTENTION, "sdpa[flash]"),
                 (SDPBackend.CUDNN_ATTENTION, "sdpa[cudnn]"),
                 (SDPBackend.EFFICIENT_ATTENTION, "sdpa[efficient]")])
    for backend, name in backends:
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:  # the backend refuses these shapes: try the next
            continue
        return call, name
    return None, "none"


def child(src: str, checked: bool) -> None:
    """Inside one copy: every case, checked (when ``checked``) and timed,
    and the yardstick's time of the same function."""
    sys.path.insert(0, src)
    import importlib
    import threading
    import time

    import torch

    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ref import flash_attention_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    build_all([fa.LIBRARY])
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

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
    for key, BH, S, D, Dv, causal in CASES:
        q, k = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(2))
        v = torch.randn(BH, S, Dv, generator=gen, device="cuda")
        fn = lambda: fa._launch(q, k, v, causal, D ** -0.5)[0]  # noqa: E731
        before = dict(fa.LIBRARY.counts)
        got, again = fn(), fn()
        moved = {n for n in fa.LIBRARY.counts if fa.LIBRARY.counts[n] != before[n]}
        r = {"variant": sorted(moved), "same_bits": torch.equal(got, again),
             "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        if checked:
            want = flash_attention_ref(q, k, v, causal=causal)
            r["max_abs_err"] = float((got - want).abs().max())
            r["within"] = bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
            lib, r["library"] = library_call(torch, q, k, v, causal)
            r["lib_ms"] = ms(lib) if lib is not None else None
            del want
        del got, again
        r["ms"] = ms(fn)
        if checked and key == "d64":
            r["clocks"] = clocks(fn)
        res[key] = r
        del q, k, v
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(res), flush=True)


def main() -> None:
    if len(sys.argv) > 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3] == "checked")
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--build":
        sys.path.insert(0, sys.argv[2])
        from repro_torch.kernels import FLASH_LIBRARY
        from repro_torch.kernels._build import build_all

        build_all([FLASH_LIBRARY])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="another checkout whose kernel to time the same way")
    ap.add_argument("--earlier-only", action="store_true",
                    help="time only the --earlier checkout's copies")
    ap.add_argument("--only", default="",
                    help="comma-separated names of this checkout's copies to run (all by default)")
    args = ap.parse_args()
    if args.earlier_only and not args.earlier:
        ap.error("--earlier-only needs --earlier")
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_probe: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    srcs = {}
    if not args.earlier_only:
        only = [n for n in args.only.split(",") if n]
        srcs.update({name: copy_with(WORK, CSRC, name, subs) if subs else os.path.join(ROOT, "src")
                     for name, subs in VARIANTS.items() if not only or name in only})
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
        print(f"{name} (ms, L2 flushed; ptxas: template arguments):", flush=True)
        for inst, regs, spill, stack in res["ptxas"]:
            print(f"  ptxas {inst}: {regs} registers, {spill} bytes spilled, {stack} bytes of "
                  f"stack", flush=True)
        for key, *_ in CASES:
            r = res[key]
            line = f"  {key:14} {r['ms']:.4f}  {r['variant']}  same bits {r['same_bits']}"
            if "within" in r:
                lib = "none" if r["lib_ms"] is None else f"{r['lib_ms']:.4f}"
                line += (f"  max abs err {r['max_abs_err']:.3g}, within tol {r['within']}"
                         f"  ({r['library']} {lib})")
                if not (r["within"] and r["same_bits"]):
                    bad.append(f"{name} {key}")
            print(line, flush=True)
            if "clocks" in r:
                print(f"  d64 run back to back: SM clock {r['clocks'][0]:.0f} MHz, "
                      f"{r['clocks'][1]:.0f} W", flush=True)
    if "as built" in runs and "earlier" in runs and not any(
            "error" in runs[n] for n in ("as built", "earlier")):
        same = {key: runs["as built"][key]["digest"] == runs["earlier"][key]["digest"]
                for key, *_ in CASES}
        print(f"outputs bit for bit equal to the earlier checkout's: {same}", flush=True)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "probe.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    if bad:
        print(f"flash_f32_probe: failed, outside tolerance or not bit-stable: {bad}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
