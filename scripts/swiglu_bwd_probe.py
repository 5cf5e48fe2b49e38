#!/usr/bin/env python3
"""Probe the fused SwiGLU's backward kernel ``wgmma_bwd`` on one CUDA card.

Run from the root of a checkout::

    python3 scripts/swiglu_bwd_probe.py
    python3 scripts/swiglu_bwd_probe.py --earlier build/parent   # and another checkout's

At the four shapes the train paths give the kernel (TinyLlama's microbatch:
M 4096, D 2048, F 5632; DeepSeek's experts: E 64, M 120, D 2048, F 1408;
the Jamba period's experts: E 4, M 1280, D 4096, F 14336, and its dense
FFN: M 2048, D 4096, F 14336), the whole call (CUDA events, median of 20,
L2 flushed before each), after holding dg and du against
``swiglu_bwd_ref`` (5e-2 + 2e-2·|ref|, as ``chip_smoke.py``) and two
launches against each other bit for bit; the forward ``wgmma`` at
TinyLlama's shape beside it; each copy's ``-Xptxas -v`` registers and
spills of the ``wgmma`` kernel's instantiations.  Once as built and once
from each attribution copy (below: timed only, their outputs are wrong by
design).  ``--earlier DIR`` times DIR's kernel (a checkout unpacked with
``git archive``, e.g. the parent commit's) and its own attribution copies
the same way, and says whether its dg and du equal this checkout's bit for
bit.  Every copy builds at once, one ``nvcc`` each; the cases then run one
copy at a time.

The copies live under ``build/swiglu_bwd_probe/`` (listed in
``.gitignore``), each building its own library there; the results go to
``build/swiglu_bwd_probe/probe.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from probe_copies import ROOT, copy_with, run_child

WORK = os.path.join(ROOT, "build", "swiglu_bwd_probe")
CSRC = os.path.join("repro_torch", "csrc", "swiglu_matmul.cu")

# copies of this checkout's kernel: (name, [(text in csrc/swiglu_matmul.cu,
# its replacement)]); a name in brackets is an attribution copy, timed only
VARIANTS = {
    "as built": [],
    # the other shared-memory budget: a 3-stage ring (the forward's too) beside two buffers
    "3 stages, two buffers": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    # σ(g) through the correctly rounded division of the earlier epilogue
    "exact reciprocal": [("__fdividef(1.f, 1.f + __expf(-g0)), s1 = __fdividef(1.f, 1.f + "
                          "__expf(-g1));", "1.f / (1.f + __expf(-g0)), s1 = 1.f / (1.f + "
                          "__expf(-g1));")],
    # (b) the forward's epilogue: out = silu(g) u by direct stores, no dout
    "(b) forward epilogue": [("constexpr bool TMA_EPI = BWD;", "constexpr bool TMA_EPI = false;")],
    # (c) dout read, dg and du computed into shared memory, no TMA store
    "(c) dout read, no stores": [
        (f"            store(&bmaps.dg, din, {a});\n"
         f"            store(&bmaps.du, din + C::BOX_BYTES, {a});\n", "") for a in (0, 1)],
}
# the same attribution of the earlier kernel (dout by 4-byte loads after the
# mainloop, dg and du by 4-byte stores), for --earlier
EARLIER_VARIANTS = {
    "earlier": [],
    "earlier (b) forward epilogue": [
        ("          if constexpr (BWD) {\n            // s = σ(g)",
         "          if constexpr (false) {\n            // s = σ(g)")],
    "earlier (c) dout read, no stores": [
        ("            *reinterpret_cast<__nv_bfloat162*>(du + eoff + at) =",
         "            if (d.x == 1234.5f) *reinterpret_cast<__nv_bfloat162*>(du + eoff + at) ="),
        ("            *reinterpret_cast<__nv_bfloat162*>(oe + at) =\n                "
         "__floats2bfloat162_rn(d.x * u0",
         "            if (d.x == 1234.5f) *reinterpret_cast<__nv_bfloat162*>(oe + at) =\n"
         "                __floats2bfloat162_rn(d.x * u0")],
    "earlier (d) stores, no dout read": [
        ("            const float2 d = __bfloat1622float2(\n"
         "                *reinterpret_cast<const __nv_bfloat162*>(dout + eoff + at));",
         "            const float2 d = make_float2(1.f, 1.f);")],
    "earlier (e) 3 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
}
# (key, E or None, M, D, F): the train paths' shapes
CASES = [("train", None, 4096, 2048, 5632), ("deepseek", 64, 120, 2048, 1408),
         ("jamba_experts", 4, 1280, 4096, 14336), ("jamba_dense", None, 2048, 4096, 14336)]
ATOL, RTOL = 5e-2, 2e-2


def ptxas_summary(src: str) -> list:
    """-Xptxas -v of the copy's ``swiglu_wgmma_kernel`` instantiations:
    (consumers/BN/experts/backward, registers at launch, spill stores, stack
    frame bytes), and any C75xx warning line (ptxas serialising ``wgmma``)."""
    logs = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(os.path.dirname(src), "build"))
            for f in fs if f.startswith("swiglu_matmul-") and f.endswith(".log")]
    if not logs:
        return []
    out, name, spill, stack = [], None, 0, 0
    for line in open(logs[0]):
        if re.search(r"warning.*C75\d\d", line):
            out.append((line.strip()[:160],))
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            t = re.search(r"swiglu_wgmma_kernelILi(\d)ELi(\d+)ELb(\d)ELb(\d)E", name)
            if t:
                out.append(("/".join(t.groups()), int(m.group(1)), spill, stack))
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
    """Inside one copy: every case, checked (when ``checked``) and timed."""
    sys.path.insert(0, src)
    import hashlib
    import importlib

    import torch

    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ref import swiglu_bwd_ref

    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    build_all([sw.LIBRARY])
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(scale).to(torch.bfloat16)

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

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.view(torch.int16).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    res = {}
    for key, E, M, D, F in CASES:
        lead = () if E is None else (E,)
        x, dout = randn(*lead, M, D), randn(*lead, M, F)
        wg, wu = (randn(*lead, D, F, scale=D ** -0.5) for _ in range(2))
        fn = lambda: sw._launch_bwd(x, wg, wu, dout)  # noqa: E731
        got, again = fn(), fn()
        r = {"same_bits": all(torch.equal(a, b) for a, b in zip(got, again)),
             "digest": digest(got)}
        if checked:
            want = swiglu_bwd_ref(x, wg, wu, dout)
            r["max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want))
            r["within"] = all(bool(((g.float() - w.float()).abs()
                                    <= ATOL + RTOL * w.float().abs()).all())
                              for g, w in zip(got, want))
            del want
        del got, again
        torch.cuda.empty_cache()
        r["ms"] = ms(fn)
        if key == "train":
            r["fwd_ms"] = ms(lambda: sw._launch(x, wg, wu))
        res[key] = r
        del x, dout, wg, wu
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
    ap.add_argument("--earlier", help="another checkout whose backward to time the same way")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("swiglu_bwd_probe: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    srcs = {name: copy_with(WORK, CSRC, name, subs) if subs else os.path.join(ROOT, "src")
            for name, subs in VARIANTS.items()}
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
        print(f"{name} (ms, L2 flushed):", flush=True)
        for entry in res["ptxas"]:
            if len(entry) == 1:
                print(f"  ptxas {entry[0]}", flush=True)
                continue
            inst, regs, spill, stack = entry
            print(f"  ptxas consumers/BN/experts/bwd {inst}: {regs} registers, {spill} bytes "
                  f"spilled, {stack} bytes of stack", flush=True)
        for key, *_ in CASES:
            r = res[key]
            line = f"  {key:13} {r['ms']:.4f}  same bits {r['same_bits']}"
            if "fwd_ms" in r:
                line += f"  (forward wgmma {r['fwd_ms']:.4f})"
            if "within" in r:
                line += f"  max abs err {r['max_abs_err']:.3g}, within tol {r['within']}"
                if not (r["within"] and r["same_bits"]):
                    bad.append(f"{name} {key}")
            print(line, flush=True)
    if args.earlier and "error" not in runs["as built"] and "error" not in runs["earlier"]:
        same = {key: runs["as built"][key]["digest"] == runs["earlier"][key]["digest"]
                for key, *_ in CASES}
        print(f"dg and du bit for bit equal to the earlier checkout's: {same}", flush=True)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "probe.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    if bad:
        print(f"swiglu_bwd_probe: outside tolerance or not bit-stable: {bad}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
