#!/usr/bin/env python3
"""Probe flash attention's backward kernel ``wgmma_bwd`` on one CUDA card.

Run from the root of a checkout::

    python3 scripts/flash_bwd_probe.py
    python3 scripts/flash_bwd_probe.py --earlier build/parent   # and another checkout's

At the four shapes the train paths give the kernel (TinyLlama's microbatch:
BH 128 = 4 x 32 heads, S 1024, D 64, causal; MLA's 192/128: BH 64, causal;
HuBERT's 80: BH 128, S 1500, non-causal; D 128: BH 128, causal), the whole
call (CUDA events, median of 20, L2 flushed before each) and each of its
three kernels (profiler: delta and lse·log2 e, dK/dV, dQ), after holding
the gradients against the plain version (``flash_attention_bwd_ref``, 3e-2
of each gradient's largest magnitude, as ``chip_smoke.py``) and two launches
against each other bit for bit, with each copy's ``-Xptxas -v`` registers,
spills and serialised ``wgmma`` for the backward kernels.  Once as built
and once from a copy whose producer keeps two stages in flight instead of
three.  ``--earlier DIR`` times DIR's backward the same way (a checkout
unpacked with ``git archive``, e.g. the parent commit's ``mma_bwd``).  Every copy builds at once, one ``nvcc`` each; the cases then
run one copy at a time.

The copies live under ``build/flash_bwd_probe/`` (listed in ``.gitignore``),
each building its own library there; the results go to
``build/flash_bwd_probe/probe.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from probe_copies import ROOT, copy_with, run_child
WORK = os.path.join(ROOT, "build", "flash_bwd_probe")
CSRC = os.path.join("repro_torch", "csrc", "flash_attention.cu")

# (name, [(text in csrc/flash_attention.cu, its replacement)])
VARIANTS = {
    "as built": [],
    "2 stages": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
}
# (key, BH, S, D, Dv, causal): the train paths' shapes
CASES = [("train", 128, 1024, 64, 64, True), ("mla", 64, 1024, 192, 128, True),
         ("hubert", 128, 1500, 80, 80, False), ("d128", 128, 1024, 128, 128, True)]
KERNEL = r"flash_(delta|\w*dkdv|\w*dq)_kernel"
BWD_TOL = 3e-2


def ptxas_summary(src: str) -> list:
    """-Xptxas -v of the copy's backward kernels: (kernel, tile, registers at
    launch, spill stores, wgmma serialised), from its library's build log."""
    logs = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(os.path.dirname(src), "build"))
            for f in fs if f.startswith("flash_attention-") and f.endswith(".log")]
    if not logs:
        return []
    serial, out, name, spill = set(), [], None, 0
    for line in open(logs[0]):
        m = re.search(r"C7512.*function '([^']+)'", line)
        if m:
            serial.add(m.group(1))
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kind = re.search(r"flash_(wgmma_dkdv|wgmma_dq|delta)_kernel", name)
            if kind:
                tile = re.search(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)", name)
                out.append((kind.group(1), "/".join(tile.groups()) if tile else "",
                            int(m.group(1)), spill, name in serial))
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


def child(src: str) -> None:
    """Inside one copy: every case, checked and timed."""
    sys.path.insert(0, src)
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    build_all([fa.LIBRARY])
    variant = [v for v in fa.LIBRARY.variants if v.endswith("_bwd")][0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

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

    def kernel_ms(fn, reps=10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(KERNEL, e.key)
            if m:
                name = "delta" if m.group(1) == "delta" else m.group(1).split("_")[-1]
                out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
        return out

    res = {"variant": variant}
    for key, BH, S, D, Dv, causal in CASES:
        q, k, v, do = randn(BH, S, D), randn(BH, S, D), randn(BH, S, Dv), randn(BH, S, Dv)
        sc = D ** -0.5
        o, lse = fa._launch(q, k, v, causal, sc, with_lse=True)
        fn = lambda: fa._launch_bwd(q, k, v, o, do, lse, causal, sc)  # noqa: E731
        got, again = fn(), fn()
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, sc)
        rel = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                  for g, w in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        torch.cuda.empty_cache()
        res[key] = {"ms": ms(fn), **kernel_ms(fn), "rel_err": rel, "same_bits": same,
                    "ok": rel <= BWD_TOL and same}
    print("RESULT " + json.dumps(res), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--build":
        sys.path.insert(0, sys.argv[2])
        from repro_torch.kernels import FLASH_LIBRARY
        from repro_torch.kernels._build import build_all

        build_all([FLASH_LIBRARY])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="another checkout whose backward to time the same way")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_probe: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    srcs = {name: copy_with(WORK, CSRC, name, subs) if subs else os.path.join(ROOT, "src")
            for name, subs in VARIANTS.items()}
    if args.earlier:
        srcs["earlier"] = os.path.join(os.path.abspath(args.earlier), "src")
    build(srcs.values())
    # a copy that fails is reported; the others still run
    runs = {name: run_child(__file__, src, check=False) for name, src in srcs.items()}
    for name, src in srcs.items():
        runs[name]["ptxas"] = ptxas_summary(src)
    bad = []
    for name, res in runs.items():
        if "error" in res:
            print(f"{name}: failed\n{res['error']}", flush=True)
            bad.append(name)
            continue
        print(f"{name} ({res['variant']}; ms, L2 flushed):", flush=True)
        for kind, tile, regs, spill, serial in res["ptxas"]:
            print(f"  ptxas {kind} {tile} (D/Dv/atom/BQ/BKQ): {regs} registers, {spill} bytes "
                  f"spilled{', wgmma serialised' if serial else ''}", flush=True)
        for key, *_ in CASES:
            r = res[key]
            print(f"  {key:7} call {r['ms']:.4f}  delta {r.get('delta', 0):.4f}  "
                  f"dkdv {r.get('dkdv', 0):.4f}  dq {r.get('dq', 0):.4f}  "
                  f"err {r['rel_err']:.3g}  same bits {r['same_bits']}", flush=True)
            if not r["ok"]:
                bad.append(f"{name} {key}")
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "probe.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    if bad:
        print(f"flash_bwd_probe: outside {BWD_TOL} or not bit-stable: {bad}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
