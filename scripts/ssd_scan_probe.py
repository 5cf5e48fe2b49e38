#!/usr/bin/env python3
"""Probe the SSD scan's ``wgmma`` variant on one CUDA card.

Run from the root of a checkout::

    python3 scripts/ssd_scan_probe.py            # all three probes
    python3 scripts/ssd_scan_probe.py phases     # or some of them
    python3 scripts/ssd_scan_probe.py faults
    python3 scripts/ssd_scan_probe.py bwd

``phases``: device time of each of the variant's three kernels (profiler
kernel names, L2 flushed before each call) and of the whole call (CUDA
events, median of 30) at mamba2-370m's prefill shapes: 32 heads, head dim
64, state 128, S = 128 and 1024 on flat ``[BH, S, *]`` operands, S = 1024
on views of the mixer's conv output.  Once as built, and once from a copy
whose phases 2 and 3 are launched without programmatic dependent launch, so
that the three kernels do not overlap and each one's time is its own.

``faults``: plants one fault at a time in a copy of the CUDA source (no
decay L in phase 3, no carry decay in phase 2, a chunk skipped by phase 2,
the lo halves of the split operands dropped), builds each, and prints for
every case the largest error of y and of the final state over the
tolerance ``chip_smoke.py`` holds them to (a check fails above 1).  Cases
with dt ~0.02 (``dt_shift`` 4) are those where the state carried from chunk
to chunk counts.

``bwd``: the backward ``wgmma_bwd`` at the train layouts (mamba2-370m's
microbatch: B 4, S 1024, H 32, N 128; the Jamba period's: B 2, H 128, N
16; views of one conv output): the whole call (CUDA events, median of 30,
L2 flushed) and each of its three kernels (profiler), as built and without
programmatic dependent launch; then planted faults in copies of the
source (the state pass without its decay, dC's state term scaled by
exp(T - cs) in place of exp(cs), the d T term dropped, the last rank's
share of the on-chip head sum dropped), each with its largest error over
``ssd_scan_vjp``'s gradients as a share of their largest magnitude
(``chip_smoke.py`` holds the kernel to 1e-2).

The copies live under ``build/ssd_scan_probe/`` (listed in ``.gitignore``);
every copy builds its own library there.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import probe_copies
from probe_copies import ROOT

WORK = os.path.join(ROOT, "build", "ssd_scan_probe")
CSRC = os.path.join("repro_torch", "csrc", "ssd_scan.cu")

# (name, [(text in csrc/ssd_scan.cu, its replacement)])
FAULTS = {
    "none": [],
    "no decay L": [("cb[v] * expf(csi - cs[j]) * dts[j]", "cb[v] * dts[j]"),
                   ("cb[v + 1] * expf(csi - cs[j + 1]) * dts[j + 1]", "cb[v + 1] * dts[j + 1]")],
    "no carry decay": [(f"h.{c} = fmaf(d[k], h.{c}, s[k].{c});", f"h.{c} = h.{c} + s[k].{c};")
                       for c in "xyzw"],
    "chunk 1 skipped in state_pass": [
        ("      if (c0 + k < nch) {\n        if (c0 + k > 0)",
         "      if (c0 + k < nch && c0 + k != 1) {\n        if (c0 + k > 0)")],
    "lo halves dropped": [
        ("  lo = hopper::pack_bf16(v0 - __low2float(h), v1 - __high2float(h));", "  lo = 0u;")],
}
# the forward's phases 2-3 and the backward's dA_reduce lose the attribute;
# the backward's chunk_grad keeps its cluster
NO_PDL = [("cfg.numAttrs = 1;", "cfg.numAttrs = 0;"), ("cfg.numAttrs = 2;", "cfg.numAttrs = 1;")]
# the backward's planted faults
BWD_FAULTS = {
    "none": [],
    "no decay in the state pass": [
        ("for (int v = 0; v < 32; ++v) st[v] = fmaf(decay, st[v], s[v]);",
         "for (int v = 0; v < 32; ++v) st[v] = st[v] + s[v];")],
    "dC's state term by exp(T - cs)": [("const float e0 = V.ecs[r0], e1 = V.ecs[r0 + 8];",
                                        "const float e0 = V.wexp[r0], e1 = V.wexp[r0 + 8];")],
    "d T dropped": [("dc[1] += s + expf(v.cs[Q - 1]) * (v.scr[0] + v.scr[1] + v.scr[2] + v.scr[3]);",
                     "dc[1] += 0.f;")],
    "the last rank's head sum dropped": [("for (int r = 1; r < ranks; ++r) {",
                                          "for (int r = 1; r < ranks - 1; ++r) {")],
}
# (B, S, H, N): the train layouts of mamba2-370m and of the Jamba period
BWD_CASES = [(4, 1024, 32, 128), (2, 1024, 128, 16)]
BWD_KERNELS = ("bwd_states", "chunk_grad", "dA_reduce")
# (BH, S, P, N, dt_shift)
FAULT_CASES = [(2, 100, 64, 128, 0.0), (3, 256, 64, 128, 0.0), (1, 37, 64, 16, 0.0),
               (2, 64, 64, 64, 0.0), (1, 1, 64, 128, 0.0), (2, 1000, 64, 128, 0.0),
               (32, 1024, 64, 128, 0.0), (2, 1000, 64, 128, 4.0), (3, 256, 64, 128, 4.0),
               (2, 300, 64, 16, 4.0), (32, 1024, 64, 128, 4.0)]


def copy_with(name: str, subs) -> str:
    """A copy of src/repro_torch with ``subs`` applied to its ssd_scan.cu;
    returns its src directory."""
    return probe_copies.copy_with(WORK, CSRC, name, subs)


def run_child(mode: str, src: str) -> dict:
    return probe_copies.run_child(__file__, mode, src)


# --------------------------------------------------------------------------- #
# inside one copy
# --------------------------------------------------------------------------- #
def child(mode: str, src: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import SSD_LIBRARY, ssd_mixer, ssd_scan
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ref import ssd_scan_ref

    build_all([SSD_LIBRARY])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def flat(BH, S, P, N, dt_shift=0.0):
        x = randn(BH, S, P, dtype=bf16)
        dt = torch.nn.functional.softplus(randn(BH, S, dtype=f32) - dt_shift)
        A = -torch.exp(randn(BH, dtype=f32, scale=0.5))
        return x, dt, A, randn(BH, S, N, dtype=bf16, scale=0.5), randn(BH, S, N, dtype=bf16,
                                                                          scale=0.5)

    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(fn, reps=30):
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

    def kernel_ms(fn, pattern, reps=10):
        """Device ms a call of each kernel whose profiler name matches
        ``pattern`` (group 1 its phase name)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(pattern, e.key)
            if m:
                out[m.group(1)] = e.self_device_time_total / reps / 1e3
        return out

    if mode in ("bwd", "bwd_faults"):
        import importlib

        ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
        res = {}
        for (Bsz, S, H, N) in BWD_CASES:
            P, G = 64, 1
            buf = randn(Bsz, S, H * P + 2 * G * N, dtype=bf16, scale=0.5)
            x = buf[..., :H * P].reshape(Bsz, S, H, P)
            Bm = buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
            Cm = buf[..., H * P + G * N:].reshape(Bsz, S, G, N)
            dt = torch.nn.functional.softplus(randn(Bsz, S, H, dtype=f32) - 4.0)
            A2 = (-torch.exp(randn(H, dtype=f32, scale=0.5)))[None].expand(Bsz, H)
            dy = randn(Bsz, S, H, P, dtype=bf16)
            args = (x, dt, A2, Bm, Cm, dy, None)
            key = f"B={Bsz} S={S} H={H} N={N}"
            if mode == "bwd_faults":
                got, want = ssd._launch_bwd(*args), ssd.ssd_scan_vjp(*args)
                res[key] = max(float((g.float() - w.float()).abs().max()
                                     / w.float().abs().max()) for g, w in zip(got, want))
                continue
            fn = lambda: ssd._launch_bwd(*args)  # noqa: E731
            phases = kernel_ms(fn, r"ssd_(bwd_states|chunk_grad|dA_reduce)_kernel")
            res[key] = {"ms": ms(fn), **{k: phases.get(k, 0.0) for k in BWD_KERNELS}}
        print("RESULT " + json.dumps(res), flush=True)
        return

    if mode == "faults":
        def ratio(o, r, atol, rtol):
            o, r = o.float(), r.float()
            return float(((o - r).abs() / (atol * max(float(r.abs().max()), 1.0)
                                           + rtol * r.abs())).max())
        res = {}
        for (BH, S, P, N, shift) in FAULT_CASES:
            args = flat(BH, S, P, N, shift)
            y, h = ssd_scan(*args, return_state=True)
            ry, rh = ssd_scan_ref(*args, return_state=True)
            res[str((BH, S, P, N, shift))] = [round(ratio(y, ry, 1e-4, 2 ** -7), 3),
                                              round(ratio(h, rh, 1e-4, 0.0), 3)]
        print("RESULT " + json.dumps(res), flush=True)
        return

    def serving(S, H=32, P=64, N=128):
        buf = randn(1, S, H * P + 2 * N, dtype=bf16)
        x = buf[..., :H * P].reshape(1, S, H, P)
        B = buf[..., H * P:H * P + N].reshape(1, S, 1, N)
        C = buf[..., H * P + N:].reshape(1, S, 1, N)
        dt = torch.nn.functional.softplus(randn(1, S, H, dtype=f32))
        return x, dt, -torch.exp(randn(H, dtype=f32, scale=0.5)), B, C

    res = {}
    for name, call, args in (("flat S=128", ssd_scan, flat(32, 128, 64, 128)),
                             ("flat S=1024", ssd_scan, flat(32, 1024, 64, 128)),
                             ("serving S=1024", ssd_mixer, serving(1024))):
        fn = lambda: call(*args, return_state=True)  # noqa: E731
        total = ms(fn)
        phases = kernel_ms(fn, r"ssd_(chunk_state|state_pass|chunk_scan)_kernel")
        res[name] = {"ms": total, **{k: phases[k] for k in ("chunk_state", "state_pass",
                                                            "chunk_scan")}}
    print("RESULT " + json.dumps(res), flush=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_probe: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    modes = sys.argv[1:] or ["phases", "faults", "bwd"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if "phases" in modes:
        for label, subs in (("as built", []), ("without programmatic dependent launch", NO_PDL)):
            res = run_child("phases", os.path.join(ROOT, "src") if not subs
                            else copy_with("no pdl", subs))
            print(f"phases, {label} (ms; L2 flushed):", flush=True)
            for shape, r in res.items():
                print(f"  {shape:15} call {r['ms']:.4f}  chunk_state {r['chunk_state']:.4f}  "
                      f"state_pass {r['state_pass']:.4f}  chunk_scan {r['chunk_scan']:.4f}",
                      flush=True)
    if "bwd" in modes:
        for label, subs in (("as built", []), ("without programmatic dependent launch", NO_PDL)):
            res = run_child("bwd", os.path.join(ROOT, "src") if not subs
                            else copy_with("no pdl", subs))
            print(f"backward phases, {label} (ms; L2 flushed):", flush=True)
            for shape, r in res.items():
                print(f"  {shape:22} call {r['ms']:.4f}  " + "  ".join(
                    f"{k} {r[k]:.4f}" for k in BWD_KERNELS), flush=True)
        print("backward faults: largest error of a gradient over ssd_scan_vjp's, as a share of "
              "its largest magnitude (chip_smoke.py's bound: 1e-2)", flush=True)
        for name, subs in BWD_FAULTS.items():
            res = run_child("bwd_faults", copy_with("bwd " + name, subs) if subs
                            else os.path.join(ROOT, "src"))
            print(f"  {name}: " + ", ".join(f"{k} {v:.4g}" for k, v in res.items()), flush=True)
    if "faults" in modes:
        srcs = {name: copy_with(name, subs) for name, subs in FAULTS.items()}
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", "faults", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in srcs.items()}
        print("faults: largest error over its tolerance, [y, final state], per case "
              "(BH, S, P, N, dt_shift); a check fails above 1", flush=True)
        for name, proc in procs.items():
            log, _ = proc.communicate()
            line = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not line:
                raise SystemExit(f"fault {name!r} failed:\n{log[-3000:]}")
            res = json.loads(line[0][len("RESULT "):])
            caught = sum(1 for v in res.values() if max(v) > 1)
            print(f"  {name}: caught in {caught} of {len(res)} cases: {json.dumps(res)}",
                  flush=True)


if __name__ == "__main__":
    main()
