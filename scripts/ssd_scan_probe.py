#!/usr/bin/env python3
"""Probe the SSD scan's ``wgmma`` variant on one CUDA card.

Run from the root of a checkout::

    python3 scripts/ssd_scan_probe.py            # all three probes
    python3 scripts/ssd_scan_probe.py phases     # or some of them
    python3 scripts/ssd_scan_probe.py faults
    python3 scripts/ssd_scan_probe.py bwd
    python3 scripts/ssd_scan_probe.py cuda_core [--earlier DIR [--earlier-only]]

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

``cuda_core``: the f32 CUDA-core variant called through its wrapper
``_launch_cuda_core`` (with the final state) at the three shapes its rows
report: BH 32, S 1024, P 64, N 128 in f32 (mamba2-370m's heads), Jamba's
BH 128, S 1024, P 64, N 16 in f32, and BH 32, S 1024, P 64, N 128 in bf16
(the element path; the selector sends these shapes to ``wgmma``).  Each:
y and the final state held against ``ssd_scan_ref`` element by element at
``chip_smoke.py``'s tolerances, two launches compared bit for bit, then
the call timed (CUDA events, median of 20, L2 flushed before each) and the
SM clock and power sampled while it runs back to back.  Once as built and
once from each attribution copy, timed only (their outputs are wrong by
design): each skips one step behind a condition that is false at run time
(``S < 0``), so that the compiler keeps the rest (``VARIANTS``; the
earlier kernel's in ``EARLIER_VARIANTS``).  ``-Xptxas -v`` registers, spills
and stack of every SSD kernel are printed beside each copy's times.
``--earlier DIR`` times DIR's kernel (a checkout unpacked with ``git
archive``, e.g. the parent commit's) and its copies the same way, in the
same session; ``--earlier-only`` times DIR's copies alone.  Every copy
builds at once, one ``nvcc`` each; the cases then run one copy at a time,
each in a child process; the results go to ``build/ssd_scan_probe/
cuda_core.json``.

The copies live under ``build/ssd_scan_probe/`` (listed in ``.gitignore``);
every copy builds its own library there.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import hashlib
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

# the CUDA-core variant's shapes: (key, BH, S, P, N, dtype name)
CC_CASES = [("f32", 32, 1024, 64, 128, "float32"), ("jamba f32", 128, 1024, 64, 16, "float32"),
            ("bf16", 32, 1024, 64, 128, "bfloat16")]
# copies of this checkout's CUDA-core kernel: (name, [(text in
# csrc/ssd_scan.cu, its replacement)]); a name with "(" is an attribution
# copy, timed only
_CB = ("for (int n4 = lo; n4 < hi; ++n4) {\n    float4 cv[4];",
       "for (int n4 = lo; n4 < (hi < 0 ? hi : lo); ++n4) {\n    float4 cv[4];")
_STATE = ("for (int j = h * Q / STAGES1; j < (h + 1) * Q / STAGES1; ++j) {",
          "for (int j = h * Q / STAGES1; j < (h + 1) * Q / STAGES1 && S < 0; ++j) {")
_SX = ("for (int j = 0; j < jend; ++j) {", "for (int j = 0; j < (S < 0 ? jend : 0); ++j) {")
_CH = ("for (int n4 = H4 * h; n4 < hi; ++n4) {\n        float cv[4][4];",
       "for (int n4 = H4 * h; n4 < (S < 0 ? hi : 0); ++n4) {\n        float cv[4][4];")
_LOADS = ("const bool ok = r < nrows && col0 + c < ncol;",
          "const bool ok = r < nrows && col0 + c < ncol && ncol < 0;")
VARIANTS = {
    "as built": [],
    # (b) every global load of the three phases' tiles predicated off (zeros land)
    "(b) no loads": [_LOADS, ("v[k] = r < nrows && col0 + c < ncol ?",
                              "v[k] = r < nrows && col0 + c < ncol && ncol < 0 ?")],
    # (c) C·Bᵀ and the masked scores skipped
    "(c) no CB": [_CB, ("if (k >= km) break;", "if (k >= km || S > 0) break;")],
    # (d) phase 1's state update (the rank-Q product) skipped
    "(d) no state update": [_STATE],
    # (e) every product's FFMAs skipped: loads, scans, exps, barriers and the state pass alone
    "(e) no FFMAs": [_CB, _STATE, _SX, _CH],
    # (f) the barriers of phases 1 and 3 skipped (reads race the writes)
    "(f) no barriers": [
        ("  __syncthreads();\n  if (tid == 0 && blockIdx.z == 0)",
         "  if (S < 0) __syncthreads();\n  if (tid == 0 && blockIdx.z == 0)"),
        ("__syncthreads();  // the stage has landed", "if (S < 0) __syncthreads();  // the stage"),
        ("__syncthreads();  // columns [4 H4 h", "if (S < 0) __syncthreads();  // columns [4 H4 h"),
        ("__syncthreads();  // every read of B is done", "if (S < 0) __syncthreads();  // B"),
        ("__syncthreads();  // S^T and x", "if (S < 0) __syncthreads();  // S^T and x"),
        ("__syncthreads();  // every read of S^T", "if (S < 0) __syncthreads();  // S^T"),
        ("__syncthreads();  // rows [4 H4 h", "if (S < 0) __syncthreads();  // rows [4 H4 h")],
    # (h) the skeleton: no loads and no FFMAs (scans, exps, barriers, the
    # state pass, the stores)
    "(h) no loads or FFMAs": [_LOADS, _CB, _STATE, _SX, _CH],
    # (g) the state pass's loop skipped for this variant (phase 3 reads phase 1's terms)
    "(g) no state pass": [("for (int c0 = 0; c0 < nch; c0 += PASS_CH) {",
                           "for (int c0 = 0; c0 < (SIMT && nch > 0 ? 0 : nch); c0 += PASS_CH) {")],
    # chunk_scan's bands by warp % 4 (the two warps of a scheduler on one
    # band), not paired b and 3 - b on each scheduler
    "bands by warp % 4": [("const int b = warp < 4 ? b0 : 3 - b0, hp = q >> 1,",
                           "const int b = (warp & 3) + 0 * b0, hp = warp >> 2,")],
    # the general path's element loads 16 in flight a thread, not 8
    "element loads 16 at a time": [("BATCH = COPIES < 8 ? COPIES : 8;",
                                    "BATCH = COPIES < 16 ? COPIES : 16;")],
    # chunk_scan at 2 CTAs an SM in both classes (launch bounds: 128
    # registers, no spills), not 3 at N <= 32
    "scan at 2 CTAs an SM": [("using N32 = Cls<32, 4, 3>;", "using N32 = Cls<32, 4, 2>;")],
    # chunk_scan's chunk-0 CTAs (they read no state) exit without waiting
    # for the state pass, as an earlier version of the kernel did: what the
    # wait costs
    "chunk 0 not waiting": [("  hopper::griddep_wait();\n  if (c > 0) {\n    __syncthreads();",
                             "  if (c > 0) {\n    hopper::griddep_wait();\n    __syncthreads();")],
    # the three phases without programmatic dependent launch (the forward's
    # and the backward's launches lose the attribute)
    "without PDL": NO_PDL,
}
# the same attribution of the earlier kernel (one CTA of 256 threads per
# (bh, 16 rows of P) walking the chunks of 32 in order, four __syncthreads a
# chunk, the next chunk's operands staged in registers), for --earlier
EARLIER_VARIANTS = {
    "earlier": [],
    # (b) the global loads of x, dt, B and C predicated off (zeros land)
    "earlier (b) no loads": [
        ("const bool in = e < Q * N && t0 + r < S;", "const bool in = e < Q * N && t0 + r < S && S < 0;"),
        ("st.x[k] = (t0 + r < S && p < P) ?", "st.x[k] = (t0 + r < S && p < P && S < 0) ?"),
        ("st.dt = (tid < Q && t0 + tid < S) ?", "st.dt = (tid < Q && t0 + tid < S && S < 0) ?")],
    # (c) C·Bᵀ and the masked scores skipped
    "earlier (c) no CB": [
        ("for (int n4 = 0; n4 < N / 4; ++n4) {\n        const float4 cv = ci[n4];\n#pragma unroll",
         "for (int n4 = 0; n4 < (S < 0 ? N / 4 : 0); ++n4) {\n        const float4 cv = ci[n4];\n"
         "#pragma unroll"),
        ("        Ss[i * (Q + 1) + j] = j <= i ?", "        if (S < 0) Ss[i * (Q + 1) + j] = j <= i ?")],
    # (d) the state update's FFMAs skipped
    "earlier (d) no state update": [
        ("for (int j = 0; j < Q; ++j) {\n        const float b = Bs[j * NS + n];",
         "for (int j = 0; j < (S < 0 ? Q : 0); ++j) {\n        const float b = Bs[j * NS + n];")],
    # (e) every product's FFMAs skipped: loads, scans, exps and barriers alone
    "earlier (e) no FFMAs": [
        ("for (int n4 = 0; n4 < N / 4; ++n4) {\n        const float4 cv = ci[n4];\n#pragma unroll",
         "for (int n4 = 0; n4 < (S < 0 ? N / 4 : 0); ++n4) {\n        const float4 cv = ci[n4];\n"
         "#pragma unroll"),
        ("for (int j = 0; j < Q; ++j) {\n        const float b = Bs[j * NS + n];",
         "for (int j = 0; j < (S < 0 ? Q : 0); ++j) {\n        const float b = Bs[j * NS + n];"),
        ("for (int j = 0; j < Q; ++j) {\n        const float s = Ss[i * (Q + 1) + j];",
         "for (int j = 0; j < (S < 0 ? Q : 0); ++j) {\n        const float s = Ss[i * (Q + 1) + j];"),
        ("for (int n4 = 0; n4 < N / 4; ++n4) {\n        const float4 cv = ci[n4];\n        o0 = dot4",
         "for (int n4 = 0; n4 < (S < 0 ? N / 4 : 0); ++n4) {\n        const float4 cv = ci[n4];\n"
         "        o0 = dot4")],
    # (f) the four barriers a chunk skipped (reads race the writes)
    "earlier (f) no barriers": [
        ("if (tid < Q) dts[tid] = st.dt;\n    __syncthreads();",
         "if (tid < Q) dts[tid] = st.dt;\n    if (S < 0) __syncthreads();"),
        ("    __syncthreads();\n\n    // 4. S_ij", "    if (S < 0) __syncthreads();\n\n    // 4. S_ij"),
        ("    __syncthreads();\n\n    // 5. y_i", "    if (S < 0) __syncthreads();\n\n    // 5. y_i"),
        ("    __syncthreads();\n  }\n\n  if (h_out != nullptr && n < N) {",
         "    if (S < 0) __syncthreads();\n  }\n\n  if (h_out != nullptr && n < N) {")],
}
# the CUDA-core variant's kernels (and the earlier ssd_scan_kernel) by their
# mangled names' length-prefixed identifiers
PTXAS_NAME = re.compile(r"\d(ssd_(?:cc_\w+?|state_pass|scan)_kernel)")


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


# --------------------------------------------------------------------------- #
# the CUDA-core variant
# --------------------------------------------------------------------------- #
def ptxas_summary(src: str) -> list:
    """-Xptxas -v of every SSD kernel of the copy, from the build log of its
    library (named, as ``kernels/_build.py`` names it, by a hash of the
    source and the shared headers): (kernel and template arguments,
    registers, spill stores, stack frame bytes)."""
    csrc = os.path.join(src, "repro_torch", "csrc")
    h = hashlib.sha256(open(os.path.join(csrc, "ssd_scan.cu"), "rb").read())
    for header in sorted(f for f in os.listdir(csrc) if f.endswith(".cuh")):
        h.update(open(os.path.join(csrc, header), "rb").read())
    log = os.path.join(os.path.dirname(src), "build", "repro_torch_kernels",
                       f"ssd_scan-{h.hexdigest()[:16]}.log")
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
            t = PTXAS_NAME.search(name)
            if t:
                kind = "bf16" if "bfloat16" in name else ""
                nums = re.findall(r"L[ib](\d+)E", name)
                out.append((" ".join(x for x in (t.group(1), kind, "/".join(nums)) if x),
                            int(m.group(1)), spill, stack))
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


def cuda_core_child(src: str, checked: bool) -> None:
    """Inside one copy: every CC_CASES shape through ``_launch_cuda_core``,
    checked (when ``checked``) and timed."""
    sys.path.insert(0, src)
    import importlib
    import threading
    import time

    import torch

    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ref import ssd_scan_ref

    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    build_all([ssd.LIBRARY])
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

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

    def kernel_ms(fn, pattern, reps=10):
        """Device ms a call of each kernel whose profiler name matches
        ``pattern`` (group 1 its name), L2 flushed before each call."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(pattern, e.key)
            if m:
                out[m.group(1)] = out.get(m.group(1), 0.0) + e.self_device_time_total / reps / 1e3
        return out

    def ratio(o, r, atol, rtol):
        """Largest error over its tolerance, element by element, as
        chip_smoke.py's ssd_hold counts it."""
        o, r = o.float(), r.float()
        a = atol * max(float(r.abs().max()), 1.0)
        return float(((o - r).abs() / (a + rtol * r.abs())).max())

    res = {}
    for key, BH, S, P, N, dname in CC_CASES:
        dtype = getattr(torch, dname)
        x = randn(BH, S, P, dtype=dtype)
        dt = torch.nn.functional.softplus(randn(BH, S, dtype=torch.float32))
        A = -torch.exp(randn(BH, dtype=torch.float32, scale=0.5))
        B, C = randn(BH, S, N, dtype=dtype, scale=0.5), randn(BH, S, N, dtype=dtype, scale=0.5)
        views = (x[:, :, None], dt[:, :, None], A[:, None], B[:, :, None], C[:, :, None])
        fn = lambda: ssd._launch_cuda_core(*views, True)  # noqa: E731
        before = ssd.LIBRARY.counts["cuda_core"]
        (y, h), (y2, h2) = fn(), fn()
        r = {"launches": ssd.LIBRARY.counts["cuda_core"] - before,
             "same_bits": bool(torch.equal(y, y2) and torch.equal(h, h2)),
             "digest": hashlib.sha256(y.float().cpu().numpy().tobytes()
                                      + h.cpu().numpy().tobytes()).hexdigest()[:16]}
        if checked:
            ry, rh = ssd_scan_ref(x, dt, A, B, C, return_state=True)
            rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            r["ratio"] = [ratio(y[:, :, 0], ry, 1e-4, rtol), ratio(h[:, 0], rh, 1e-4, 0.0)]
            r["within"] = max(r["ratio"]) <= 1.0
            del ry, rh
        del y, h, y2, h2
        r["ms"] = ms(fn)
        if checked:
            r["clocks"] = clocks(fn)
            r["phases"] = kernel_ms(
                fn, r"(ssd_cc_state|ssd_cc_scan|ssd_state_pass|ssd_scan)_kernel")
        res[key] = r
        del x, dt, A, B, C, views
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(res), flush=True)


def cuda_core_probe(args) -> None:
    """Build and run every copy of the ``cuda_core`` mode; print and save
    the results; exit 1 if a checked copy is outside tolerance or not
    bit-stable."""
    srcs = {}
    if not args.earlier_only:
        only = [n for n in args.only.split(",") if n]
        srcs.update({name: copy_with(name, subs) if subs else os.path.join(ROOT, "src")
                     for name, subs in VARIANTS.items() if not only or name in only})
    if args.earlier:
        root = os.path.abspath(args.earlier)
        srcs.update({name: probe_copies.copy_with(WORK, CSRC, name, subs, root=root) if subs
                     else os.path.join(root, "src") for name, subs in EARLIER_VARIANTS.items()})
    build(srcs.values())
    # a copy that fails is reported; the others still run
    runs = {name: probe_copies.run_child(__file__, "cuda_core_timed" if "(" in name
                                         else "cuda_core_checked", src, check=False)
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
        for inst, regs, spill, stack in res["ptxas"]:
            print(f"  ptxas {inst}: {regs} registers, {spill} bytes spilled, {stack} bytes of "
                  f"stack", flush=True)
        for key, *_ in CC_CASES:
            r = res[key]
            line = (f"  {key:10} {r['ms']:.4f}  launches {r['launches']}  same bits "
                    f"{r['same_bits']}")
            if "within" in r:
                line += (f"  error over tolerance: y {r['ratio'][0]:.3g}, state "
                         f"{r['ratio'][1]:.3g}  (SM clock {r['clocks'][0]:.0f} MHz, "
                         f"{r['clocks'][1]:.0f} W)")
                if not (r["within"] and r["same_bits"] and r["launches"] == 2):
                    bad.append(f"{name} {key}")
            print(line, flush=True)
            if r.get("phases"):
                print("             kernels (profiler, device ms a call): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in r["phases"].items()), flush=True)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "cuda_core.json"), "w") as f:
        json.dump({"card": args.card, "runs": runs}, f, indent=1)
    if bad:
        print(f"ssd_scan_probe: failed, outside tolerance or not bit-stable: {bad}",
              file=sys.stderr)
        sys.exit(1)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        if sys.argv[2].startswith("cuda_core_"):
            cuda_core_child(sys.argv[3], sys.argv[2] == "cuda_core_checked")
        else:
            child(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--build":
        sys.path.insert(0, sys.argv[2])
        from repro_torch.kernels import SSD_LIBRARY
        from repro_torch.kernels._build import build_all

        build_all([SSD_LIBRARY])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", help="phases, faults, bwd, cuda_core "
                    "(default: phases faults bwd)")
    ap.add_argument("--earlier", help="cuda_core: another checkout whose kernel to time the "
                    "same way")
    ap.add_argument("--earlier-only", action="store_true",
                    help="cuda_core: time only the --earlier checkout's copies")
    ap.add_argument("--only", default="",
                    help="cuda_core: comma-separated names of this checkout's copies to run")
    args = ap.parse_args()
    modes = args.modes or ["phases", "faults", "bwd"]
    unknown = set(modes) - {"phases", "faults", "bwd", "cuda_core"}
    if unknown:
        ap.error(f"unknown modes {sorted(unknown)}")
    if args.earlier_only and not args.earlier:
        ap.error("--earlier-only needs --earlier")
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_probe: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    args.card = smi
    if "cuda_core" in modes:
        cuda_core_probe(args)
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
