#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which exits non-zero (and prints no result) on failure:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel of the port from ``src/repro_torch/csrc``
             (one ``nvcc`` per source, all started together).
3. kernels — hold every variant of each kernel against its plain PyTorch
             version on the card, at the CPU tests' shapes (each case going
             through the variant its wrapper's selector picks; every variant
             must be reached) and at the serving paths' shapes (the SSD scan
             also on the mixer's own strided, grouped layout), and time
             variant, plain version and one PyTorch call that computes the
             same function (a yardstick the port never calls: SDPA on 4-D
             views under a forced, named fused backend; cuBLAS for SwiGLU).
4. serve   — two serving runs, each with the same traffic (16 requests):
             a full-width TinyLlama-1.1B ``Engine`` (bf16, random weights
             from a seeded generator, 22 layers; flash attention and fused
             SwiGLU), then a full-width Mamba2-370M one (48 layers; the SSD
             scan's wgmma variant).  Launch counters, per kernel variant and zeroed just
             before each run, prove that run went through its kernels, each
             through the variant its selector picks for the step's shapes
             (TinyLlama: tensor-core variants only), and no other; two
             requests of each are checked against a teacher-forced forward,
             and one prefill and one decode tick are profiled.
5. cnn     — the paper's pipeline: inception_net(224) at batch 8 (random
             weights from a seeded generator), DSH plans on the whole model
             (m=4) and on the grid-sliced one (m=8), validated; run_sequential,
             the plan interpreter and the MPMD executor on m CUDA streams
             (eager, and captured into one CUDA graph, replayed twice), each
             held against the float64 run on the CPU; the executor's stream
             count and copied bytes checked; wall times and the device's busy
             share printed.  None of the three kernels may launch here.
6. faults  — the fault runner on the cnn phase's grid-sliced model, weights,
             input and reference (DSH m=8): a run with no faults on 8
             streams; the kill drill (worker 3 dies at superstep 8, heartbeats
             detect it, the planner replans to 7 workers and deep-validates the
             replan with the happens-before analyzer, the barrier snapshot
             migrates, the resume runs on 7 streams); a seeded campaign of
             stragglers and dropped rounds.  Streams are counted from the
             profiler's device events; outputs are held to the float64 run;
             none of the three kernels may launch here.
7. segmented — the segmented executor on the same sliced model, weights,
             input and reference (DSH m=8) on 8 streams: buffer depths 1, 2
             and 4, with and without checkpoints, and the span, cohort and
             parameter knobs, each eager and captured, held to the float64
             run and bit for bit to each other (snapshot registers too); a
             second input between two calls; the last snapshot against the
             fault runner's final barrier; walls beside the unrolled
             executor's, streams, bytes shipped and real, memory.
8. frontend — the serving frontend with the executor attached: 32
             fault-free requests at full width on the sliced
             inception_net(224) (every tick on the executor, every output
             held to the float64 run), then the reference's headline chaos
             drill (1000 requests, grid-sliced inception_net(64), m=8, a kill
             and a straggler; zero loss).  None of the three kernels may
             launch in phases 7 and 8.
9. report  — one JSON line of numbers per kernel variant, then the device line.

Device memory still allocated is printed at the start of each serving, cnn,
faults, segmented and frontend phase; the cyclic collector runs before the
cache is emptied between phases.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak for its type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# tolerances (absolute, relative) of a kernel against its plain version, as
# in the CPU tests: the kernel and the plain version both accumulate in f32
# and differ in summation order; bf16 outputs differ by bf16 rounding of that
FLASH_TOL = {"torch.float32": (2e-5, 1e-2), "torch.bfloat16": (3e-2, 1e-2)}
SWIGLU_TOL = {"torch.float32": (1e-4, 2e-2), "torch.bfloat16": (5e-2, 2e-2)}
# ssd_scan against the exact sequential recurrence, per element.  Both
# compute in f32 from the same inputs and differ only in summation order
# (chunked against sequential form: <= 3e-6 of y's largest magnitude and of
# the state's on the CPU, for the Pallas kernel's chunks of 16 to 256); in
# bf16 each then rounds y once, so the two may sit one bf16 ulp
# (<= 2**-7 |y|) apart.  y: |err| <= atol·max(|ref|, 1) + rtol·|ref|, with
# (atol, rtol) below; the final state (f32 in both): |err| <= 1e-4·max(|h|, 1).
# A kernel missing one of its terms fails this (PERF.md, PR 12).
SSD_Y_TOL = {"torch.float32": (1e-4, 0.0), "torch.bfloat16": (1e-4, 2 ** -7)}
SSD_STATE_TOL = 1e-4

# serving: engine logits against a teacher-forced forward over the same
# tokens, both bf16 end to end.  They differ in decode attention (plain
# chunked attention over the bf16 cache, probabilities rounded to bf16)
# against prefill/train attention (the flash kernel, f32 probabilities), and
# in the bf16 rounding of GEMMs of other shapes (8 rows against a whole
# prompt).  Measured on the CPU at 22 layers: <= 0.031; 0.25 is ~6% of the
# logits' largest magnitude (~4), far below what a wrong position, cache row
# or mask gives (errors of the logits' own size).
LOGIT_TOL = 0.25
# mamba2-370m: engine logits (decode: the one-token recurrence on the cached
# state) against a teacher-forced forward (the SSD-scan kernel over the
# whole sequence), bf16 end to end.  They round at other places: the
# kernel's y is rounded to bf16 before the D·x skip is added, decode adds it
# in f32; GEMMs of one row against a whole prompt.  48 layers amplify that,
# and the state carries each step's difference into the next few.  Measured
# on the H100 at full width (logits of ~5): <= 0.164 at the first decode
# step, <= 0.844 over all steps.  Faults planted at full depth read far
# above: a decode that does not roll its conv window, or does not carry its
# state, gives 4.2-7.7 from the second decode step on; a prefill state that
# does not reach its slot gives 1.9-3.0 at the first decode step (CPU,
# reduced width).  So the first decode step, which reads only what prefill
# cached, is held to 0.5, and every step to 2.0 (PERF.md, PR 12).
MAMBA_LOGIT_TOL, MAMBA_HANDOFF_TOL = 2.0, 0.5
# name fragments of the kernels in src/repro_torch/csrc, for the profiles
PORT_KERNELS = ("flash_", "swiglu_", "ssd_")
N_REQUESTS, MAX_NEW, SLOTS, MAX_SEQ = 16, 32, 8, 2048


def log(msg: str = "") -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        yield
    except Exception:  # any failure ends the run without a result line
        traceback.print_exc()
        log(f"FAILED phase {name}")
        sys.exit(1)
    log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing and bounds
# --------------------------------------------------------------------------- #
class Timer:
    """Median device time of a call, each run after flushing the 50 MB L2
    (as the serving path finds its weights: 22 layers do not fit in L2).
    The device then spins ~0.5 ms before the start event, so that the host
    has enqueued the whole call by the time the device reaches it: the
    events time the device's work, not a wrapper's Python between its
    launches (a busy host took more than 0.1 ms to enqueue the SSD scan's
    three kernels)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_work(BH, Sq, Sk, D, causal, elem):
    """Bytes (q, k, v read once, o written once) and operations (QK^T and
    PV, 2 each per multiply-add) of the unmasked (query, key) pairs."""
    if causal:
        off = Sk - Sq
        pairs = sum(min(Sk, max(0, i + off + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return (2 * BH * Sq * D + 2 * BH * Sk * D) * elem, 4.0 * BH * pairs * D


def swiglu_work(M, D, F, elem):
    return (M * D + 2 * D * F + M * F) * elem, 4.0 * M * D * F


def ssd_work(heads, groups, S, P, N, elem, chunk):
    """Bytes and operations of one scan over ``heads`` sequences that read
    ``groups`` B and C sequences (a flat ``[BH, S, *]`` call: groups =
    heads; the mixer's layout: the model's groups).  Bytes: x read and y
    written, B and C read, in the input type; dt, A read and the final state
    written in f32.  Operations: the chunked form at the variant's
    ``chunk``, per head and chunk C·B^T and (C·B^T∘L)·x over the lower
    triangle, C·h and the state update in full; 2 per multiply-add."""
    nbytes = ((2 * heads * S * P + 2 * groups * S * N) * elem + heads * S * 4 + heads * 4
              + heads * P * N * 4)
    Q = chunk
    macs = -(-S // Q) * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * P * N)
    return nbytes, 2.0 * heads * macs


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol) -> bool:
    atol, rtol = tol
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def launched(lib, fn):
    """Call ``fn``; return its result and the one variant of ``lib`` whose
    count it raised."""
    before = dict(lib.counts)
    out = fn()
    moved = [v for v in lib.counts if lib.counts[v] != before[v]]
    if len(moved) != 1 or lib.counts[moved[0]] != before[moved[0]] + 1:
        raise AssertionError(f"{lib.name}: one launch expected, counts {before} -> {lib.counts}")
    return out, moved[0]


def sdpa_call(torch, backend, q, k, v):
    """PyTorch's fused attention on 4-D views ``[1, BH, S, D]`` of the
    kernel's ``[BH, S, D]`` operands, forced onto ``backend``: the call fails
    rather than silently taking another backend (a 3-D call takes the math
    backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    q4, k4, v4 = (t.view(1, *t.shape) for t in (q, k, v))

    def call():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    return call


def check_kernels(torch, timer):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import (
        FLASH_LIBRARY, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, ssd_mixer, ssd_scan,
        swiglu_matmul,
    )
    from repro_torch.kernels._build import stream_handle
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref, swiglu_ref
    from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    rows = {}
    f32, bf16 = torch.float32, torch.bfloat16
    # (BH, Sq, Sk, D): the CPU tests' sweep, ragged ends, Sq != Sk both ways,
    # a head dim that is not a multiple of 16 (bf16 on the CUDA cores); f32
    # goes to the CUDA-core kernel, bf16 with D % 16 == 0 to the tensor cores
    flash_cases = [(2, 128, 128, 64), (3, 256, 256, 128), (1, 64, 64, 32), (2, 96, 96, 64),
                   (2, 100, 100, 16), (2, 64, 128, 64), (2, 128, 64, 64), (2, 100, 130, 40)]
    hit = {FLASH_LIBRARY.name: set(), SWIGLU_LIBRARY.name: set(), SSD_LIBRARY.name: set()}
    for (BH, Sq, Sk, D) in flash_cases:
        for dtype in (f32, bf16):
            for causal in (True, False):
                q, k, v = (randn(BH, s, D, dtype=dtype) for s in (Sq, Sk, Sk))
                o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=causal))
                hit[FLASH_LIBRARY.name].add(variant)
                r = flash_attention_ref(q, k, v, causal=causal)
                tol = FLASH_TOL[str(dtype)]
                if not within(o, r, tol):
                    raise AssertionError(f"flash_attention[{variant}] {(BH, Sq, Sk, D)} {dtype} "
                                         f"causal={causal}: max err {max_err(o, r):.3g} > tol {tol}")
    log(f"flash_attention: {len(flash_cases) * 4} sweep cases within tolerance "
        f"(variants {sorted(hit[FLASH_LIBRARY.name])})")
    # the serving path's prefill shapes (32 heads, head dim 64): the bf16
    # tensor-core kernel, and the CUDA-core kernel on the same shapes in f32
    # (its route); the yardstick is SDPA on 4-D views, forced onto a named
    # fused backend (flash takes no f32: the f32 row uses memory-efficient)
    for S, dtype in ((128, bf16), (1024, bf16), (1024, f32)):
        BH, D = 32, 64
        q, k, v = (randn(BH, S, D, dtype=dtype) for _ in range(3))
        o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=True))
        r = flash_attention_ref(q, k, v, causal=True)
        tol = FLASH_TOL[str(dtype)]
        if not within(o, r, tol):
            raise AssertionError(f"flash_attention[{variant}] path S={S} {dtype}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        backend, lib_name = ((SDPBackend.FLASH_ATTENTION, "sdpa[flash]") if dtype == bf16 else
                             (SDPBackend.EFFICIENT_ATTENTION, "sdpa[efficient]"))
        nbytes, ops = flash_work(BH, S, S, D, True, q.element_size())
        b_ms, b_by = bound(nbytes, ops, dtype)
        rows[("flash_attention", variant, S)] = dict(
            shape=f"BH={BH} S={S} D={D} {str(dtype)[6:]} causal", max_abs_err=max_err(o, r),
            tol=list(tol), ms=timer.ms(lambda: flash_attention(q, k, v, causal=True)),
            plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, causal=True)),
            library=lib_name, library_ms=timer.ms(sdpa_call(torch, backend, q, k, v)),
            bound_ms=b_ms, bound_by=b_by)

    # (M, D, F): the CPU tests' sweep, then a K tail (D = 2056) with F not a
    # multiple of the column tiles at both ends of the bf16 row range; bf16
    # goes to the decode kernel below 64 rows and to wgmma from 64, f32 and
    # unaligned bf16 (5, 100, 70) to the CUDA cores
    swiglu_cases = [(64, 128, 256), (128, 256, 128), (32, 64, 64), (5, 100, 70), (24, 64, 96),
                    (1, 2056, 200), (79, 2056, 200)]
    for (M, D, Fd) in swiglu_cases:
        for dtype in (f32, bf16):
            x = randn(M, D, dtype=dtype)
            wg = randn(D, Fd, dtype=dtype, scale=D ** -0.5)
            wu = randn(D, Fd, dtype=dtype, scale=D ** -0.5)
            o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_matmul(x, wg, wu))
            hit[SWIGLU_LIBRARY.name].add(variant)
            r = swiglu_ref(x, wg, wu)
            tol = SWIGLU_TOL[str(dtype)]
            if not within(o, r, tol):
                raise AssertionError(f"swiglu_matmul[{variant}] {(M, D, Fd)} {dtype}: "
                                     f"max err {max_err(o, r):.3g} > tol {tol}")
    log(f"swiglu_matmul: {len(swiglu_cases) * 2} sweep cases within tolerance "
        f"(variants {sorted(hit[SWIGLU_LIBRARY.name])})")
    for lib in (FLASH_LIBRARY, SWIGLU_LIBRARY):
        if hit[lib.name] != set(lib.variants):
            raise AssertionError(f"{lib.name}: the sweep reached {sorted(hit[lib.name])}, "
                                 f"not every variant of {sorted(lib.variants)}")
    # the serving path's shapes: decode (8 slots) and prefill rows, bf16;
    # the CUDA-core kernel on the prefill shape in f32 (its route)
    for M, dtype in ((8, bf16), (512, bf16), (1024, bf16), (512, f32)):
        D, Fd = 2048, 5632
        x = randn(M, D, dtype=dtype)
        wg = randn(D, Fd, dtype=dtype, scale=D ** -0.5)
        wu = randn(D, Fd, dtype=dtype, scale=D ** -0.5)
        o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_matmul(x, wg, wu))
        r = swiglu_ref(x, wg, wu)
        tol = SWIGLU_TOL[str(dtype)]
        if not within(o, r, tol):
            raise AssertionError(f"swiglu_matmul[{variant}] path M={M} {dtype}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        nbytes, ops = swiglu_work(M, D, Fd, x.element_size())
        b_ms, b_by = bound(nbytes, ops, dtype)
        rows[("swiglu_matmul", variant, M)] = dict(
            shape=f"M={M} D={D} F={Fd} {str(dtype)[6:]}", max_abs_err=max_err(o, r),
            tol=list(tol), ms=timer.ms(lambda: swiglu_matmul(x, wg, wu)),
            plain_ms=timer.ms(lambda: swiglu_ref(x, wg, wu)),
            library="F.silu(x@wg)*(x@wu)", library_ms=timer.ms(lambda: F.silu(x @ wg) * (x @ wu)),
            bound_ms=b_ms, bound_by=b_by)

    def ssd_inputs(BH, S, P, N, dtype, dt_shift=0.0):
        """dt = softplus(normal - dt_shift): at 0 a chunk of 64 decays by
        ~e^-50, so the state carried across chunks is negligible; at 4 (dt
        ~0.02, as in trained models) by 0.1-0.4, and it counts."""
        x = randn(BH, S, P, dtype=dtype)
        dt = torch.nn.functional.softplus(randn(BH, S, dtype=f32) - dt_shift)
        A = -torch.exp(randn(BH, dtype=f32, scale=0.5))
        B, C = randn(BH, S, N, dtype=dtype, scale=0.5), randn(BH, S, N, dtype=dtype, scale=0.5)
        return x, dt, A, B, C

    worst = {"y": 0.0, "state": 0.0}  # largest error over its tolerance, element by element

    def ssd_hold(what, out, ref, dtype):
        """Hold y and the final state to tolerance, element by element;
        return y's max error and its (atol, rtol)."""
        (y, h), (ry, rh) = out, ref
        atol, rtol = SSD_Y_TOL[str(dtype)]
        tols = {"y": (atol * max(float(ry.float().abs().max()), 1.0), rtol),
                "state": (SSD_STATE_TOL * max(float(rh.abs().max()), 1.0), 0.0)}
        for name, o, r in (("y", y, ry), ("state", h, rh)):
            o, r = o.float(), r.float()
            a, rt = tols[name]
            ratio = float(((o - r).abs() / (a + rt * r.abs())).max())
            if ratio > 1:
                raise AssertionError(
                    f"ssd_scan {what} {dtype}: {name} max err {max_err(o, r):.3g} is {ratio:.3g} "
                    f"times its tolerance (atol {a:.3g}, rtol {rt:.3g}; max |ref| "
                    f"{float(r.abs().max()):.3g})")
            worst[name] = max(worst[name], ratio)
        return max_err(y, ry), tols["y"]

    def ssd_check(what, args, dtype):
        out, variant = launched(SSD_LIBRARY, lambda: ssd_scan(*args, return_state=True))
        hit[SSD_LIBRARY.name].add(variant)
        return ssd_hold(f"[{variant}] {what}", out, ssd_scan_ref(*args, return_state=True),
                        dtype), variant

    def cuda_core_bf16(x, dt, A, B, C):
        """The CUDA-core kernel on bf16 operands the selector now sends to
        wgmma: the earlier kernel of the mamba2 path, timed beside the new
        one in the same run (the call the wrapper made before)."""
        BH, S, P = x.shape
        y = torch.empty_like(x)
        h = torch.empty((BH, P, B.shape[-1]), dtype=f32, device="cuda")
        SSD_LIBRARY.launch("cuda_core", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                           C.data_ptr(), y.data_ptr(), h.data_ptr(), BH, S, P, B.shape[-1], 1,
                           stream_handle(x))
        return y, h

    # (BH, S, P, N): the CPU tests' sweep, then ragged S and P; f32 and bf16
    # with P != 64 or N % 16 != 0 go to the CUDA-core kernel, bf16 with
    # P = 64 to wgmma
    ssd_cases = [(2, 128, 32, 64), (3, 256, 64, 128), (2, 128, 64, 32), (1, 64, 16, 16),
                 (2, 100, 64, 128), (1, 37, 24, 8)]
    for (BH, S, P, N) in ssd_cases:
        for dtype in (f32, bf16):
            ssd_check((BH, S, P, N), ssd_inputs(BH, S, P, N, dtype), dtype)
    # the wgmma variant's edges: ragged S, one position, one chunk, state
    # widths 16 to 128, a prefill-length sequence
    wgmma_cases = [(2, 100, 64, 128), (3, 256, 64, 128), (1, 37, 64, 16), (2, 64, 64, 64),
                   (1, 1, 64, 128), (2, 1000, 64, 128)]
    for (BH, S, P, N) in wgmma_cases:
        _, variant = ssd_check((BH, S, P, N), ssd_inputs(BH, S, P, N, bf16), bf16)
        if variant != "wgmma":
            raise AssertionError(f"ssd_scan {(BH, S, P, N)} bf16 took {variant}, not wgmma")
    # slow decay, where the state carried from chunk to chunk counts: both
    # variants
    slow_cases = [(2, 1000, 64, 128, bf16), (3, 256, 64, 128, bf16), (2, 300, 64, 16, bf16),
                  (2, 300, 64, 128, f32)]
    for (BH, S, P, N, dtype) in slow_cases:
        ssd_check(f"{(BH, S, P, N)} slow decay", ssd_inputs(BH, S, P, N, dtype, dt_shift=4.0),
                  dtype)
    if hit[SSD_LIBRARY.name] != set(SSD_LIBRARY.variants):
        raise AssertionError(f"ssd_scan: the sweep reached {sorted(hit[SSD_LIBRARY.name])}")

    def conv_views(Bsz, S, H, G, P, N, scale=1.0):
        """x, dt, A, B, C in the mixer's layout: x, B and C strided views of
        one conv-output buffer [Bsz, S, H·P + 2·G·N] (bf16), as
        ``models/ssm.py::_split`` slices them."""
        buf = randn(Bsz, S, H * P + 2 * G * N, dtype=bf16, scale=scale)
        x = buf[..., :H * P].reshape(Bsz, S, H, P)
        Bm = buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
        Cm = buf[..., H * P + G * N:].reshape(Bsz, S, G, N)
        dt = torch.nn.functional.softplus(randn(Bsz, S, H, dtype=f32))
        A = -torch.exp(randn(H, dtype=f32, scale=0.5))
        return x, dt, A, Bm, Cm

    # the mixer's own layout, grouped (8 heads on 2 groups) and strided,
    # against the plain version on the CPU (broadcast copies)
    args = conv_views(2, 150, 8, 2, 64, 128, scale=0.5)
    out, variant = launched(SSD_LIBRARY, lambda: ssd_mixer(*args, return_state=True))
    if variant != "wgmma":
        raise AssertionError(f"ssd_mixer on strided views took {variant}, not wgmma")
    ref = ssd_mixer(*(t.cpu() for t in args), return_state=True)
    ssd_hold("[wgmma] mixer B=2 S=150 H=8 G=2 strided", (out[0].cpu(), out[1].cpu()), ref, bf16)
    log(f"ssd_scan: {len(ssd_cases) * 2 + len(wgmma_cases) + len(slow_cases)} sweep cases and "
        f"a strided grouped "
        f"mixer within tolerance (y and final state; variants {sorted(hit[SSD_LIBRARY.name])})")

    # mamba2-370m's prefill: 32 heads, head dim 64, state 128 (one group).
    # [BH, S, *] rows: wgmma in bf16, the CUDA-core kernel in f32 (its route)
    # and, for comparison, in bf16 (the mamba2 path's kernel before wgmma)
    for S, dtype in ((128, bf16), (1024, bf16), (1024, f32)):
        BH, P, N = 32, 64, 128
        args = ssd_inputs(BH, S, P, N, dtype)
        (err, tol), variant = ssd_check(f"path S={S}", args, dtype)
        b_ms, b_by = bound(*ssd_work(BH, BH, S, P, N, args[0].element_size(), SSD_CHUNK[variant]),
                           dtype)
        rows[("ssd_scan", variant, S)] = dict(
            shape=f"BH={BH} S={S} P={P} N={N} {str(dtype)[6:]}", max_abs_err=err, tol=list(tol),
            ms=timer.ms(lambda: ssd_scan(*args, return_state=True)),
            plain_ms=timer.ms(lambda: ssd_scan_ref(*args, return_state=True), reps=5),
            library=None, library_ms=None,  # no single PyTorch call computes an SSD scan
            bound_ms=b_ms, bound_by=b_by)
        if S == 1024 and dtype == bf16:
            out = cuda_core_bf16(*args)
            err, tol = ssd_hold("[cuda_core] path S=1024", out,
                                ssd_scan_ref(*args, return_state=True), bf16)
            b_ms, b_by = bound(*ssd_work(BH, BH, S, P, N, 2, SSD_CHUNK["cuda_core"]), bf16)
            rows[("ssd_scan", "cuda_core", "bf16")] = dict(
                rows[("ssd_scan", variant, S)], shape=f"BH={BH} S={S} P={P} N={N} bf16, earlier",
                max_abs_err=err, tol=list(tol),
                ms=timer.ms(lambda: cuda_core_bf16(*args)), bound_ms=b_ms, bound_by=b_by)
    # the serving layout: x, B and C views of mamba2's conv output [1, S,
    # 2048 + 2·128], one group; the bound counts the bytes this layout needs
    S, H, G, P, N = 1024, 32, 1, 64, 128
    args = conv_views(1, S, H, G, P, N)
    flat = (args[0][0].movedim(1, 0).contiguous(), args[1][0].T.contiguous(), args[2],
            args[3][0, :, 0][None].expand(H, S, N).contiguous(),
            args[4][0, :, 0][None].expand(H, S, N).contiguous())
    out, variant = launched(SSD_LIBRARY, lambda: ssd_mixer(*args, return_state=True))
    ref = ssd_scan_ref(*flat, return_state=True)
    err, tol = ssd_hold(f"[{variant}] serving layout S={S}",
                        (out[0][0].movedim(1, 0), out[1][0]), ref, bf16)
    b_ms, b_by = bound(*ssd_work(H, G, S, P, N, 2, SSD_CHUNK[variant]), bf16)
    rows[("ssd_scan", variant, "serving")] = dict(
        shape=f"B=1 S={S} H={H} G={G} P={P} N={N} bf16, views of conv_out", max_abs_err=err,
        tol=list(tol), ms=timer.ms(lambda: ssd_mixer(*args, return_state=True)),
        plain_ms=timer.ms(lambda: ssd_scan_ref(*flat, return_state=True), reps=5),
        library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(f"ssd_scan: largest error over its tolerance, element by element, in the sweep and at "
        f"the path shapes: y {worst['y']:.3g}, final state {worst['state']:.3g}")

    log(f"{'kernel':26} {'shape':32} {'max_err':>9} {'(atol, rtol)':>14} {'ms':>9} "
        f"{'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} bound_by  library")
    for (name, variant, _), r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name + '[' + variant + ']':26} {r['shape']:32} {r['max_abs_err']:9.3g} "
            f"{'(' + ', '.join(f'{t:.3g}' for t in r['tol']) + ')':>14} {r['ms']:9.4f} "
            f"{r['plain_ms']:9.4f} {lib:>10} {r['bound_ms']:9.4f} {r['bound_by']:11} {r['library']}")
    return rows


# --------------------------------------------------------------------------- #
# phase 4: serving
# --------------------------------------------------------------------------- #
def expected_launches(torch, cfg, prompt_lens, n_decode: int, slots: int) -> dict:
    """Launches of each kernel variant on a serving run: one per layer and
    step of the kernels the model's layers call, through the variant each
    wrapper's selector picks for that step's shapes (bf16; the MLP's rows
    padded as ``ops.fused_swiglu`` pads them), and none of the others."""
    from repro_torch.kernels import (
        LIBRARIES, select_flash_variant, select_ssd_variant, select_swiglu_variant,
    )

    L = cfg.n_layers
    bf16 = torch.bfloat16
    expect = {lib.name: {v: 0 for v in lib.variants} for lib in LIBRARIES}
    if cfg.family == "ssm":  # the SSD scan in every prefill mixer; decode is plain
        variant = select_ssd_variant(cfg.ssm.head_dim, cfg.ssm.d_state, bf16)
        expect["ssd_scan"][variant] = L * len(prompt_lens)
        return expect
    for n in prompt_lens:
        expect["flash_attention"][select_flash_variant(cfg.head_dim, bf16)] += L
        m = -(-n // min(256, n)) * min(256, n)
        expect["swiglu_matmul"][select_swiglu_variant(m, cfg.d_model, cfg.d_ff, bf16)] += L
    expect["swiglu_matmul"][select_swiglu_variant(slots, cfg.d_model, cfg.d_ff, bf16)] += (
        L * n_decode)
    return expect


def serve(torch, np, arch: str, logit_tol: float, handoff_tol: float):
    """Serve the traffic with ``arch``; hold two requests' logits to a
    teacher-forced forward: every step within ``logit_tol``, the first
    decode step (after prefill's cache) within ``handoff_tol``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LIBRARIES
    from repro_torch.models import forward, init_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    if cfg.family != "ssm":
        # init_params draws at the reference's ParamDef.default_scale, which
        # takes shape[-2] as the fan-in: for wq/wk/wv [d, H, Dh] that is the
        # head count, not d_model, and attention scores come out with a std
        # of ~180.  Softmax is then a hard argmax that any rounding
        # difference flips, and a deep random model is chaotic: the
        # reference's own engine and teacher-forced decoding disagree from 8
        # layers on (f32, CPU).  Scaling q/k/v to the fan-in d_model makes
        # the teacher-forced check below meaningful.
        with torch.no_grad():
            for block in model.layers:
                for name in ("wq", "wk", "wv"):
                    w = block.attn[name]
                    w.mul_((w.shape[1] / cfg.d_model) ** 0.5)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B params "
        f"(bf16), init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, size=N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in lens]
    engine = Engine(cfg, model, ServeConfig(max_seq=MAX_SEQ, slots=SLOTS), device="cuda")
    reqs = [engine.submit(p, max_new=MAX_NEW) for p in prompts]

    # record the logits the engine decides on for two requests, and time its steps
    watched = {0: [], 1: []}
    prefill_ms, decode_ms = [], []
    prefill, decode = engine._prefill1, engine._decode

    def timed_prefill(params, cache, inputs):
        rid = len(prefill_ms)  # requests are prefilled in submission order
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, cache = prefill(params, cache, inputs)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        if rid in watched:
            watched[rid].append(last[0].float())
        return last, cache

    def timed_decode(params, cache, tokens):
        live = {s: r.rid for s, r in enumerate(engine.slot_req) if r is not None}
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = decode(params, cache, tokens)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        for s, rid in live.items():
            if rid in watched:
                watched[rid].append(logits[s].float())
        return logits, cache

    engine._prefill1, engine._decode = timed_prefill, timed_decode
    torch.cuda.reset_peak_memory_stats()
    for lib in LIBRARIES:
        lib.reset()
    t0 = time.perf_counter()
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.name: dict(lib.counts) for lib in LIBRARIES}

    for r in reqs:
        if not (r.done and len(r.out) == MAX_NEW and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"request {r.rid}: done={r.done}, {len(r.out)} tokens")
    n_tok = sum(len(r.out) for r in reqs)
    log(f"served {len(reqs)} requests (prompts {int(lens.min())}-{int(lens.max())} tokens, "
        f"{MAX_NEW} new each) in {wall:.3f} s: {n_tok / wall:.1f} tokens/s, "
        f"{len(prefill_ms)} prefills mean {np.mean(prefill_ms):.2f} ms, "
        f"{len(decode_ms)} decode ticks mean {np.mean(decode_ms):.2f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(prefill_ms) != len(reqs):
        raise AssertionError(f"{len(prefill_ms)} prefills for {len(reqs)} requests")
    expect = expected_launches(torch, cfg, [len(p) for p in prompts], len(decode_ms), SLOTS)
    log(f"launches on the serving path: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    if any(launches[lib]["cuda_core"] for lib in launches):
        raise AssertionError("a serving launch went through a CUDA-core kernel")

    # the timing closures read the engine and are stored on it: put the
    # engine's own steps back, so that the engine and its weights are freed
    # with the last reference to them, not at the next cyclic collection
    engine._prefill1, engine._decode = prefill, decode
    profile_steps(torch, engine, prompts[int(np.argmax(lens))])

    # teacher-forced check: a train-mode forward over prompt + generated tokens
    failures, worst, agree, decided = [], 0.0, 0, 0
    for rid, rows in watched.items():
        r = reqs[rid]
        toks = torch.tensor(r.prompt + r.out[:-1], device="cuda")[None]
        tf = forward(model, cfg, {"tokens": toks})[0, len(r.prompt) - 1:].float()
        eng = torch.stack(rows)
        if eng.shape != tf.shape:
            raise AssertionError(f"request {rid}: engine logits {tuple(eng.shape)} vs {tuple(tf.shape)}")
        step_err = (eng - tf).abs().amax(dim=-1)
        worst = max(worst, float(step_err.max()))
        top2 = tf.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        tf_tok = tf.argmax(-1).tolist()
        log(f"request {rid} (prompt {len(r.prompt)}): per-step max |engine - teacher-forced "
            f"logit| {[round(e, 3) for e in step_err.tolist()]}, max |logit| "
            f"{float(tf.abs().max()):.2f}")
        for i, t in enumerate(r.out):
            agree += int(t == tf_tok[i])
            # no logit moved by more than step_err[i]: a top-2 margin above
            # twice that decides the engine's token
            if margin[i] > 2 * float(step_err[i]):
                decided += 1
                if t != tf_tok[i]:
                    failures.append(f"request {rid} step {i}: engine token {t} != teacher-forced "
                                    f"{tf_tok[i]} (margin {margin[i]:.3f})")
        if float(step_err.max()) > logit_tol:
            failures.append(f"request {rid}: logits differ by {float(step_err.max()):.4f} > {logit_tol}")
        if float(step_err[1]) > handoff_tol:
            failures.append(f"request {rid}: first decode step's logits differ by "
                            f"{float(step_err[1]):.4f} > {handoff_tol}")
    log(f"teacher-forced: {agree}/{2 * MAX_NEW} tokens equal, {decided} decided (top-2 margin "
        f"above twice the step's logit error); max logit error {worst:.4f} (tol {logit_tol}; "
        f"first decode step tol {handoff_tol})")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def profile_steps(torch, engine, prompt) -> None:
    """Device time by kernel for one prefill of ``prompt`` and one decode
    tick of the full slot pool (after the counted run).  Wall time is taken
    without the profiler; the device's busy time with it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache

    toks = torch.tensor(prompt, device="cuda")[None]
    cfg, scfg = engine.cfg, engine.scfg
    steps = {
        f"prefill ({len(prompt)} tokens)": lambda: engine._prefill1(
            engine.params, init_cache(cfg, 1, scfg.max_seq), {"tokens": toks}),
        f"decode tick ({scfg.slots} slots)": lambda: engine._decode(
            engine.params, engine.cache, engine.next_tok),
    }
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only: operator rows would count their kernels twice
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        events.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f"profile {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
            f"device idle {100 * max(0.0, 1 - busy / wall):.1f}%")
        # the eight largest, then every other kernel of the port's sources
        ours = [e for e in events[8:] if any(k in e.key for k in PORT_KERNELS)]
        for e in events[:8] + ours:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


# --------------------------------------------------------------------------- #
# phase 5: the paper's pipeline, inception_net(224) on m streams
# --------------------------------------------------------------------------- #
CNN_HW, CNN_BATCH, CNN_REPS = 224, 8, 20
# every run against the port's float64 run_sequential on the CPU: f32 on the
# card (TF32 off) differs from it by f32 rounding only
CNN_TOL = 1e-4


def wall_ms(torch, fn, reps: int = CNN_REPS, warm: int = 3) -> float:
    """Median wall time of one call: CUDA events on the calling stream
    around the call, host enqueue included (an executor joins its worker
    streams back into the calling stream before it returns)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_events(torch, fn) -> tuple:
    """Run ``fn`` once under the profiler; return its result and its device
    events (kernels, copies, fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy(events) -> tuple:
    """The union of the events' intervals over every stream and their plain
    sum (above the union where streams overlap), in ms, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    union, total, end = 0.0, 0.0, -math.inf
    for lo, hi in spans:
        total += hi - lo
        if hi > end:
            union += hi - max(lo, end)
            end = hi
    return union / 1e3, total / 1e3, len(spans)


def device_busy_ms(torch, fn) -> tuple:
    """Device time of one call under the profiler (after one call unprofiled):
    ``busy`` of its device events."""
    fn()
    return busy(device_events(torch, fn)[1])


def cnn_phase(torch) -> tuple:
    """inception_net(224) at batch 8 through the paper's pipeline: DSH m=4 on
    the whole model and DSH m=8 on the grid-sliced one, each plan validated,
    interpreted and executed on m CUDA streams (eager, then as one captured
    CUDA graph), every result held against the float64 CPU run.  Returns
    the report and what the faults phase reuses (the sliced model, weights,
    input, reference and tolerance)."""
    from repro_torch.codegen import (
        build_mpmd_executor, build_plan, coalesce_transfer_steps, executed_comm_bytes,
        interpret_plan, validate_plan,
    )
    from repro_torch.core import dsh
    from repro_torch.core.costmodel import KEYSTONE_CPU
    from repro_torch.kernels import LIBRARIES
    from repro_torch.models.cnn import inception_net, run_sequential
    from repro_torch.models.slicing import choose_slice_factors, slice_model

    for lib in LIBRARIES:
        lib.reset()
    model = inception_net(CNN_HW)
    params = model.init_params(0, device="cuda")
    x = torch.randn((CNN_BATCH, CNN_HW, CNN_HW, 3), generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    ref = run_sequential(model, {k: {n: t.cpu().double() for n, t in d.items()}
                                 for k, d in params.items()}, x.double())
    tol = CNN_TOL * max(1.0, float(ref.abs().max()))
    log(f"inception_net({CNN_HW}): {len(model.layers)} layers, "
        f"{sum(t.numel() for d in params.values() for t in d.values()) / 1e6:.2f} M weights; "
        f"float64 CPU reference at batch {CNN_BATCH} in {time.perf_counter() - t0:.1f} s, "
        f"max |ref| {float(ref.abs().max()):.4g}, tolerance {tol:.3g}")
    x = x.cuda()
    worst = {}

    def hold(what, out):
        if tuple(out.shape) != tuple(ref.shape) or out.dtype != torch.float32:
            raise AssertionError(f"{what}: {tuple(out.shape)} {out.dtype}, expected "
                                 f"{tuple(ref.shape)} float32")
        err = float((out.cpu().double() - ref).abs().max())
        if not err <= tol:  # NaN fails too
            raise AssertionError(f"{what}: max abs error {err:.3g} > {tol:.3g}")
        worst[what] = err

    sliced = slice_model(model, choose_slice_factors(model, KEYSTONE_CPU))
    times = {}
    for name, mdl in (("whole", model), ("sliced", sliced)):
        hold(f"run_sequential {name}", run_sequential(mdl, params, x))
        times[f"run_sequential {name}"] = wall_ms(torch, lambda: run_sequential(mdl, params, x))
    plans = {}
    for name, mdl, m in (("whole m=4", model, 4), ("sliced m=8", sliced, 8)):
        dag = mdl.to_dag(KEYSTONE_CPU, time_unit=1e-6)
        plan = build_plan(dsh(dag, m), dag)
        stats = validate_plan(plan, dag, mdl)
        log(f"DSH {name}: {len(mdl.layers)} tasks, {len(plan.steps)} supersteps "
            f"({len(coalesce_transfer_steps(plan).steps)} after coalescing), {plan.n_transfers} "
            f"transfers, makespan {plan.makespan:.1f} us (KEYSTONE_CPU cost model); "
            f"validate_plan: {stats}")
        hold(f"interpret_plan {name}", interpret_plan(plan, mdl, params, x))
        f = build_mpmd_executor(plan, mdl, params, device="cuda", batch=CNN_BATCH)
        hold(f"executor eager {name}", f.eager(x))
        torch.cuda.synchronize()
        handles = {s.cuda_stream for s in f.streams}
        if len(handles) != m or f.streams_used != handles:
            raise AssertionError(f"{name}: work went to {len(f.streams_used)} of {len(handles)} "
                                 f"streams, {m} workers")
        want = executed_comm_bytes(plan, mdl, batch=CNN_BATCH)
        if f.comm_bytes != want:
            raise AssertionError(f"{name}: copied {f.comm_bytes} bytes, executed_comm_bytes {want}")
        first, second = f(x), f(x)
        hold(f"executor captured {name} (replay 1)", first)
        hold(f"executor captured {name} (replay 2)", second)
        times[f"executor eager {name}"] = wall_ms(torch, lambda: f.eager(x))
        times[f"executor captured {name}"] = wall_ms(torch, lambda: f(x))
        busy, total, n_events = device_busy_ms(torch, lambda: f.eager(x))
        eager_ms = times[f"executor eager {name}"]
        plans[name] = dict(m=m, tasks=len(mdl.layers), supersteps=len(plan.steps),
                           transfers=plan.n_transfers, comm_bytes=f.comm_bytes,
                           streams=len(handles), busy_ms=busy, kernel_sum_ms=total,
                           device_events=n_events, busy_share=busy / eager_ms)
        log(f"executor {name}: {len(handles)} streams, {f.comm_bytes} bytes copied between "
            f"workers (= executed_comm_bytes); one eager call: {n_events} device events, busy "
            f"{busy:.3f} ms (union over streams; sum {total:.3f} ms), {100 * busy / eager_ms:.1f}% "
            f"of its {eager_ms:.3f} ms wall")
        del f
    launches = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    if any(n for counts in launches.values() for n in counts.values()):
        raise AssertionError(f"the CNN path launched a Hopper kernel: {launches}")
    log(f"all {len(worst)} runs within tolerance; largest error {max(worst.values()):.3g} "
        f"({max(worst, key=worst.get)})")
    log(f"median wall of one call at batch {CNN_BATCH} ({CNN_REPS} calls, CUDA events):")
    for k, v in times.items():
        log(f"  {k:34} {v:9.3f} ms")
    log(f"launches of the port's kernels on this path: {launches}")
    shared = dict(sliced=sliced, params=params, x=x, ref=ref, tol=tol)
    return {"times_ms": times, "plans": plans, "max_abs_err": worst}, shared


# --------------------------------------------------------------------------- #
# phase 6: the fault runner and the kill drill on the sliced plan
# --------------------------------------------------------------------------- #
FAULT_M, FAULT_KILL_STEP, FAULT_KILL_WORKER, FAULT_REPS = 8, 8, 3, 5


def device_streams(torch, fn) -> tuple:
    """Run ``fn`` once under the profiler; return its result, the streams
    (the profiler's ids) that copied to the host, the count of device events
    per stream and name, and the device's busy ms (``busy``) with the part
    of it spent copying to the host.

    A runner worker copies its barrier snapshot to the host on its own
    stream, so the streams that copied to the host are the workers that
    ran.  cuDNN may run part of a convolution on a stream of its own (FFT
    kernels, on the card's machine): such a stream carries the worker's
    convolution, not a worker, and is reported beside them.  Raises if a
    copy, fill or PyTorch kernel ran on a stream that is not a worker's."""
    from collections import Counter, defaultdict

    out, evs = device_events(torch, fn)
    events = defaultdict(Counter)
    for e in evs:
        events[getattr(e, "device_resource_id", e.thread)][e.name] += 1
    to_host = {s for s, names in events.items() if any(n.startswith("Memcpy DtoH") for n in names)}
    strays = {s: names for s, names in events.items() if s not in to_host and any(
        n.startswith(("Memcpy", "Memset")) or "at::native" in n for n in names)}
    if strays:
        raise AssertionError(f"PyTorch's own device work off the workers' streams: {strays}")
    union, _total, _n = busy(evs)
    dtoh = busy([e for e in evs if e.name.startswith("Memcpy DtoH")])[0]
    return out, to_host, events, (union, dtoh)


def stream_report(to_host, events) -> str:
    """Per stream: its device events; the other streams' names too."""
    parts = [f"{sum(events[s].values())}" for s in sorted(to_host)]
    other = {s: dict(events[s].most_common(3)) for s in events if s not in to_host}
    return f"workers' streams {len(to_host)} (events {', '.join(parts)}); other streams {other}"


def faults_phase(torch, shared: dict) -> dict:
    """The fault runner (``runtime/faults.py``) on the grid-sliced
    inception_net(224) at batch 8, DSH m=8, with the cnn phase's weights,
    input and float64 reference: a run with no faults on 8 streams; the
    kill drill (worker 3 dies entering superstep 8, the monitor detects it,
    the planner replans to 7 workers and deep-validates the replan, the
    barrier snapshot migrates, the resume runs on 7 streams); a seeded
    campaign of stragglers and dropped rounds.  None of the three kernels
    may launch here."""
    import repro_torch.codegen.analyze as analyze_mod
    import repro_torch.runtime.faults as faults_mod
    from repro_torch.codegen import build_plan, coalesce_transfer_steps, plan_fingerprint
    from repro_torch.core import dsh
    from repro_torch.core.costmodel import KEYSTONE_CPU
    from repro_torch.kernels import LIBRARIES
    from repro_torch.runtime import FaultPlan, HealthMonitor, kill_and_resume_drill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for lib in LIBRARIES:
        lib.reset()
    sliced, params, x, ref, tol = (shared[k] for k in ("sliced", "params", "x", "ref", "tol"))
    worst = {}

    def hold(what, out):
        if out is None or tuple(out.shape) != tuple(ref.shape) or str(out.dtype) != "float32":
            raise AssertionError(f"{what}: {None if out is None else (out.shape, out.dtype)}, "
                                 f"expected {tuple(ref.shape)} float32")
        err = float((torch.from_numpy(out).double() - ref).abs().max())
        if not err <= tol:  # NaN fails too
            raise AssertionError(f"{what}: max abs error {err:.3g} > {tol:.3g}")
        worst[what] = err

    def snapshot_bytes(outcome) -> int:
        return sum(b.nbytes for snap in outcome.snapshots.values() for b in snap)

    dag = sliced.to_dag(KEYSTONE_CPU, time_unit=1e-6)
    plan = coalesce_transfer_steps(build_plan(dsh(dag, FAULT_M), dag))
    layout = faults_mod._plan_layout(plan, sliced)
    n_steps = len(plan.steps)
    log(f"DSH m={FAULT_M} on {len(sliced.layers)} tasks: {n_steps} supersteps, "
        f"{plan.n_transfers} transfers, {layout.total} packed columns per worker")

    # 1. no faults: every superstep on 8 streams, the final barrier's snapshot
    def run():
        return faults_mod.run_with_faults(plan, sliced, params, x, layout)

    out = run()
    if out.status != "ok":
        raise AssertionError(f"no-fault run ended {out.status}")
    hold("run_with_faults, no faults", out.output)
    walls = []
    for _ in range(FAULT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out, streams, events, (busy_ms, dtoh_ms) = device_streams(torch, run)
    hold("run_with_faults, no faults (profiled)", out.output)
    if len(streams) != FAULT_M:
        raise AssertionError(f"no-fault run: {stream_report(streams, events)}; not {FAULT_M}")
    no_faults = dict(wall_ms=sorted(walls)[len(walls) // 2], walls_ms=walls,
                     streams=len(streams), device_streams=len(events),
                     snapshot_bytes=snapshot_bytes(out), busy_ms=busy_ms, to_host_ms=dtoh_ms)
    log(f"no faults: median wall {no_faults['wall_ms']:.3f} ms of {FAULT_REPS} calls (host clock, "
        f"final barrier's snapshot to the host included: {no_faults['snapshot_bytes']} bytes); "
        f"one profiled call: device busy {busy_ms:.3f} ms (union over streams), of which "
        f"copies to the host {dtoh_ms:.3f} ms; {stream_report(streams, events)}")

    # 2. the kill drill, its runs and its deep analysis observed through
    # wrappers of the module functions it calls (the drill itself is the
    # reference's, verbatim)
    runs, analyses, resume = [], [], {}
    real_run, real_resume, real_analyze = (
        faults_mod.run_with_faults, faults_mod.resume_plan, analyze_mod.analyze_plan)

    def timed_run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outcome = real_run(*a, **kw)
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3, outcome))
        return outcome

    def timed_analyze(*a, **kw):
        t0 = time.perf_counter()
        report = real_analyze(*a, **kw)
        analyses.append(((time.perf_counter() - t0) * 1e3, a[0], kw.get("depths"), report))
        return report

    def counted_resume(*a, **kw):
        """The resume as the drill calls it, then once more under the
        profiler, to count the streams it runs on."""
        outcome = real_resume(*a, **kw)
        again, resume["streams"], resume["events"], resume["busy"] = device_streams(
            torch, lambda: real_resume(*a, **kw))
        hold("kill drill, resumed (profiled)", again.output)
        return outcome

    faults_mod.run_with_faults, faults_mod.resume_plan = timed_run, counted_resume
    analyze_mod.analyze_plan = timed_analyze
    try:
        t0 = time.perf_counter()
        drill = kill_and_resume_drill(sliced, params, x, dag, m=FAULT_M,
                                      kill_step=FAULT_KILL_STEP, kill_worker=FAULT_KILL_WORKER,
                                      hw=KEYSTONE_CPU)
        drill_s = time.perf_counter() - t0
    finally:
        faults_mod.run_with_faults, faults_mod.resume_plan = real_run, real_resume
        analyze_mod.analyze_plan = real_analyze
    new_plan, cert = drill["new_plan"], drill["certificate"]
    if not (drill["detected"] and new_plan.n_workers == FAULT_M - 1
            and drill["recomputed_supersteps"] <= 1 and drill["migrated_bytes"] > 0
            and cert is not None and cert.total >= new_plan.makespan):
        raise AssertionError(f"drill: detected {drill['detected']}, {new_plan.n_workers} workers, "
                             f"{drill['recomputed_supersteps']} recomputed supersteps, "
                             f"{drill['migrated_bytes']} migrated bytes, certificate "
                             f"{None if cert is None else cert.total} for makespan "
                             f"{new_plan.makespan}")
    hold("kill drill, resumed", drill["output"])
    deep = [a for a in analyses if plan_fingerprint(a[1]) == plan_fingerprint(new_plan)]
    if len(deep) != 1 or tuple(deep[0][2]) != (1, 2, 4) or not deep[0][3].ok:
        raise AssertionError(f"the replan was not deep-validated once at depths (1, 2, 4): "
                             f"{[(round(w), d, r.ok) for w, _p, d, r in deep]}")
    analysis_ms, _plan, _depths, report = deep[0]
    # the run up to the kill, the resume, and the resume again under the profiler
    if len(runs) != 3 or runs[0][1].status != "killed" or runs[1][1].status != "ok":
        raise AssertionError(f"drill runs: {[(o.status, o.step) for _w, o in runs]}")
    if len(resume["streams"]) != FAULT_M - 1:
        raise AssertionError(f"resume: {stream_report(resume['streams'], resume['events'])}; "
                             f"not {FAULT_M - 1}")
    events = report.stats["plan_events"] + report.stats["cell_events"]
    kill = dict(
        drill_s=drill_s, replan_ms=drill["replan_ms"], analysis_ms=analysis_ms,
        analysis_events=events, plan_events=report.stats["plan_events"],
        cell_events=report.stats["cell_events"], to_kill_ms=runs[0][0],
        kill_snapshot_bytes=snapshot_bytes(runs[0][1]), resume_ms=runs[1][0],
        resume_snapshot_bytes=snapshot_bytes(runs[1][1]), resume_streams=len(resume["streams"]),
        resume_busy_ms=resume["busy"][0], resume_to_host_ms=resume["busy"][1],
        migrated_bytes=drill["migrated_bytes"], placements=drill["placements"],
        recomputed_nodes=drill["recomputed_nodes"], completed_nodes=drill["completed_nodes"],
        n_steps_new=drill["n_steps_new"], transfers_new=new_plan.n_transfers,
        cert_total=cert.total, makespan_new=new_plan.makespan)
    log(f"kill drill (worker {FAULT_KILL_WORKER} at superstep {FAULT_KILL_STEP}): {drill_s:.1f} s "
        f"in all; up to the kill {kill['to_kill_ms']:.3f} ms ({kill['kill_snapshot_bytes']} "
        f"snapshot bytes to the host); replan to {new_plan.n_workers} workers "
        f"({kill['n_steps_new']} supersteps, {kill['transfers_new']} transfers) "
        f"{kill['replan_ms']:.1f} ms, of which the deep analysis at depths (1, 2, 4) "
        f"{analysis_ms:.1f} ms over {events} events ({kill['plan_events']} superstep, "
        f"{kill['cell_events']} cell); migrated {kill['migrated_bytes']} bytes in "
        f"{kill['placements']} placements, {kill['recomputed_nodes']} nodes recomputed; "
        f"resume {kill['resume_ms']:.3f} ms (profiled: device busy {resume['busy'][0]:.3f} ms, "
        f"copies to the host {resume['busy'][1]:.3f} ms), "
        f"{stream_report(resume['streams'], resume['events'])} "
        f"({kill['resume_snapshot_bytes']} snapshot bytes to the host); certificate "
        f"{cert.total:.1f} >= makespan {new_plan.makespan:.1f} (KEYSTONE_CPU units)")

    # 3. a seeded campaign of stragglers and dropped rounds
    seed = next(s for s in range(1000) if {"straggle", "drop_round"} <= {
        e.kind for e in FaultPlan.random(FAULT_M, n_steps, seed=s, p_kill=0.0).events})
    campaign = FaultPlan.random(FAULT_M, n_steps, seed=seed, p_kill=0.0)
    monitor = HealthMonitor(FAULT_M, heartbeat_timeout=1e9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = faults_mod.run_with_faults(plan, sliced, params, x, layout, faults=campaign,
                                     monitor=monitor, dag=dag)
    campaign_ms = (time.perf_counter() - t0) * 1e3
    if out.status != "ok":
        raise AssertionError(f"campaign run ended {out.status}")
    hold("campaign", out.output)
    out_bytes = {n: layout.size(n) * 4.0 for n in layout.offsets}
    dropped = sorted({e.step for e in campaign.events if e.kind == "drop_round"})
    want = sum(faults_mod._round_bytes(plan.steps[i], out_bytes) for i in dropped) * CNN_BATCH
    slow = {}
    for e in campaign.events:
        if e.kind == "straggle":
            slow[e.worker] = max(slow.get(e.worker, 1.0), e.factor)
    if out.retransmitted_bytes != want or out.straggled != slow:
        raise AssertionError(f"campaign: retransmitted {out.retransmitted_bytes} bytes (want "
                             f"{want}), straggled {out.straggled} (want {slow})")
    if any(len(w.timings) != min(n_steps, monitor.window) for w in monitor.workers.values()):
        raise AssertionError("campaign: the monitor missed a superstep")
    verdict = monitor.check()
    log(f"campaign seed {seed}: {[(e.kind, e.step, e.worker) for e in campaign.events]}; "
        f"{campaign_ms:.3f} ms; retransmitted {out.retransmitted_bytes:.0f} bytes over dropped "
        f"rounds {dropped}; straggled {slow}; monitor verdict {verdict}")

    launches = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    if any(n for counts in launches.values() for n in counts.values()):
        raise AssertionError(f"the fault runner launched a Hopper kernel: {launches}")
    log(f"all {len(worst)} outputs within tolerance {tol:.3g}; largest error "
        f"{max(worst.values()):.3g} ({max(worst, key=worst.get)}); launches of the port's "
        f"kernels: {launches}")
    return {"no_faults": no_faults, "kill": kill,
            "campaign": dict(seed=seed, wall_ms=campaign_ms, dropped_rounds=dropped,
                             retransmitted_bytes=out.retransmitted_bytes,
                             straggled={str(k): v for k, v in slow.items()}),
            "max_abs_err": worst}


# --------------------------------------------------------------------------- #
# phase 7: the segmented executor on the sliced plan
# --------------------------------------------------------------------------- #
SEG_M, SEG_DEPTHS = 8, (1, 2, 4)


def work_streams(torch, fn) -> tuple:
    """Run ``fn`` once under the profiler; return its result, the streams
    (the profiler's ids) that ran PyTorch's own device work (copies, fills,
    index and elementwise kernels), the count of device events per stream
    and name, and ``busy`` of all its device events.  An executor's workers
    issue all of that on their own streams (the calling stream only waits);
    cuDNN may run part of a convolution on a stream of its own, which is
    reported beside them."""
    from collections import Counter, defaultdict

    out, evs = device_events(torch, fn)
    events = defaultdict(Counter)
    for e in evs:
        events[getattr(e, "device_resource_id", e.thread)][e.name] += 1
    own = {s for s, names in events.items() if any(
        n.startswith(("Memcpy", "Memset")) or "at::native" in n for n in names)}
    return out, own, events, busy(evs)


def segmented_phase(torch, shared: dict, unrolled_ms: dict) -> dict:
    """The segmented executor (``build_mpmd_executor(segmented=True)``) on
    the cnn phase's grid-sliced inception_net(224), weights, batch-8 input
    and float64 reference, DSH m=8: buffer depths 1, 2 and 4 with and
    without checkpoints, and the span, cohort and parameter knobs at depth
    1, each eager and captured, held to the reference and to each other
    bit for bit (snapshots' register regions too); the depth-2 and depth-4
    executors called with a second input between two calls with the first;
    the last snapshot of an unpacked checkpointed executor against the
    fault runner's final barrier; walls beside the unrolled executor's,
    streams, bytes and memory.  None of the three kernels may launch."""
    from repro_torch.codegen import build_mpmd_executor, build_plan, coalesce_transfer_steps
    from repro_torch.codegen import executed_comm_bytes
    from repro_torch.codegen.plan import RegisterLayout
    from repro_torch.core import dsh
    from repro_torch.core.costmodel import KEYSTONE_CPU
    from repro_torch.kernels import LIBRARIES
    from repro_torch.runtime.faults import run_with_faults

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for lib in LIBRARIES:
        lib.reset()
    torch.cuda.reset_peak_memory_stats()
    sliced, params, x, ref, tol = (shared[k] for k in ("sliced", "params", "x", "ref", "tol"))
    # a second input: the batch reversed, whose reference is known
    x_b, ref_b = x.flip(0).contiguous(), ref.flip(0)
    dag = sliced.to_dag(KEYSTONE_CPU, time_unit=1e-6)
    plan = build_plan(dsh(dag, SEG_M), dag)
    worst = {}

    def hold(what, out, want=ref):
        if tuple(out.shape) != tuple(want.shape) or out.dtype != torch.float32:
            raise AssertionError(f"{what}: {tuple(out.shape)} {out.dtype}")
        err = float((out.cpu().double() - want).abs().max())
        if not err <= tol:  # NaN fails too
            raise AssertionError(f"{what}: max abs error {err:.3g} > {tol:.3g}")
        worst[what] = err

    configs = [(f"depth {d}{', checkpoint' if ck else ''}", dict(buffer_depth=d, checkpoint=ck))
               for ck in (False, True) for d in SEG_DEPTHS]
    configs += [("depth 1, span_coalesce off", dict(span_coalesce=False)),
                ("depth 1, cohort_rounds off", dict(cohort_rounds=False)),
                ("depth 1, bake_params on", dict(bake_params=True))]

    # cuDNN stays unpinned: every kernel input is a fresh contiguous tensor,
    # so its algorithm choice is the same in every configuration
    report, base, base_snaps = {}, None, None
    for name, kw in configs:
        ck = kw.get("checkpoint", False)
        t0 = time.perf_counter()
        f = build_mpmd_executor(plan, sliced, params, device="cuda", batch=CNN_BATCH,
                                segmented=True, **kw)
        build_ms = (time.perf_counter() - t0) * 1e3

        def out(r):
            return r[0] if ck else r

        eager = out(f.eager(x))
        torch.cuda.synchronize()
        hold(f"segmented eager, {name}", eager)
        t0 = time.perf_counter()
        captured = out(f(x))
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        hold(f"segmented captured, {name}", captured)
        if base is None:
            base = eager
        for what, y in (("eager", eager), ("captured", captured)):
            if not torch.equal(y, base):
                raise AssertionError(f"{name}, {what}: not bit-identical to depth 1 "
                                     f"(max diff {float((y - base).abs().max()):.3g})")
        if ck:
            regs = f.snaps[:, :, :, :f.layout.total]
            if base_snaps is None:
                base_snaps = regs.clone()
            elif not torch.equal(regs, base_snaps):
                raise AssertionError(f"{name}: snapshot registers not bit-identical to depth 1")
        if kw.get("buffer_depth", 1) >= 2:
            # the carry persists across calls: a second input between
            # two calls with the first, captured and eager
            hold(f"segmented captured, {name}, second input", out(f(x_b)), ref_b)
            if not torch.equal(out(f(x)), captured):
                raise AssertionError(f"{name}: a call after the second input differs")
            hold(f"segmented eager, {name}, second input", out(f.eager(x_b)), ref_b)
        want_real = executed_comm_bytes(plan, sliced, batch=CNN_BATCH, segmented=True,
                                        buffer_depth=kw.get("buffer_depth", 1),
                                        cohort_rounds=kw.get("cohort_rounds", True))
        shipped = sum(s["comm_shipped_elems"] for s in f.segment_stats) * CNN_BATCH * 4
        if f.comm_real_bytes != want_real or f.comm_bytes != shipped:
            raise AssertionError(f"{name}: real {f.comm_real_bytes} (want {want_real}), "
                                 f"shipped {f.comm_bytes} (want {shipped}) bytes")
        handles = {s.cuda_stream for s in f.streams}
        if len(handles) != SEG_M or f.streams_used != handles:
            raise AssertionError(f"{name}: work went to {len(f.streams_used)} of "
                                 f"{len(handles)} streams, {SEG_M} workers")
        st = f.segment_stats
        r = dict(build_ms=build_ms, capture_ms=capture_ms,
                 captured_ms=wall_ms(torch, lambda: f(x)), width=f.width,
                 total=f.layout.total, segments=len(st), ticks=sum(s["ticks"] for s in st),
                 rounds=sum(s["rounds"] for s in st),
                 round_fires=sum(s["round_fires"] for s in st),
                 retire_elems=sum(s["retire_elems"] for s in st),
                 span_coverage=[round(s["span_coverage"], 4) for s in st],
                 shipped_bytes=f.comm_bytes, real_bytes=f.comm_real_bytes,
                 carry_bytes=f.carry_bytes,
                 checkpoint_bytes=f.snaps.numel() * 4 if ck else 0)
        if name == "depth 1":
            r["eager_ms"] = wall_ms(torch, lambda: f.eager(x))
            busy_ms, total_ms, n_events = device_busy_ms(torch, lambda: f.eager(x))
            _y, own, events, _b = work_streams(torch, lambda: f.eager(x))
            if len(own) != SEG_M:
                raise AssertionError(f"{name}: PyTorch's device work on {len(own)} streams, "
                                     f"not {SEG_M}: {dict(events)}")
            r.update(busy_ms=busy_ms, kernel_sum_ms=total_ms, device_events=n_events,
                     busy_share=busy_ms / r["eager_ms"], worker_streams=len(own),
                     other_streams={str(s): dict(events[s].most_common(3))
                                    for s in events if s not in own})
        report[name] = r
        log(f"segmented {name}: built in {build_ms:.0f} ms, first capture {capture_ms:.0f} ms; "
            f"width {f.width} ({f.layout.total} register columns), {r['segments']} segments, "
            f"{r['ticks']} ticks, {r['rounds']} rounds, {r['round_fires']} fires, "
            f"{r['retire_elems']} retired columns; bytes shipped {f.comm_bytes}, real "
            f"{f.comm_real_bytes} (= executed_comm_bytes); carries {f.carry_bytes}, "
            f"checkpoint {r['checkpoint_bytes']} bytes; captured {r['captured_ms']:.3f} ms")
        del f
        torch.cuda.empty_cache()

    # the last snapshot against the fault runner's final barrier, unpacked
    # (liveness off: with packing, slots of dead registers hold whichever
    # dead value each side wrote last, in the reference too)
    cplan = coalesce_transfer_steps(plan)
    f = build_mpmd_executor(plan, sliced, params, device="cuda", batch=CNN_BATCH,
                            segmented=True, checkpoint=True, liveness=False)
    y, snaps = f(x)
    hold("segmented captured, checkpoint, liveness off", y)
    layout = RegisterLayout.of(cplan, {l.name: tuple(l.out_shape) for l in sliced.layers},
                               liveness=None)
    if dict(layout.offsets) != dict(f.layout.offsets):
        raise AssertionError("the runner's unpacked layout differs from the executor's")
    barrier = run_with_faults(cplan, sliced, params, x, layout).snapshots[len(cplan.steps)]
    got = snaps[-1, :, :, :layout.total].cpu()
    want = torch.stack([torch.from_numpy(b) for b in barrier])
    snap_err = float((got - want).abs().max())
    snap_tol = CNN_TOL * max(1.0, float(want.abs().max()))
    if not snap_err <= snap_tol:
        raise AssertionError(f"last snapshot against the runner's final barrier: {snap_err:.3g} "
                             f"> {snap_tol:.3g}")
    log(f"last snapshot (liveness off, {f.checkpoint_steps[-1]} supersteps) against the fault "
        f"runner's final barrier: max abs error {snap_err:.3g} (tolerance {snap_tol:.3g}), "
        f"bit-identical: {bool(torch.equal(got, want))}")
    del f, snaps, got, want, barrier
    torch.cuda.empty_cache()

    launches = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    if any(n for counts in launches.values() for n in counts.values()):
        raise AssertionError(f"the segmented executor launched a Hopper kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    d1 = report["depth 1"]
    log(f"all {len(worst)} outputs within tolerance {tol:.3g}; largest error "
        f"{max(worst.values()):.3g} ({max(worst, key=worst.get)}); every configuration "
        f"bit-identical to depth 1, cuDNN unpinned")
    log(f"median wall of one call at batch {CNN_BATCH} ({CNN_REPS} calls, CUDA events): "
        f"segmented eager {d1['eager_ms']:.3f} ms, captured {d1['captured_ms']:.3f} ms; unrolled "
        f"eager {unrolled_ms['executor eager sliced m=8']:.3f} ms, captured "
        f"{unrolled_ms['executor captured sliced m=8']:.3f} ms (this run's cnn phase); one eager "
        f"call: {d1['device_events']} device events, busy {d1['busy_ms']:.3f} ms "
        f"({100 * d1['busy_share']:.1f}% of its wall); PyTorch's work on {d1['worker_streams']} "
        f"streams, other streams {d1['other_streams']}")
    log(f"peak device memory in the phase {peak / 2**30:.2f} GiB; launches of the port's "
        f"kernels: {launches}")
    return {"configs": report, "snapshot_vs_runner_err": snap_err,
            "peak_bytes": peak, "max_abs_err": worst}


# --------------------------------------------------------------------------- #
# phase 8: the serving frontend on the executor
# --------------------------------------------------------------------------- #
FE_BUCKETS, FE_REQUESTS = (1, 2, 4, 8), 32
# the reference's headline chaos drill (benchmarks/serve_chaos.py): grid-sliced
# inception_net(64) at m=8, 1000 requests; its CPU run (runner only,
# BENCH_sched.json) completed 840 and shed 160
CHAOS_SEED, CHAOS_HW, CHAOS_M, CHAOS_REQUESTS = 1234, 64, 8, 1000
REF_COMPLETED, REF_SHED = 840, 160


def frontend_phase(torch, shared: dict) -> dict:
    """The serving frontend (``serve/frontend.py``) with its executor fast
    path on 8 streams: (a) at full width, the cnn phase's sliced
    inception_net(224) and weights, the executor attached at buckets 1, 2,
    4 and 8, 32 fault-free requests of 1-2 rows drawn from the cnn phase's
    input, every output held to the float64 run; (b) the reference's
    headline drill, 1000 requests on grid-sliced inception_net(64) at m=8
    under a kill and a straggler, zero loss required.  None of the three
    kernels may launch."""
    from repro_torch.core.costmodel import KEYSTONE_CPU
    from repro_torch.kernels import LIBRARIES
    from repro_torch.models.cnn import inception_net, run_sequential
    from repro_torch.models.slicing import slice_model, uniform_factors
    from repro_torch.serve import ChaosCampaign, Frontend, input_pool, poisson_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for lib in LIBRARIES:
        lib.reset()

    # (a) full width, fault-free, every tick on the executor
    torch.cuda.reset_peak_memory_stats()
    sliced, params, x, ref, tol = (shared[k] for k in ("sliced", "params", "x", "ref", "tol"))
    dag = sliced.to_dag(KEYSTONE_CPU, time_unit=1e-6)
    t0 = time.perf_counter()
    fe = Frontend(sliced, params, dag, m=SEG_M, hw=KEYSTONE_CPU, validate=False)
    fe.attach_executor(buckets=FE_BUCKETS)
    init_s = time.perf_counter() - t0
    trace = poisson_trace(FE_REQUESTS, seed=0, rate=2.0 / fe.est_service,
                          service=fe.est_service)
    t0 = time.perf_counter()
    summary = fe.run_trace(trace, x.cpu().numpy())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    audit = fe.audit(ref_pool=ref.numpy(), atol=tol)
    if not (audit["zero_loss"] and fe.exec_runs == fe.runs > 0
            and summary["completed"] + summary["shed"] == FE_REQUESTS and summary["completed"]):
        raise AssertionError(f"full width: {summary}, exec_runs {fe.exec_runs} of {fe.runs} "
                             f"ticks, audit {audit}")
    executors = {str(k[0]): dict(carry_bytes=f.carry_bytes, checkpoint_bytes=f.snaps.numel() * 4)
                 for k, f in fe._exec_cache.items()}
    full = dict(summary=summary, runs=fe.runs, exec_runs=fe.exec_runs, wall_s=wall_s,
                init_s=init_s, max_err=audit["max_err"], executors=executors,
                peak_bytes=torch.cuda.max_memory_allocated())
    log(f"full width: {summary['completed']} of {FE_REQUESTS} requests completed, "
        f"{summary['shed']} shed, in {fe.runs} ticks, every one on the executor "
        f"({wall_s:.2f} s of host, executors built and captured included; frontend ready in "
        f"{init_s:.2f} s); outputs within {audit['max_err']:.3g} of the float64 run; executors "
        f"by bucket {executors}; peak device memory {full['peak_bytes'] / 2**30:.2f} GiB")
    fe._exec_cache.clear()
    del fe
    release(torch)

    # (b) the reference's headline drill: kill, straggler, zero loss
    model = inception_net(CHAOS_HW)
    base = uniform_factors(model, CHAOS_M, spatial=True)
    grid = {k: ((2, CHAOS_M // 2) if v == (1, CHAOS_M) else v) for k, v in base.items()}
    sliced = slice_model(model, grid)
    params = model.init_params(0, device="cuda")
    dag = sliced.to_dag(KEYSTONE_CPU, time_unit=1e-6)
    pool = input_pool(model.layers[0].out_shape, 8, seed=CHAOS_SEED + 1)
    refs = run_sequential(sliced, {k: {n: t.cpu().double() for n, t in d.items()}
                                   for k, d in params.items()},
                          torch.from_numpy(pool).double()).numpy()
    t0 = time.perf_counter()
    fe = Frontend(sliced, params, dag, m=CHAOS_M, hw=KEYSTONE_CPU)
    fe.attach_executor()
    init_s = time.perf_counter() - t0
    trace = poisson_trace(CHAOS_REQUESTS, seed=CHAOS_SEED, rate=3.0 / fe.est_service,
                          rows=(1, 2), pool_size=len(pool), deadline=(6.0, 18.0),
                          service=fe.est_service)
    chaos = ChaosCampaign.kill_and_straggle(CHAOS_REQUESTS, CHAOS_M, seed=CHAOS_SEED)
    kill_w, strag_w = (e.fault.worker for e in chaos.events)
    t0 = time.perf_counter()
    summary = fe.run_trace(trace, pool, chaos=chaos)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    audit = fe.audit(ref_pool=refs)
    actions = [r["action"] for r in fe.recoveries]
    if not (audit["zero_loss"] and "remesh" in actions and kill_w not in fe.fleet
            and strag_w not in fe.fleet and 0 < fe.exec_runs < fe.runs
            and summary["completed"] + summary["shed"] == CHAOS_REQUESTS):
        raise AssertionError(f"drill: {summary}, recoveries {fe.recoveries}, fleet {fe.fleet}, "
                             f"exec_runs {fe.exec_runs} of {fe.runs}, audit {audit}")
    recoveries = [{k: r[k] for k in ("action", "replan_ms", "workers", "at_completed")}
                  for r in fe.recoveries]
    drill = dict(summary=summary, runs=fe.runs, exec_runs=fe.exec_runs, wall_s=wall_s,
                 init_s=init_s, max_err=audit["max_err"], kill_worker=kill_w,
                 straggle_worker=strag_w, fleet=list(fe.fleet), recoveries=recoveries,
                 reference_completed=REF_COMPLETED, reference_shed=REF_SHED)
    log(f"drill: {summary['completed']} completed, {summary['shed']} shed "
        f"{summary['shed_by_reason']} (the reference's CPU drill: {REF_COMPLETED} and "
        f"{REF_SHED}), {summary['retried']} retries, {summary['deadline_misses']} deadline "
        f"misses, p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms (simulated); "
        f"{fe.exec_runs} of {fe.runs} ticks on the executor; worker {kill_w} killed, {strag_w} "
        f"straggling, final fleet {list(fe.fleet)}; recoveries {recoveries}; zero loss, outputs "
        f"within {audit['max_err']:.3g} of the float64 run; {wall_s:.2f} s of host for the "
        f"trace (frontend ready, its plan deep-validated, in {init_s:.2f} s)")
    fe._exec_cache.clear()
    del fe

    launches = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    if any(n for counts in launches.values() for n in counts.values()):
        raise AssertionError(f"the frontend launched a Hopper kernel: {launches}")
    log(f"launches of the port's kernels: {launches}")
    return {"full_width": full, "drill": drill}


def log_allocated(torch) -> None:
    """What the previous phases left allocated on the card."""
    log(f"device memory allocated at the start of the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def release(torch) -> None:
    """Free what the last phase held: collect its reference cycles first,
    then return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, SRC)
    import numpy as np

    with phase("device"):
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        log(f"card: {smi}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
        torch.backends.cudnn.allow_tf32 = False

    with phase("build"):
        from repro_torch.kernels import LIBRARIES
        from repro_torch.kernels._build import build_all

        t0 = time.perf_counter()
        secs = build_all(LIBRARIES)
        log(f"built {', '.join(f'{n} ({s:.1f} s)' for n, s in secs.items())} "
            f"in {time.perf_counter() - t0:.1f} s")
        for lib in LIBRARIES:
            for line in lib.log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {lib.name}: {line.strip()}")

    with phase("kernels"):
        timer = Timer(torch)
        rows = check_kernels(torch, timer)
        del timer

    # each kernel's launches are read from the serving run whose path it is on
    launches = {}
    with phase("serve tinyllama-1.1b"):
        log_allocated(torch)
        run = serve(torch, np, "tinyllama-1.1b", LOGIT_TOL, LOGIT_TOL)
        launches.update(flash_attention=run["flash_attention"], swiglu_matmul=run["swiglu_matmul"])
    release(torch)
    with phase("serve mamba2-370m"):
        log_allocated(torch)
        run = serve(torch, np, "mamba2-370m", MAMBA_LOGIT_TOL, MAMBA_HANDOFF_TOL)
        launches["ssd_scan"] = run["ssd_scan"]
    release(torch)
    with phase(f"cnn inception-{CNN_HW}"):
        log_allocated(torch)
        cnn, shared = cnn_phase(torch)
        log("cnn: " + json.dumps(cnn))
    with phase(f"faults inception-{CNN_HW}"):
        log_allocated(torch)
        report = faults_phase(torch, shared)
        log("faults: " + json.dumps(report))
    release(torch)
    with phase(f"segmented inception-{CNN_HW}"):
        log_allocated(torch)
        report = segmented_phase(torch, shared, cnn["times_ms"])
        log("segmented: " + json.dumps(report))
    release(torch)
    with phase("frontend"):
        log_allocated(torch)
        report = frontend_phase(torch, shared)
        log("frontend: " + json.dumps(report))
    del shared
    release(torch)

    with phase("report"):
        # each variant's row: the path shape it serves (f32 for the CUDA-core
        # kernels, whose route that is)
        picks = {("flash_attention", "mma"): 1024, ("flash_attention", "cuda_core"): 1024,
                 ("swiglu_matmul", "wgmma"): 512, ("swiglu_matmul", "decode"): 8,
                 ("swiglu_matmul", "cuda_core"): 512, ("ssd_scan", "wgmma"): 1024,
                 ("ssd_scan", "cuda_core"): 1024}
        replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:81",
                    "swiglu_matmul": "src/repro/kernels/swiglu_matmul.py:50",
                    "ssd_scan": "src/repro/kernels/ssd_scan.py:75"}
        kernels = []
        for lib in LIBRARIES:
            for variant in lib.variants:
                r = rows[(lib.name, variant, picks[(lib.name, variant)])]
                kernels.append({
                    "name": lib.name if len(lib.variants) == 1 else f"{lib.name}[{variant}]",
                    "route": "cuda", "source": os.path.relpath(lib.source, ROOT),
                    "replaces": replaces[lib.name], "launches": launches[lib.name][variant],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "library": r["library"], "shape": r["shape"],
                })
        if any(not math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError("a kernel number is not finite")
        # the CUDA-core kernels serve f32 (and shapes the tensor-core ones do
        # not take), which no serving run here uses: every other variant
        # must have been launched on its path
        idle = [k["name"] for k in kernels if k["launches"] <= 0
                and not k["name"].endswith("[cuda_core]")]
        if idle:
            raise AssertionError(f"not launched on their serving paths: {idle} ({launches})")

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
