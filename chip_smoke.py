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
             views under a forced, named fused backend; cuBLAS for SwiGLU);
             the backward kernels at the train paths' shapes, each launched
             twice for the same bits, beside SDPA's backward and cuBLAS (the
             SSD scan's beside ``ssd_scan_vjp``).  The SwiGLU sweep reaches
             every tile class and load path of its f32 CUDA-core kernel
             (asserted), and three faults planted in copies of its source
             (the last k-stage dropped, a ring stage read one step early,
             the ragged-F store unmasked) must each fail it; so do the
             flash and SSD sweeps for theirs (the SSD scan's: the carry's
             decay dropped, one chunk's state term dropped, the diagonal
             term's decay L dropped).  The causal conv's kernels are held
             and timed at mamba2's training layout and Jamba's prefill and
             decode beside the eager passes they replace.
4. serve   — the LM paths, each at full width, random weights from a
             seeded generator, bf16: TinyLlama-1.1B (22 layers; flash
             attention and fused SwiGLU) and Mamba2-370M (48 layers; the SSD
             scan's wgmma variant) through the ``Engine`` with the same
             traffic (16 requests); DeepSeek-V2-Lite (27 layers; MLA, routed
             and shared experts); Jamba-v0.1 at 16 of 32 layers (the hybrid
             ``super`` segment: mamba2 mixers, attention, MoE and dense
             FFNs); HuBERT-XLarge (48 layers; a non-causal encoder over 8
             clips of 1500 frames, a train forward and a prefill);
             LLaVA-NeXT-Mistral-7B (32 layers; 8 requests of one image's 576
             embedding rows and 576 text tokens, one batched prefill, 32
             decode ticks); Arctic at 2 of 35 layers (128 experts beside a
             dense residual).  Launch counters, per kernel variant and zeroed
             just before each run, prove that run went through its kernels,
             each through the variant its selector picks for the step's
             shapes (tensor-core variants only), and no other, as
             ``expected_launches`` counts them from the config's layers; each
             run is checked against a teacher-forced forward or a plain
             computation, each check against planted faults; one prefill (or
             forward) and one decode tick are profiled.
   train   — TinyLlama-1.1B trains at full width and depth (22 layers, bf16,
             AdamW, 2 microbatches of 4 x 1024 tokens, remat): the flash and
             SwiGLU kernels forward and their backward kernels (flash
             ``wgmma_bwd``, SwiGLU ``wgmma_bwd``) backward, no PyTorch VJP.
             (a) every parameter gets a finite, non-zero gradient (planted
             fault: the kernels' outputs detached); (b) each backward kernel
             at the path's shape, through its Function, against autograd
             through its plain version (faults through the kernels' own
             launches: the causal flag cleared, dQ's first key tile dropped,
             dg and du swapped, the SwiGLU epilogue reading dout from the
             other box of its buffer, built from a copy of its source); (c) one
             step at 2 layers on the card against the CPU in f32 (every fault
             of (a) and (b)); (d) one batch as 1 or 2 microbatches; (e) 20
             steps through ``Trainer.run``, counted (88 flash ``mma``, 44
             flash ``wgmma_bwd`` and 0 ``mma_bwd``, 88 SwiGLU ``wgmma`` and 44
             ``wgmma_bwd`` a step; the
             flash and SwiGLU VJPs called 0 times) and timed, the loss
             falling; (f) the kill-and-resume drill at 2 layers with
             checkpoints in a temporary directory, against an uninterrupted
             run, bit for bit (the backward kernels use no float atomics).
             Then mamba2-370m (48 layers, 0.420 B parameters) through the SSD
             scan's ``wgmma`` kernel forward and its ``wgmma_bwd`` kernel
             backward, with the same data shape and checks: (a)'s fault the
             SSD Function's backward returning None; (b) the backward kernel
             on the mixer's strided views at B 4, S 1024, dt ~0.02 (faults
             through its launch: no carry across chunks, dB and dC swapped,
             dA dropped); (c) with dt_bias at -4 so the carried state counts;
             (e) 192 ``wgmma`` and 96 ``wgmma_bwd`` launches a step, the SSD
             VJP called 0 times, and the causal conv's 192 ``fwd``, 96
             ``bwd`` and 96 ``bwd_reduce``.  Then one Jamba-v0.1 period (8 layers, full
             width, experts cut from 16 to 4, AdamW with bf16 moments): (a)
             with every kernel's backward gone as the fault, 5 counted steps,
             no PyTorch VJP called, the loss falling.
   accounting — the launch accounting (``src/repro_torch/launch``): (a) for
             every registry arch × runnable shape at full size on one card,
             host only, the analytic compute and memory seconds under the
             H100's peaks, the dominant term, the operands' GiB and whether
             they fit; (b) every arch × kind as a probe (``validate_probe``:
             2 layers or one period, full width, seq 1024, batch 16) counted
             on ``meta`` and, where the meta count fits the card, on the card:
             FLOPs equal per component and kernel variant, launches equal
             to the meta count and ``expected_launches``, outputs finite, the
             skipped probes exactly Arctic's and Jamba's train (planted
             fault: the SwiGLU entry recording no work); prints counted /
             analytic FLOPs, device ms, the analytic bound, MFU, the peak.
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
faults, segmented and frontend phase (a serving phase fails if 1 GiB or more
is left); the cyclic collector runs before the cache is emptied between
phases.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

For development, ``--only kernels,jamba`` runs the build and the named
phases alone (the kernels phase, the serving paths, ``train``,
``train_mamba2``, ``train_jamba`` and ``accounting``), then exits 2 with
no result.
"""
from __future__ import annotations

import functools
import gc
import importlib
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

# tolerances (absolute, relative) of a kernel against its plain version, as
# in the CPU tests: the kernel and the plain version both accumulate in f32
# and differ in summation order; bf16 outputs differ by bf16 rounding of that
FLASH_TOL = {"torch.float32": (2e-5, 1e-2), "torch.bfloat16": (3e-2, 1e-2)}
SWIGLU_TOL = {"torch.float32": (1e-4, 2e-2), "torch.bfloat16": (5e-2, 2e-2)}
# the flash backward kernel against its plain version from the same inputs
# (the forward kernel's own o and lse), within this share of each
# gradient's largest magnitude: both compute in f32; the kernel rounds P and
# dS to bf16 for its products, and both round the gradients to bf16
# (tests/test_torch_card.py's bound).  The SwiGLU backward kernel's dg and du
# are held to SWIGLU_TOL, as its forward.
BWD_TOL = 3e-2
# the SSD scan's backward kernel against ssd_scan_vjp on the same inputs,
# within this share of each gradient's largest magnitude: both compute in
# f32 (the kernel's f32 operands as bf16 hi + lo pairs: ~5e-6 of each
# gradient on the CPU, ref.ssd_scan_bwd_phases) and round dx, dB and dC to
# bf16 (tests/test_torch_card.py's bound)
SSD_BWD_TOL = 1e-2
# the forward kernel's lse (f32, natural log) against the plain forward's,
# per element, (absolute, relative) as tests/test_torch_card.py holds it
LSE_TOL = (1e-4, 1e-4)
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
PORT_KERNELS = ("flash_", "swiglu_", "ssd_", "conv_silu_")
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


def sdpa_call(torch, backend, q, k, v, causal=True):
    """PyTorch's fused attention on 4-D views ``[1, BH, S, D]`` of the
    kernel's ``[BH, S, D]`` operands, forced onto ``backend``: the call fails
    rather than silently taking another backend (a 3-D call takes the math
    backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    q4, k4, v4 = (t.view(1, *t.shape) for t in (q, k, v))

    def call():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    return call


def sdpa_value_dim_call(torch, q, k, v):
    """The yardstick for attention with a value head dim Dv != D: SDPA under
    the first named fused backend that takes Dv != D (flash, cuDNN,
    memory-efficient, in that order), or, if none does, under the flash
    backend with v zero-padded to D (its output sliced back to Dv).  Returns
    (call, name)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    for backend, name in ((SDPBackend.FLASH_ATTENTION, "sdpa[flash]"),
                          (SDPBackend.CUDNN_ATTENTION, "sdpa[cudnn]"),
                          (SDPBackend.EFFICIENT_ATTENTION, "sdpa[efficient]")):
        call = sdpa_call(torch, backend, q, k, v)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:  # the backend refuses these shapes: try the next
            continue
        return call, name
    padded = sdpa_call(torch, SDPBackend.FLASH_ATTENTION, q, k,
                       F.pad(v, (0, q.shape[-1] - v.shape[-1])))
    return (lambda: padded()[..., :v.shape[-1]]), "sdpa[flash], v padded to D"


def slice_paths(torch, timer, rows, randn, conv_views, ssd_hold) -> None:
    """Every kernel shape of the hybrid, encoder, VLM and Arctic paths, held
    against its plain version; the new ones timed into ``rows`` with their
    bound and a library call: flash ``mma`` at HuBERT's head dim 80,
    non-causal; the dense SwiGLU at D 4096 F 14336 (Jamba, LLaVA), D 1280 F
    5120 (HuBERT) and D 7168 F 4864 (Arctic's residual); the expert entries
    at E 16, D 4096, F 14336 (Jamba) and E 128, D 7168, F 4864 (Arctic); the
    SSD scan on Jamba's mixer layout (H 128, N 16, rows of 8224)."""
    from repro_torch.kernels.flash_attention import work as flash_work
    from repro_torch.kernels.swiglu_matmul import work as swiglu_work
    from repro_torch.kernels.ssd_scan import work as ssd_work
    from repro_torch.launch.roofline_model import H100

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import (
        FLASH_LIBRARY, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, ssd_mixer, swiglu_experts,
        swiglu_matmul,
    )
    from repro_torch.kernels.ref import (
        flash_attention_ref, ssd_scan_ref, swiglu_experts_ref, swiglu_ref,
    )
    from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK

    bf16 = torch.bfloat16
    tol = FLASH_TOL[str(bf16)]
    # (BH, S, D, causal, timed): HuBERT's encoder (8 clips x 16 heads, 1500
    # frames), Jamba's and Arctic's prefill of one 1024-token prompt (32 and
    # 56 heads), LLaVA's batch of 8 x 1152 positions (256 heads)
    for BH, S, D, causal, timed in ((128, 1500, 80, False, True), (32, 1024, 128, True, False),
                                    (56, 1024, 128, True, False),
                                    (256, 1152, 128, True, False)):
        q, k, v = (randn(BH, S, D, dtype=bf16) for _ in range(3))
        o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=causal))
        r = flash_attention_ref(q, k, v, causal=causal)
        if variant != "mma" or not within(o, r, tol):
            raise AssertionError(f"flash_attention[{variant}] path BH={BH} S={S} D={D} "
                                 f"causal={causal}: max err {max_err(o, r):.3g} > {tol}")
        log(f"flash_attention[{variant}] path BH={BH} S={S} D={D} causal={causal}: max err "
            f"{max_err(o, r):.3g}")
        if timed:
            lib = sdpa_call(torch, SDPBackend.FLASH_ATTENTION, q, k, v, causal=causal)
            b_ms, b_by = H100.bound_ms(*flash_work(BH, S, S, D, causal, 2), bf16)
            rows[("flash_attention", variant, "hubert")] = dict(
                shape=f"BH={BH} S={S} D={D} bf16 non-causal", max_abs_err=max_err(o, r),
                tol=list(tol), ms=timer.ms(lambda: flash_attention(q, k, v, causal=causal)),
                plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, causal=causal)),
                library="sdpa[flash]", library_ms=timer.ms(lib), bound_ms=b_ms, bound_by=b_by)
        del q, k, v, o, r
    # the dense SwiGLU: (M, D, F, key or None when only held)
    tol = SWIGLU_TOL[str(bf16)]
    for M, D, Fd, key in ((1024, 4096, 14336, "d4096"), (8, 4096, 14336, "d4096"),
                          (8 * 1152, 4096, 14336, None), (12000, 1280, 5120, "hubert"),
                          (1024, 7168, 4864, "d7168"), (8, 7168, 4864, "d7168")):
        x = randn(M, D, dtype=bf16)
        wg = randn(D, Fd, dtype=bf16, scale=D ** -0.5)
        wu = randn(D, Fd, dtype=bf16, scale=D ** -0.5)
        o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_matmul(x, wg, wu))
        r = swiglu_ref(x, wg, wu)
        if variant != ("wgmma" if M >= 64 else "decode") or not within(o, r, tol):
            raise AssertionError(f"swiglu_matmul[{variant}] path M={M} D={D} F={Fd}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        log(f"swiglu_matmul[{variant}] path M={M} D={D} F={Fd}: max err {max_err(o, r):.3g}")
        if key is not None:
            b_ms, b_by = H100.bound_ms(*swiglu_work(M, D, Fd, 2), bf16)
            rows[("swiglu_matmul", variant, key)] = dict(
                shape=f"M={M} D={D} F={Fd} bf16", max_abs_err=max_err(o, r), tol=list(tol),
                ms=timer.ms(lambda: swiglu_matmul(x, wg, wu)),
                plain_ms=timer.ms(lambda: swiglu_ref(x, wg, wu)),
                library="F.silu(x@wg)*(x@wu)",
                library_ms=timer.ms(lambda: F.silu(x @ wg) * (x @ wu)), bound_ms=b_ms,
                bound_by=b_by)
        del x, wg, wu, o, r
    # the routed experts: Jamba's 16 (a prefill's capacity of 160 rows, a
    # tick's 8) and Arctic's 128 (20 rows, 8); (E, M, D, F, key)
    for E, M, D, Fd, key in ((16, 160, 4096, 14336, "jamba"), (16, 8, 4096, 14336, "jamba"),
                             (128, 20, 7168, 4864, "arctic"), (128, 8, 7168, 4864, "arctic")):
        x = randn(E, M, D, dtype=bf16)
        wg = randn(E, D, Fd, dtype=bf16, scale=D ** -0.5)
        wu = randn(E, D, Fd, dtype=bf16, scale=D ** -0.5)
        o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_experts(x, wg, wu))
        r = swiglu_experts_ref(x, wg, wu)
        if variant != ("experts_wgmma" if M >= 64 else "experts_decode") or not within(o, r, tol):
            raise AssertionError(f"swiglu_experts[{variant}] path E={E} M={M} D={D} F={Fd}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        b_ms, b_by = H100.bound_ms(*swiglu_work(M, D, Fd, 2, E=E), bf16)
        rows[("swiglu_matmul", variant, f"{key}{M}")] = dict(
            shape=f"E={E} M={M} D={D} F={Fd} bf16", max_abs_err=max_err(o, r), tol=list(tol),
            ms=timer.ms(lambda: swiglu_experts(x, wg, wu)),
            plain_ms=timer.ms(lambda: swiglu_experts_ref(x, wg, wu)),
            library="F.silu(bmm(x,wg))*bmm(x,wu)",
            library_ms=timer.ms(lambda: F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)),
            bound_ms=b_ms, bound_by=b_by)
        del x, wg, wu, o, r
        torch.cuda.empty_cache()
    # Jamba's mixer layout: x, B and C views of the conv output [1, S, 8192 +
    # 2·16] (row stride 8224, C from element 8208), 128 heads of 64, one group
    S, H, G, P, N = 1024, 128, 1, 64, 16
    args = conv_views(1, S, H, G, P, N)
    assert args[0].stride()[1] == H * P + 2 * G * N == 8224 and (
        args[4].data_ptr() - args[0].data_ptr()) // 2 == 8208
    flat = (args[0][0].movedim(1, 0).contiguous(), args[1][0].T.contiguous(), args[2],
            args[3][0, :, 0][None].expand(H, S, N).contiguous(),
            args[4][0, :, 0][None].expand(H, S, N).contiguous())
    out, variant = launched(SSD_LIBRARY, lambda: ssd_mixer(*args, return_state=True))
    if variant != "wgmma":
        raise AssertionError(f"ssd_mixer on Jamba's layout took {variant}, not wgmma")
    ref = ssd_scan_ref(*flat, return_state=True)
    err, ytol = ssd_hold(f"[{variant}] Jamba's layout S={S}",
                         (out[0][0].movedim(1, 0), out[1][0]), ref, bf16)
    b_ms, b_by = H100.bound_ms(*ssd_work(H, G, S, P, N, 2, SSD_CHUNK[variant]), bf16)
    rows[("ssd_scan", variant, "jamba")] = dict(
        shape=f"B=1 S={S} H={H} G={G} P={P} N={N} bf16, views of conv_out", max_abs_err=err,
        tol=list(ytol), ms=timer.ms(lambda: ssd_mixer(*args, return_state=True)),
        plain_ms=timer.ms(lambda: ssd_scan_ref(*flat, return_state=True), reps=5),
        library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(f"ssd_scan[{variant}] Jamba's layout S={S} H={H} N={N}: max err {err:.3g}")


def train_paths(torch, timer, rows, randn, conv_views, ssd_hold) -> None:
    """The train paths' forward shapes, held against the plain versions and
    timed into ``rows``: one microbatch of 4 x 1024 tokens, flash ``mma``
    over 4 x 32 heads of 64 (causal) and the SwiGLU ``wgmma`` over 4096
    rows at D 2048, F 5632 (TinyLlama); the SSD scan's ``wgmma`` on
    mamba2's mixer views at B 4 (the 4 sequences of a microbatch)."""
    from repro_torch.kernels.flash_attention import work as flash_work
    from repro_torch.kernels.swiglu_matmul import work as swiglu_work
    from repro_torch.kernels.ssd_scan import work as ssd_work
    from repro_torch.launch.roofline_model import H100

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import FLASH_LIBRARY, SWIGLU_LIBRARY, flash_attention, swiglu_matmul
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref

    bf16 = torch.bfloat16
    BH, S, D = 4 * 32, TRAIN_SEQ, 64
    q, k, v = (randn(BH, S, D, dtype=bf16) for _ in range(3))
    o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=True))
    r = flash_attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL[str(bf16)]
    if variant != "mma" or not within(o, r, tol):
        raise AssertionError(f"flash_attention[{variant}] train path: max err {max_err(o, r):.3g}")
    b_ms, b_by = H100.bound_ms(*flash_work(BH, S, S, D, True, 2), bf16)
    rows[("flash_attention", variant, "train")] = dict(
        shape=f"BH={BH} S={S} D={D} bf16 causal", max_abs_err=max_err(o, r), tol=list(tol),
        ms=timer.ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, causal=True)),
        library="sdpa[flash]", library_ms=timer.ms(sdpa_call(torch, SDPBackend.FLASH_ATTENTION,
                                                             q, k, v)),
        bound_ms=b_ms, bound_by=b_by)
    del q, k, v, o, r
    M, D, Fd = 4 * TRAIN_SEQ, 2048, 5632
    x = randn(M, D, dtype=bf16)
    wg = randn(D, Fd, dtype=bf16, scale=D ** -0.5)
    wu = randn(D, Fd, dtype=bf16, scale=D ** -0.5)
    o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_matmul(x, wg, wu))
    r = swiglu_ref(x, wg, wu)
    tol = SWIGLU_TOL[str(bf16)]
    if variant != "wgmma" or not within(o, r, tol):
        raise AssertionError(f"swiglu_matmul[{variant}] train path: max err {max_err(o, r):.3g}")
    b_ms, b_by = H100.bound_ms(*swiglu_work(M, D, Fd, 2), bf16)
    rows[("swiglu_matmul", variant, "train")] = dict(
        shape=f"M={M} D={D} F={Fd} bf16", max_abs_err=max_err(o, r), tol=list(tol),
        ms=timer.ms(lambda: swiglu_matmul(x, wg, wu)),
        plain_ms=timer.ms(lambda: swiglu_ref(x, wg, wu)),
        library="F.silu(x@wg)*(x@wu)", library_ms=timer.ms(lambda: F.silu(x @ wg) * (x @ wu)),
        bound_ms=b_ms, bound_by=b_by)
    log(f"train path: flash mma BH={BH} and swiglu wgmma M={M} within tolerance")
    del x, wg, wu, o, r
    from repro_torch.kernels import SSD_LIBRARY, ssd_mixer
    from repro_torch.kernels.ref import ssd_mixer_ref
    from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK

    Bsz, S, H, G, P, N = 4, TRAIN_SEQ, 32, 1, 64, 128
    args = conv_views(Bsz, S, H, G, P, N)
    out, variant = launched(SSD_LIBRARY, lambda: ssd_mixer(*args, return_state=True))
    if variant != "wgmma":
        raise AssertionError(f"ssd_mixer on mamba2's train layout took {variant}, not wgmma")
    ref = ssd_mixer_ref(*args, return_state=True)
    err, tol = ssd_hold(f"[{variant}] mamba2's train layout B={Bsz}", out, ref, bf16)
    b_ms, b_by = H100.bound_ms(*ssd_work(Bsz * H, Bsz * G, S, P, N, 2, SSD_CHUNK[variant]), bf16)
    rows[("ssd_scan", variant, "train")] = dict(
        shape=f"B={Bsz} S={S} H={H} G={G} P={P} N={N} bf16, views of conv_out", max_abs_err=err,
        tol=list(tol), ms=timer.ms(lambda: ssd_mixer(*args, return_state=True)),
        plain_ms=timer.ms(lambda: ssd_mixer_ref(*args, return_state=True), reps=5),
        library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(f"train path: ssd_scan wgmma B={Bsz} S={S} H={H} N={N} within tolerance")


def conv_paths(torch, timer, rows, randn) -> None:
    """The causal conv's kernels (``csrc/causal_conv.cu``) at the paths'
    shapes, held against the eager passes they replace
    (``ref.causal_conv_ref``, the plain version, with the window's copy
    where it is written: also the yardstick, ``library_ms``) and timed into
    ``rows``: the forward at mamba2's training layout (B 16, S 2048, CH
    2304), Jamba's prefill (one prompt of 4096, CH 8224, the window written)
    and Jamba's decode (16 slots, the window read and rewritten in place),
    within one bf16 ulp, the window bit for bit; the backward and its
    reduction at the training layout beside autograd through the eager
    passes, dx at SwiGLU's bf16 tolerance, dw and db within 1e-2 of their
    largest magnitude, two launches bit for bit."""
    import importlib

    from repro_torch.kernels import CONV_LIBRARY, causal_conv
    from repro_torch.kernels._build import stream_handle
    from repro_torch.kernels.ref import causal_conv_ref
    from repro_torch.launch.roofline_model import H100

    cc = importlib.import_module("repro_torch.kernels.causal_conv")
    bf16 = torch.bfloat16
    tol = (1e-6, 2 ** -7)  # one bf16 ulp

    def eager(x, w, b, carry, window):
        out, new = causal_conv_ref(x, w, b, carry)
        if window is not None:
            window.copy_(new)
        return out

    for key, B, S, CH, reads, writes in (("train", 16, 2048, 2304, False, False),
                                         ("jamba", 1, 4096, 8224, False, True),
                                         ("decode", 16, 1, 8224, True, True)):
        x = randn(B, S, CH, dtype=bf16)
        w, b = randn(4, CH, dtype=bf16, scale=0.5), randn(CH, dtype=bf16, scale=0.25)
        carry = randn(B, 3, CH, dtype=bf16) if reads else None
        window = (carry.clone() if reads else torch.empty((B, 3, CH), dtype=bf16, device="cuda")
                  ) if writes else None
        want, want_window = causal_conv_ref(x, w, b, carry)
        out, variant = launched(CONV_LIBRARY, lambda: causal_conv(
            x, w, b, window if reads else None, window))
        if variant != "fwd" or not within(out, want, tol) or (
                writes and not torch.equal(window, want_window)):
            raise AssertionError(f"causal_conv[{variant}] {key}: max err {max_err(out, want):.3g}")
        log(f"causal_conv[{variant}] {key} B={B} S={S} CH={CH}: max err {max_err(out, want):.3g}")
        b_ms, b_by = H100.bound_ms(*cc.work(B, S, CH, 2, 2 if reads or writes else 0, reads,
                                            writes), bf16)
        lib_ms = timer.ms(lambda: eager(x, w, b, window if reads else None, window))
        rows[("causal_conv", variant, key)] = dict(
            shape=f"B={B} S={S} CH={CH} bf16{', window' if writes else ''}"
                  f"{' read' if reads else ''}",
            max_abs_err=max_err(out, want), tol=list(tol),
            ms=timer.ms(lambda: causal_conv(x, w, b, window if reads else None, window)),
            plain_ms=lib_ms, library="eager passes", library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by)
        del x, w, b, carry, window, out, want
    B, S, CH = 16, 2048, 2304
    x, dy = randn(B, S, CH, dtype=bf16), randn(B, S, CH, dtype=bf16)
    w, b = randn(4, CH, dtype=bf16, scale=0.5), randn(CH, dtype=bf16, scale=0.25)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    graph = causal_conv_ref(*leaves)[0]
    want = torch.autograd.grad(graph, leaves, dy, retain_graph=True)
    got = cc._launch_bwd(x, w, b, dy)
    if not all(torch.equal(g, a) for g, a in zip(got, cc._launch_bwd(x, w, b, dy))):
        raise AssertionError("causal_conv[bwd]: two launches differ")
    shares = [float((g.float() - r.float()).abs().max() / r.float().abs().max())
              for g, r in zip(got[1:], want[1:])]
    if not within(got[0], want[0], SWIGLU_TOL[str(bf16)]) or max(shares) > 1e-2:
        raise AssertionError(f"causal_conv[bwd]: dx max err {max_err(got[0], want[0]):.3g}, "
                             f"dw and db {shares}")
    log(f"causal_conv[bwd] train: dx max err {max_err(got[0], want[0]):.3g}, dw and db "
        f"{shares[0]:.3g}, {shares[1]:.3g} of their largest")
    lib_ms = timer.ms(lambda: torch.autograd.grad(graph, leaves, dy, retain_graph=True))
    rows[("causal_conv", "bwd", "train")] = dict(
        shape=f"B={B} S={S} CH={CH} bf16, both kernels", max_abs_err=max_err(got[0], want[0]),
        tol=list(SWIGLU_TOL[str(bf16)]), ms=timer.ms(lambda: cc._launch_bwd(x, w, b, dy)),
        plain_ms=lib_ms, library="autograd of the eager passes", library_ms=lib_ms,
        **dict(zip(("bound_ms", "bound_by"), H100.bound_ms(*cc.work_bwd(B, S, CH, 2, 2), bf16))))
    # the reduction alone, over the partials of one backward launch
    part = torch.empty(CONV_LIBRARY.size("conv_silu_bwd_scratch_floats", B, S, CH),
                       dtype=torch.float32, device="cuda")
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    CONV_LIBRARY.launch("bwd", x.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), part.data_ptr(), B, S, CH, 1, stream_handle(x))

    def reduce():
        CONV_LIBRARY.launch("bwd_reduce", part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, S, CH,
                            1, stream_handle(x))

    def plain():
        return part.view(-1, 5, CH).sum(0).to(bf16)

    reduce()
    sums = plain()
    # the two sum in other orders, then round to bf16: one ulp, or a
    # thousandth of the largest sum near zero
    red_tol = (1e-3 * float(sums.float().abs().max()), 2 ** -7)
    if not within(torch.cat([dw, db[None]]), sums, red_tol):
        raise AssertionError("causal_conv[bwd_reduce]: not the sum of the partials")
    rows[("causal_conv", "bwd_reduce", "train")] = dict(
        shape=f"B={B} S={S} CH={CH}: {part.numel() // (5 * CH)} partials",
        max_abs_err=max_err(torch.cat([dw, db[None]]), sums), tol=list(red_tol),
        ms=timer.ms(reduce), plain_ms=timer.ms(plain), library=None, library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), H100.bound_ms(*cc.work_reduce(B, S, CH, 2), bf16))))


def backward_paths(torch, timer, rows, randn) -> None:
    """The backward kernels at the train paths' shapes, held against their
    plain versions (the forward kernel's lse against the plain forward's
    within LSE_TOL, then ``flash_attention_bwd_ref`` from the kernel's own o
    and lse, within BWD_TOL of each gradient's largest magnitude;
    ``swiglu_bwd_ref`` at SWIGLU_TOL), launched twice for bit-identical
    results, and timed into ``rows`` beside their bound (``work_bwd``), the
    plain version and the library's backward: flash ``wgmma_bwd`` at
    TinyLlama's microbatch (BH 128 = 4 x 32 heads, S 1024, D 64, causal),
    MLA's 192/128 (4 x 16 heads, causal), HuBERT's 80 (8 clips x 16 heads
    of 1500 frames, non-causal) and 128 (4 x 32 heads, causal; LLaVA,
    Jamba, Qwen); ``wgmma_bwd`` at TinyLlama's microbatch (M 4096, D 2048,
    F 5632) and at the Jamba train period's dense FFN (M 2048 = 2 x 1024,
    D 4096, F 14336), ``experts_wgmma_bwd`` at DeepSeek's experts (E 64, M
    120, D 2048, F 1408) and at the Jamba train period's
    (``hybrid_expert_rows``: E 4, M 1280, D 4096, F 14336), the path that
    launches it.  The library's backward is SDPA's (under the forward's forced backend), and
    for the SwiGLU the two cuBLAS products with autograd's derivative of
    ``F.silu(g) * u``.  Then the SSD scan's ``wgmma_bwd`` at mamba2's train
    layout (B 4, S 1024, H 32, N 128) and the Jamba period's (B 2, H 128,
    N 16), on strided views of one conv output with dt ~0.02 (the carry
    counts), against ``ssd_scan_vjp`` (its plain version, and the VJP it
    replaces) within SSD_BWD_TOL of each gradient's largest magnitude; no
    library call computes an SSD scan."""
    import importlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import FLASH_LIBRARY, SWIGLU_LIBRARY
    from repro_torch.kernels.ref import (
        flash_attention_bwd_ref, flash_attention_ref, swiglu_bwd_ref,
    )
    from repro_torch.launch.roofline_model import H100

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    bf16 = torch.bfloat16

    def twice(lib, fn, what):
        out, variant = launched(lib, fn)
        again = fn()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"{lib.name}[{variant}] {what}: two launches differ")
        return out, variant

    for key, BH, S, D, Dv, causal in (("train", 128, TRAIN_SEQ, 64, 64, True),
                                      ("mla", 64, 1024, 192, 128, True),
                                      ("hubert", 128, 1500, 80, 80, False),
                                      ("d128", 128, 1024, 128, 128, True)):
        q, k = (randn(BH, S, D, dtype=bf16) for _ in range(2))
        v, do = (randn(BH, S, Dv, dtype=bf16) for _ in range(2))
        sc = D ** -0.5
        o, lse = fa._launch(q, k, v, causal, sc, with_lse=True)
        what = f"BH={BH} S={S} D={D} Dv={Dv} {'causal' if causal else 'non-causal'}"
        want_lse = flash_attention_ref(q, k, v, causal, sc, return_lse=True)[1]
        lse_err = max_err(lse, want_lse)
        if not within(lse, want_lse, LSE_TOL):
            raise AssertionError(f"flash_attention[mma] {what}: lse max err {lse_err:.3g} > "
                                 f"{LSE_TOL}")
        del want_lse
        got, variant = twice(FLASH_LIBRARY, lambda: fa._launch_bwd(q, k, v, o, do, lse, causal, sc),
                             what)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, sc)
        rel = max(rel_err(g, w) for g, w in zip(got, want))
        if variant != "wgmma_bwd" or not rel <= BWD_TOL:
            raise AssertionError(f"flash_attention[{variant}] {what}: largest error {rel:.3g} "
                                 f"of a gradient's largest magnitude > {BWD_TOL}")
        # the library's backward alone: SDPA's forward once, its gradient timed
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        if Dv == D:
            lib_name = "sdpa[flash] backward"
            out = sdpa_call(torch, SDPBackend.FLASH_ATTENTION, *leaves, causal=causal)()
        else:
            call, lib_name = sdpa_value_dim_call(torch, *leaves)
            out, lib_name = call(), lib_name + " backward"
        lib_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, do.view(out.shape),
                                                      retain_graph=True), reps=10)
        del out, leaves
        b_ms, b_by = H100.bound_ms(*fa.work_bwd(BH, S, S, D, causal, 2, Dv), bf16)
        rows[("flash_attention", variant, key)] = dict(
            shape=what + " bf16", max_abs_err=max(max_err(g, w) for g, w in zip(got, want)),
            rel_err=rel, tol_share=BWD_TOL, ms=timer.ms(lambda: fa._launch_bwd(q, k, v, o, do, lse, causal,
                                                                   sc)),
            plain_ms=timer.ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, causal, sc),
                              reps=5),
            library=lib_name, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        r = rows[("flash_attention", variant, key)]
        log(f"flash_attention[{variant}] {what}: lse max err {lse_err:.3g}; largest error "
            f"{rel:.3g} of a gradient's largest magnitude; bit-identical over two launches; "
            f"{r['ms']:.4f} ms ({lib_name} {lib_ms:.4f}, "
            f"bound {b_ms:.4f})")
        del q, k, v, do, o, lse, got, want
        torch.cuda.empty_cache()

    tol = SWIGLU_TOL[str(bf16)]
    E_jamba, M_jamba = hybrid_expert_rows()
    M_dense = HYBRID_TRAIN_BATCH // HYBRID_TRAIN_MICROBATCHES * TRAIN_SEQ
    for key, E, M, D, Fd in (("train", None, 4 * TRAIN_SEQ, 2048, 5632), (120, 64, 120, 2048, 1408),
                             ("train_jamba", E_jamba, M_jamba, 4096, 14336),
                             ("train_jamba_dense", None, M_dense, 4096, 14336)):
        lead = () if E is None else (E,)
        x, dout = randn(*lead, M, D, dtype=bf16), randn(*lead, M, Fd, dtype=bf16)
        wg, wu = (randn(*lead, D, Fd, dtype=bf16, scale=D ** -0.5) for _ in range(2))
        what = f"{'' if E is None else f'E={E} '}M={M} D={D} F={Fd}"
        got, variant = twice(SWIGLU_LIBRARY, lambda: sw._launch_bwd(x, wg, wu, dout), what)
        want = swiglu_bwd_ref(x, wg, wu, dout)
        if variant != ("wgmma_bwd" if E is None else "experts_wgmma_bwd") or not all(
                within(g, w, tol) for g, w in zip(got, want)):
            raise AssertionError(f"swiglu_matmul[{variant}] {what}: max err "
                                 f"{max(max_err(g, w) for g, w in zip(got, want)):.3g} > {tol}")
        mm = torch.matmul if E is None else torch.bmm

        def library():
            g, u = mm(x, wg).requires_grad_(True), mm(x, wu).requires_grad_(True)
            return torch.autograd.grad(F.silu(g) * u, (g, u), dout)

        b_ms, b_by = H100.bound_ms(*sw.work_bwd(M, D, Fd, 2, E or 1), bf16)
        rows[("swiglu_matmul", variant, key)] = dict(
            shape=what + " bf16", max_abs_err=max(max_err(g, w) for g, w in zip(got, want)),
            tol=list(tol), ms=timer.ms(lambda: sw._launch_bwd(x, wg, wu, dout)),
            plain_ms=timer.ms(lambda: swiglu_bwd_ref(x, wg, wu, dout), reps=5),
            library=f"cuBLAS {'bmm' if E else 'x@wg, x@wu'}, autograd of F.silu(g)*u",
            library_ms=timer.ms(library), bound_ms=b_ms, bound_by=b_by)
        log(f"swiglu_matmul[{variant}] {what}: dg, du within {tol}; bit-identical over two "
            f"launches")
        del x, dout, wg, wu, got, want
        torch.cuda.empty_cache()

    from repro_torch.kernels import SSD_LIBRARY

    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    for key, Bsz, H, N in (("train", 4, 32, 128), ("train_jamba", 2, 128, 16)):
        S, G, P = TRAIN_SEQ, 1, 64
        buf = randn(Bsz, S, H * P + 2 * G * N, dtype=bf16, scale=0.5)
        x = buf[..., :H * P].reshape(Bsz, S, H, P)
        Bm = buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
        Cm = buf[..., H * P + G * N:].reshape(Bsz, S, G, N)
        dt = F.softplus(randn(Bsz, S, H, dtype=torch.float32) - 4.0)
        A2 = (-torch.exp(randn(H, dtype=torch.float32, scale=0.5)))[None].expand(Bsz, H)
        dy = randn(Bsz, S, H, P, dtype=bf16)
        what = f"B={Bsz} S={S} H={H} G={G} P={P} N={N}"
        got, variant = twice(SSD_LIBRARY, lambda: ssd._launch_bwd(x, dt, A2, Bm, Cm, dy, None),
                             what)
        want = ssd.ssd_scan_vjp(x, dt, A2, Bm, Cm, dy, None)
        rel = max(rel_err(g, w) for g, w in zip(got, want))
        if variant != "wgmma_bwd" or not rel <= SSD_BWD_TOL:
            raise AssertionError(f"ssd_scan[{variant}] {what}: largest error {rel:.3g} of a "
                                 f"gradient's largest magnitude > {SSD_BWD_TOL}")
        b_ms, b_by = H100.bound_ms(*ssd.work_bwd(Bsz * H, Bsz * G, S, P, N, 2), bf16)
        rows[("ssd_scan", variant, key)] = dict(
            shape=what + " bf16, views of conv_out, dt ~0.02",
            max_abs_err=max(max_err(g, w) for g, w in zip(got, want)), rel_err=rel,
            tol_share=SSD_BWD_TOL,
            ms=timer.ms(lambda: ssd._launch_bwd(x, dt, A2, Bm, Cm, dy, None)),
            plain_ms=timer.ms(lambda: ssd.ssd_scan_vjp(x, dt, A2, Bm, Cm, dy, None), reps=5),
            library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"ssd_scan[{variant}] {what}: largest error {rel:.3g} of a gradient's largest "
            f"magnitude; bit-identical over two launches")
        del buf, x, Bm, Cm, dt, A2, dy, got, want
        torch.cuda.empty_cache()


# (BH, Sq, Sk, D): the CPU tests' sweep, ragged ends, Sq != Sk both ways,
# a head dim that is not a multiple of 16 (bf16 on the CUDA cores),
# HuBERT's 80 (the mma tile of 128, masked past 80) ragged, and 300 rows
# (five 64-key tiles: each of a row block's two walks takes more than one,
# so alpha counts); f32 goes to the CUDA-core kernel, bf16 with D % 16 == 0
# to the tensor cores
FLASH_CASES = [(2, 128, 128, 64), (3, 256, 256, 128), (1, 64, 64, 32), (2, 96, 96, 64),
               (2, 100, 100, 16), (2, 64, 128, 64), (2, 128, 64, 64), (2, 100, 130, 40),
               (2, 100, 100, 80), (2, 77, 130, 80), (2, 130, 77, 80), (2, 300, 300, 64)]
# (BH, Sq, Sk, D, Dv): a value head dim Dv != D (MLA's prefill: 192 / 128),
# ragged and Sq != Sk, on the mma tiles (192/128, 64/64) and, off the
# multiples of 16, the CUDA cores
FLASH_DV_CASES = [(2, 100, 100, 192, 128), (2, 130, 100, 192, 128), (2, 100, 130, 192, 128),
                  (1, 200, 200, 64, 32), (2, 96, 96, 40, 24)]
# (BH, Sq, Sk, D, Dv, offset): the CUDA-core kernel's (class, path) pairs
# the two lists above leave out: the general path of the 32/32, 128/128 and
# 192/128 classes (bf16 with D % 16 != 0; f32 with D % 4 != 0) and of f32
# operands one element off their 16-byte boundaries (offset 1)
FLASH_PLAN_CASES = [(2, 150, 150, 30, 30, 0), (2, 150, 150, 120, 72, 0),
                    (2, 150, 150, 180, 120, 0), (2, 150, 150, 64, 64, 1)]
# every (tile class, load path) of the flash CUDA-core kernel, as its C plan
# (flash_cuda_core_plan) numbers them: class 2 c + 1 on the fast path
FLASH_CUDA_CORE_PLANS = {(c, p) for c in ("d32", "d64", "d128", "d192")
                         for p in ("fast", "general")}
# planted faults in copies of csrc/flash_attention.cu's CUDA-core kernel,
# each of which the flash sweep must see: (name, ((old, new), ...))
FLASH_CUDA_CORE_FAULTS = (
    ("the last KV stage dropped", (("for (int h = 0; h < nh; ++h) {",
                                    "for (int h = 0; h < nh - 2; ++h) {"),)),
    ("a ring stage read one step early", (
        ("const float* tile = own + h % C::NS * C::SLOT;",
         "const float* tile = own + (h + 1) % C::NS * C::SLOT;"),)),
    ("alpha not applied", (("for (int j = 0; j < C::TV; ++j) acc[i][j] *= alpha;",
                            "for (int j = 0; j < C::TV; ++j) acc[i][j] *= 1.f;"),)),
)

# (BH, S, P, N, offset): the SSD CUDA-core kernel's (class, path) pairs the
# sweep's other cases leave out: the general path in f32 (P % 4 != 0) at
# each class (N 48 on the 128 class's tiles, zero past N), and f32 operands
# one element off their 16-byte boundaries
SSD_PLAN_CASES = [(2, 150, 30, 16, 0), (2, 150, 30, 48, 0), (2, 150, 30, 128, 0),
                  (2, 150, 64, 128, 1)]
# every (tile class, load path) of the SSD CUDA-core kernel, as its C plan
# (ssd_cuda_core_plan) numbers them: class 2 c + 1 on the fast path
SSD_CUDA_CORE_PLANS = {(c, p) for c in ("n32", "n128") for p in ("fast", "general")}
# the chunk at which an SSD variant's bound_ms counts the scan's work, where
# it is not the variant's own: the CUDA-core kernel's yardstick stays at
# chunks of 32 whatever chunk the kernel takes (the chunked form's triangle
# work grows with the chunk, so a longer one would raise the bound with
# nothing faster); its rows give the bound at the kernel's own chunk beside
# it (bound_ms_own_chunk)
SSD_BOUND_CHUNK = {"cuda_core": 32}
# planted faults in copies of csrc/ssd_scan.cu's CUDA-core kernels, each of
# which the SSD sweep must see: (name, ((old, new), ...))
SSD_CUDA_CORE_FAULTS = (
    ("the carry's decay dropped", tuple((f"h.{c} = fmaf(d[k], h.{c}, s[k].{c});",
                                         f"h.{c} = h.{c} + s[k].{c};") for c in "xyzw")),
    ("one chunk's state term dropped", (
        ("  if (c > 0) {\n    __syncthreads();  // every read of S^T is done",
         "  if (c > 1) {\n    __syncthreads();  // every read of S^T is done"),)),
    ("the diagonal term's decay L dropped", (("cb[r][k] * expf(cs[i] - cs[j]) * dts[j]",
                                               "cb[r][k] * dts[j]"),)),
)


def ssd_cuda_core_call(torch, lib, x, dt, A, B, C):
    """y and the final state of one launch of the SSD CUDA-core kernel from
    ``lib`` on flat [BH, S, *] operands (any dtype it takes, the ones the
    selector sends to ``wgmma`` too), its scratch allocated from the
    library's own count."""
    from repro_torch.kernels._build import stream_handle

    BH, S, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((BH, P, N), dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.size("ssd_cuda_core_scratch_floats", BH, S, P, N),
                          dtype=torch.float32, device=x.device)
    lib.launch("cuda_core", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
               y.data_ptr(), h.data_ptr(), scratch.data_ptr(), BH, S, P, N,
               int(x.dtype == torch.bfloat16), stream_handle(x))
    return y, h


def ssd_cuda_core_plan_of(torch, lib, x, B, C, y) -> tuple:
    """(tile class, load path) the C side picked for an SSD CUDA-core launch
    on these operands (``ssd_cuda_core_plan``)."""
    from repro_torch.kernels.ssd_scan import cuda_core_plan_of_code

    aligned = all(t.data_ptr() % 16 == 0 for t in (x, B, C, y))
    return cuda_core_plan_of_code(lib.size("ssd_cuda_core_plan", x.shape[-1], B.shape[-1],
                                           int(x.dtype == torch.bfloat16), int(aligned)))


def flash_sweep_cases(torch):
    """Every case of the flash sweep: (BH, Sq, Sk, D, Dv, offset, dtype,
    causal); operands off their boundaries in f32 only (the tensor-core
    kernel, which bf16 with D % 16 == 0 takes, refuses them)."""
    cases = ([(BH, Sq, Sk, D, D, 0) for BH, Sq, Sk, D in FLASH_CASES]
             + [(*c, 0) for c in FLASH_DV_CASES] + list(FLASH_PLAN_CASES))
    return [(*c, dtype, causal) for c in cases for dtype in (torch.float32, torch.bfloat16)
            for causal in (True, False) if not (c[-1] and dtype == torch.bfloat16)]


def flash_inputs(torch, randn, BH, Sq, Sk, D, Dv, offset, dtype):
    """q, k, v, each a contiguous view ``offset`` elements into its storage
    (1: off the 16-byte boundaries the CUDA-core kernel's fast path needs)."""
    out = []
    for shape in ((BH, Sq, D), (BH, Sk, D), (BH, Sk, Dv)):
        t = randn(*shape, dtype=dtype)
        if offset:
            buf = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
            buf[offset:].copy_(t.reshape(-1))
            t = buf[offset:].view(shape)
        out.append(t)
    return out


def flash_cuda_core_plan_of(torch, lib, k, v, o) -> tuple:
    """(tile class, load path) the C side picked for a flash CUDA-core
    launch on these operands (``flash_cuda_core_plan``)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (k, v, o))
    code = lib.size("flash_cuda_core_plan", k.shape[-1], v.shape[-1],
                    int(k.dtype == torch.bfloat16), int(aligned))
    return ("d32", "d64", "d128", "d192")[code // 2], ("general", "fast")[code % 2]


def flash_sweep(torch, randn, hit: set) -> set:
    """Every case of ``flash_sweep_cases`` through the wrapper, held against
    the plain version within FLASH_TOL; the variants reached go into
    ``hit``.  Returns the CUDA-core kernel's (class, path) pairs reached."""
    from repro_torch.kernels import FLASH_LIBRARY, flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    reached = set()
    for BH, Sq, Sk, D, Dv, offset, dtype, causal in flash_sweep_cases(torch):
        q, k, v = flash_inputs(torch, randn, BH, Sq, Sk, D, Dv, offset, dtype)
        o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=causal))
        hit.add(variant)
        if variant == "cuda_core":
            reached.add(flash_cuda_core_plan_of(torch, FLASH_LIBRARY, k, v, o))
        r = flash_attention_ref(q, k, v, causal=causal)
        tol = FLASH_TOL[str(dtype)]
        if o.shape != r.shape or not within(o, r, tol):
            raise AssertionError(f"flash_attention[{variant}] {(BH, Sq, Sk, D, Dv, offset)} "
                                 f"{dtype} causal={causal}: max err {max_err(o, r):.3g} > {tol}")
    return reached


def flash_cuda_core_fault_sweep(torch, randn, lib) -> tuple:
    """The flash sweep's CUDA-core cases launched from ``lib`` (a copy of the
    library with a planted fault): (cases outside FLASH_TOL, cases, largest
    error)."""
    from repro_torch.kernels._build import stream_handle
    from repro_torch.kernels.flash_attention import select_variant
    from repro_torch.kernels.ref import flash_attention_ref

    failed = total = 0
    worst = 0.0
    for BH, Sq, Sk, D, Dv, offset, dtype, causal in flash_sweep_cases(torch):
        if select_variant(D, Dv, dtype) != "cuda_core":
            continue
        q, k, v = flash_inputs(torch, randn, BH, Sq, Sk, D, Dv, offset, dtype)
        o = torch.empty((BH, Sq, Dv), dtype=dtype, device="cuda")
        lib.launch("cuda_core", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, Sq,
                   Sk, D, Dv, D ** -0.5, int(causal), int(dtype == torch.bfloat16),
                   stream_handle(q))
        torch.cuda.synchronize()
        r = flash_attention_ref(q, k, v, causal=causal)
        total += 1
        err = max_err(o, r)
        worst = max(worst, err if math.isfinite(err) else math.inf)
        failed += not within(o, r, FLASH_TOL[str(dtype)])
    return failed, total, worst


# (M, D, F): the CPU tests' sweep, then a K tail (D = 2056) with F not a
# multiple of the column tiles at both ends of the bf16 row range; bf16 goes
# to the decode kernel below 64 rows and to wgmma from 64, f32 and unaligned
# bf16 (5, 100, 70) to the CUDA cores; then the CUDA-core kernel's classes
# and paths: 576 rows on the 64-row class (f32; bf16 on wgmma), F % 4 != 0
# on the general path of each class (bf16 there too: D % 8 != 0), and a K
# tail (D = 2050) that is not a multiple of a stage's 8 or 32 k rows
SWIGLU_CASES = [(64, 128, 256), (128, 256, 128), (32, 64, 64), (5, 100, 70), (24, 64, 96),
                (1, 2056, 200), (79, 2056, 200), (576, 512, 5632), (576, 300, 5630),
                (200, 2050, 98), (8, 2050, 5630)]
# (E, M, D, F): the expert entries, M rows an expert: both sides of 64 rows,
# ragged M (a tile past an expert's rows), a K tail, one row, E = 1,
# unaligned D and F (the CUDA cores in bf16); the CUDA-core kernel's 64-row
# class (64 experts of 64 rows) and its general path on the 128-row class
SWIGLU_EXPERT_CASES = [(3, 64, 256, 96), (5, 79, 2056, 200), (3, 63, 256, 96), (4, 1, 256, 96),
                       (1, 200, 256, 96), (1, 8, 256, 96), (3, 7, 100, 70), (3, 24, 256, 96),
                       (64, 64, 256, 1408), (4, 130, 2050, 98)]
# every (tile class, load path) of the CUDA-core kernel, as its C plan
# (swiglu_cuda_core_plan) numbers them: class 2 c + 1 on the fast path
CUDA_CORE_PLANS = {(c, p) for c in ("small", "r64", "r128") for p in ("fast", "general")}
# planted faults in copies of csrc/swiglu_matmul.cu's CUDA-core kernel, each
# of which the sweep must see: (name, ((old, new), ...))
CUDA_CORE_FAULTS = (
    ("the last k-stage dropped", (("for (int i = 0; i < nk; ++i) {",
                                   "for (int i = 0; i < nk - 1; ++i) {"),)),
    ("a ring stage read one step early", (
        ("const float* cur = sm + (i % C::STAGES) * C::STAGE;",
         "const float* cur = sm + ((i + 1) % C::STAGES) * C::STAGE;"),)),
    ("the ragged-F store unmasked", (
        ("if (n < F) *reinterpret_cast<float4*>(o)", "*reinterpret_cast<float4*>(o)"),
        ("if (n + j < F) store(o + j, v[j]);", "store(o + j, v[j]);"),
        ("if (m < M && n < F) store(out", "if (m < M) store(out"))),
)


def cuda_core_plan_of(torch, lib, x, wg, wu, out) -> tuple:
    """(tile class, load path) the C side picked for a CUDA-core launch on
    these operands (``swiglu_cuda_core_plan``)."""
    *lead, M, D = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (wg, wu, out))
    code = lib.size("swiglu_cuda_core_plan", *(lead or [1]), M, D, wg.shape[-1],
                    int(x.dtype == torch.bfloat16), int(aligned))
    return ("small", "r64", "r128")[code // 2], ("general", "fast")[code % 2]


def swiglu_sweep(torch, randn, hit: set) -> set:
    """Every case of SWIGLU_CASES and SWIGLU_EXPERT_CASES in f32 and bf16
    through the wrappers, held against the plain versions; the variants
    reached go into ``hit``.  Returns the CUDA-core kernel's (class, path)
    pairs the sweep reached."""
    from repro_torch.kernels import SWIGLU_LIBRARY, swiglu_experts, swiglu_matmul
    from repro_torch.kernels.ref import swiglu_experts_ref, swiglu_ref

    reached = set()
    cases = [(None, *c) for c in SWIGLU_CASES] + list(SWIGLU_EXPERT_CASES)
    for E, M, D, Fd in cases:
        lead = () if E is None else (E,)
        entry, ref = (swiglu_matmul, swiglu_ref) if E is None else (swiglu_experts,
                                                                    swiglu_experts_ref)
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*lead, M, D, dtype=dtype)
            wg = randn(*lead, D, Fd, dtype=dtype, scale=D ** -0.5)
            wu = randn(*lead, D, Fd, dtype=dtype, scale=D ** -0.5)
            o, variant = launched(SWIGLU_LIBRARY, lambda: entry(x, wg, wu))
            hit.add(variant)
            if variant.endswith("cuda_core"):
                reached.add(cuda_core_plan_of(torch, SWIGLU_LIBRARY, x, wg, wu, o))
            r = ref(x, wg, wu)
            tol = SWIGLU_TOL[str(dtype)]
            if o.shape != r.shape or not within(o, r, tol):
                raise AssertionError(f"{entry.__name__}[{variant}] {(E, M, D, Fd)} {dtype}: "
                                     f"max err {max_err(o, r):.3g} > tol {tol}")
    return reached


def cuda_core_fault_sweep(torch, randn, lib) -> tuple:
    """The sweep's CUDA-core cases launched from ``lib`` (a copy of the
    library with a planted fault), each into an output with 4 KB of slack
    behind it (a store past F must not leave the allocation): (cases
    outside tolerance, cases, largest error)."""
    from repro_torch.kernels._build import stream_handle
    from repro_torch.kernels.ref import swiglu_experts_ref, swiglu_ref
    from repro_torch.kernels.swiglu_matmul import select_variant

    failed = total = 0
    worst = 0.0
    cases = [(None, *c) for c in SWIGLU_CASES] + list(SWIGLU_EXPERT_CASES)
    for E, M, D, Fd in cases:
        lead = () if E is None else (E,)
        for dtype in (torch.float32, torch.bfloat16):
            if select_variant(M, D, Fd, dtype) != "cuda_core":
                continue
            x = randn(*lead, M, D, dtype=dtype)
            wg = randn(*lead, D, Fd, dtype=dtype, scale=D ** -0.5)
            wu = randn(*lead, D, Fd, dtype=dtype, scale=D ** -0.5)
            n = (E or 1) * M * Fd
            buf = torch.zeros(n + 4096 // x.element_size(), dtype=dtype, device="cuda")
            o = buf[:n].view(*lead, M, Fd)
            variant = "cuda_core" if E is None else "experts_cuda_core"
            lib.launch(variant, x.data_ptr(), wg.data_ptr(), wu.data_ptr(), o.data_ptr(),
                       *lead, M, D, Fd, int(dtype == torch.bfloat16), stream_handle(x))
            torch.cuda.synchronize()
            r = (swiglu_ref if E is None else swiglu_experts_ref)(x, wg, wu)
            total += 1
            worst = max(worst, max_err(o, r))
            failed += not within(o, r, SWIGLU_TOL[str(dtype)])
    return failed, total, worst


def check_kernels(torch, timer):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import (
        FLASH_LIBRARY, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, select_ssd_variant, ssd_mixer,
        ssd_scan, swiglu_experts, swiglu_matmul,
    )
    from repro_torch.kernels.ref import (
        flash_attention_ref, ssd_scan_ref, swiglu_experts_ref, swiglu_ref,
    )
    from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK
    from repro_torch.kernels.flash_attention import work as flash_work
    from repro_torch.kernels.swiglu_matmul import work as swiglu_work
    from repro_torch.kernels.ssd_scan import work as ssd_work
    from repro_torch.launch.roofline_model import H100

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(scale).to(dtype)

    rows = {}
    f32, bf16 = torch.float32, torch.bfloat16
    hit = {FLASH_LIBRARY.name: set(), SWIGLU_LIBRARY.name: set(), SSD_LIBRARY.name: set()}
    flash_reached = flash_sweep(torch, randn, hit[FLASH_LIBRARY.name])
    if flash_reached != FLASH_CUDA_CORE_PLANS:
        raise AssertionError(f"the flash sweep reached the CUDA-core kernel's (class, path) "
                             f"{sorted(flash_reached)}, not {sorted(FLASH_CUDA_CORE_PLANS)}")
    log(f"flash_attention: {len(flash_sweep_cases(torch))} sweep cases within tolerance "
        f"(variants {sorted(hit[FLASH_LIBRARY.name])}; cuda_core classes and load paths "
        f"{sorted(flash_reached)})")
    for name, lib in flash_cuda_core_fault_libraries().items():
        failed, cases, worst = flash_cuda_core_fault_sweep(torch, randn, lib)
        log(f"flash cuda_core planted fault ({name}): {failed} of {cases} CUDA-core sweep cases "
            f"outside tolerance (largest error {worst:.3g})")
        if not failed:
            raise AssertionError(f"the flash sweep does not see the planted fault: {name}")
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
        ops, nbytes = flash_work(BH, S, S, D, True, q.element_size())
        b_ms, b_by = H100.bound_ms(ops, nbytes, dtype)
        rows[("flash_attention", variant, S)] = dict(
            shape=f"BH={BH} S={S} D={D} {str(dtype)[6:]} causal", max_abs_err=max_err(o, r),
            tol=list(tol), ms=timer.ms(lambda: flash_attention(q, k, v, causal=True)),
            plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, causal=True)),
            library=lib_name, library_ms=timer.ms(sdpa_call(torch, backend, q, k, v)),
            bound_ms=b_ms, bound_by=b_by)
    # the CUDA-core kernel at the other tile classes a path's head dims
    # reach, in f32: D 128 (32 heads) and MLA's 192/128 (16 heads); the
    # yardstick SDPA's memory-efficient backend, as at D 64 (the first fused
    # backend that takes Dv != D in f32)
    for key, BH, D, Dv in (("d128", 32, 128, 128), ("mla", 16, 192, 128)):
        S = 1024
        q, k = (randn(BH, S, D, dtype=f32) for _ in range(2))
        v = randn(BH, S, Dv, dtype=f32)
        o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=True))
        r = flash_attention_ref(q, k, v, causal=True)
        tol = FLASH_TOL[str(f32)]
        if variant != "cuda_core" or not within(o, r, tol):
            raise AssertionError(f"flash_attention[{variant}] f32 {key}: max err "
                                 f"{max_err(o, r):.3g} > {tol}")
        lib_call, lib_name = ((sdpa_call(torch, SDPBackend.EFFICIENT_ATTENTION, q, k, v),
                               "sdpa[efficient]") if D == Dv else sdpa_value_dim_call(torch, q, k, v))
        if not within(lib_call()[0], r, tol):
            raise AssertionError(f"{lib_name} does not compute the same function at {key}")
        b_ms, b_by = H100.bound_ms(*flash_work(BH, S, S, D, True, 4, Dv=Dv), f32)
        rows[("flash_attention", variant, key)] = dict(
            shape=f"BH={BH} S={S} D={D}{f' Dv={Dv}' if Dv != D else ''} f32 causal",
            max_abs_err=max_err(o, r), tol=list(tol),
            ms=timer.ms(lambda: flash_attention(q, k, v, causal=True)),
            plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, causal=True)),
            library=lib_name, library_ms=timer.ms(lib_call), bound_ms=b_ms, bound_by=b_by)
        del q, k, v, o, r
    # DeepSeek-V2-Lite's MLA prefill: 16 heads, q/k 192 (128 nope + 64 rope), v 128
    BH, S, D, Dv = 16, 1024, 192, 128
    q, k = (randn(BH, S, D, dtype=bf16) for _ in range(2))
    v = randn(BH, S, Dv, dtype=bf16)
    o, variant = launched(FLASH_LIBRARY, lambda: flash_attention(q, k, v, causal=True))
    r = flash_attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL[str(bf16)]
    if not within(o, r, tol):
        raise AssertionError(f"flash_attention[{variant}] MLA path: max err {max_err(o, r):.3g}")
    lib_call, lib_name = sdpa_value_dim_call(torch, q, k, v)
    lib_out = lib_call()[0]
    if not within(lib_out, r, tol):
        raise AssertionError(f"{lib_name} does not compute the same function: "
                             f"max err {max_err(lib_out, r):.3g}")
    b_ms, b_by = H100.bound_ms(*flash_work(BH, S, S, D, True, 2, Dv=Dv), bf16)
    rows[("flash_attention", variant, "mla")] = dict(
        shape=f"BH={BH} S={S} D={D} Dv={Dv} bf16 causal", max_abs_err=max_err(o, r),
        tol=list(tol), ms=timer.ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=timer.ms(lambda: flash_attention_ref(q, k, v, causal=True)),
        library=lib_name, library_ms=timer.ms(lib_call), bound_ms=b_ms, bound_by=b_by)

    reached = swiglu_sweep(torch, randn, hit[SWIGLU_LIBRARY.name])
    if reached != CUDA_CORE_PLANS:
        raise AssertionError(f"the f32 and unaligned sweep reached the CUDA-core kernel's "
                             f"(class, path) {sorted(reached)}, not {sorted(CUDA_CORE_PLANS)}")
    log(f"swiglu_matmul: {len(SWIGLU_CASES) * 2} sweep cases and {len(SWIGLU_EXPERT_CASES) * 2} "
        f"expert cases within tolerance (variants {sorted(hit[SWIGLU_LIBRARY.name])}; "
        f"cuda_core classes and load paths {sorted(reached)})")
    for name, lib in cuda_core_fault_libraries().items():
        failed, cases, worst = cuda_core_fault_sweep(torch, randn, lib)
        log(f"cuda_core planted fault ({name}): {failed} of {cases} CUDA-core sweep cases "
            f"outside tolerance (largest error {worst:.3g})")
        if not failed:
            raise AssertionError(f"the sweep does not see the planted fault: {name}")
    for lib in (FLASH_LIBRARY, SWIGLU_LIBRARY):  # the backward kernels: backward_paths
        if hit[lib.name] != {v for v in lib.variants if not v.endswith("_bwd")}:
            raise AssertionError(f"{lib.name}: the sweep reached {sorted(hit[lib.name])}, "
                                 f"not every variant of {sorted(lib.variants)}")
    # the serving path's shapes: decode (8 slots) and prefill rows, bf16;
    # the CUDA-core kernel on the prefill shape and on 8 rows (its small
    # class, bound by the weights' bytes) in f32 (its route)
    for M, dtype in ((8, bf16), (512, bf16), (1024, bf16), (512, f32), (8, f32)):
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
        ops, nbytes = swiglu_work(M, D, Fd, x.element_size())
        b_ms, b_by = H100.bound_ms(ops, nbytes, dtype)
        assert not torch.backends.cuda.matmul.allow_tf32  # cuBLAS's f32 yardstick in full f32
        rows[("swiglu_matmul", variant, M)] = dict(
            shape=f"M={M} D={D} F={Fd} {str(dtype)[6:]}", max_abs_err=max_err(o, r),
            tol=list(tol), ms=timer.ms(lambda: swiglu_matmul(x, wg, wu)),
            plain_ms=timer.ms(lambda: swiglu_ref(x, wg, wu)),
            library="F.silu(x@wg)*(x@wu)", library_ms=timer.ms(lambda: F.silu(x @ wg) * (x @ wu)),
            bound_ms=b_ms, bound_by=b_by)
    # DeepSeek-V2-Lite's dense products (D 2048): the lead layer's FFN (F
    # 10944) and the shared experts (F 2816), at a prefill's rows (wgmma)
    # and a tick's (decode)
    for M, Fd in ((1024, 10944), (1024, 2816), (8, 10944), (8, 2816)):
        D = 2048
        x = randn(M, D, dtype=bf16)
        wg = randn(D, Fd, dtype=bf16, scale=D ** -0.5)
        wu = randn(D, Fd, dtype=bf16, scale=D ** -0.5)
        o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_matmul(x, wg, wu))
        r = swiglu_ref(x, wg, wu)
        tol = SWIGLU_TOL[str(bf16)]
        if variant != ("wgmma" if M >= 64 else "decode") or not within(o, r, tol):
            raise AssertionError(f"swiglu_matmul[{variant}] DeepSeek path M={M} F={Fd}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        log(f"swiglu_matmul[{variant}] DeepSeek path M={M} D={D} F={Fd}: max err "
            f"{max_err(o, r):.3g}")
    # the routed experts at a prefill's other capacities: 24 and 48 rows
    # (the decode kernel's 2- and 4-tile forms), 63 (its last) and 64 (the
    # first that goes to wgmma)
    for M in (24, 48, 63, 64):
        E, D, Fd = 64, 2048, 1408
        x = randn(E, M, D, dtype=bf16)
        wg = randn(E, D, Fd, dtype=bf16, scale=D ** -0.5)
        wu = randn(E, D, Fd, dtype=bf16, scale=D ** -0.5)
        o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_experts(x, wg, wu))
        r = swiglu_experts_ref(x, wg, wu)
        tol = SWIGLU_TOL[str(bf16)]
        if variant != ("experts_wgmma" if M >= 64 else "experts_decode") or not within(o, r, tol):
            raise AssertionError(f"swiglu_experts[{variant}] path M={M}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        log(f"swiglu_experts[{variant}] path E={E} M={M} D={D} F={Fd}: max err "
            f"{max_err(o, r):.3g}")
        del x, wg, wu
    # DeepSeek-V2-Lite's routed experts (64 experts, D 2048, F 1408): a
    # prefill's capacity of 120 rows an expert (n = 1024) and a decode tick's
    # 8 slots of one row, bf16; the CUDA cores on 120 rows in f32 (their route)
    for M, dtype in ((120, bf16), (8, bf16), (120, f32)):
        E, D, Fd = 64, 2048, 1408
        x = randn(E, M, D, dtype=dtype)
        wg = randn(E, D, Fd, dtype=dtype, scale=D ** -0.5)
        wu = randn(E, D, Fd, dtype=dtype, scale=D ** -0.5)
        o, variant = launched(SWIGLU_LIBRARY, lambda: swiglu_experts(x, wg, wu))
        r = swiglu_experts_ref(x, wg, wu)
        tol = SWIGLU_TOL[str(dtype)]
        if not within(o, r, tol):
            raise AssertionError(f"swiglu_experts[{variant}] path M={M} {dtype}: "
                                 f"max err {max_err(o, r):.3g} > {tol}")
        b_ms, b_by = H100.bound_ms(*swiglu_work(M, D, Fd, x.element_size(), E=E), dtype)
        assert not torch.backends.cuda.matmul.allow_tf32  # cuBLAS's f32 yardstick in full f32
        rows[("swiglu_matmul", variant, M)] = dict(
            shape=f"E={E} M={M} D={D} F={Fd} {str(dtype)[6:]}", max_abs_err=max_err(o, r),
            tol=list(tol), ms=timer.ms(lambda: swiglu_experts(x, wg, wu)),
            plain_ms=timer.ms(lambda: swiglu_experts_ref(x, wg, wu)),
            library="F.silu(bmm(x,wg))*bmm(x,wu)",
            library_ms=timer.ms(lambda: F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)),
            bound_ms=b_ms, bound_by=b_by)
        del x, wg, wu

    def ssd_inputs(BH, S, P, N, dtype, dt_shift=0.0, offset=0):
        """dt = softplus(normal - dt_shift): at 0 a chunk of 64 decays by
        ~e^-50, so the state carried across chunks is negligible; at 4 (dt
        ~0.02, as in trained models) by 0.1-0.4, and it counts.  x, B and C
        are contiguous views ``offset`` elements into their storage (1: off
        the 16-byte boundaries the CUDA-core kernel's fast path needs)."""
        x = randn(BH, S, P, dtype=dtype)
        dt = torch.nn.functional.softplus(randn(BH, S, dtype=f32) - dt_shift)
        A = -torch.exp(randn(BH, dtype=f32, scale=0.5))
        B, C = randn(BH, S, N, dtype=dtype, scale=0.5), randn(BH, S, N, dtype=dtype, scale=0.5)
        if offset:
            def off(t):
                buf = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
                buf[offset:].copy_(t.reshape(-1))
                return buf[offset:].view(t.shape)
            x, B, C = off(x), off(B), off(C)
        return x, dt, A, B, C

    worst = {"y": 0.0, "state": 0.0}  # largest error over its tolerance, element by element

    def ssd_ratios(out, ref, dtype):
        """Each of y's and the final state's largest error over its
        tolerance, element by element (NaN where one is not finite), and
        their (atol, rtol)."""
        (y, h), (ry, rh) = out, ref
        atol, rtol = SSD_Y_TOL[str(dtype)]
        tols = {"y": (atol * max(float(ry.float().abs().max()), 1.0), rtol),
                "state": (SSD_STATE_TOL * max(float(rh.abs().max()), 1.0), 0.0)}
        ratios = {}
        for name, o, r in (("y", y, ry), ("state", h, rh)):
            o, r = o.float(), r.float()
            a, rt = tols[name]
            ratios[name] = float(((o - r).abs() / (a + rt * r.abs())).max())
        return ratios, tols

    def ssd_hold(what, out, ref, dtype):
        """Hold y and the final state to tolerance, element by element;
        return y's max error and its (atol, rtol)."""
        ratios, tols = ssd_ratios(out, ref, dtype)
        for name, o, r in (("y", out[0], ref[0]), ("state", out[1], ref[1])):
            if not ratios[name] <= 1:
                a, rt = tols[name]
                raise AssertionError(
                    f"ssd_scan {what} {dtype}: {name} max err {max_err(o, r):.3g} is "
                    f"{ratios[name]:.3g} times its tolerance (atol {a:.3g}, rtol {rt:.3g}; max "
                    f"|ref| {float(r.float().abs().max()):.3g})")
            worst[name] = max(worst[name], ratios[name])
        return max_err(out[0], ref[0]), tols["y"]

    ssd_reached = set()  # the CUDA-core kernel's (class, path) pairs the sweep reached

    def ssd_check(what, args, dtype):
        out, variant = launched(SSD_LIBRARY, lambda: ssd_scan(*args, return_state=True))
        hit[SSD_LIBRARY.name].add(variant)
        if variant == "cuda_core":
            ssd_reached.add(ssd_cuda_core_plan_of(torch, SSD_LIBRARY, args[0], args[3], args[4],
                                                  out[0]))
        return ssd_hold(f"[{variant}] {what}", out, ssd_scan_ref(*args, return_state=True),
                        dtype), variant

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
    # variants; the CUDA-core kernel at ragged S, N 16 and P 24 too
    slow_cases = [(2, 1000, 64, 128, bf16), (3, 256, 64, 128, bf16), (2, 300, 64, 16, bf16),
                  (2, 300, 64, 128, f32), (2, 1000, 64, 16, f32), (3, 300, 24, 16, f32)]
    for (BH, S, P, N, dtype) in slow_cases:
        ssd_check(f"{(BH, S, P, N)} slow decay", ssd_inputs(BH, S, P, N, dtype, dt_shift=4.0),
                  dtype)
    # the CUDA-core kernel's general path in f32 at each class, and off the
    # 16-byte boundaries
    for (BH, S, P, N, offset) in SSD_PLAN_CASES:
        _, variant = ssd_check(f"{(BH, S, P, N)} offset {offset}",
                               ssd_inputs(BH, S, P, N, f32, offset=offset), f32)
        if variant != "cuda_core":
            raise AssertionError(f"ssd_scan {(BH, S, P, N)} f32 took {variant}, not cuda_core")
    # the backward kernel: backward_paths
    if hit[SSD_LIBRARY.name] != {v for v in SSD_LIBRARY.variants if not v.endswith("_bwd")}:
        raise AssertionError(f"ssd_scan: the sweep reached {sorted(hit[SSD_LIBRARY.name])}")
    if ssd_reached != SSD_CUDA_CORE_PLANS:
        raise AssertionError(f"the SSD sweep reached the CUDA-core kernel's (class, path) "
                             f"{sorted(ssd_reached)}, not {sorted(SSD_CUDA_CORE_PLANS)}")
    # every CUDA-core case of the sweep, launched from copies of the source
    # with a fault planted: each fault must fail some
    ssd_cc_cases = ([(BH, S, P, N, dtype, 0.0, 0) for (BH, S, P, N) in ssd_cases
                     for dtype in (f32, bf16) if select_ssd_variant(P, N, dtype) == "cuda_core"]
                    + [(BH, S, P, N, dtype, 4.0, 0) for (BH, S, P, N, dtype) in slow_cases
                       if select_ssd_variant(P, N, dtype) == "cuda_core"]
                    + [(BH, S, P, N, f32, 0.0, offset) for (BH, S, P, N, offset) in SSD_PLAN_CASES])
    for name, lib in ssd_cuda_core_fault_libraries().items():
        failed, largest = 0, 0.0
        for (BH, S, P, N, dtype, shift, offset) in ssd_cc_cases:
            args = ssd_inputs(BH, S, P, N, dtype, shift, offset)
            out = ssd_cuda_core_call(torch, lib, *args)
            torch.cuda.synchronize()
            ratios, _ = ssd_ratios(out, ssd_scan_ref(*args, return_state=True), dtype)
            ratio = max(v if math.isfinite(v) else math.inf for v in ratios.values())
            failed += ratio > 1
            largest = max(largest, ratio)
        log(f"ssd_scan cuda_core planted fault ({name}): {failed} of {len(ssd_cc_cases)} "
            f"CUDA-core sweep cases outside tolerance (largest error over it {largest:.3g})")
        if not failed:
            raise AssertionError(f"the SSD sweep does not see the planted fault: {name}")

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
    log(f"ssd_scan: {len(ssd_cases) * 2 + len(wgmma_cases) + len(slow_cases)} sweep cases, "
        f"{len(SSD_PLAN_CASES)} plan cases and a strided grouped mixer within tolerance (y and "
        f"final state; variants {sorted(hit[SSD_LIBRARY.name])}; cuda_core classes and load "
        f"paths {sorted(ssd_reached)})")

    def ssd_bound(BH, S, P, N, dtype, variant):
        """bound_ms and bound_by of a flat [BH, S, *] scan at the chunk
        its variant's yardstick counts at (SSD_BOUND_CHUNK), and, where that
        is not the kernel's own chunk, the bound at the kernel's own."""
        elem = torch.empty((), dtype=dtype).element_size()
        chunk = SSD_BOUND_CHUNK.get(variant, SSD_CHUNK[variant])
        b_ms, b_by = H100.bound_ms(*ssd_work(BH, BH, S, P, N, elem, chunk), dtype)
        out = dict(bound_ms=b_ms, bound_by=b_by)
        if chunk != SSD_CHUNK[variant]:
            out["bound_ms_own_chunk"] = H100.bound_ms(
                *ssd_work(BH, BH, S, P, N, elem, SSD_CHUNK[variant]), dtype)[0]
        return out

    # mamba2-370m's prefill: 32 heads, head dim 64, state 128 (one group).
    # [BH, S, *] rows: wgmma in bf16, the CUDA-core kernel in f32 (its route)
    # and, for comparison, in bf16 (the mamba2 path's kernel before wgmma)
    for S, dtype in ((128, bf16), (1024, bf16), (1024, f32)):
        BH, P, N = 32, 64, 128
        args = ssd_inputs(BH, S, P, N, dtype)
        (err, tol), variant = ssd_check(f"path S={S}", args, dtype)
        rows[("ssd_scan", variant, S)] = dict(
            shape=f"BH={BH} S={S} P={P} N={N} {str(dtype)[6:]}", max_abs_err=err, tol=list(tol),
            ms=timer.ms(lambda: ssd_scan(*args, return_state=True)),
            plain_ms=timer.ms(lambda: ssd_scan_ref(*args, return_state=True), reps=5),
            library=None, library_ms=None,  # no single PyTorch call computes an SSD scan
            **ssd_bound(BH, S, P, N, dtype, variant))
        if S == 1024 and dtype == bf16:
            # the CUDA-core kernel on the bf16 operands the selector sends to
            # wgmma: its element path, timed beside wgmma in the same run
            out = ssd_cuda_core_call(torch, SSD_LIBRARY, *args)
            err, tol = ssd_hold("[cuda_core] path S=1024", out,
                                ssd_scan_ref(*args, return_state=True), bf16)
            rows[("ssd_scan", "cuda_core", "bf16")] = dict(
                rows[("ssd_scan", variant, S)],
                shape=f"BH={BH} S={S} P={P} N={N} bf16, element path",
                max_abs_err=err, tol=list(tol),
                ms=timer.ms(lambda: ssd_cuda_core_call(torch, SSD_LIBRARY, *args)),
                **ssd_bound(BH, S, P, N, bf16, "cuda_core"))
    # Jamba's heads in f32 (the CUDA-core kernel's route; its N <= 32 class)
    BH, S, P, N = 128, 1024, 64, 16
    args = ssd_inputs(BH, S, P, N, f32)
    (err, tol), variant = ssd_check(f"Jamba's heads S={S}", args, f32)
    rows[("ssd_scan", variant, "jamba f32")] = dict(
        shape=f"BH={BH} S={S} P={P} N={N} float32", max_abs_err=err, tol=list(tol),
        ms=timer.ms(lambda: ssd_scan(*args, return_state=True)),
        plain_ms=timer.ms(lambda: ssd_scan_ref(*args, return_state=True), reps=5),
        library=None, library_ms=None, **ssd_bound(BH, S, P, N, f32, variant))
    del args
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
    b_ms, b_by = H100.bound_ms(*ssd_work(H, G, S, P, N, 2, SSD_CHUNK[variant]), bf16)
    rows[("ssd_scan", variant, "serving")] = dict(
        shape=f"B=1 S={S} H={H} G={G} P={P} N={N} bf16, views of conv_out", max_abs_err=err,
        tol=list(tol), ms=timer.ms(lambda: ssd_mixer(*args, return_state=True)),
        plain_ms=timer.ms(lambda: ssd_scan_ref(*flat, return_state=True), reps=5),
        library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(f"ssd_scan: largest error over its tolerance, element by element, in the sweep and at "
        f"the path shapes: y {worst['y']:.3g}, final state {worst['state']:.3g}")

    slice_paths(torch, timer, rows, randn, conv_views, ssd_hold)
    train_paths(torch, timer, rows, randn, conv_views, ssd_hold)
    backward_paths(torch, timer, rows, randn)
    conv_paths(torch, timer, rows, randn)

    log(f"{'kernel':26} {'shape':32} {'max_err':>9} {'(atol, rtol)':>14} {'ms':>9} "
        f"{'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} bound_by  library")
    for (name, variant, _), r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        # the flash backward's tolerance is a share of each gradient's largest magnitude
        tol = (f"{r['rel_err']:.3g}<={r['tol_share']:.3g}" if "tol_share" in r else
               "(" + ", ".join(f"{t:.3g}" for t in r["tol"]) + ")")
        log(f"{name + '[' + variant + ']':26} {r['shape']:32} {r['max_abs_err']:9.3g} "
            f"{tol:>14} {r['ms']:9.4f} "
            f"{r['plain_ms']:9.4f} {lib:>10} {r['bound_ms']:9.4f} {r['bound_by']:11} {r['library']}")
    return rows


# --------------------------------------------------------------------------- #
# phase 4: serving
# --------------------------------------------------------------------------- #
def expected_launches(torch, cfg, prompt_lens=(), n_decode: int = 0, slots: int = 0,
                      batch: int = 1, train=None) -> dict:
    """Launches of each kernel variant on a serving run, from the config's
    layers (``layer_plan``): per prefill (or train forward) of ``batch``
    sequences of n positions, flash attention in every attention slot (MLA:
    q/k nope + rope wide, v v_head_dim), the SSD scan in every mamba2 slot,
    the SwiGLU kernel once for every dense FFN, shared-expert MLP and dense
    residual (batch·n rows, padded as ``ops.fused_swiglu`` pads them), and
    the expert kernel once in every MoE layer (rows an expert: the groups
    times their capacity, G = batch·ceil(n / router_chunk) groups of
    min(router_chunk, n) tokens); per decode tick the same SwiGLU and expert
    kernels over the slots (each slot its own group of one token), and no
    attention or scan kernel (decode is plain).  An encoder has no tick
    (``n_decode`` 0).  Each through the variant its selector picks (bf16),
    and none of the others.

    The train form, ``train=(tcfg, global_batch, seq_len)``, counts one
    train step instead, for every family (the SSD scan in each mixer as
    flash in each attention layer): ``tcfg.microbatches`` forwards of
    global_batch / microbatches sequences each, twice under remat (the
    forward, then its recompute in the backward), and one backward of each:
    per attention layer one flash ``wgmma_bwd``, per mamba2 mixer one SSD
    ``wgmma_bwd``, per SwiGLU call of the forward one ``wgmma_bwd``
    (``experts_wgmma_bwd``), each through the variant ``select_bwd_variant``
    picks (a ``"vjp"`` backward, PyTorch, launches nothing).

    Every mamba2 mixer also launches the causal conv's ``fwd`` in each
    forward, prefill and decode tick alike, and its ``bwd`` and
    ``bwd_reduce`` in each backward."""
    n_backward = 0
    if train is not None:
        tcfg, global_batch, seq_len = train
        prompt_lens = [seq_len] * tcfg.microbatches * (2 if tcfg.remat else 1)
        batch = global_batch // tcfg.microbatches
        n_backward = tcfg.microbatches
    from repro_torch.kernels import (
        LIBRARIES, select_experts_variant, select_flash_bwd_variant, select_flash_variant,
        select_ssd_bwd_variant, select_ssd_variant, select_swiglu_bwd_variant,
        select_swiglu_variant,
    )
    from repro_torch.models import layer_plan
    from repro_torch.models.layers import moe_capacity

    bf16 = torch.bfloat16
    plan = layer_plan(cfg)
    expect = {lib.name: {v: 0 for v in lib.variants} for lib in LIBRARIES}
    if cfg.mla is not None:
        dq, dv = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim, cfg.mla.v_head_dim
    else:
        dq = dv = cfg.head_dim
    mlps = {"dense": [cfg.d_ff], "moe": [], "none": []}
    if cfg.moe is not None:
        mlps["moe"] = ([cfg.moe.n_shared * cfg.moe.d_ff_expert] if cfg.moe.n_shared else []) + (
            [cfg.d_ff] if cfg.moe.dense_residual else [])

    def count(lib: str, variant: str):
        if variant != "vjp":  # a PyTorch backward launches no kernel
            expect[lib][variant] += 1

    def step(rows: int, groups: int, group_tokens: int, prefill: bool, backward: bool = False):
        for slot in plan:
            if prefill and slot.mixer == "attn":
                count("flash_attention", (select_flash_bwd_variant if backward else
                                          select_flash_variant)(dq, dv, bf16))
            if prefill and slot.mixer == "ssm":
                count("ssd_scan", (select_ssd_bwd_variant if backward else select_ssd_variant)(
                    cfg.ssm.head_dim, cfg.ssm.d_state, bf16))
            if slot.mixer == "ssm":
                for variant in (("bwd", "bwd_reduce") if backward else ("fwd",)):
                    count("causal_conv", variant)
            for f in mlps[slot.ffn]:
                count("swiglu_matmul", select_swiglu_bwd_variant(rows, cfg.d_model, f, bf16)
                      if backward else select_swiglu_variant(rows, cfg.d_model, f, bf16))
            if slot.ffn == "moe":
                m = groups * moe_capacity(cfg.moe, group_tokens)
                count("swiglu_matmul", select_swiglu_bwd_variant(
                    m, cfg.d_model, cfg.moe.d_ff_expert, bf16, experts=True) if backward else
                    select_experts_variant(m, cfg.d_model, cfg.moe.d_ff_expert, bf16))

    chunk = cfg.moe.router_chunk if cfg.moe is not None else 1
    for i, n in enumerate(prompt_lens):
        m = batch * n
        shape = (-(-m // min(256, m)) * min(256, m), batch * -(-n // chunk), min(chunk, n))
        step(*shape, True)
        if i < n_backward:
            step(*shape, True, backward=True)
    for _ in range(n_decode):
        step(slots, slots, 1, False)
    return expect


def rescale_attention(torch, cfg, model) -> None:
    """Scale q/k/v (MLA: w_uk/w_uv) to their real fan-in, in place."""
    # init_params draws at the reference's ParamDef.default_scale, which takes
    # shape[-2] as the fan-in: for wq/wk/wv [d, H, Dh] (and MLA's wq [d, H,
    # 192], w_uk/w_uv [512, H, 128]) that is the head count, not the input
    # width, and attention scores come out with a std of ~180 (MLA: ~60).
    # Softmax is then a hard argmax that any rounding difference flips, and a
    # deep random model is chaotic: the reference's own engine and
    # teacher-forced decoding disagree from 8 layers on (f32, CPU).  Scaling
    # them to their real fan-in (d_model; MLA's latent: kv_lora_rank) makes
    # the teacher-forced checks meaningful.
    with torch.no_grad():
        for block in model.layers:
            if not hasattr(block, "attn"):
                continue
            for name in ("wq", "wk", "wv"):
                if name in block.attn:
                    w = block.attn[name]
                    w.mul_((w.shape[1] / cfg.d_model) ** 0.5)
            for name in ("w_uk", "w_uv"):
                if name in block.attn:
                    w = block.attn[name]
                    w.mul_((w.shape[1] / w.shape[0]) ** 0.5)


def init_model(torch, cfg):
    """Random bf16 weights from a seeded generator, with attention rescaled
    so that its scores are of order one (``rescale_attention``); prints the
    size and the init time."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rescale_attention(torch, cfg, model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B params "
        f"(bf16), init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return model


def traffic(np, cfg):
    """The serving runs' prompts: 16, lengths uniform in 64-1024."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, size=N_REQUESTS)
    return [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in lens]


def reset_counts(torch) -> None:
    """Zero every kernel count and the peak memory, the device idle."""
    from repro_torch.kernels import LIBRARIES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for lib in LIBRARIES:
        lib.reset()


def read_counts() -> dict:
    from repro_torch.kernels import LIBRARIES

    return {lib.name: dict(lib.counts) for lib in LIBRARIES}


def check_launches(launches: dict, expect: dict) -> None:
    """A run's launches must be ``expected_launches``' and none may be a
    CUDA-core kernel's."""
    log(f"launches on the path: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    if any(n for lib in launches.values() for v, n in lib.items() if v.endswith("cuda_core")):
        raise AssertionError("a launch on the path went through a CUDA-core kernel")


def synced_ms(torch, fn):
    """(result, host ms) of ``fn`` between two synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def run_engine(torch, cfg, model, prompts, scfg, watched=(0, 1), count=False):
    """Serve ``prompts`` to the end; return the requests, the logits the
    engine decided on for the ``watched`` requests (prefill, then each
    decode step), and the host wall of each synchronised prefill and tick.
    With ``count``, every kernel count is set to 0 just before the run and
    read just after it, and the peak memory is the run's."""
    from repro_torch.serve import Engine

    engine = Engine(cfg, model, scfg, device="cuda")
    reqs = [engine.submit(p, max_new=MAX_NEW) for p in prompts]
    logits = {rid: [] for rid in watched}
    prefill_ms, decode_ms = [], []
    prefill, decode = engine._prefill1, engine._decode

    def timed_prefill(params, cache, inputs):
        rid = len(prefill_ms)  # requests are prefilled in submission order
        (last, cache), ms = synced_ms(torch, lambda: prefill(params, cache, inputs))
        prefill_ms.append(ms)
        if rid in logits:
            logits[rid].append(last[0].float())
        return last, cache

    def timed_decode(params, cache, tokens):
        live = {s: r.rid for s, r in enumerate(engine.slot_req) if r is not None}
        (out, cache), ms = synced_ms(torch, lambda: decode(params, cache, tokens))
        decode_ms.append(ms)
        for s, rid in live.items():
            if rid in logits:
                logits[rid].append(out[s].float())
        return out, cache

    engine._prefill1, engine._decode = timed_prefill, timed_decode
    if count:
        reset_counts(torch)
    t0 = time.perf_counter()
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts() if count else None
    # the timing closures read the engine and are stored on it: put the
    # engine's own steps back, so that the engine and its weights are freed
    # with the last reference to them, not at the next cyclic collection
    engine._prefill1, engine._decode = prefill, decode
    for r in reqs:
        if not (r.done and len(r.out) == MAX_NEW and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"request {r.rid}: done={r.done}, {len(r.out)} tokens")
    if len(prefill_ms) != len(reqs):
        raise AssertionError(f"{len(prefill_ms)} prefills for {len(reqs)} requests")
    return dict(engine=engine, reqs=reqs, logits=logits, prefill_ms=prefill_ms,
                decode_ms=decode_ms, wall=wall, launches=launches)


def report_run(torch, np, cfg, prompts, run) -> dict:
    """Print the counted run's throughput, step times and memory; check its
    launches against ``expected_launches`` (no CUDA-core kernel); profile
    one prefill of the longest prompt and one decode tick."""
    reqs, wall = run["reqs"], run["wall"]
    lens = [len(p) for p in prompts]
    n_tok = sum(len(r.out) for r in reqs)
    log(f"served {len(reqs)} requests (prompts {min(lens)}-{max(lens)} tokens, "
        f"{MAX_NEW} new each) in {wall:.3f} s: {n_tok / wall:.1f} tokens/s, "
        f"{len(run['prefill_ms'])} prefills mean {np.mean(run['prefill_ms']):.2f} ms, "
        f"{len(run['decode_ms'])} decode ticks mean {np.mean(run['decode_ms']):.2f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = run["launches"]
    check_launches(launches, expected_launches(torch, cfg, lens, len(run["decode_ms"]), SLOTS))
    profile_steps(torch, engine_steps(torch, run["engine"], prompts[int(np.argmax(lens))]))
    return launches


def serve(torch, np, arch: str, logit_tol: float, handoff_tol: float):
    """Serve the traffic with ``arch``; hold two requests' logits to a
    teacher-forced forward: every step within ``logit_tol``, the first
    decode step (after prefill's cache) within ``handoff_tol``."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    from repro_torch.serve import ServeConfig

    cfg = get_config(arch)
    model = init_model(torch, cfg)
    prompts = traffic(np, cfg)
    run = run_engine(torch, cfg, model, prompts, ServeConfig(max_seq=MAX_SEQ, slots=SLOTS),
                     count=True)
    launches = report_run(torch, np, cfg, prompts, run)
    worst, _, _ = teacher_forced(torch, cfg, model, run, forward, logit_tol, handoff_tol)
    log(f"teacher-forced: max logit error {worst:.4f} (tol {logit_tol}; first decode step tol "
        f"{handoff_tol})")
    return launches


def teacher_forced(torch, cfg, model, run, forward, logit_tol, handoff_tol, fail=True,
                   median_tol=None):
    """Hold the watched requests' engine logits to a train-mode forward over
    prompt + generated tokens: every step within ``logit_tol``, the first
    decode step within ``handoff_tol`` and, with ``median_tol``, the median
    over the decode steps within it; return the largest error over every
    step, over the first decode steps and over the requests' medians (with
    ``fail=False``, only return them)."""
    failures, worst, handoff, median, agree, decided, steps = [], 0.0, 0.0, 0.0, 0, 0, 0
    for rid, rows in run["logits"].items():
        r = run["reqs"][rid]
        toks = torch.tensor(r.prompt + r.out[:-1], device="cuda")[None]
        tf = forward(model, cfg, {"tokens": toks})[0, len(r.prompt) - 1:].float()
        eng = torch.stack(rows)
        if eng.shape != tf.shape:
            raise AssertionError(f"request {rid}: engine logits {tuple(eng.shape)} vs {tuple(tf.shape)}")
        step_err = (eng - tf).abs().amax(dim=-1)
        worst = max(worst, float(step_err.max()))
        handoff = max(handoff, float(step_err[1]))
        med = float(step_err[1:].median())
        median = max(median, med)
        if not fail:
            continue
        top2 = tf.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        tf_tok = tf.argmax(-1).tolist()
        log(f"request {rid} (prompt {len(r.prompt)}): per-step max |engine - teacher-forced "
            f"logit| {[round(e, 3) for e in step_err.tolist()]}, max |logit| "
            f"{float(tf.abs().max()):.2f}")
        for i, t in enumerate(r.out):
            steps += 1
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
        if median_tol is not None and med > median_tol:
            failures.append(f"request {rid}: the decode steps' median error {med:.4f} > "
                            f"{median_tol}")
    if fail:
        log(f"teacher-forced: {agree}/{steps} tokens equal, {decided} decided (top-2 margin above "
            f"twice the step's logit error)")
    if failures:
        raise AssertionError("; ".join(failures))
    return worst, handoff, median


# DeepSeek-V2-Lite: (a) each prefill's last logits against a train-mode
# forward of its prompt (the same chunks, so the same capacity drops); (b)
# the two watched requests served again with moe.router_chunk = 1 (every
# token its own group of capacity 1: nothing dropped in prefill, decode or
# the forward) against a teacher-forced forward of that config.  bf16 end to
# end, logits of ~4.5.  Sized on the H100 (PERF.md, §6) by planted
# faults that each check must catch: (a) the same kernels on the same
# shapes, errors 0.0 in every request; a forward without the shared
# experts reads >= 1.17.  (b) engine against forward <= 0.076 (decode's
# absorbed MLA against flash, GEMMs of other shapes; ~1.5% of the (token,
# layer) top-6 sets flip near ties, each moving a logit a little); a
# forward whose top-6 weights are not renormalised reads 0.44.  Both held
# to 0.25, TinyLlama's tolerance.
MOE_PREFILL_TOL = 0.25
MOE_LOGIT_TOL, MOE_HANDOFF_TOL = 0.25, 0.25
# (c) one full-width MoE layer, routed with the config's own chunks and
# capacity, against ``plain_moe``: relative to the largest output
# magnitude, bf16 as tests/test_torch_serve.py sets it.  On the H100
# (PERF.md, §6): 0.0045 under both dispatches, 7,077 of 13,200 choices
# dropped; the plain layer with no capacity reads 0.54.
MOE_DROP_TOL = 5e-2


def plain_moe(torch, np, cfg, p, x, capacity=True):
    """A MoE layer's output for x [B, S, D] in f32, written apart from
    ``layers``: the sequence is cut into chunks of ``router_chunk`` tokens;
    in each, the tokens' top-k experts (softmax of the f32 router logits,
    the same product on the same padded tensor as the port's, so the sets
    agree exactly) take their experts' C = ceil(top_k·chunk/E·capacity
    factor) slots in token-major order, given out by a host loop; a choice
    past its expert's C slots is dropped (none with ``capacity=False``);
    each kept (token, expert) pair goes through that expert's SwiGLU in
    f32, weighted by the renormalised gate; the shared experts are added in
    f32.  Returns (output, dropped choices)."""
    import torch.nn.functional as F

    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    chunk = min(m.router_chunk, S)
    n_ch = -(-S // chunk)
    C = max(1, math.ceil(K * chunk / E * m.capacity_factor))
    xp = F.pad(x, (0, 0, 0, n_ch * chunk - S)).reshape(B * n_ch, chunk, D)
    gates = torch.softmax(torch.einsum("gsd,de->gse", xp.float(), p["router"].float()), dim=-1)
    gate_k, idx_k = torch.topk(gates, K, dim=-1)
    gate_k = (gate_k / gate_k.sum(-1, keepdim=True)).cpu().numpy()
    idx_k = idx_k.cpu().numpy()
    weight = np.zeros((B * n_ch, chunk, E), np.float32)  # kept choices' gates
    keep = np.zeros((B * n_ch, chunk, E), bool)
    dropped = 0
    for g in range(B * n_ch):
        taken = np.zeros(E, np.int64)
        real = min(chunk, S - (g % n_ch) * chunk)  # padding sits last and is not a token
        for s in range(real):
            for k in range(K):
                e = idx_k[g, s, k]
                if capacity and taken[e] >= C:
                    dropped += 1
                else:
                    keep[g, s, e], weight[g, s, e] = True, gate_k[g, s, k]
                taken[e] += 1
    keep, weight = torch.from_numpy(keep).to(x.device), torch.from_numpy(weight).to(x.device)
    xf = xp.float()
    y = torch.zeros_like(xf)
    for e in range(E):
        sel = keep[..., e]
        if bool(sel.any()):
            xe = xf[sel]
            h = F.silu(xe @ p["wg"][e].float()) * (xe @ p["wu"][e].float())
            y[sel] += weight[..., e][sel][:, None] * (h @ p["wd"][e].float())
    y = y.reshape(B, n_ch * chunk, D)[:, :S]
    xf, sh = x.float(), p["shared"]
    y = y + (F.silu(xf @ sh["wg"].float()) * (xf @ sh["wu"].float())) @ sh["wd"].float()
    return y, dropped


def moe_drop_check(torch, np, cfg, model) -> None:
    """(c) The first MoE layer at full width, both dispatches, against
    ``plain_moe``: two sequences of router_chunk + 76 tokens (a full chunk
    and a padded one each), bf16 inputs with x[..., 0] = 4 and the router's
    row 0 set to 0.5 for experts 0-7 (their logits +2), so that those eight
    take most of the top-k choices and overflow their slots.  The planted fault is the plain
    layer with no capacity (nothing dropped): it must read above the
    tolerance."""
    from repro_torch.models import layers

    p = next(b.moe for b in model.layers if hasattr(b, "moe"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, cfg.moe.router_chunk + 76, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x[..., 0] = 4.0
    saved = p["router"].detach().clone()
    try:
        with torch.no_grad():
            p["router"][0, :8] = 0.5
            ref, dropped = plain_moe(torch, np, cfg, p, x)
            nodrop, _ = plain_moe(torch, np, cfg, p, x, capacity=False)
            scale = float(ref.abs().max())
            errs = {impl: float((layers.moe_layer(p, cfg, x, impl=impl).float() - ref).abs().max())
                    / scale for impl in ("einsum", "scatter")}
            fault = float((nodrop - ref).abs().max()) / scale
    finally:
        with torch.no_grad():
            p["router"].copy_(saved)
    n_choices = x.shape[0] * x.shape[1] * cfg.moe.top_k
    log(f"(c) MoE layer with drops vs plain: {dropped} of {n_choices} top-{cfg.moe.top_k} "
        f"choices dropped; max error / max |out| {errs} (tol {MOE_DROP_TOL}); planted fault "
        f"(no capacity): {fault:.4f}")
    if dropped == 0 or max(errs.values()) > MOE_DROP_TOL or fault <= MOE_DROP_TOL:
        raise AssertionError(f"(c) MoE drop check: dropped {dropped}, errors {errs}, fault "
                             f"{fault:.4f}, tol {MOE_DROP_TOL}")


class RouteLog:
    """Records the top-k expert sets ``layers.moe_route`` returns, each call
    tagged with the step that made it, while installed (``with``)."""

    def __init__(self, layers):
        self.layers, self.calls, self.tag = layers, [], None

    def __enter__(self):
        route = self.orig = self.layers.moe_route

        def recorded(p, m, xc):
            gate_k, idx_k = route(p, m, xc)
            self.calls.append((self.tag, idx_k.sort(dim=-1).values))
            return gate_k, idx_k
        self.layers.moe_route = recorded
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.orig


@contextmanager
def patched(obj, name: str, value):
    """``obj.name`` replaced by ``value`` while inside (a planted fault)."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextmanager
def zeroed(torch, tensors):
    """The given weights zeroed while inside, then restored (a planted fault)."""
    saved = [t.clone() for t in tensors]
    with torch.no_grad():
        for t in tensors:
            t.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)


def unnormalised_route(torch):
    """A ``layers.moe_route`` whose top-k weights are not renormalised (a
    planted fault)."""
    def route(p, m, xc):
        gates = torch.softmax(torch.einsum("gsd,de->gse", xc.float(), p["router"].float()), -1)
        return torch.topk(gates, m.top_k, dim=-1)
    return route


def serve_checked(torch, np, cfg, prefill_fault, b_faults, b_tol, after_a=None):
    """Serve the traffic with ``cfg`` (weights from ``init_model``), counted
    and timed with the config's own router chunks; then (a) every prefill's
    last logits against a train-mode forward of its prompt, with the planted
    fault ``prefill_fault`` = (what, weights to zero) reading above the
    tolerance; ``after_a(model)`` (DeepSeek's check (c)); and (b) the two
    watched requests served again with ``moe.router_chunk = 1`` (no capacity
    drops anywhere; the same weights) against a teacher-forced forward,
    every step within ``b_tol[0]``, the first decode step within
    ``b_tol[1]`` and, unless it is None, the decode steps' median within
    ``b_tol[2]``, and router top-k sets that differ between engine and
    forward counted.  Each of ``b_faults`` = (what, context, where) must
    fail (b): ``where`` "forward" plants it in the teacher-forced forward,
    "engine" in the engine's run.  Every number is printed before any check
    fails.  Returns the counted run's launches."""
    import dataclasses

    from repro_torch.models import forward, layers
    from repro_torch.serve import ServeConfig

    model = init_model(torch, cfg)
    log(f"the config's param_count (no norm scales): {cfg.param_count()[0] / 1e9:.3f} B total, "
        f"{cfg.param_count()[1] / 1e9:.3f} B active a token")
    prompts = traffic(np, cfg)
    scfg = ServeConfig(max_seq=MAX_SEQ, slots=SLOTS)
    run = run_engine(torch, cfg, model, prompts, scfg, watched=range(N_REQUESTS), count=True)
    launches = report_run(torch, np, cfg, prompts, run)

    def prefill_err():
        errs = []
        for rid, p in enumerate(prompts):
            tf = forward(model, cfg, {"tokens": torch.tensor(p, device="cuda")[None]})[0, -1]
            errs.append(float((run["logits"][rid][0] - tf.float()).abs().max()))
        return errs

    errs = prefill_err()
    what, leaves = prefill_fault
    with zeroed(torch, leaves(model)):
        fault = prefill_err()
    log(f"(a) prefill vs train forward, last logits, max error per request "
        f"{[round(e, 4) for e in errs]} (tol {MOE_PREFILL_TOL}); planted fault ({what}): "
        f"min {min(fault):.3f}")
    if max(errs) > MOE_PREFILL_TOL or min(fault) <= MOE_PREFILL_TOL:
        raise AssertionError(f"(a) prefill check: errors {max(errs):.4f}, fault {min(fault):.4f}, "
                             f"tol {MOE_PREFILL_TOL}")
    run.clear()  # the timed run's engine, its cache and logits
    if after_a is not None:
        after_a(model)

    cfg1 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_chunk=1))
    logit_tol, handoff_tol, median_tol = b_tol
    with RouteLog(layers) as routes:
        routes.tag = "engine"
        run1 = run_engine(torch, cfg1, model, prompts[:2], scfg)
        routes.tag = None
        worst, handoff, median = teacher_forced(torch, cfg1, model, run1, forward, logit_tol,
                                                handoff_tol, fail=False)
        # the routes of the same tokens: the engine's prefills and ticks,
        # then a teacher-forced forward per request
        flips = routed_differences(torch, cfg1, model, run1, routes, forward)
    faults = {}
    for what, context, where in b_faults:
        with context():
            run_f = run_engine(torch, cfg1, model, prompts[:2], scfg) if where == "engine" else None
            if where == "forward":
                faults[what] = teacher_forced(torch, cfg1, model, run1, forward, 0, 0, fail=False)
        if where == "engine":
            faults[what] = teacher_forced(torch, cfg1, model, run_f, forward, 0, 0, fail=False)
            run_f.clear()
    tols = (logit_tol, handoff_tol, math.inf if median_tol is None else median_tol)
    log(f"(b) router_chunk = 1: engine vs teacher-forced max logit error {worst:.4f}, first "
        f"decode step {handoff:.4f}, median decode step {median:.4f} (tol {logit_tol}, first "
        f"decode step {handoff_tol}, median {median_tol}); router top-{cfg.moe.top_k} sets that "
        f"differ between engine and forward: {flips[0]} of {flips[1]} (token, layer) pairs")
    for what, errs in faults.items():
        log(f"(b) planted fault ({what}): max logit error {errs[0]:.4f}, first decode step "
            f"{errs[1]:.4f}, median decode step {errs[2]:.4f}")
    teacher_forced(torch, cfg1, model, run1, forward, logit_tol, handoff_tol,
                   median_tol=median_tol)
    missed = [w for w, errs in faults.items() if all(e <= t for e, t in zip(errs, tols))]
    if missed:
        raise AssertionError(f"(b) planted faults within the tolerances {b_tol}: {missed}")
    return launches


def serve_deepseek(torch, np):
    """Full-width DeepSeek-V2-Lite: checks (a), (b) and (c) above; the
    planted faults drop the shared experts (a) and leave the top-6 weights
    unnormalised (b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("deepseek-v2-lite-16b")
    return serve_checked(
        torch, np, cfg,
        ("no shared experts",
         lambda m: [b.moe.shared["wd"] for b in m.layers if hasattr(b, "moe")]),
        [("combine weights not renormalised",
          lambda: patched(layers, "moe_route", unnormalised_route(torch)), "forward")],
        (MOE_LOGIT_TOL, MOE_HANDOFF_TOL, None),
        after_a=lambda model: moe_drop_check(torch, np, cfg, model))


# --------------------------------------------------------------------------- #
# the hybrid, encoder and VLM serving paths, and Arctic at reduced depth
# --------------------------------------------------------------------------- #
# Jamba-v0.1 at 16 of its 32 layers (2 of its 4 super-block repeats: 26.0 B
# parameters, 48.4 GiB in bf16; 3 repeats would be 73.1 GiB and leave no room
# for init_params' 3.5 GiB f32 draw and the serving temporaries).  (b) holds
# the engine against a teacher-forced forward, bf16 end to end: decode runs
# the SSD recurrence on the cached state and plain attention over the bf16
# cache where the forward runs the scan and flash kernels.  With 16 experts
# top-2, a near tie that bf16 rounding resolves one way in the engine and
# the other in the forward swaps half of a layer's MoE output: 27 of 12,952
# (token, layer) routes differ, and single steps jump (to 1.71 of logits of
# ~5; H100, PERF.md §6) while the median decode step reads 0.160.  So
# three bounds: the first decode step (which reads only what prefill
# cached: 0.09) within 0.5, the median decode step within 0.3, every step
# within 4.0.  Planted faults (max / first / median): an SSM state that does
# not reach its slot 2.37 / 2.37 / 0.56, a conv window that does not roll
# 8.0 / 0.09 / 5.84, prefill k/v that do not reach the slot 3.48 / 2.26 /
# 2.66, decode k/v not written 2.26 / 0.09 / 0.39, top-2 weights not
# renormalised 2.59 / 2.34 / 2.37: each reads above one bound.
JAMBA_LAYERS = 16
JAMBA_LOGIT_TOL, JAMBA_HANDOFF_TOL, JAMBA_MEDIAN_TOL = 4.0, 0.5, 0.3
# Arctic at 2 of its 35 layers: 27.2 B parameters, 51.5 GiB in bf16 (~888
# GiB in full).  Its checks are DeepSeek's (a) and (b), with the dense
# residual zeroed as (a)'s planted fault.  As in Jamba, top-2 routes that
# flip between engine and forward move single steps (1 of 3,238 (token,
# layer) routes: 0.50; H100, PERF.md §6), so (b) bounds the first
# decode step (0.031) and the median decode step (0.031) by DeepSeek's 0.25
# and every step by 4.0; the planted fault (top-2 weights not
# renormalised) reads 1.20 / 1.04 / 0.96.
ARCTIC_LAYERS = 2
ARCTIC_LOGIT_TOL = 4.0
# HuBERT-XLarge at full depth: 8 clips of 1500 frames (30 s of audio at 50
# frames/s), frame embeddings from synth_inputs.  (a) prefill's last logits
# against train's (the same kernels on the same shapes); the planted fault
# is the causal route the port took before (``gqa_flash_attention``, causal
# whatever it is given) in the prefill.  (b) bidirectionality: a new last
# frame must move the first frame's logits by more than HUBERT_REACH; the
# causal route leaves them bit for bit unchanged.  (c) one full-width layer
# against ``plain_encoder_layer``, relative to the largest output, attention
# sublayer and whole layer apart, bf16 as tests/test_torch_serve.py sets it;
# a causal plain layer must read above it.
HUBERT_CLIPS, HUBERT_FRAMES = 8, 1500
HUBERT_PREFILL_TOL, HUBERT_REACH, ENCODER_LAYER_TOL = 0.25, 1e-2, 5e-2
# LLaVA-NeXT (Mistral-7B) at full depth: 8 requests, each one image (576
# embedding rows) and 576 text tokens, prefilled as one batch, then 32
# decode ticks; logits against a teacher-forced forward over image, text and
# the generated tokens at TinyLlama's tolerance (bf16, 32 layers).  Planted
# faults: the image rows left out of the forward, and decode positions
# restarting at the text.
LLAVA_BATCH, LLAVA_SEQ, LLAVA_TICKS = 8, 1152, 32


def splice_without(engine_mod, left_out):
    """An engine ``_splice_cache`` that leaves the leaves ``left_out`` out of
    the slot (a planted fault: a prefill's SSM state, or its attention k/v,
    that does not reach its slot)."""
    splice = engine_mod._splice_cache

    def spliced(cache, single, slot):
        splice({"segments": {seg: {pj: {n: t for n, t in leaves.items() if n not in left_out}
                                   for pj, leaves in ps.items()}
                             for seg, ps in cache["segments"].items()}}, single, slot)
        return cache
    return spliced


def stale_conv(ssm_mod):
    """An SSM ``_causal_conv`` that leaves the window it read as it was (a
    planted fault: a decode whose conv window does not roll)."""
    conv = ssm_mod._causal_conv

    def stale(p, xBC, carry=None, carry_out=None):
        return conv(p, xBC, carry, carry_out if carry is None else None)
    return stale


def serve_jamba(torch, np):
    """Jamba's ``super`` segment at 16 layers and full width: the standard
    traffic, checks (a) and (b); (a)'s planted fault silences every mamba2
    mixer (their output projections zeroed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers, ssm
    from repro_torch.serve import engine as engine_mod

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    return serve_checked(
        torch, np, cfg,
        ("mamba2 mixers silenced",
         lambda m: [b.ssm["wo"] for b in m.layers if hasattr(b, "ssm")]),
        [("SSM state not spliced into its slot",
          lambda: patched(engine_mod, "_splice_cache", splice_without(engine_mod, {"ssd"})),
          "engine"),
         ("conv window not rolled", lambda: patched(ssm, "_causal_conv", stale_conv(ssm)),
          "engine"),
         ("attention k/v not spliced into its slot",
          lambda: patched(engine_mod, "_splice_cache", splice_without(engine_mod, {"k", "v"})),
          "engine"),
         ("decode k/v not written to the cache",
          lambda: patched(layers, "cache_write", lambda arr, val, pos: arr), "engine"),
         ("combine weights not renormalised",
          lambda: patched(layers, "moe_route", unnormalised_route(torch)), "forward")],
        (JAMBA_LOGIT_TOL, JAMBA_HANDOFF_TOL, JAMBA_MEDIAN_TOL))


def serve_arctic(torch, np):
    """Arctic at 2 layers and full width (128 experts top-2 beside a dense
    residual): the standard traffic, checks (a) and (b) as DeepSeek's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=ARCTIC_LAYERS)
    return serve_checked(
        torch, np, cfg,
        ("no dense residual", lambda m: [b.moe.residual["wd"] for b in m.layers]),
        [("combine weights not renormalised",
          lambda: patched(layers, "moe_route", unnormalised_route(torch)), "forward")],
        (ARCTIC_LOGIT_TOL, MOE_HANDOFF_TOL, MOE_HANDOFF_TOL))


def plain_encoder_layer(torch, cfg, blk, x, causal: bool):
    """An encoder layer's attention sublayer output and whole output for x
    [B, S, d] in f32, written apart from ``layers``: f32 rmsnorms, q/k/v
    and output projections as einsums, k/v heads repeated to the query
    heads, ``flash_attention_ref`` per head (non-causal unless ``causal``),
    and silu(h @ wg) * (h @ wu) @ wd."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import flash_attention_ref

    assert cfg.rope_theta is None and not cfg.qkv_bias and not cfg.qk_norm

    def norm(t, scale):
        t = t.float()
        return t * torch.rsqrt((t * t).mean(-1, keepdim=True) + cfg.norm_eps) * scale.float()

    a, m = blk.attn, blk.mlp
    B, S, _ = x.shape
    H, G = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    h = norm(x, blk.ln1["scale"])
    q, k, v = (torch.einsum("bsd,dhk->bhsk", h, a[n].float()) for n in ("wq", "wk", "wv"))
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    o = flash_attention_ref(*(t.reshape(B * H, S, -1) for t in (q, k, v)), causal=causal)
    attn = torch.einsum("bhsk,hkd->bsd", o.reshape(B, H, S, -1), a["wo"].float())
    x1 = x.float() + attn
    h2 = norm(x1, blk.ln2["scale"])
    return attn, x1 + (F.silu(h2 @ m["wg"].float()) * (h2 @ m["wu"].float())) @ m["wd"].float()


def encoder_layer_check(torch, cfg, model) -> None:
    """(c) HuBERT's first layer at full width on 2 clips of 1500 frames,
    bf16, against ``plain_encoder_layer``: the attention sublayer and the
    whole layer, each relative to its largest magnitude; the causal plain
    layer is the planted fault."""
    from repro_torch.models import layers

    blk = model.layers[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, HUBERT_FRAMES, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    attn = layers.attention_full(blk.attn, cfg, layers.rmsnorm(blk.ln1, x, cfg.norm_eps))
    out = blk(cfg, x, None, None, "train")
    errs, faults = {}, {}
    for causal, into in ((False, errs), (True, faults)):
        ref_attn, ref_out = plain_encoder_layer(torch, cfg, blk, x, causal)
        into["attention"] = float((attn.float() - ref_attn).abs().max() / ref_attn.abs().max())
        into["layer"] = float((out.float() - ref_out).abs().max() / ref_out.abs().max())
    log(f"(c) encoder layer vs plain, max error / max |out|: {errs} (tol {ENCODER_LAYER_TOL}); "
        f"planted fault (causal plain layer): {faults}")
    if max(errs.values()) > ENCODER_LAYER_TOL or min(faults.values()) <= ENCODER_LAYER_TOL:
        raise AssertionError(f"(c) encoder layer check: errors {errs}, faults {faults}")


def encode_hubert(torch, np):
    """HuBERT-XLarge at full width and depth over 8 clips of 1500 frames: a
    train forward and a prefill into ``init_cache(cfg, 8, 1500)``, counted
    and timed; checks (a), (b) and (c) above, each against its planted
    fault; the forward profiled."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gqa_flash_attention
    from repro_torch.models import forward, init_cache, layers, synth_inputs
    from repro_torch.serve import ServeConfig, make_prefill_step

    cfg = get_config("hubert-xlarge")
    model = init_model(torch, cfg)
    inputs = synth_inputs(cfg, HUBERT_CLIPS, HUBERT_FRAMES,
                          torch.Generator(device="cuda").manual_seed(1), device="cuda")
    assert set(inputs) == {"embeds"}
    prefill = make_prefill_step(cfg, ServeConfig(max_seq=HUBERT_FRAMES, slots=HUBERT_CLIPS))

    def prefill_fresh(inp):
        return prefill(model, init_cache(cfg, HUBERT_CLIPS, HUBERT_FRAMES, device="cuda"), inp)

    forward(model, cfg, inputs)  # warm: cuBLAS and the allocator
    reset_counts(torch)
    logits, fwd_ms = synced_ms(torch, lambda: forward(model, cfg, inputs))
    (last, cache), pre_ms = synced_ms(torch, lambda: prefill_fresh(inputs))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    frames = HUBERT_CLIPS * HUBERT_FRAMES
    log(f"encoded {HUBERT_CLIPS} clips of {HUBERT_FRAMES} frames: train forward {fwd_ms:.2f} ms "
        f"({frames / fwd_ms * 1e3:.0f} frames/s), prefill {pre_ms:.2f} ms "
        f"({frames / pre_ms * 1e3:.0f} frames/s), peak memory {peak:.2f} GiB")
    check_launches(launches,
                   expected_launches(torch, cfg, [HUBERT_FRAMES] * 2, 0, HUBERT_CLIPS,
                                     batch=HUBERT_CLIPS))
    if not (logits.shape == (HUBERT_CLIPS, HUBERT_FRAMES, cfg.vocab)
            and bool(torch.isfinite(logits).all()) and int(cache["pos"]) == HUBERT_FRAMES):
        raise AssertionError(f"encoder output {tuple(logits.shape)}, pos {int(cache['pos'])}")
    del cache

    def causal_route(q, k, v):  # the route the port took before: causal whatever it is given
        return gqa_flash_attention(q, k, v, causal=cfg.causal)

    # (a) prefill's last logits against train's
    err = float((last.float() - logits[:, -1].float()).abs().max())
    with patched(layers, "gqa_bidirectional_attention", causal_route):
        fault_last, _ = prefill_fresh(inputs)
    fault = float((fault_last.float() - logits[:, -1].float()).abs().max())
    log(f"(a) prefill vs train forward, last logits: max error {err:.4f} (tol "
        f"{HUBERT_PREFILL_TOL}); planted fault (causal attention): {fault:.4f}; max |logit| "
        f"{float(logits.float().abs().max()):.2f}")
    # (b) a new last frame must reach the first frame
    bumped = dict(inputs, embeds=inputs["embeds"].clone())
    gen = torch.Generator(device="cuda").manual_seed(3)
    bumped["embeds"][:, -1] = (torch.randn(bumped["embeds"][:, -1].shape, generator=gen,
                                           device="cuda") * 0.02).to(torch.bfloat16)
    moved = float((forward(model, cfg, bumped)[:, 0].float() - logits[:, 0].float()).abs().max())
    with patched(layers, "gqa_bidirectional_attention", causal_route):
        base = forward(model, cfg, inputs)[:, 0].float()
        stuck = float((forward(model, cfg, bumped)[:, 0].float() - base).abs().max())
    log(f"(b) a new last frame moves the first frame's logits by {moved:.4f} (must exceed "
        f"{HUBERT_REACH}); planted fault (causal attention): {stuck:.4f}")
    del logits, last, fault_last, base
    encoder_layer_check(torch, cfg, model)
    if err > HUBERT_PREFILL_TOL or fault <= HUBERT_PREFILL_TOL:
        raise AssertionError(f"(a) encoder prefill check: error {err:.4f}, fault {fault:.4f}")
    if moved <= HUBERT_REACH or stuck > HUBERT_REACH:
        raise AssertionError(f"(b) bidirectionality: moved {moved:.4f}, fault {stuck:.4f}")
    profile_steps(torch, {f"forward ({HUBERT_CLIPS} x {HUBERT_FRAMES} frames)":
                          lambda: forward(model, cfg, inputs)})
    return launches


def serve_llava(torch, np):
    """LLaVA-NeXT-Mistral-7B at full width and depth: 8 requests of one
    image (576 embedding rows) and 576 text tokens, prefilled as one batch
    through ``make_prefill_step``, then 32 ``make_decode_step`` ticks
    (greedy), counted and timed; every request's logits against a
    teacher-forced forward over image, text and generated tokens, with
    planted faults; one prefill and one tick profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, frontend_token_split, init_cache, synth_inputs
    from repro_torch.serve import ServeConfig, make_decode_step, make_prefill_step

    cfg = get_config("llava-next-mistral-7b")
    model = init_model(torch, cfg)
    n_img, n_txt = frontend_token_split(cfg, LLAVA_SEQ)
    inputs = synth_inputs(cfg, LLAVA_BATCH, LLAVA_SEQ,
                          torch.Generator(device="cuda").manual_seed(1), device="cuda")
    assert inputs["embeds"].shape[1] == n_img and inputs["tokens"].shape[1] == n_txt
    scfg = ServeConfig(max_seq=MAX_SEQ, slots=LLAVA_BATCH)
    prefill, decode = make_prefill_step(cfg, scfg), make_decode_step(cfg, scfg)

    def generate(text_pos=False):
        """(tokens [B, 1 + ticks], logits [1 + ticks, B, V] f32, prefill ms,
        tick ms); ``text_pos`` restarts the decode positions at the text (a
        planted fault)."""
        cache = init_cache(cfg, LLAVA_BATCH, scfg.max_seq, device="cuda")
        (last, cache), pre_ms = synced_ms(torch, lambda: prefill(model, cache, inputs))
        if text_pos:
            cache["pos"] = torch.tensor(n_txt, device="cuda")
        toks, rows, tick_ms = [last.argmax(-1)], [last.float()], []
        for _ in range(LLAVA_TICKS):
            (lg, cache), ms = synced_ms(torch, lambda: decode(model, cache, toks[-1][:, None]))
            toks.append(lg.argmax(-1))
            rows.append(lg.float())
            tick_ms.append(ms)
        return torch.stack(toks, 1), torch.stack(rows), pre_ms, tick_ms, cache

    generate()  # warm
    reset_counts(torch)
    t0 = time.perf_counter()
    toks, rows, pre_ms, tick_ms, cache = generate()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"served {LLAVA_BATCH} requests (one image of {n_img} rows and {n_txt} text tokens each, "
        f"{LLAVA_TICKS + 1} new tokens) in {wall:.3f} s: {toks.numel() / wall:.1f} tokens/s, "
        f"prefill {pre_ms:.2f} ms, {LLAVA_TICKS} decode ticks mean {np.mean(tick_ms):.2f} ms, "
        f"peak memory {peak:.2f} GiB")
    check_launches(launches,
                   expected_launches(torch, cfg, [LLAVA_SEQ], LLAVA_TICKS, LLAVA_BATCH,
                                     batch=LLAVA_BATCH))
    if int(cache["pos"]) != LLAVA_SEQ + LLAVA_TICKS or not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"cache pos {int(cache['pos'])}, finite {torch.isfinite(rows).all()}")
    last_cache = cache
    del cache

    def errors(rows, with_image=True):
        """Per step, the largest |engine - teacher-forced| logit over the batch."""
        text = torch.cat([inputs["tokens"].long(), toks[:, :-1]], dim=1)
        inp = {"embeds": inputs["embeds"], "tokens": text} if with_image else {"tokens": text}
        tf = forward(model, cfg, inp)[:, -(LLAVA_TICKS + 1):].float().movedim(1, 0)
        return (rows - tf).abs().amax(dim=(1, 2)), float(tf.abs().max())

    step_err, scale = errors(rows)
    no_image, _ = errors(rows, with_image=False)
    _, restarted, *_ = generate(text_pos=True)
    restart, _ = errors(restarted)
    log(f"teacher-forced over image + text + generated: per-step max logit error "
        f"{[round(e, 3) for e in step_err.tolist()]} (tol {LOGIT_TOL}), max |logit| {scale:.2f}; "
        f"planted faults: image rows left out {float(no_image.max()):.3f}, positions restarting "
        f"at the text {float(restart.max()):.3f}")
    if (float(step_err.max()) > LOGIT_TOL or float(no_image.max()) <= LOGIT_TOL
            or float(restart.max()) <= LOGIT_TOL):
        raise AssertionError(f"VLM check: error {float(step_err.max()):.4f}, faults "
                             f"{float(no_image.max()):.4f} / {float(restart.max()):.4f}")
    del rows, restarted
    profile_steps(torch, {
        f"prefill ({LLAVA_BATCH} x {LLAVA_SEQ} positions)":
            lambda: prefill(model, init_cache(cfg, LLAVA_BATCH, scfg.max_seq, device="cuda"),
                            inputs),
        f"decode tick ({LLAVA_BATCH} requests)":
            lambda: decode(model, last_cache, toks[:, -1:]),
    })
    return launches


def routed_differences(torch, cfg, model, run, routes, forward):
    """(differing, compared) (token, layer) top-k sets between the engine's
    steps and a teacher-forced forward over the same tokens.  The engine's
    calls come in order: each request's prefill (its prompt's tokens), then
    the ticks (one row a slot; every watched request holds its slot from
    admission to its last token)."""
    n_moe = sum(1 for b in model.layers if hasattr(b, "moe"))
    calls = [idx[:, 0] for tag, idx in routes.calls if tag == "engine"]
    reqs = run["reqs"]
    per_req = {}
    i = 0
    for r in reqs:  # prefills, in submission order
        per_req[r.rid] = [calls[i + l] for l in range(n_moe)]
        i += n_moe
    ticks = (len(calls) - i) // n_moe
    slot = {r.rid: s for s, r in enumerate(reqs)}  # admitted into slots 0, 1, ...
    differing = compared = 0
    for r in reqs:
        eng = [torch.cat([per_req[r.rid][l]] + [calls[i + t * n_moe + l][slot[r.rid]][None]
                                                for t in range(min(ticks, MAX_NEW - 1))])
               for l in range(n_moe)]
        routes.tag = ("forward", r.rid)
        toks = torch.tensor(r.prompt + r.out[:-1], device="cuda")[None]
        forward(model, cfg, {"tokens": toks})
        fwd = [idx[:, 0] for tag, idx in routes.calls if tag == ("forward", r.rid)]
        for e, f in zip(eng, fwd):
            n = min(len(e), len(f))
            differing += int((e[:n] != f[:n]).any(dim=-1).sum())
            compared += n
    return differing, compared


def engine_steps(torch, engine, prompt) -> dict:
    """One prefill of ``prompt`` and one decode tick of the full slot pool
    (after the counted run), as ``profile_steps`` takes them."""
    from repro_torch.models import init_cache

    toks = torch.tensor(prompt, device="cuda")[None]
    cfg, scfg = engine.cfg, engine.scfg
    return {
        f"prefill ({len(prompt)} tokens)": lambda: engine._prefill1(
            engine.params, init_cache(cfg, 1, scfg.max_seq, device="cuda"), {"tokens": toks}),
        f"decode tick ({scfg.slots} slots)": lambda: engine._decode(
            engine.params, engine.cache, engine.next_tok),
    }


def profile_steps(torch, steps: dict) -> dict:
    """Device time by kernel for each of ``steps`` (name -> call), each
    called three times: once to warm up, once timed on the host clock
    without the profiler (the wall), once under it (the device's busy
    time).  Returns {name: (wall ms, busy ms)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
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
            f"device idle {100 * max(0.0, 1 - busy / wall):.1f}%, "
            f"{sum(e.count for e in events)} device kernels")
        # the eight largest, then every other kernel of the port's sources
        ours = [e for e in events[8:] if any(k in e.key for k in PORT_KERNELS)]
        for e in events[:8] + ours:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
        out[name] = (wall, busy)
    return out


# --------------------------------------------------------------------------- #
# phase: training TinyLlama-1.1B at full width and depth
# --------------------------------------------------------------------------- #
TRAIN_ARCH = "tinyllama-1.1b"
SSM_TRAIN_ARCH = "mamba2-370m"  # the same steps, data shape and checks
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 20, 1024, 8
# (c) and (f) run at full width with 2 of the 22 layers: (c) holds one step
# against the CPU, (f) writes checkpoints (2.2 GB each at 2 layers; the
# 22-layer state is 10.4 GB, so the full-depth run writes none)
TRAIN_SMALL_LAYERS = 2
# (b): each kernel's backward at the path's shapes, through its autograd
# Function on the card, against autograd through its plain version, bf16,
# within this share of each gradient's largest magnitude
# (tests/test_torch_card.py's bound).  Both round the gradients to bf16; the
# kernels read the forward kernels' bf16 outputs (flash: O in rowsum(dO ⊙
# O)) and round P and dS (flash) to bf16 for their products, and the
# SwiGLU's four products around its kernel are bf16.
VJP_TOL = 3e-2
# (d): one batch as 1 or 2 microbatches, the loss's relative difference
# (the reference test's bound)
MICROBATCH_TOL = 1e-4
# (c): one step on the card (bf16) against the CPU (f32, the same weights):
# relative differences of the loss and the gradient norm; each leaf's first
# moment (0.1 of its clipped gradient) within this share of its largest
# magnitude, which every planted fault of (a) and (b) breaks; the updated
# weights within one bf16 ulp and 2·lr of the CPU's rounded to bf16
CARD_CPU_TOL = dict(loss=1e-2, grad_norm=5e-2, moment=0.1, weights=1.05)


def train_config(total_steps: int = TRAIN_STEPS):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    return TrainConfig(microbatches=2, remat=True,
                       optim=AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=total_steps))


def make_trainer(torch, cfg, ckpt=None, ckpt_every: int = 100, monitor=None):
    """``Trainer`` on the card over the path's data, its attention rescaled
    as ``init_model``'s (the trainer draws from ``init_params``, seed 0)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.train import Trainer

    ds = SyntheticLMDataset(cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    tr = Trainer(cfg, train_config(), ds, ckpt_manager=ckpt, ckpt_every=ckpt_every,
                 monitor=monitor, seed=0, device="cuda")
    rescale_attention(torch, cfg, tr.params)
    return tr


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def grads_err(got, want) -> float:
    return max(rel_err(g, w) for g, w in zip(got, want))


def hold(name: str, err: float, tol: float, faults: dict) -> None:
    """``err`` within ``tol`` and every planted fault's error beyond it."""
    log(f"{name}: {err:.4g} (tol {tol}); planted faults "
        + ", ".join(f"{k} {v:.4g}" for k, v in faults.items()))
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.4g} > {tol}")
    missed = [k for k, v in faults.items() if not v > tol]
    if missed:
        raise AssertionError(f"{name}: planted faults {missed} within {tol}")


def vjp_checks(torch, timer) -> dict:
    """(b) Each backward kernel at the train path's shape, through its
    kernel's ``autograd.Function`` on the card (one launch of flash's or the
    SwiGLU's ``wgmma_bwd`` and no PyTorch VJP), against autograd through the
    plain version, bf16; the planted faults, each through the kernel's own
    launch (the causal flag cleared; dQ's first key tile dropped, held on dQ
    alone; dg and du swapped; the SwiGLU epilogue reading dout from the
    other box of its buffer, from ``swiglu_box_fault_library``, caught by >=
    0.1); the backward's times: the PyTorch VJP it replaces, the SwiGLU's
    whole backward (the kernel and its four products), the forward +
    backward beside the plain version's and the library's, and the bound.  The flash and SwiGLU backward kernels'
    own times are the kernels phase's (``backward_paths``, rows "train")."""
    import importlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.launch.roofline_model import H100

    from repro_torch.kernels import (
        FLASH_LIBRARY, SWIGLU_LIBRARY, flash_attention, flash_attention_vjp, swiglu_matmul,
        swiglu_vjp,
    )
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(scale).to(torch.bfloat16)

    def grads(lib, variant, fn, inputs, cot):
        """The gradients of ``fn()`` through the kernel's Function, and the
        launch of ``variant`` its backward made (and no other)."""
        out = fn()
        if out.grad_fn is None:
            raise AssertionError(f"{lib.name}: a CUDA output with no gradient path")
        g, moved = launched(lib, lambda: torch.autograd.grad(out, inputs, cot))
        if moved != variant:
            raise AssertionError(f"{lib.name}: the backward launched {moved}, not {variant}")
        return g

    rows = {}
    # flash: 4 sequences x 32 heads, S 1024, D 64, causal (one microbatch)
    BH, S, D = 4 * 32, TRAIN_SEQ, 64
    sc = D ** -0.5
    q, k, v = (randn(BH, S, D).requires_grad_(True) for _ in range(3))
    do = randn(BH, S, D)
    fwd = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
    got = grads(FLASH_LIBRARY, "wgmma_bwd", fwd, (q, k, v), do)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal=True), (q, k, v), do)
    with flash_bwd_without_mask():
        fault = grads(FLASH_LIBRARY, "wgmma_bwd", fwd, (q, k, v), do)
    with flash_dq_key_tile_dropped(torch):
        dropped = grads(FLASH_LIBRARY, "wgmma_bwd", fwd, (q, k, v), do)
    hold(f"(b) flash wgmma_bwd BH={BH} S={S} D={D} causal, dq/dk/dv", grads_err(got, want),
         VJP_TOL, {"causal flag cleared": grads_err(fault, want),
                   "dQ's first key tile dropped (dq)": rel_err(dropped[0], want[0])})
    del got, want, fault, dropped
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    od = fa._launch(qd, kd, vd, True, sc)[0]
    b_ms, b_by = H100.bound_ms(*fa.work_bwd(BH, S, S, D, True, 2), torch.bfloat16)
    q4, k4, v4 = (t.view(1, *t.shape) for t in (q, k, v))

    def sdpa_fwd_bwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        return torch.autograd.grad(out, (q, k, v), do.view(1, *do.shape))

    rows["flash"] = dict(
        shape=f"BH={BH} S={S} D={D} bf16 causal",
        vjp_ms=timer.ms(lambda: flash_attention_vjp(qd, kd, vd, od, do, True, sc), reps=10),
        fwd_bwd_ms=timer.ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do), reps=10),
        plain_fwd_bwd_ms=timer.ms(lambda: torch.autograd.grad(
            flash_attention_ref(q, k, v, causal=True), (q, k, v), do), reps=5),
        library="sdpa[flash] forward + backward", library_ms=timer.ms(sdpa_fwd_bwd, reps=10),
        bound_ms=b_ms, bound_by=b_by)
    del q, k, v, do, qd, kd, vd, od, q4, k4, v4
    torch.cuda.empty_cache()
    # SwiGLU: one microbatch's 4096 rows at D 2048, F 5632
    M, D, Fd = 4 * TRAIN_SEQ, 2048, 5632
    x = randn(M, D).requires_grad_(True)
    wg, wu = (randn(D, Fd, scale=D ** -0.5).requires_grad_(True) for _ in range(2))
    dout = randn(M, Fd)
    fwd = lambda: swiglu_matmul(x, wg, wu)  # noqa: E731
    got = grads(SWIGLU_LIBRARY, "wgmma_bwd", fwd, (x, wg, wu), dout)
    want = torch.autograd.grad(swiglu_ref(x, wg, wu), (x, wg, wu), dout)
    with swapped_swiglu_bwd():
        fault = grads(SWIGLU_LIBRARY, "wgmma_bwd", fwd, (x, wg, wu), dout)
    with swiglu_bwd_other_box():
        other = grads(swiglu_box_fault_library(), "wgmma_bwd", fwd, (x, wg, wu), dout)
    hold(f"(b) SwiGLU wgmma_bwd M={M} D={D} F={Fd}, dx/dwg/dwu", grads_err(got, want), VJP_TOL,
         {"dg and du swapped": grads_err(fault, want),
          "the epilogue reads dout from the other box": grads_err(other, want)})
    if not grads_err(other, want) >= 0.1:
        raise AssertionError(f"(b) the SwiGLU epilogue reading the other box is off by only "
                             f"{grads_err(other, want):.4g} (< 0.1)")
    del got, want, fault, other
    xd, wgd, wud = x.detach(), wg.detach(), wu.detach()
    # the backward's work: the kernel's two products and the four around it
    ops, _ = sw.work_bwd(M, D, Fd, 2)
    nbytes = (M * D + 2 * D * Fd + M * Fd) * 2 * 2  # x, wg, wu, dout read; dx, dwg, dwu written
    b_ms, b_by = H100.bound_ms(3 * ops, nbytes, torch.bfloat16)

    def kernel_bwd():
        dg, du = sw._launch_bwd(xd, wgd, wud, dout)
        return sw.swiglu_grads(xd, wgd, wud, dg, du)

    rows["swiglu"] = dict(
        shape=f"M={M} D={D} F={Fd} bf16",
        bwd_ms=timer.ms(kernel_bwd, reps=10),
        vjp_ms=timer.ms(lambda: swiglu_vjp(xd, wgd, wud, dout), reps=10),
        fwd_bwd_ms=timer.ms(lambda: torch.autograd.grad(fwd(), (x, wg, wu), dout), reps=10),
        plain_fwd_bwd_ms=timer.ms(lambda: torch.autograd.grad(swiglu_ref(x, wg, wu),
                                                              (x, wg, wu), dout), reps=5),
        library="cuBLAS F.silu(x@wg)*(x@wu) forward + backward",
        library_ms=timer.ms(lambda: torch.autograd.grad(F.silu(x @ wg) * (x @ wu), (x, wg, wu),
                                                        dout), reps=10),
        bound_ms=b_ms, bound_by=b_by)
    return rows


@contextmanager
def detached_kernels():
    """The kernel wrappers return their CUDA outputs with no gradient path,
    as they did before their autograd Functions (a planted fault)."""
    import importlib

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    with patched(fa._FlashAttention, "apply",
                 staticmethod(lambda q, k, v, causal, sc: fa._launch(q, k, v, causal, sc)[0])), \
            patched(sw._SwiGLU, "apply", staticmethod(sw._launch)):
        yield


def flash_bwd_without_mask():
    """The flash backward kernel launched with its causal flag cleared (a
    planted fault)."""
    import importlib

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    launch = fa._launch_bwd
    return patched(fa, "_launch_bwd", lambda q, k, v, o, do, lse, causal, sc: launch(
        q, k, v, o, do, lse, False, sc))


def flash_dq_key_tile_dropped(torch):
    """dQ of the flash backward kernel without its first 64-key tile (a
    planted fault): one launch on keys 64.. with the rows' own lse, so that
    when causal each row keeps its diagonal (Sk - Sq falls by 64 with the
    keys) and rows 0..63 see no key; dk and dv of that launch are not
    held (zeros)."""
    import importlib

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    launch = fa._launch_bwd

    def dropped(q, k, v, o, do, lse, causal, sc):
        dq = launch(q, k[:, 64:].contiguous(), v[:, 64:].contiguous(), o, do, lse, causal, sc)[0]
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    return patched(fa, "_launch_bwd", dropped)


def swapped_swiglu_bwd():
    """The SwiGLU backward kernel's dg and du swapped (a planted fault)."""
    import importlib

    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    launch = sw._launch_bwd
    return patched(sw, "_launch_bwd", lambda *args: launch(*args)[::-1])


def lacking_gradient(torch, model) -> list:
    """Parameters whose gradient is missing, not finite, or zero."""
    return [n for n, p in model.named_parameters()
            if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]


# the SSD scan's gradient path and its planted faults
def ssd_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.ssd_scan")


def ssd_backward_none():
    """The SSD scan's ``autograd.Function`` returning no gradient (a planted
    fault: what a launch with no VJP gives)."""
    ssd = ssd_module()
    return patched(ssd._SSDScan, "backward",
                   staticmethod(lambda ctx, dy, dh=None: (None,) * 7))


def ssd_bwd_per_chunk(torch):
    """The SSD backward kernel launched on each chunk of 64 positions alone
    (a planted fault): no state reaches a chunk and no state cotangent
    leaves it, in either direction."""
    ssd = ssd_module()
    launch, Q = ssd._launch_bwd, ssd.CHUNK["wgmma"]

    def per_chunk(x, dt, A2, Bm, Cm, dy, dh):
        S = x.shape[1]
        outs = [launch(x[:, s:s + Q], dt[:, s:s + Q], A2, Bm[:, s:s + Q], Cm[:, s:s + Q],
                       dy[:, s:s + Q], dh if s + Q >= S else None) for s in range(0, S, Q)]
        return (torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1),
                sum(o[2] for o in outs), torch.cat([o[3] for o in outs], 1),
                torch.cat([o[4] for o in outs], 1))
    return patched(ssd, "_launch_bwd", per_chunk)


def ssd_bwd_swapped(torch):
    """The SSD backward kernel's dB and dC swapped (a planted fault)."""
    ssd = ssd_module()
    launch = ssd._launch_bwd

    def swapped(*args):
        dx, ddt, dA, dB, dC = launch(*args)
        return dx, ddt, dA, dC, dB
    return patched(ssd, "_launch_bwd", swapped)


def ssd_bwd_no_dA(torch):
    """The SSD backward kernel's dA dropped: A's gradient path cut (a
    planted fault)."""
    ssd = ssd_module()
    launch = ssd._launch_bwd

    def without_dA(*args):
        dx, ddt, dA, dB, dC = launch(*args)
        return dx, ddt, torch.zeros_like(dA), dB, dC
    return patched(ssd, "_launch_bwd", without_dA)


# the on-chip sum of dB and dC over a cluster's ranks in csrc/ssd_scan.cu, and
# the planted fault that leaves the last rank's share out
RANK_SUM = ("for (int r = 1; r < ranks; ++r) {", "for (int r = 1; r < ranks - 1; ++r) {")
# the read of columns 0-63's dout in csrc/swiglu_matmul.cu's backward
# epilogue, and the planted fault that reads it from the buffer's other box
# (columns 64-127's dout), as ref.swiglu_bwd_tiles(read_other=True) models it
OTHER_BOX = ("grads(i, word(din + at(i)), word(din + at(i)), word(din + C::BOX_BYTES + at(i)));",
             "grads(i, word(din + C::BOX_BYTES + at(i)), word(din + at(i)), "
             "word(din + C::BOX_BYTES + at(i)));")


@functools.lru_cache(maxsize=None)
def source_fault_library(name: str, work: str, subs: tuple):
    """Library ``name`` built from a copy of csrc/<name>.cu under
    build/<work> with each (old, new) of ``subs`` replaced: a planted fault
    in the CUDA source, built beside the real library in the build phase.
    One object a run."""
    import shutil

    from repro_torch.kernels._build import BUILD_DIR, CSRC, KernelLibrary

    text = (CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise AssertionError(f"csrc/{name}.cu holds no {old!r}")
        text = text.replace(old, new)
    folder = BUILD_DIR.parent / work
    folder.mkdir(parents=True, exist_ok=True)
    (folder / f"{name}.cu").write_text(text)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, folder / header.name)
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    lib = KernelLibrary(name, module.LIBRARY.variants)
    lib.source = folder / f"{name}.cu"
    return lib


def ssd_rank_fault_library():
    """The SSD library whose on-chip sum of dB and dC over a cluster's ranks
    leaves the last rank's share out."""
    return source_fault_library("ssd_scan", "ssd_rank_fault", (RANK_SUM,))


def swiglu_box_fault_library():
    """The SwiGLU library whose backward epilogue reads columns 0-63's dout
    from the other box of its buffer."""
    return source_fault_library("swiglu_matmul", "swiglu_box_fault", (OTHER_BOX,))


def cuda_core_fault_libraries() -> dict:
    """The SwiGLU libraries built from copies of its source with each of
    CUDA_CORE_FAULTS planted in the CUDA-core kernel, by fault."""
    return {name: source_fault_library("swiglu_matmul", "swiglu_cuda_core_fault_" + str(i), subs)
            for i, (name, subs) in enumerate(CUDA_CORE_FAULTS)}


def flash_cuda_core_fault_libraries() -> dict:
    """The flash libraries built from copies of its source with each of
    FLASH_CUDA_CORE_FAULTS planted in the CUDA-core kernel, by fault."""
    return {name: source_fault_library("flash_attention", "flash_cuda_core_fault_" + str(i), subs)
            for i, (name, subs) in enumerate(FLASH_CUDA_CORE_FAULTS)}


def ssd_cuda_core_fault_libraries() -> dict:
    """The SSD libraries built from copies of its source with each of
    SSD_CUDA_CORE_FAULTS planted in the CUDA-core kernels, by fault."""
    return {name: source_fault_library("ssd_scan", "ssd_cuda_core_fault_" + str(i), subs)
            for i, (name, subs) in enumerate(SSD_CUDA_CORE_FAULTS)}


def swiglu_bwd_other_box():
    """The SwiGLU kernels launched from ``swiglu_box_fault_library`` (a
    planted fault: the backward's epilogue reads dout from the other box)."""
    return patched(importlib.import_module("repro_torch.kernels.swiglu_matmul"), "LIBRARY",
                   swiglu_box_fault_library())


def ssd_bwd_rank_dropped(torch):
    """The SSD kernels launched from ``ssd_rank_fault_library`` (a planted
    fault: the backward's on-chip head sum without its last rank's share)."""
    return patched(ssd_module(), "LIBRARY", ssd_rank_fault_library())


# each through the kernel's own launch (the VJP's planted faults, which
# patch its helpers, are the CPU tests': tests/test_torch_ssd_vjp.py)
SSD_BWD_FAULTS = {"no carry across chunks": ssd_bwd_per_chunk, "dB and dC swapped": ssd_bwd_swapped,
                  "dA dropped": ssd_bwd_no_dA, "a rank's head sum dropped": ssd_bwd_rank_dropped}


def ssd_bwd_checks(torch, timer) -> dict:
    """(b) The SSD scan's backward at the train path's shape (one microbatch
    of mamba2-370m: B 4, S 1024, 32 heads of 64, state 128, one group)
    through ``_SSDScan`` (one ``wgmma_bwd`` launch, no VJP) on the mixer's
    strided views of one bf16 conv output, dt = softplus(N(0,1) - 4) (dt
    ~0.02: a dropped carry shows), against autograd through the plain
    version on the card; the planted faults, each through the kernel's own
    launch; the backward's times beside its bound and the VJP it replaces
    (no library call computes an SSD scan).  The kernel's own time is the
    kernels phase's (``backward_paths``, row "train")."""
    from repro_torch.kernels import ssd_mixer
    from repro_torch.kernels.ref import ssd_mixer_ref
    from repro_torch.launch.roofline_model import H100

    ssd = ssd_module()
    gen = torch.Generator(device="cuda").manual_seed(2)
    Bsz, S, H, G, P, N = 4, TRAIN_SEQ, 32, 1, 64, 128
    buf = torch.randn((Bsz, S, H * P + 2 * G * N), generator=gen, device="cuda").mul_(0.5).to(
        torch.bfloat16).requires_grad_(True)
    dt = torch.nn.functional.softplus(torch.randn((Bsz, S, H), generator=gen, device="cuda")
                                      - 4.0).requires_grad_(True)
    A = (-torch.exp(torch.randn(H, generator=gen, device="cuda") * 0.5)).requires_grad_(True)
    dy = torch.randn((Bsz, S, H, P), generator=gen, device="cuda").to(torch.bfloat16)

    def views():
        return (buf[..., :H * P].reshape(Bsz, S, H, P),
                buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N),
                buf[..., H * P + G * N:].reshape(Bsz, S, G, N))

    def fwd_bwd(fn):
        x, Bm, Cm = views()
        y, _ = fn(x, dt, A, Bm, Cm, return_state=True)  # the train path discards the state
        return torch.autograd.grad(y, (buf, dt, A), dy)

    from repro_torch.kernels import SSD_LIBRARY

    before = dict(SSD_LIBRARY.counts)
    got = fwd_bwd(ssd_mixer)
    moved = {v: n - before[v] for v, n in SSD_LIBRARY.counts.items() if n != before[v]}
    if moved != {"wgmma": 1, "wgmma_bwd": 1}:
        raise AssertionError(f"(b) the SSD forward and backward launched {moved}, not one "
                             f"wgmma and one wgmma_bwd")
    want = fwd_bwd(ssd_mixer_ref)
    faults = {}
    for name, fault in SSD_BWD_FAULTS.items():
        with fault(torch):
            faults[name] = grads_err(fwd_bwd(ssd_mixer), want)
    hold(f"(b) SSD wgmma_bwd B={Bsz} S={S} H={H} N={N}, d(conv output)/ddt/dA",
         grads_err(got, want), VJP_TOL, faults)
    del got, want
    x, Bm, Cm = (t.detach() for t in views())
    dtd, A2 = dt.detach(), A.detach()[None].expand(Bsz, H)
    b_ms, b_by = H100.bound_ms(*ssd.work_bwd(Bsz * H, Bsz * G, S, P, N, 2), torch.bfloat16)
    return {"ssd": dict(
        shape=f"B={Bsz} S={S} H={H} G={G} P={P} N={N} bf16, views of conv_out",
        bwd_ms=timer.ms(lambda: ssd._launch_bwd(x, dtd, A2, Bm, Cm, dy, None), reps=10),
        vjp_ms=timer.ms(lambda: ssd.ssd_scan_vjp(x, dtd, A2, Bm, Cm, dy, None), reps=10),
        fwd_bwd_ms=timer.ms(lambda: fwd_bwd(ssd_mixer), reps=10),
        plain_fwd_bwd_ms=timer.ms(lambda: fwd_bwd(ssd_mixer_ref), reps=2),
        library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        faults=faults)}


def shifted_dt_bias(torch, model) -> None:
    """``dt_bias`` at -4 in every mixer (dt ~0.018, inside Mamba-2's own
    dt initialisation range [0.001, 0.1]; the reference initialises it at
    0, where dt ~0.7 and a chunk of 64 positions decays by ~e^-45): the state
    carried across chunks, and so its gradient, then counts."""
    with torch.no_grad():
        for block in model.layers:
            if hasattr(block, "ssm"):
                block.ssm["dt_bias"].fill_(-4.0)


def card_against_cpu(torch, cfg, faults, prepare=None) -> dict:
    """(c) One ``make_train_step`` at full width and 2 layers on 2 x 256
    tokens, on the card (bf16, the kernels and their VJPs) against the same
    weights in f32 on the CPU (the plain versions): loss, gradient norm,
    each leaf's first moment (0.1 of its clipped gradient) and the updated
    weights; then each planted fault of ``faults`` ({name: context}) on the
    card.  ``prepare(model)`` adjusts the weights first."""
    import copy

    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step

    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rescale_attention(torch, cfg, model)
    if prepare is not None:
        prepare(torch, model)
    start = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    b = SyntheticLMDataset(cfg.vocab, seq_len=256, global_batch=2, seed=0).batch(0)
    tcfg = TrainConfig(microbatches=1, remat=True,
                       optim=AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS))
    step = make_train_step(cfg, tcfg)

    def run(m, dev):
        feed = {"tokens": torch.as_tensor(b.inputs, device=dev),
                "labels": torch.as_tensor(b.labels, device=dev)}
        _, opt, metrics = step(m, adamw_init(dict(m.named_parameters()), tcfg.optim), feed)
        return ({k: float(v) for k, v in metrics.items()},
                {n: t.float().cpu() for n, t in opt["m"].items()},
                {n: p.detach().float().cpu() for n, p in m.named_parameters()})

    t0 = time.perf_counter()
    cpu = run(copy.deepcopy(model).to(device="cpu", dtype=torch.float32), "cpu")
    log(f"(c) the CPU's f32 step: {time.perf_counter() - t0:.1f} s")

    def card_run():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        return run(model, "cuda")

    def compare(res):
        (m1, mom1, p1), (m0, mom0, p0) = res, cpu
        # a weight may differ from the CPU's rounded to bf16 by one bf16 ulp,
        # and by 2·lr more where a gradient near 0 has the other sign (Adam's
        # first step moves every weight by about lr): ``weights`` is the
        # largest excess over the ulp, in units of 2·lr
        excess = max(float(((p1[n] - p0[n].bfloat16().float()).abs()
                            - 2.0 ** -7 * p0[n].abs()).max()) for n in p0)
        return dict(loss=abs(m1["loss"] - m0["loss"]) / m0["loss"],
                    grad_norm=abs(m1["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"],
                    moment=max(rel_err(mom1[n], mom0[n]) for n in mom0),
                    weights=excess / (2 * m0["lr"]))

    ok = compare(card_run())
    planted = {}
    for name, ctx in faults.items():
        with ctx:
            planted[name] = compare(card_run())
    log(f"(c) card against CPU: {json.dumps(ok)}; planted faults {json.dumps(planted)}")
    for key, tol in CARD_CPU_TOL.items():
        if not ok[key] <= tol:
            raise AssertionError(f"(c) {key}: {ok[key]:.4g} > {tol}")
    hold("(c) first moments, card against CPU", ok["moment"], CARD_CPU_TOL["moment"],
         {k: f["moment"] for k, f in planted.items()})
    del model
    return dict(card_vs_cpu=ok, faults=planted, cpu_loss=cpu[0]["loss"],
                cpu_grad_norm=cpu[0]["grad_norm"])


# the PyTorch VJPs that the flash, SwiGLU and SSD backward kernels replace on
# the bf16 train paths: counted there, and called 0 times
KERNEL_BACKWARD_VJPS = {"flash_attention": "flash_attention_vjp", "swiglu_matmul": "swiglu_vjp",
                        "ssd_scan": "ssd_scan_vjp"}


def train_path(torch, arch: str) -> dict:
    """What the train phase of ``arch`` checks beyond the common steps: (b)
    its backwards, (a)'s planted fault, (c)'s faults and weight adjustment."""
    if arch == TRAIN_ARCH:
        return dict(vjps=vjp_checks, detach=detached_kernels,
                    c_faults=lambda: {"detached outputs": detached_kernels(),
                                      "flash wgmma_bwd causal flag cleared":
                                          flash_bwd_without_mask(),
                                      "SwiGLU wgmma_bwd dg and du swapped": swapped_swiglu_bwd()},
                    prepare=None)
    return dict(vjps=ssd_bwd_checks, detach=ssd_backward_none,
                c_faults=lambda: {"SSD backward returns None": ssd_backward_none(),
                                  **{k: f(torch) for k, f in SSD_BWD_FAULTS.items()}},
                prepare=shifted_dt_bias)


@contextmanager
def counting_vjps(counted: dict, calls: dict):
    """Each VJP of ``counted`` ({module: function}) counts its calls into
    ``calls`` while inside."""
    import importlib
    from contextlib import ExitStack

    def counting(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    with ExitStack() as stack:
        for mod, fn in counted.items():
            m = importlib.import_module(f"repro_torch.kernels.{mod}")
            calls[fn] = 0
            stack.enter_context(patched(m, fn, counting(fn, getattr(m, fn))))
        yield


def step_report(torch, tr, steps: int, batch: int, wall: float) -> dict:
    """The counted run's losses, median step wall (steps 3 on), tokens/s and
    peak, then one profiled step (wall and device busy)."""
    losses = [h["loss"] for h in tr.history]
    step_ms = sorted(dt * 1e3 for _, dt in tr.monitor.workers[0].timings[2:])
    median_ms = step_ms[len(step_ms) // 2]
    tokens_s = batch * TRAIN_SEQ / (median_ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"(e) losses {[round(x, 4) for x in losses]}")
    log(f"(e) {steps} steps in {wall:.2f} s; median step {median_ms:.2f} ms over steps "
        f"3-{steps}, {tokens_s:.0f} tokens/s; peak {peak:.2f} GiB")
    nxt = tr.dataset.batch(tr.step)
    feed = {"tokens": torch.as_tensor(nxt.inputs, device="cuda"),
            "labels": torch.as_tensor(nxt.labels, device="cuda")}

    def one_step():
        tr.params, tr.opt_state, _ = tr.step_fn(tr.params, tr.opt_state, feed)

    prof = profile_steps(torch, {"train step": one_step})["train step"]
    return dict(losses=losses, median_step_ms=median_ms, tokens_per_s=tokens_s, peak_gib=peak,
                profiled_step=dict(wall_ms=prof[0], busy_ms=prof[1],
                                   busy_share=prof[1] / prof[0]))


def train_phase(torch, np, arch: str = TRAIN_ARCH) -> dict:
    """Train ``arch`` (TinyLlama-1.1B through the flash and SwiGLU kernels
    and their backward kernels, or mamba2-370m through the SSD scan and its
    backward kernel) at full width and depth; checks (a)-(f) (module
    docstring)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.runtime import HealthMonitor, simulate_failure_recovery
    from repro_torch.train import loss_fn

    path = train_path(torch, arch)
    cfg = get_config(arch)
    small = dataclasses.replace(cfg, n_layers=TRAIN_SMALL_LAYERS)
    report = {}
    # (c) one step, card against CPU, 2 layers
    report["c"] = card_against_cpu(torch, small, path["c_faults"](), path["prepare"])
    release(torch)
    # (b) the VJPs at the path's shapes
    timer = Timer(torch)
    report["backward"] = path["vjps"](torch, timer)
    del timer
    release(torch)
    log("backward: " + json.dumps(report["backward"]))

    tr = make_trainer(torch, cfg, monitor=HealthMonitor(n_workers=1, window=TRAIN_STEPS))
    n_params = sum(p.numel() for p in tr.params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB with AdamW's state")
    first = tr.dataset.batch(0)
    tokens = torch.as_tensor(first.inputs, device="cuda")
    labels = torch.as_tensor(first.labels, device="cuda")
    half = TRAIN_BATCH // 2
    # (a) every parameter gets a finite, non-zero gradient from one
    # microbatch's backward; the planted fault leaves some without
    report["a"] = every_gradient(torch, cfg, tr.params, tokens[:half], labels[:half],
                                 path["detach"])
    # (d) one batch as 1 and as 2 microbatches (the step's loss metric)
    with torch.no_grad():
        one = float(loss_fn(tr.params, cfg, tokens, labels)[0])
        two = sum(float(loss_fn(tr.params, cfg, tokens[i * half:(i + 1) * half],
                                labels[i * half:(i + 1) * half])[0]) for i in range(2)) / 2
    d_rel = abs(one - two) / abs(one)
    log(f"(d) loss over 8 sequences {one:.6f}, as 2 microbatches {two:.6f}: relative "
        f"difference {d_rel:.3g} (tol {MICROBATCH_TOL})")
    if not d_rel <= MICROBATCH_TOL:
        raise AssertionError(f"(d) microbatch losses differ by {d_rel:.3g}")
    report["d"] = dict(loss_1=one, loss_2=two, rel=d_rel)
    del tokens, labels
    # (e) 20 steps through Trainer.run, counted; the VJP calls counted too
    vjp_calls = {}
    reset_counts(torch)
    t0 = time.perf_counter()
    with counting_vjps(KERNEL_BACKWARD_VJPS, vjp_calls):
        tr.run(TRAIN_STEPS, log_every=5, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    per_step = expected_launches(torch, cfg, train=(tr.tcfg, TRAIN_BATCH, TRAIN_SEQ))
    check_launches(launches, {lib: {v: n * TRAIN_STEPS for v, n in c.items()}
                              for lib, c in per_step.items()})
    calls = {k: n / TRAIN_STEPS for k, n in vjp_calls.items()}
    log(f"launches a step: {per_step}; VJP calls a step: {calls}")
    if any(vjp_calls.values()):
        raise AssertionError(f"(e) PyTorch VJPs called on the kernels' train path: {vjp_calls}")
    report["e"] = dict(step_report(torch, tr, TRAIN_STEPS, TRAIN_BATCH, wall),
                       launches_per_step=per_step, vjp_calls_per_step=calls)
    losses = report["e"]["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] - 0.3:
        raise AssertionError(f"(e) losses {losses}: not finite, or the last not 0.3 below the first")
    del tr
    release(torch)
    # (f) kill and resume at 2 layers, against an uninterrupted run
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)  # listed in .gitignore
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(ROOT, "build"))
    log(f"(f) checkpoints under {root}: {shutil.disk_usage(root).free / 2**30:.1f} GiB free")
    try:
        t0 = time.perf_counter()
        res = simulate_failure_recovery(
            lambda: make_trainer(torch, small, ckpt=CheckpointManager(root, keep=2), ckpt_every=5),
            fail_at_step=12, total_steps=TRAIN_STEPS, ckpt_every=5)
        drill_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    whole = make_trainer(torch, small)
    whole.run(TRAIN_STEPS, log_every=0)
    ref = [h["loss"] for h in whole.history]
    pre = [h["loss"] for h in res["pre_crash"]]
    post = [h["loss"] for h in res["post_crash"]]
    pre_diff = max(abs(a - b) for a, b in zip(pre, ref))
    post_diff = max(abs(a - b) for a, b in zip(post, ref[res["resume_step"]:]))
    log(f"(f) drill {drill_s:.1f} s: resumed at step {res['resume_step']}; largest loss "
        f"difference from an uninterrupted run before the kill {pre_diff:.3g}, after the "
        f"resume {post_diff:.3g}")
    if not (res["resumed"] and res["resume_step"] == 10 and len(post) == TRAIN_STEPS - 10):
        raise AssertionError(f"(f) resumed {res['resumed']} at {res['resume_step']}, "
                             f"{len(post)} steps after")
    # the steps are deterministic on the card (the first chip runs read 0.0
    # both ways): the resumed run must be the uninterrupted one, bit for bit
    if pre_diff != 0.0 or post_diff != 0.0:
        raise AssertionError(f"(f) losses differ from an uninterrupted run by {pre_diff:.3g} "
                             f"before the kill and {post_diff:.3g} after the resume")
    report["f"] = dict(resume_step=res["resume_step"], pre_diff=pre_diff, post_diff=post_diff,
                       drill_s=drill_s)
    del whole, res
    log(f"train {arch}: " + json.dumps(report))
    return launches


def every_gradient(torch, cfg, model, tokens, labels, fault) -> dict:
    """(a) One microbatch's backward gives every parameter a finite,
    non-zero gradient; under the planted ``fault`` (a context) some lack
    one.  Gradients are cleared after each."""
    from repro_torch.train import loss_fn

    def backward_lacking():
        loss, _ = loss_fn(model, cfg, tokens, labels, remat=True)
        loss.backward()
        bad = lacking_gradient(torch, model)
        for p in model.parameters():
            p.grad = None
        return bad

    lacking = backward_lacking()
    with fault():
        planted = backward_lacking()
    n_leaves = len(list(model.parameters()))
    log(f"(a) parameters lacking a gradient: {len(lacking)} of {n_leaves}; with the planted "
        f"fault: {len(planted)} ({', '.join(planted[:6])}, ...)")
    if lacking or not planted:
        raise AssertionError(f"(a) lacking gradients {lacking}; planted fault lacking {planted[:6]}")
    return dict(leaves=n_leaves, lacking=len(lacking), lacking_under_fault=len(planted))


# --------------------------------------------------------------------------- #
# phase: one Jamba period trains (the hybrid super segment)
# --------------------------------------------------------------------------- #
HYBRID_TRAIN_ARCH = "jamba-v0.1-52b"
# one period of 8 layers (the least ``segments`` allows) at full width, with
# the experts cut from 16 to 4 (top-2 kept): 4.81 B parameters; AdamW with
# bf16 moments (the reference's option) keeps the train state at ~54 GiB
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_EXPERTS = 8, 4
HYBRID_TRAIN_STEPS, HYBRID_TRAIN_BATCH = 5, 4
HYBRID_TRAIN_MICROBATCHES = 2  # of 2 x 1024 tokens


def hybrid_config():
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_TRAIN_ARCH)
    return dataclasses.replace(cfg, n_layers=HYBRID_TRAIN_LAYERS,
                               moe=dataclasses.replace(cfg.moe, n_experts=HYBRID_TRAIN_EXPERTS))


def hybrid_expert_rows() -> tuple:
    """(E, M) of the expert kernels on one microbatch of the Jamba period:
    the experts kept, each with G·C rows (G groups of ``router_chunk``
    tokens, C slots a group, as ``moe_layer`` dispatches them)."""
    from repro_torch.models.layers import moe_capacity

    m = hybrid_config().moe
    chunk = min(m.router_chunk, TRAIN_SEQ)
    groups = HYBRID_TRAIN_BATCH // HYBRID_TRAIN_MICROBATCHES * -(-TRAIN_SEQ // chunk)
    return m.n_experts, groups * moe_capacity(m, chunk)


def hybrid_train_phase(torch, np) -> dict:
    """One Jamba period trains at full width: attention, seven mamba2
    mixers, four MoE and four dense FFNs in one backward.  (a) every
    parameter gets a finite, non-zero gradient (planted fault: every
    kernel's Function without its backward); 5 counted steps with launches
    exactly as ``expected_launches`` counts them, the loss finite and
    falling."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import HealthMonitor
    from repro_torch.train import TrainConfig, Trainer

    cfg = hybrid_config()
    tcfg = TrainConfig(microbatches=HYBRID_TRAIN_MICROBATCHES, remat=True,
                       optim=AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=HYBRID_TRAIN_STEPS,
                                         bf16_moments=True))
    ds = SyntheticLMDataset(cfg.vocab, seq_len=TRAIN_SEQ, global_batch=HYBRID_TRAIN_BATCH, seed=0)
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, ds, monitor=HealthMonitor(n_workers=1, window=HYBRID_TRAIN_STEPS),
                 seed=0, device="cuda")
    rescale_attention(torch, cfg, tr.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tr.params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
        f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B params (bf16), AdamW with bf16 "
        f"moments; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    first = ds.batch(0)
    mb = HYBRID_TRAIN_BATCH // tcfg.microbatches
    report = {"a": every_gradient(
        torch, cfg, tr.params, torch.as_tensor(first.inputs[:mb], device="cuda"),
        torch.as_tensor(first.labels[:mb], device="cuda"), every_kernel_without_backward)}
    release(torch)
    reset_counts(torch)
    vjp_calls = {}
    t0 = time.perf_counter()
    with counting_vjps(KERNEL_BACKWARD_VJPS, vjp_calls):
        tr.run(HYBRID_TRAIN_STEPS, log_every=1, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    per_step = expected_launches(torch, cfg, train=(tcfg, HYBRID_TRAIN_BATCH, TRAIN_SEQ))
    check_launches(launches, {lib: {v: n * HYBRID_TRAIN_STEPS for v, n in c.items()}
                              for lib, c in per_step.items()})
    log(f"launches a step: {per_step}; flash, SwiGLU and SSD VJP calls: {vjp_calls}")
    if any(vjp_calls.values()):
        raise AssertionError(f"PyTorch VJPs called on the kernels' train path: {vjp_calls}")
    report["e"] = dict(step_report(torch, tr, HYBRID_TRAIN_STEPS, HYBRID_TRAIN_BATCH, wall),
                       launches_per_step=per_step, params=n_params)
    losses = report["e"]["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"(e) losses {losses}: not finite, or not falling")
    del tr
    log("train jamba: " + json.dumps(report))
    return launches


@contextmanager
def every_kernel_without_backward():
    """Every kernel's output with no gradient path: flash and SwiGLU
    detached, the SSD scan's Function returning None (a planted fault)."""
    with detached_kernels(), ssd_backward_none():
        yield


# --------------------------------------------------------------------------- #
# phase 4b: the launch accounting
# --------------------------------------------------------------------------- #
# the reference's validate_probe defaults: probe_config depth, full width
PROBE_SEQ, PROBE_BATCH = 1024, 16
# the probes whose meta count (operands plus the step's peak) exceeds the
# card: Arctic's 2 layers and Jamba's period at full expert count (26.8 B and
# 13.3 B parameters) with f32 moments
PROBE_SKIPS = {("arctic-480b", "train"), ("jamba-v0.1-52b", "train")}
PROBE_WARM, PROBE_REPS = 2, 5


def accounting_cells() -> None:
    """(a) Every registry arch × runnable shape at full size on one card
    (``CARD_MESH``), host only: the analytic compute and memory seconds under
    the H100's peaks, the dominant term, the operands' GiB (parameters,
    moments, cache, inputs) and whether they fit the card."""
    from repro_torch.configs import SHAPES, get_config, list_archs, runnable_cells
    from repro_torch.launch.mesh import CARD_MESH
    from repro_torch.launch.roofline_model import H100, analytic_terms
    from repro_torch.launch.specs import cell_pspecs, per_device_bytes

    for arch in list_archs():
        cfg = get_config(arch)
        for name in runnable_cells(cfg):
            shape = SHAPES[name]
            ana = analytic_terms(cfg, shape, CARD_MESH, chip=H100)
            arg = per_device_bytes(cell_pspecs(cfg, shape, CARD_MESH), CARD_MESH)
            r = ana["roofline"]
            log(f"cell {arch:22s} {name:12s} compute {r['compute_s']:10.4f} s  memory "
                f"{r['memory_s']:9.4f} s  dominant {ana['dominant'][:-2]:7s}  operands "
                f"{arg / 2**30:9.2f} GiB  fits one card: {arg <= H100.hbm_bytes}")


def probe_timer(torch):
    """Median device ms of a call over ``PROBE_REPS`` runs after
    ``PROBE_WARM`` (CUDA events around each run)."""
    def ms(call) -> float:
        for _ in range(PROBE_WARM):
            call()
        times = []
        for _ in range(PROBE_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]
    return ms


def probe_launches(torch, cfg, kind: str) -> dict:
    """``expected_launches`` for one probe step: a prefill of PROBE_BATCH
    sequences, one decode tick of PROBE_BATCH slots, or one train step (one
    microbatch, remat)."""
    from repro_torch.train import TrainConfig

    if kind == "train":
        return expected_launches(torch, cfg, train=(TrainConfig(microbatches=1, remat=True),
                                                    PROBE_BATCH, PROBE_SEQ))
    if kind == "prefill":
        return expected_launches(torch, cfg, [PROBE_SEQ], batch=PROBE_BATCH)
    return expected_launches(torch, cfg, n_decode=1, slots=PROBE_BATCH)


def accounting_phase(torch, device: str = "cuda") -> list:
    """(a) ``accounting_cells``; (b) every arch × kind of the registry as a
    probe (``launch.analysis.validate_probe``: ``probe_config`` depth, full
    width, seq PROBE_SEQ, batch PROBE_BATCH, one microbatch, f32 moments):
    counted on ``meta``; where the operands and the counted peak fit the
    card, counted again on ``device`` and timed.  Checks: the FLOPs on the
    card equal the meta count exactly, per component and per kernel variant
    (planted fault: the SwiGLU entry's ``work()`` not recorded on CUDA); the
    launches equal the meta count and ``expected_launches``; the outputs are
    finite; the skipped probes are exactly ``PROBE_SKIPS``.  Prints counted / analytic FLOPs (in total and
    by component), device ms, the analytic bound, MFU and the peak."""
    import importlib

    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.analysis import probe_config, validate_probe
    from repro_torch.launch.roofline_model import H100

    accounting_cells()
    timer = probe_timer(torch)
    rows, skipped = [], set()
    for arch in list_archs():
        cfg = probe_config(get_config(arch))
        for kind in ("train", "prefill") + (() if cfg.encoder_only else ("decode",)):
            meta = validate_probe(arch, kind, "meta", PROBE_SEQ, PROBE_BATCH)
            mc = meta["count"]
            need = mc["argument_bytes"] + mc["peak_bytes"]
            if need > H100.hbm_bytes:
                skipped.add((arch, kind))
                log(f"probe {arch} {kind}: skipped, the meta count needs {need / 2**30:.2f} GiB "
                    f"(operands {mc['argument_bytes'] / 2**30:.2f} + peak "
                    f"{mc['peak_bytes'] / 2**30:.2f}) > {H100.hbm_bytes / 2**30:.2f} GiB")
                continue
            release(torch)
            card = validate_probe(arch, kind, device, PROBE_SEQ, PROBE_BATCH, timer=timer)
            cc = card["count"]
            peak = cc["device_peak_bytes"]  # the counted step's, operands included
            if cc["components"] != mc["components"] or cc["kernels"] != mc["kernels"]:
                raise AssertionError(f"probe {arch} {kind}: card count {cc['components']} "
                                     f"{cc['kernels']} != meta {mc['components']} "
                                     f"{mc['kernels']}")
            expect = probe_launches(torch, cfg, kind)
            if cc["launches"] != mc["launches"] or cc["launches"] != expect:
                raise AssertionError(f"probe {arch} {kind}: launches {cc['launches']}, meta "
                                     f"{mc['launches']}, expected {expect}")
            if not card["finite"]:
                raise AssertionError(f"probe {arch} {kind}: non-finite outputs")
            # every bf16 train path's backward is a kernel: no PyTorch VJP's work
            vjps = [k for k in cc["components"] if k.endswith(".vjp") and
                    not k.startswith("swiglu_matmul")]
            if vjps:
                raise AssertionError(f"probe {arch} {kind}: PyTorch VJPs {vjps} on the card")
            ms, bound_s = card["ms"], card["analytic"]["step_time_bound_s"]
            mfu = card["model_flops"] / (ms * 1e-3 * H100.peak_flops)
            row = dict(arch=arch, kind=kind, counted_flops=cc["flops"],
                       analytic_flops=card["analytic"]["flops"], ratio=card["ratio"], ms=ms,
                       bound_ms=bound_s * 1e3, mfu=mfu, peak_gib=peak / 2**30,
                       meta_operands_gib=mc["argument_bytes"] / 2**30,
                       meta_peak_gib=mc["peak_bytes"] / 2**30,
                       launches={f"{lib}[{v}]": n for lib, row in cc["launches"].items()
                                 for v, n in row.items() if n})
            parts = ", ".join(f"{k} {v:.3f}" for k, v in card["ratio"].items()
                              if k != "flops" and v is not None)
            log(f"probe {arch} {kind}: counted/analytic {card['ratio']['flops']:.4f} "
                f"({parts}); {ms:.3f} ms (bound {bound_s * 1e3:.3f} ms); MFU {mfu:.4f}; peak "
                f"{peak / 2**30:.2f} GiB (meta: operands {mc['argument_bytes'] / 2**30:.2f} + "
                f"peak {mc['peak_bytes'] / 2**30:.2f}); launches {row['launches']}")
            rows.append(row)
            del card
    if skipped != PROBE_SKIPS:
        raise AssertionError(f"skipped probes {sorted(skipped)} != {sorted(PROBE_SKIPS)}")
    # planted fault: the dense SwiGLU entry records no work on CUDA; the card's
    # count must then differ from the meta count
    sw_module = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    with patched(sw_module, "record", lambda *a: None):
        faulty = validate_probe("tinyllama-1.1b", "prefill", device, 128, 2)["count"]
    honest = validate_probe("tinyllama-1.1b", "prefill", "meta", 128, 2)["count"]
    if faulty["components"] == honest["components"]:
        raise AssertionError("a kernel entry that records no work went unnoticed")
    log("planted fault (the SwiGLU entry records no work): the card's count differs from meta")
    release(torch)
    return rows


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


def log_allocated(torch) -> float:
    """Print and return what the previous phases left allocated on the card
    (GiB)."""
    gib = torch.cuda.memory_allocated() / 2**30
    log(f"device memory allocated at the start of the phase: {gib:.3f} GiB")
    return gib


def release(torch) -> None:
    """Free what the last phase held: collect its reference cycles first,
    then return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="",
                        help="development: run the build and only these comma-separated "
                             "phases (kernels, tinyllama, mamba2, deepseek, jamba, hubert, "
                             "llava, arctic, train, train_mamba2, train_jamba, accounting), "
                             "then exit 2 with no result")
    args = parser.parse_args()
    only = {p for p in args.only.split(",") if p}

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
        secs = build_all([*LIBRARIES, ssd_rank_fault_library(), swiglu_box_fault_library(),
                          *cuda_core_fault_libraries().values(),
                          *flash_cuda_core_fault_libraries().values(),
                          *ssd_cuda_core_fault_libraries().values()])
        log(f"built {', '.join(f'{n} ({s:.1f} s)' for n, s in secs.items())} "
            f"in {time.perf_counter() - t0:.1f} s")
        for lib in LIBRARIES:
            for line in lib.log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {lib.name}: {line.strip()}")

    if not only or "kernels" in only:
        with phase("kernels"):
            timer = Timer(torch)
            rows = check_kernels(torch, timer)
            del timer
        release(torch)

    # each kernel's launches are read from the serving run whose path it is on
    launches = {}
    serving = [("serve tinyllama-1.1b", "tinyllama",
                lambda: serve(torch, np, "tinyllama-1.1b", LOGIT_TOL, LOGIT_TOL)),
               ("serve mamba2-370m", "mamba2",
                lambda: serve(torch, np, "mamba2-370m", MAMBA_LOGIT_TOL, MAMBA_HANDOFF_TOL)),
               ("serve deepseek-v2-lite-16b", "deepseek", lambda: serve_deepseek(torch, np)),
               (f"serve jamba-v0.1-52b ({JAMBA_LAYERS} layers)", "jamba",
                lambda: serve_jamba(torch, np)),
               ("encode hubert-xlarge", "hubert", lambda: encode_hubert(torch, np)),
               ("serve llava-next-mistral-7b", "llava", lambda: serve_llava(torch, np)),
               (f"serve arctic-480b ({ARCTIC_LAYERS} layers)", "arctic",
                lambda: serve_arctic(torch, np)),
               (f"train {TRAIN_ARCH}", "train", lambda: train_phase(torch, np)),
               (f"train {SSM_TRAIN_ARCH}", "train_mamba2",
                lambda: train_phase(torch, np, SSM_TRAIN_ARCH)),
               (f"train {HYBRID_TRAIN_ARCH} ({HYBRID_TRAIN_LAYERS} layers, "
                f"{HYBRID_TRAIN_EXPERTS} experts)", "train_jamba",
                lambda: hybrid_train_phase(torch, np)),
               ("accounting", "accounting", lambda: accounting_phase(torch))]
    for name, path, run in serving:
        if only and path not in only:
            continue
        with phase(name):
            if log_allocated(torch) >= 1.0:  # the last model must be gone before the next
                raise AssertionError("a previous phase left 1 GiB or more allocated")
            launches[path] = run()
        release(torch)
    if only:
        log(f"partial run ({', '.join(sorted(only))}): no result")
        sys.exit(2)
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
        # kernels, whose route that is), its launches from that path's run;
        # flash mma has a second row at MLA's head dims
        picks = [("flash_attention", "mma", 1024, "tinyllama", ""),
                 ("flash_attention", "mma", "mla", "deepseek", " D=192 Dv=128"),
                 ("flash_attention", "cuda_core", 1024, "tinyllama", ""),
                 ("flash_attention", "cuda_core", "d128", "tinyllama", " D=128"),
                 ("flash_attention", "cuda_core", "mla", "deepseek", " D=192 Dv=128"),
                 ("swiglu_matmul", "wgmma", 512, "tinyllama", ""),
                 ("swiglu_matmul", "decode", 8, "tinyllama", ""),
                 ("swiglu_matmul", "cuda_core", 512, "tinyllama", ""),
                 ("swiglu_matmul", "cuda_core", 8, "tinyllama", " M=8"),
                 ("swiglu_matmul", "experts_wgmma", 120, "deepseek", ""),
                 ("swiglu_matmul", "experts_decode", 8, "deepseek", ""),
                 ("swiglu_matmul", "experts_cuda_core", 120, "deepseek", ""),
                 ("ssd_scan", "wgmma", 1024, "mamba2", ""),
                 ("ssd_scan", "cuda_core", 1024, "mamba2", ""),
                 ("ssd_scan", "cuda_core", "jamba f32", "jamba", " Jamba N=16"),
                 ("ssd_scan", "cuda_core", "bf16", "mamba2", " bf16"),
                 # the hybrid, encoder, VLM and Arctic paths' shapes; each
                 # row's launches are its variant's on the path named
                 ("flash_attention", "mma", "hubert", "hubert", " D=80 non-causal"),
                 ("swiglu_matmul", "wgmma", "d4096", "jamba", " D=4096 F=14336"),
                 ("swiglu_matmul", "decode", "d4096", "jamba", " D=4096 F=14336"),
                 ("swiglu_matmul", "wgmma", "hubert", "hubert", " D=1280 F=5120"),
                 ("swiglu_matmul", "wgmma", "d7168", "arctic", " D=7168 F=4864"),
                 ("swiglu_matmul", "decode", "d7168", "arctic", " D=7168 F=4864"),
                 ("swiglu_matmul", "experts_wgmma", "jamba160", "jamba", " E=16 M=160"),
                 ("swiglu_matmul", "experts_decode", "jamba8", "jamba", " E=16 M=8"),
                 ("swiglu_matmul", "experts_decode", "arctic20", "arctic", " E=128 M=20"),
                 ("swiglu_matmul", "experts_decode", "arctic8", "arctic", " E=128 M=8"),
                 ("ssd_scan", "wgmma", "jamba", "jamba", " Jamba N=16"),
                 # the train path: one microbatch's forward and its backward
                 # kernels; launches from
                 # the counted steps (the expert backward's: Jamba's period,
                 # at its shape)
                 ("flash_attention", "mma", "train", "train", " train BH=128"),
                 ("swiglu_matmul", "wgmma", "train", "train", " train M=4096"),
                 ("ssd_scan", "wgmma", "train", "train_mamba2", " train B=4"),
                 ("flash_attention", "wgmma_bwd", "train", "train", " train BH=128"),
                 ("swiglu_matmul", "wgmma_bwd", "train", "train", " train M=4096"),
                 ("swiglu_matmul", "wgmma_bwd", "train_jamba_dense", "train_jamba",
                  " train Jamba dense M=2048"),
                 ("swiglu_matmul", "experts_wgmma_bwd", "train_jamba", "train_jamba",
                  " train Jamba E=4"),
                 ("ssd_scan", "wgmma_bwd", "train", "train_mamba2", " train B=4"),
                 ("ssd_scan", "wgmma_bwd", "train_jamba", "train_jamba",
                  " train Jamba H=128 N=16"),
                 # the causal conv: mamba2's train layout, Jamba's prefill and
                 # decode; the backward and its reduction at the train layout
                 ("causal_conv", "fwd", "train", "train_mamba2", " train B=16 S=2048"),
                 ("causal_conv", "fwd", "jamba", "jamba", " Jamba prefill S=4096"),
                 ("causal_conv", "fwd", "decode", "jamba", " Jamba decode 16 slots"),
                 ("causal_conv", "bwd", "train", "train_mamba2", " train B=16 S=2048"),
                 ("causal_conv", "bwd_reduce", "train", "train_mamba2", " train B=16 S=2048")]
        if {(n, v) for n, v, *_ in picks} != {(lib.name, v) for lib in LIBRARIES
                                               for v in lib.variants}:
            raise AssertionError("the report misses a kernel variant")
        replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:81",
                    "swiglu_matmul": "src/repro/kernels/swiglu_matmul.py:50",
                    "ssd_scan": "src/repro/kernels/ssd_scan.py:75",
                    # no TPU kernel: the reference's conv is jnp, which XLA fuses
                    "causal_conv": "none (src/repro/models/ssm.py:67, jnp)"}
        sources = {lib.name: lib.source for lib in LIBRARIES}
        kernels = []
        for name, variant, pick, path, suffix in picks:
            r = rows[(name, variant, pick)]
            kernels.append({
                "name": f"{name}[{variant}]{suffix}",
                "route": "cuda", "source": os.path.relpath(sources[name], ROOT),
                "replaces": replaces[name], "launches": launches[path][name][variant],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "library": r["library"], "shape": r["shape"],
                **({k: r[k] for k in ("rel_err", "bound_ms_own_chunk") if k in r}),
            })
        if any(not math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError("a kernel number is not finite")
        # the CUDA-core kernels serve f32 (and shapes the tensor-core ones do
        # not take), which no serving run here uses: every other variant
        # must have been launched on its path
        idle = [k["name"] for k, (_, variant, *_) in zip(kernels, picks)
                if k["launches"] <= 0 and not variant.endswith("cuda_core")]
        if idle:
            raise AssertionError(f"not launched on their serving paths: {idle} ({launches})")

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
