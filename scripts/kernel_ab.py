#!/usr/bin/env python3
"""Time the CUDA-core kernel rows of two copies of the port on one CUDA card.

Run from the root of a checkout::

    python3 scripts/kernel_ab.py DIR_A DIR_B [--rounds 2]

``DIR_A`` and ``DIR_B`` are roots of two checkouts (each with
``src/repro_torch``), for example this one and an earlier state of it
unpacked under ``build/`` (listed in ``.gitignore``); each builds its own
libraries under its own ``build/``.  Each row is timed as ``chip_smoke.py``
times it (its ``Timer``: L2 flushed, a device-side head start, the median
of 20 calls) and held against its plain version with ``chip_smoke.py``'s
tolerance, in a child process per checkout and round, in the order A B B A
(``--rounds`` times), so that a drift of the card's clock falls on both
sides alike.  The rows are those of the f32 CUDA-core kernels on the
serving shapes ``chip_smoke.py`` reports them at.

Prints one JSON line per child, then one with each row's readings for A and
B, their medians and B / A.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(src_root: str) -> None:
    """Build ``src_root``'s kernels and print its rows' times as JSON."""
    import torch

    sys.path.insert(0, os.path.join(src_root, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention, swiglu_experts, swiglu_matmul
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_experts_ref, swiglu_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    D = 2048
    x = randn(32, 1024, 64)
    rows = {"flash cuda_core BH=32 S=1024 D=64 f32 causal": (
        lambda: flash_attention(x, x, x, causal=True),
        lambda: flash_attention_ref(x, x, x, causal=True), cs.FLASH_TOL)}
    m, wg, wu = randn(512, D), randn(D, 5632, scale=D ** -0.5), randn(D, 5632, scale=D ** -0.5)
    rows["swiglu cuda_core M=512 D=2048 F=5632 f32"] = (
        lambda: swiglu_matmul(m, wg, wu), lambda: swiglu_ref(m, wg, wu), cs.SWIGLU_TOL)
    xe = randn(64, 120, D)
    eg, eu = randn(64, D, 1408, scale=D ** -0.5), randn(64, D, 1408, scale=D ** -0.5)
    rows["experts_cuda_core E=64 M=120 D=2048 F=1408 f32"] = (
        lambda: swiglu_experts(xe, eg, eu), lambda: swiglu_experts_ref(xe, eg, eu),
        cs.SWIGLU_TOL)
    timer = cs.Timer(torch)
    out = {}
    for name, (fn, ref, tols) in rows.items():
        tol = tols[str(torch.float32)]
        if not cs.within(fn(), ref(), tol):
            raise AssertionError(f"{src_root}: {name} outside {tol}")
        out[name] = timer.ms(fn)
    print(json.dumps({"root": src_root, "ms": out}), flush=True)


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        child(args[1])
        return
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    a, b = (os.path.abspath(p) for p in args)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    readings = {a: [], b: []}
    for _ in range(rounds):
        for root in (a, b, b, a):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                                 capture_output=True, text=True, check=False)
            if res.returncode:
                sys.stderr.write(res.stdout + res.stderr)
                sys.exit(res.returncode)
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            readings[root].append(json.loads(line)["ms"])
    summary = {}
    for name in readings[a][0]:
        ra = [r[name] for r in readings[a]]
        rb = [r[name] for r in readings[b]]
        summary[name] = {"a_ms": ra, "b_ms": rb, "a_median": statistics.median(ra),
                         "b_median": statistics.median(rb),
                         "b_over_a": statistics.median(rb) / statistics.median(ra)}
    print(json.dumps({"a": a, "b": b, "rows": summary}))


if __name__ == "__main__":
    main()
