"""Dry-run CLI over the registry's cells (port of ``repro/launch/dryrun.py``).

For each (arch × shape × mesh) cell: on ``card`` (one H100, every tensor
whole) the port's step is built on ``meta`` tensors and counted
(``analysis.analyze_cell``: FLOPs by component, kernel launches, operand
bytes, the peak of what the step allocates, whether it fits the card);
on the production meshes (``single`` 16 x 16, ``multi`` 2 x 16 x 16) no
device is involved and the record holds the analytic terms and the
operand bytes one device holds under the cell's partition specs.  Each
record goes to ``build/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape prefill_32k --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card|single|multi [--force]
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.analysis import ART_DIR, MESHES, run_cell


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=tuple(MESHES), default="card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--moe-impl", choices=("einsum", "scatter"), default="einsum")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default=os.path.normpath(ART_DIR))
    args = ap.parse_args()

    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for a, s in cells:
        t0 = time.monotonic()
        try:
            rec = run_cell(a, s, args.mesh, args.out, force=args.force, moe_impl=args.moe_impl,
                           microbatches=args.microbatches)
        except Exception as e:  # report the cell and go on with the next
            failures += 1
            print(f"[FAIL] {a} {s} {args.mesh}: {type(e).__name__}: {e}", flush=True)
            continue
        dt = time.monotonic() - t0
        if rec.get("skipped"):
            print(f"[skip] {a:24s} {s:12s} {args.mesh:6s} — {rec['skipped']}", flush=True)
            continue
        r = rec["roofline"]
        counted = (f"counted={rec['flops'] / 1e12:10.2f}TF ({rec['counted_over_analytic']:.3f} "
                   f"of analytic) " if "flops" in rec else "")
        print(f"[ ok ] {a:24s} {s:12s} {args.mesh:6s} "
              f"compute={r['compute_s'] * 1e3:9.2f}ms memory={r['memory_s'] * 1e3:9.2f}ms "
              f"coll={r['collective_s'] * 1e3:8.2f}ms dom={rec['dominant'][:-2]:10s} "
              f"{counted}hbm={rec['hbm_per_dev_bytes'] / 2**30:8.2f}GiB "
              f"fits={rec['hbm_ok']} ({dt:.1f}s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
