"""Readings that a cell's limits are set from, many seeds in one process.

    python3 port_bench/control.py --workload <cell> --role <role> --seeds 1,2,3 --seconds 15

``role``: ``program`` (the program as the cell runs it), ``control`` (the
reference computed in the precision below the configuration's, in the
program's place) or a planted fault the cell's traffic kind knows (for
training: ``half_batch``).  One JSON line a seed; the cell's own runs never
run this.  ``--seconds`` is the window of a serving role (long enough to
finish the mix's longest requests).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench.harness import load_cell, setup_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--role", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    setup_env(ROOT)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell, traffic, _, _ = load_cell(ROOT, args.workload, 0, args.seconds, False, args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = traffic.limit_readings(cell, args.role, seed)
        print(json.dumps(dict(seed=seed, role=args.role, **got)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
