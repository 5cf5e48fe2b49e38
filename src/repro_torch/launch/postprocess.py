"""Attach the analytic roofline terms to existing dry-run records in place
(port of ``repro/launch/postprocess.py``; nothing is counted again).

    PYTHONPATH=src python -m repro_torch.launch.postprocess [dir ...]
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.analysis import ART_DIR, MESHES, attach_analytic

DEFAULT_DIRS = (os.path.normpath(ART_DIR),)


def process(dirpath: str) -> int:
    n = 0
    for f in sorted(os.listdir(dirpath)):
        if not f.endswith(".json"):
            continue
        path = os.path.join(dirpath, f)
        with open(path) as fh:
            rec = json.load(fh)
        if "skipped" in rec or "error" in rec:
            continue
        mesh_kind = f[:-len(".json")].split("__")[-1]
        attach_analytic(rec, get_config(rec["arch"]), SHAPES[rec["shape"]], MESHES[mesh_kind])
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        n += 1
    return n


def main() -> None:
    dirs = sys.argv[1:] or [d for d in DEFAULT_DIRS if os.path.isdir(d)]
    for d in dirs:
        print(f"{d}: {process(d)} artifacts updated")


if __name__ == "__main__":
    main()
