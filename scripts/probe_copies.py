"""Copies of the port's source with text replaced in one CUDA file, and the
child processes that run in them: the shared machinery of
``scripts/ssd_scan_probe.py``, ``scripts/flash_bwd_probe.py`` and
``scripts/swiglu_bwd_probe.py``.

A copy is the whole of ``src/repro_torch`` under a work directory of the
probe's (under ``build/``, listed in ``.gitignore``), so that it builds its
own library there.  A child is the probe script run again with ``--child``
and its arguments; it prints one line ``RESULT <json>``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def copy_with(work: str, csrc: str, name: str, subs, root: str = ROOT) -> str:
    """A copy of ``root``'s src/repro_torch (this checkout's by default) in
    ``work``/<name> with each ``(old, new)`` of ``subs`` replaced in ``csrc``
    (a path under src/, such as ``repro_torch/csrc/ssd_scan.cu``); returns
    the copy's src directory.  Exits if a text to replace is not there."""
    src = os.path.join(work, re.sub(r"\W+", "_", name), "src")
    shutil.rmtree(os.path.dirname(src), ignore_errors=True)
    shutil.copytree(os.path.join(root, "src", "repro_torch"), os.path.join(src, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(src, csrc)
    text = open(path).read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not found in {csrc}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return src


def run_child(script: str, *args: str, check: bool = True) -> dict:
    """The JSON of ``script --child *args``'s RESULT line.  If the child
    failed: exit with its output when ``check``, else return
    ``{"error": <its output's end>}``."""
    out = subprocess.run([sys.executable, os.path.abspath(script), "--child", *args],
                         capture_output=True, text=True)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode == 0 and line:
        return json.loads(line[0][len("RESULT "):])
    if check:
        raise SystemExit(f"{' '.join(args)} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return {"error": (out.stdout[-1500:] + out.stderr[-1500:]).strip()}
