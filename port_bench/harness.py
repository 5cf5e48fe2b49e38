"""Find a cell by name, run it, and print its result line.

Everything is found by name: the cell in ``BENCHMARK.json`` and in
``port_bench/workloads/<cell>.json``, its configuration in
``port_bench/configs/<config>.json``, the kind of its traffic mix (the cell
file's ``kind``) in ``port_bench/traffic/<kind>.py`` (a module with ``run(cell) -> Record``) and
each per-layer metric in ``port_bench/metrics/<metric>.py`` (a module with
``read(record) -> float | None``).  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics; a
reader that finds nothing to read leaves its metric out.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


@dataclasses.dataclass
class Cell:
    """What a traffic kind is handed: the cell's entries and the run's arguments."""
    name: str
    workload: Dict[str, Any]          # workloads/<cell>.json
    conf: Dict[str, Any]              # configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    chips: int = 1


@dataclasses.dataclass
class Record:
    """What a traffic kind returns: end-to-end values by metric name, the
    raw readings the per-layer readers take, the numbers compared with
    their limits, and the run's counts."""
    end_to_end: Dict[str, float]
    readings: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int = 0
    trace: Optional[Dict[str, Any]] = None

    @property
    def correct(self) -> bool:
        """Every check within its limit: at most the limit, or at least it
        where the check says ``"least": true``."""
        def ok(c):
            v, lim = c["value"], c["limit"]
            return v == v and (v >= lim if c.get("least") else v <= lim)
        return bool(self.checks) and all(ok(c) for c in self.checks.values())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda"):
    """(cell, traffic module, benchmark entry, metric specs) of cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    workload = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    conf = json.loads((root / conf_entry["file"]).read_text())
    cell = Cell(name, workload, conf, seed, seconds, trace, device, entry["chips"])
    traffic = load_module(BENCH_DIR / "traffic" / f"{workload['kind']}.py",
                          f"port_bench_traffic_{workload['kind']}")
    return cell, traffic, bench, entry


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end (trace off) or per-layer (trace on) metrics."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(record: Record, specs: List[Dict], trace: bool) -> Dict[str, Dict]:
    out = {}
    for m in specs:
        if trace:
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 "port_bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(record)
        else:
            value = record.end_to_end.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def result_line(record: Record, metrics: Dict, device: Dict) -> Dict:
    line = {"correct": record.correct, "attempted": record.attempted, "failed": record.failed,
            "metrics": metrics, "device": device}
    if record.trace is not None:
        line["breakdown"] = record.trace["breakdown"]
    line["checks"] = record.checks
    return line


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: Optional[List[str]] = None, root: Optional[Path] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH_DIR.parent if root is None else root
    setup_env(root)
    cell, traffic, bench, entry = load_cell(root, args.workload, args.seed, args.seconds,
                                            bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    record = traffic.run(cell)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 4
    metrics = read_metrics(record, metrics_for(bench, cell.name, cell.trace), cell.trace)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(record.memory_peak_bytes)}
    if record.trace is not None:
        device.update(busy_s=record.trace["busy_s"], window_s=record.trace["window_s"])
    for k, c in record.checks.items():
        log(f"check {k} {c['value']!r} {'least' if c.get('least') else 'limit'} {c['limit']!r}")
    print(json.dumps(result_line(record, metrics, device)), flush=True)
    return 0


def setup_env(root: Path) -> None:
    """Caches at fixed paths inside the checkout; the port on the path; no
    library loading JAX by itself."""
    cache = root / "build" / "port_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (linear between order statistics, numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
