"""Tiny cells of the benchmark for the CPU tests: the real files, shrunk."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from port_bench import harness  # noqa: E402


def tiny_conf(name: str, dtype: str = "float32") -> dict:
    conf = json.loads((ROOT / f"port_bench/configs/{name}.json").read_text())
    a = conf["arch"]
    a.update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
    if a.get("hybrid"):
        a.update(n_layers=4, hybrid={"attn_period": 4, "attn_offset": 1})
        a["moe"].update(n_experts=4, d_ff_expert=32, router_chunk=32)
    else:
        a.update(n_layers=2)
    a["ssm"].update(d_state=16, head_dim=16, chunk=16)
    conf["dtype"] = dtype
    if "train" in conf:
        conf["train"].update(seq_len=40, global_batch=8, microbatches=2)
    return conf


def tiny_cell(name: str, dtype: str = "float32", seed: int = 2**31 + 12345,
              seconds: float = 2.0, trace: bool = False):
    """(cell, traffic module) of cell ``name`` at a tiny size on the CPU."""
    cell, traffic, _, _ = harness.load_cell(ROOT, name, seed, seconds, trace, "cpu")
    cell.conf = tiny_conf(cell.conf["name"], dtype)
    t = cell.workload["traffic"]
    if cell.workload["kind"] == "serve_closed":
        t.update(clients=4, slots=4, max_seq=80, prompt_min=20, prompt_max=60,
                 length_points=8, new_tokens=4, check_requests=3, check_min_tokens=4,
                 trace={"start": 0.2, "ticks": 3})
    else:
        t.update(bands=8, narrowing=5, ref_block_rows=2)
    return cell, traffic
