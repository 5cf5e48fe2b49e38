"""Pseudo-C rendering of per-core inference functions (paper Alg. 2/3).

A faithfulness artifact: the same plan the TPU executor runs is printed in
ACETONE's generated-code style — one ``INFERENCE_<i>`` function per core,
with *Writing*/*Reading* operators (flag + comm-array protocol, §5.2) around
every cross-core transfer, named ``<src>_<dst>_<id>`` per the paper's norm.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.codegen.plan import ExecutionPlan

__all__ = ["render_pseudo_c"]


def render_pseudo_c(plan: ExecutionPlan) -> str:
    out: List[str] = []
    # per-(src,dst) channel declarations (flag + array), paper §5.2
    channels = sorted({(t.src, t.dst) for s in plan.steps for t in s.transfers})
    out.append("/* shared-memory channels: m(m-1) flags + arrays (paper §5.2) */")
    for (s, d) in channels:
        out.append(f"volatile int flag_{s}_{d} = 0;  float comm_{s}_{d}[COMM_SIZE];")
    out.append("")
    for w in range(plan.n_workers):
        out.append(f"void INFERENCE_{w}(float **inputs, float **outputs) {{")
        seq = 0
        for step in plan.steps:
            for name in step.compute[w]:
                out.append(f"    /* {name} layer */")
                out.append(f"    out_{_c(name)} = {_c(name)}(...);")
            for t in step.transfers:
                if t.src == w:
                    out.append(f"    /* Writing {t.label()} */")
                    out.append(f"    while (flag_{t.src}_{t.dst} != 0) {{ /* wait */ }}")
                    out.append(
                        f"    memcpy(comm_{t.src}_{t.dst}, out_{_c(t.node)}, sizeof(out_{_c(t.node)}));")
                    out.append(f"    flag_{t.src}_{t.dst} += 1;")
                if t.dst == w:
                    out.append(f"    /* Reading {t.label()} */")
                    out.append(f"    while (flag_{t.src}_{t.dst} != 1) {{ /* wait */ }}")
                    out.append(
                        f"    memcpy(out_{_c(t.node)}, comm_{t.src}_{t.dst}, sizeof(out_{_c(t.node)}));")
                    out.append(f"    flag_{t.src}_{t.dst} -= 1;")
            seq += 1
        if w == plan.sink_worker:
            out.append(f"    /* Output layer */")
            out.append(f"    memcpy(outputs, out_{_c(plan.sink)}, OUTPUT_SIZE);")
        out.append("}")
        out.append("")
    return "\n".join(out)


def _c(name: str) -> str:
    return name.replace("/", "_").replace("-", "_")
