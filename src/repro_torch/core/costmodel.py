"""TPU roofline cost model — the WCET oracle of the TPU port (DESIGN §2).

The paper obtains per-layer WCETs from OTAWA static analysis of the generated
C.  There is no WCET analyser for TPUs, but the hardware is far more
deterministic than a cache-based CPU: per-op latency is well modelled by a
roofline over the systolic MXU and the HBM/ICI links.  We therefore derive

    t(v) = max(FLOPs(v) / PEAK_FLOPS, bytes(v) / HBM_BW)        [seconds]
    w(e) = ICI_LATENCY + bytes(e) / ICI_BW                      [seconds]

These populate the DAG the scheduler consumes; after a dry-run compile, the
same formulas applied to ``compiled.cost_analysis()`` refine the offline
estimates (benchmarks/roofline.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.graph import DAG

__all__ = [
    "HardwareSpec",
    "TPU_V5E",
    "OpCost",
    "annotate",
    "box_bytes",
    "roofline_time",
    "conv2d_slice_cost",
    "pool2d_slice_cost",
    "attention_cost",
]


def box_bytes(box, dtype_bytes: int = 4) -> float:
    """Byte size of an axis-aligned window ``((lo, hi), ...)``.

    The unit the direct-edge slicer prices communication in: a consumer
    slice's input window intersected with one producer tile.  Boxes carry
    one interval per axis, so the 1-D tilings and the 2-D (cout × rows)
    grid tiles of the nested tiling IR price through the same formula.
    Used for both DAG edge weights (:meth:`CNNModel.to_dag`) and transfer
    payload sizes (:class:`repro.codegen.plan.Transfer`), so the
    scheduler's ``w`` and the executor's shipped bytes agree by
    construction.
    """
    n = float(dtype_bytes)
    for lo, hi in box:
        n *= max(hi - lo, 0)
    return n


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants."""

    name: str
    peak_flops: float  # FLOP/s (bf16)
    hbm_bw: float  # B/s
    ici_bw: float  # B/s per link
    ici_latency: float  # s, per-message fixed cost
    hbm_bytes: float  # capacity, B
    vmem_bytes: float  # VMEM capacity, B

    def compute_time(self, flops: float) -> float:
        return flops / self.peak_flops

    def memory_time(self, bytes_accessed: float) -> float:
        return bytes_accessed / self.hbm_bw

    def comm_time(self, bytes_moved: float, hops: int = 1) -> float:
        return self.ici_latency * hops + bytes_moved / self.ici_bw

    def derate(self, factor: float) -> "HardwareSpec":
        """A pessimized copy: throughputs divided by ``factor`` (> 1).

        WCET calibration expresses measured-vs-roofline gaps (e.g. the
        paper's OTAWA cycle counts vs ideal FLOP time) as a derating of
        the hardware, so certificates priced on the derated spec bound
        the observed behaviour instead of the ideal one.  Latencies are
        costs, not throughputs, so they *scale up* by the same factor.
        """
        if factor <= 0:
            raise ValueError(f"derate factor must be positive, got {factor}")
        return dataclasses.replace(
            self,
            name=f"{self.name}-derated-{factor:g}x",
            peak_flops=self.peak_flops / factor,
            hbm_bw=self.hbm_bw / factor,
            ici_bw=self.ici_bw / factor,
            ici_latency=self.ici_latency * factor,
        )


# TPU v5e (the target of the dry-run/roofline brief).
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    ici_latency=1e-6,
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
)

# A Keystone-II-like embedded CPU core (the paper's §5.5 target regime):
# per-layer compute dominates inter-core UMA transfers by orders of
# magnitude, which is what makes layer-level CNN parallelism pay off there.
# Used by the paper-faithful benchmarks; the TPU spec is used everywhere else.
KEYSTONE_CPU = HardwareSpec(
    name="keystone-a15",
    peak_flops=5.6e9,      # ~4 FLOP/cycle @ 1.4 GHz, single core
    hbm_bw=3.2e9,          # DDR3 share per core
    ici_bw=2.0e9,          # shared-memory copy bandwidth
    ici_latency=2e-6,      # flag handshake
    hbm_bytes=2 * 2**30,
    vmem_bytes=4 * 2**20,  # L2 slice
)


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Static cost description of one DAG node."""

    flops: float
    bytes_accessed: float

    def time(self, hw: HardwareSpec = TPU_V5E) -> float:
        return max(hw.compute_time(self.flops), hw.memory_time(self.bytes_accessed))

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)


def roofline_time(flops: float, bytes_accessed: float, hw: HardwareSpec = TPU_V5E) -> float:
    return OpCost(flops, bytes_accessed).time(hw)


def annotate(
    nodes: Mapping[str, OpCost],
    edges: Mapping[Tuple[str, str], float],  # edge -> tensor bytes
    hw: HardwareSpec = TPU_V5E,
    time_unit: float = 1e-6,  # express t/w in microseconds by default
) -> DAG:
    """Build a cost-annotated DAG from op costs and edge tensor sizes."""
    t = {n: c.time(hw) / time_unit for n, c in nodes.items()}
    w = {e: hw.comm_time(b) / time_unit for e, b in edges.items()}
    return DAG.build(nodes=tuple(nodes), edges=tuple(edges), t=t, w=w)


# --------------------------------------------------------------------- #
# closed-form op cost helpers (used by model graph builders)
# --------------------------------------------------------------------- #
def conv2d_cost(
    h: int, w: int, cin: int, cout: int, kh: int, kw: int, dtype_bytes: int = 4,
    stride: int = 1,
) -> OpCost:
    ho, wo = h // stride, w // stride
    flops = 2.0 * ho * wo * cout * cin * kh * kw
    bytes_accessed = dtype_bytes * (h * w * cin + kh * kw * cin * cout + ho * wo * cout)
    return OpCost(flops, bytes_accessed)


def dense_cost(n_in: int, n_out: int, batch: int = 1, dtype_bytes: int = 4) -> OpCost:
    flops = 2.0 * batch * n_in * n_out
    bytes_accessed = dtype_bytes * (batch * n_in + n_in * n_out + batch * n_out)
    return OpCost(flops, bytes_accessed)


def pool2d_cost(h: int, w: int, c: int, k: int, dtype_bytes: int = 4, stride: int = 2) -> OpCost:
    ho, wo = h // stride, w // stride
    flops = 1.0 * ho * wo * c * k * k
    bytes_accessed = dtype_bytes * (h * w * c + ho * wo * c)
    return OpCost(flops, bytes_accessed)


def elementwise_cost(numel: int, flops_per_elem: float = 1.0, dtype_bytes: int = 4) -> OpCost:
    return OpCost(flops_per_elem * numel, 2.0 * dtype_bytes * numel)


def matmul_cost(m: int, k: int, n: int, dtype_bytes: int = 2) -> OpCost:
    flops = 2.0 * m * k * n
    bytes_accessed = dtype_bytes * (m * k + k * n + m * n)
    return OpCost(flops, bytes_accessed)


# --------------------------------------------------------------------- #
# per-slice op costs (operator-granularity DAGs)
#
# A slice task computes a rectangular tile of one layer's output; its FLOPs
# scale *exactly* with the tile shape (so tiles partitioning a layer conserve
# the layer's FLOPs), while its bytes account for what the tile actually
# touches — the full (or halo) input region it reads, its own weight slice,
# and its own output tile.  Input re-reads across tiles mean bytes, unlike
# FLOPs, are super-additive; the roofline `t` inherits that.  The helpers
# take output rows *and* channel-tile extents independently, so 1-D tiles
# and 2-D (cout × rows) grid tiles cost through the same formulas — a grid
# trades halo re-reads (rows) against input re-reads (channels).
# --------------------------------------------------------------------- #
def conv2d_slice_cost(
    in_rows: int, in_cols: int, cin: int, kh: int, kw: int,
    out_rows: int, out_cols: int, cout_tile: int, dtype_bytes: int = 4,
) -> OpCost:
    """Cost of one conv tile: ``out_rows x out_cols x cout_tile`` outputs
    read from an ``in_rows x in_cols x cin`` input region (incl. halo)."""
    flops = 2.0 * out_rows * out_cols * cout_tile * cin * kh * kw
    bytes_accessed = dtype_bytes * (
        in_rows * in_cols * cin
        + kh * kw * cin * cout_tile
        + out_rows * out_cols * cout_tile
    )
    return OpCost(flops, bytes_accessed)


def pool2d_slice_cost(
    in_rows: int, in_cols: int, c_tile: int, k: int,
    out_rows: int, out_cols: int, dtype_bytes: int = 4,
) -> OpCost:
    flops = 1.0 * out_rows * out_cols * c_tile * k * k
    bytes_accessed = dtype_bytes * (
        in_rows * in_cols * c_tile + out_rows * out_cols * c_tile
    )
    return OpCost(flops, bytes_accessed)


def attention_cost(
    seq: int, head_dim: int, n_heads: int, dtype_bytes: int = 4
) -> OpCost:
    """Scaled-dot-product attention over ``n_heads`` heads (QK^T, softmax,
    PV).  Linear in ``n_heads``, so head-block slices conserve FLOPs."""
    per_head_flops = 2.0 * seq * seq * head_dim * 2 + 8.0 * seq * seq
    per_head_bytes = dtype_bytes * (4.0 * seq * head_dim + 2.0 * seq * seq)
    return OpCost(n_heads * per_head_flops, n_heads * per_head_bytes)
