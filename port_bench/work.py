"""The yardstick: peaks of the card and the work of each kernel call.

A frozen copy of the port's ``kernels/{flash_attention,swiglu_matmul,
ssd_scan}.py::work`` / ``work_bwd`` and ``launch/roofline_model.py::H100``,
so that a change to the program cannot move what its kernels are measured
against.  Two rules keep the work independent of what implements it: the
SSD scan's chunk is fixed at :data:`SSD_CHUNK`, and expert products count
the routed rows (tokens × top-k), never capacity padding.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM5 80GB data sheet, dense rates at the 700 W limit
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_F32 = 67e12        # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12        # bytes/s
SSD_CHUNK = 64


def bound_ms(flops: float, nbytes: float, elem: int) -> Tuple[float, str]:
    """The least time of a call: the larger of bytes over the bandwidth and
    operations over the peak of its type (``elem`` 2: bf16, 4: f32)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / (PEAK_BF16 if elem == 2 else PEAK_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs a causal call computes: query i sees keys
    j <= i + Sk - Sq, so the sum of the integers from max(1, Sk - Sq + 1)
    to Sk."""
    lo = max(1, Sk - Sq + 1)
    return (Sk * (Sk + 1) - (lo - 1) * lo) // 2 if Sk >= lo else 0


def flash(BH: int, Sq: int, Sk: int, D: int, causal: bool, elem: int, Dv: int = None):
    Dv = D if Dv is None else Dv
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    nbytes = (BH * Sq * D + BH * Sk * D + BH * Sk * Dv + BH * Sq * Dv) * elem
    return 2.0 * BH * pairs * (D + Dv), nbytes


def flash_bwd(BH: int, Sq: int, Sk: int, D: int, causal: bool, elem: int, Dv: int = None):
    Dv = D if Dv is None else Dv
    ops, _ = flash(BH, Sq, Sk, D, causal, elem, Dv)
    nbytes = (2 * (BH * Sq * D + BH * Sk * D + BH * Sk * Dv) + 2 * BH * Sq * Dv) * elem
    return 2.5 * ops, nbytes + 2 * BH * Sq * 4


def swiglu(M: int, D: int, F: int, elem: int, E: int = 1):
    """E products of M rows each: x·wg and x·wu, x and both weights read,
    the output written."""
    return 4.0 * E * M * D * F, E * (M * D + 2 * D * F + M * F) * elem


def swiglu_bwd(M: int, D: int, F: int, elem: int, E: int = 1):
    return 4.0 * E * M * D * F, E * (M * D + 2 * D * F + 3 * M * F) * elem


def experts(rows: int, E: int, D: int, F: int, elem: int):
    """The routed experts' gate/up products over ``rows`` routed rows
    (tokens × top-k) in all: every expert's weights read once."""
    return 4.0 * rows * D * F, (rows * D + 2 * E * D * F + rows * F) * elem


def ssd(heads: int, groups: int, S: int, P: int, N: int, elem: int, chunk: int = SSD_CHUNK):
    nbytes = ((2 * heads * S * P + 2 * groups * S * N) * elem + heads * S * 4 + heads * 4
              + heads * P * N * 4)
    Q = chunk
    macs = -(-S // Q) * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * P * N)
    return 2.0 * heads * macs, nbytes


def ssd_bwd(heads: int, groups: int, S: int, P: int, N: int, elem: int, chunk: int = SSD_CHUNK):
    Q, nc = chunk, -(-S // chunk)
    nbytes = (3 * heads * S * P + 4 * groups * S * N) * elem + 2 * heads * S * 4 + 2 * heads * 4
    ops = 2.0 * nc * (heads * (6 * Q * P * N + 2 * Q * Q * P) + groups * 3 * Q * Q * N)
    return ops, nbytes


# --------------------------------------------------------------------------- #
# the kernels' bound along the benchmark's paths
# --------------------------------------------------------------------------- #
def _ms(work, elem: int) -> float:
    return bound_ms(*work, elem)[0]


def tick_work(arch: Dict, kinds, prefills, rows: int, elem: int = 2) -> Dict[str, list]:
    """[calls, Σ bound ms] by kernel family (``ssd``, ``flash``, ``swiglu``,
    ``experts``) in one engine tick: a prefill of each length in
    ``prefills`` and, where ``rows`` > 0, one decode of ``rows`` live
    sequences; one call a layer that has the family, per prefill and per
    decode."""
    out: Dict[str, list] = {}
    calls = [c for L in prefills for c in _prefill_calls(arch, kinds, L, elem)]
    if rows:
        calls += _decode_calls(arch, kinds, rows, elem)
    for fam, ms in calls:
        acc = out.setdefault(fam, [0, 0.0])
        acc[0] += 1
        acc[1] += ms
    return out


def _prefill_calls(arch: Dict, kinds, L: int, elem: int):
    d = arch["d_model"]
    calls = []
    for mixer, ffn in kinds:
        if mixer == "ssm":
            s = arch["ssm"]
            d_in = s["expand"] * d
            calls.append(("ssd", _ms(ssd(d_in // s["head_dim"], s["n_groups"], L,
                                         s["head_dim"], s["d_state"], elem), elem)))
        else:
            calls.append(("flash", _ms(flash(arch["n_heads"], L, L, arch["head_dim"], True,
                                             elem), elem)))
        calls += _ffn_calls(arch, ffn, L, elem)
    return calls


def _decode_calls(arch: Dict, kinds, rows: int, elem: int):
    return [c for _, ffn in kinds for c in _ffn_calls(arch, ffn, rows, elem)]


def _ffn_calls(arch: Dict, ffn: str, rows: int, elem: int):
    d = arch["d_model"]
    if ffn == "dense":
        return [("swiglu", _ms(swiglu(rows, d, arch["d_ff"], elem), elem))]
    if ffn == "moe":
        m = arch["moe"]
        return [("experts", _ms(experts(rows * m["top_k"], m["n_experts"], d,
                                        m["d_ff_expert"], elem), elem))]
    return []


def ssd_call_ms(arch: Dict, rows: int, S: int, backward: bool, elem: int = 2) -> float:
    """The bound of one SSD scan call (or its backward) over ``rows``
    sequences of S tokens in the mixer's layout."""
    s = arch["ssm"]
    H = s["expand"] * arch["d_model"] // s["head_dim"]
    fn = ssd_bwd if backward else ssd
    return _ms(fn(rows * H, rows * s["n_groups"], S, s["head_dim"], s["d_state"], elem), elem)
