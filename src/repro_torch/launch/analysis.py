"""A cell's step, counted: FLOPs, kernel launches and bytes, beside the
analytic roofline.

Port of ``repro/launch/analysis.py``.  The reference lowers and compiles
each cell with XLA and reads ``cost_analysis()`` and ``memory_analysis()``;
the port has no compiler to ask, so it runs the step and counts it:

- :func:`build_cell` (the counterpart of ``lower_cell``) makes the port's
  step (``train/loop.py::make_train_step``, ``serve/engine.py``'s
  ``make_prefill_step``/``make_decode_step``) and its operands on a device:
  ``meta`` (shapes alone, nothing allocated or launched), the CPU or the
  card;
- :func:`count_step` runs it inside a ``kernels._work.WorkLog``: the aten
  ops' FLOPs (``torch.utils.flop_counter``), each kernel call's own
  ``work()`` recorded once at its entry (so a call counts the same work on
  ``meta``, the CPU and the card; backward kernels too, as
  ``flash_attention[mma_bwd]``, ``swiglu_matmul[wgmma_bwd]``,
  ``ssd_scan[wgmma_bwd]``: their ``work_bwd()``), each kernel
  VJP's FLOPs on their own, the launches (``LIBRARY.counts``), the
  operands' bytes and the peak of what the step allocates;
- :func:`analyze_cell` sets the count beside :func:`attach_analytic`'s
  terms and the chip's memory; :func:`validate_probe` holds the count of a
  shallow full-width probe against the analytic model, by component.

On the CPU a train step's backward runs through the plain versions (autograd
through their aten ops), on ``meta`` and the card through the backward
kernels and the VJPs: the two counts differ by design.  Prefill and decode count the same on all
three.  ``moe_impl="scatter"`` has shapes that depend on the routing and
cannot run on ``meta``; it is counted on real tensors only.

The reference's ``collective_bytes`` (a parser of partitioned HLO text) has
no counterpart: there is no HLO, and one card has no collectives.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, skip_reason
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import LIBRARIES
from repro_torch.kernels._work import WorkLog
from repro_torch.launch.mesh import CARD_MESH, mesh_name, production_mesh_shape
from repro_torch.launch.roofline_model import (
    H100, Chip, Terms, _attn_layer, _ssm_layer, analytic_terms,
)
from repro_torch.launch.specs import (
    cell_pspecs, default_bf16_moments, input_specs, microbatches_for, per_device_bytes,
)
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.engine import ServeConfig, make_decode_step, make_prefill_step
from repro_torch.train.loop import TrainConfig, make_train_step

__all__ = ["ART_DIR", "model_flops", "build_cell", "count_step", "tensor_bytes", "finite",
           "analyze_cell", "attach_analytic", "probe_config", "validate_probe", "run_cell",
           "MESHES"]

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun_torch")
MESHES = {"card": CARD_MESH, "single": production_mesh_shape(False),
          "multi": production_mesh_shape(True)}


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (fwd)."""
    _total, active = cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def build_cell(cfg: ArchConfig, shape: ShapeSpec, device="meta", moe_impl: str = "einsum",
               microbatches: Optional[int] = None, bf16_moments: Optional[bool] = None,
               mesh_shape=CARD_MESH, seed: int = 0) -> Tuple[Callable, tuple, Dict[str, Any]]:
    """(step, args, meta): the cell's step and its operands on ``device``
    (bf16 weights; on a real device drawn from a generator seeded with
    ``seed``, as ``init_params`` draws them, and inputs from
    ``specs.input_specs``), ready for ``step(*args)``.  Train: AdamW with
    ``microbatches`` (default ``microbatches_for`` on ``mesh_shape``) and
    remat, f32 moments or bf16 (default: the reference's rule)."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen if gen is not None else torch.Generator(), device=dev)
    inputs = input_specs(cfg, shape, dev, gen)
    if shape.kind == "train":
        mb = microbatches if microbatches is not None else microbatches_for(cfg, shape,
                                                                           mesh_shape)
        bf16_m = default_bf16_moments(cfg) if bf16_moments is None else bf16_moments
        tcfg = TrainConfig(microbatches=mb, remat=True, moe_impl=moe_impl,
                           optim=AdamWConfig(bf16_moments=bf16_m))
        opt = adamw_init(dict(params.named_parameters()), tcfg.optim)
        meta = {"microbatches": mb, "bf16_moments": bf16_m, "moe_impl": moe_impl}
        return make_train_step(cfg, tcfg), (params, opt, inputs), meta
    scfg = ServeConfig(max_seq=shape.seq_len, moe_impl=moe_impl)
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
    meta = {"moe_impl": moe_impl}
    if shape.kind == "prefill":
        return make_prefill_step(cfg, scfg), (params, cache, inputs), meta
    return make_decode_step(cfg, scfg), (params, cache, inputs["tokens"]), meta


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of modules (their parameters), dicts, lists and
    tuples."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree of modules, dicts, lists and tuples,
    each storage once."""
    seen = {id(s): s.nbytes() for s in (t.untyped_storage() for t in _tensors(tree))}
    return sum(seen.values())


def count_step(step: Callable, args: tuple) -> Dict[str, Any]:
    """Run ``step(*args)`` once, counted.  Returns ``flops`` (the total),
    ``components`` (FLOPs by aten op, ``"aten.mm"``, ..., by kernel variant,
    ``"flash_attention[mma]"``, ``"flash_attention[mma_bwd]"``, ..., and by
    kernel VJP,
    ``"flash_attention.vjp"``, ...), ``kernels`` (per kernel variant: calls,
    FLOPs, bytes of its ``work()``), ``launches`` (per kernel and variant:
    what ``LIBRARY.counts`` rose by; 0 on the CPU, which launches nothing),
    ``argument_bytes`` (the operands), ``peak_bytes`` (the most the step's
    own allocations held at once), ``device_peak_bytes`` (on the card: the
    allocator's peak over the step, operands included; otherwise None),
    ``unbatched_flops`` (the products with no batch dim: ``kernels._work``)
    and ``outputs`` (what the step returned)."""
    before = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    cuda = any(t.is_cuda for t in _tensors(args))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with WorkLog() as log:
        out = step(*args)
    device_peak = torch.cuda.max_memory_allocated() if cuda else None
    components = {op: n for op, n in log.aten.items() if n}
    kernels = {}
    for (kernel, variant), (calls, flops, nbytes) in sorted(log.calls.items()):
        name = f"{kernel}.vjp" if variant == "vjp" else f"{kernel}[{variant}]"
        components[name] = components.get(name, 0.0) + flops
        if variant != "vjp":
            kernels[name] = {"calls": calls, "flops": flops, "bytes": nbytes}
    launches = {lib.name: {v: n - before[lib.name][v] for v, n in lib.counts.items()}
                for lib in LIBRARIES}
    return {"flops": sum(components.values()), "components": components, "kernels": kernels,
            "launches": launches, "argument_bytes": tensor_bytes(args),
            "peak_bytes": log.peak, "device_peak_bytes": device_peak,
            "unbatched_flops": log.unbatched, "outputs": out}


def finite(out) -> bool:
    """Every floating tensor in a step's outputs is finite (a train step's
    metrics; prefill's and decode's logits); ``meta`` tensors hold no values
    and pass."""
    if isinstance(out, torch.Tensor):
        return out.is_meta or not out.is_floating_point() or bool(torch.isfinite(out).all())
    if isinstance(out, dict):
        return all(finite(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return all(finite(v) for v in out)
    return True


def attach_analytic(rec: Dict[str, Any], cfg: ArchConfig, shape: ShapeSpec,
                    mesh_shape, moe_impl: str = "einsum", chip: Chip = H100) -> None:
    """Add the analytic roofline terms under ``chip`` (the reference's, with
    the chip a parameter) and make them the record's headline roofline."""
    meta = rec.get("meta", {})
    ana = analytic_terms(
        cfg, shape, mesh_shape, moe_impl=meta.get("moe_impl", moe_impl),
        microbatches=meta.get("microbatches"),
        bf16_moments=meta.get("bf16_moments"), chip=chip,
    )
    rec["analytic"] = ana
    rec["roofline"] = ana["roofline"]
    rec["dominant"] = ana["dominant"]
    rec["useful_flops_ratio"] = ana["useful_flops_ratio"]
    rec["model_flops_per_dev"] = ana["model_flops_per_dev"]
    rec["roofline_fraction"] = ana["roofline_fraction"]
    rec["step_time_bound_s"] = ana["step_time_bound_s"]


def analyze_cell(cfg: ArchConfig, shape: ShapeSpec, mesh_shape=CARD_MESH, device="meta",
                 chip: Chip = H100, moe_impl: str = "einsum",
                 microbatches: Optional[int] = None,
                 bf16_moments: Optional[bool] = None) -> Dict[str, Any]:
    """One cell.  On ``CARD_MESH`` the step is built on ``device`` and
    counted (:func:`count_step`): its FLOPs, launches and peak, with the
    operands' bytes, and ``hbm_ok`` when operands and peak fit
    ``chip.hbm_bytes``.  A train step of ``microbatches`` > 1 runs that
    many forward-backward passes of one microbatch's shapes, each doing the
    same work, and one AdamW update (no products): it is counted as the
    step of one microbatch, its FLOPs and launches times ``microbatches``,
    its peak plus the f32 gradient accumulator the longer step holds.  On
    a mesh of several devices nothing runs: the operands' bytes a device
    holds under the cell's partition specs stand for its memory.  Both
    carry the analytic terms (:func:`attach_analytic`)."""
    n_dev = 1
    for v in mesh_shape.values():
        n_dev *= v
    if shape.kind == "train" and microbatches is None:
        microbatches = microbatches_for(cfg, shape, mesh_shape)
    if shape.kind == "train" and bf16_moments is None:
        bf16_moments = default_bf16_moments(cfg)
    cell = cell_pspecs(cfg, shape, mesh_shape, bf16_moments=bf16_moments)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_name(mesh_shape), "n_devices": n_dev, "chip": chip.name,
        "meta": ({"microbatches": microbatches, "bf16_moments": bf16_moments,
                  "moe_impl": moe_impl} if shape.kind == "train" else {"moe_impl": moe_impl}),
        "argument_bytes_per_dev": per_device_bytes(cell, mesh_shape),
    }
    if n_dev == 1:
        t0 = time.monotonic()
        mb = microbatches if shape.kind == "train" else 1
        one = ShapeSpec(shape.name, shape.kind, shape.seq_len, shape.global_batch // mb)
        step, args, _ = build_cell(cfg, one, device, moe_impl, 1, bf16_moments)
        count = count_step(step, args)
        n_params = sum(p.numel() for p in args[0].parameters())
        del step, args
        count.pop("outputs")
        rec["count_s"] = round(time.monotonic() - t0, 2)
        rec["device"] = str(device)
        rec["flops"] = count["flops"] * mb
        rec["components"] = {k: v * mb for k, v in count["components"].items()}
        rec["kernels"] = {k: {f: v * mb for f, v in row.items()}
                          for k, row in count["kernels"].items()}
        rec["launches"] = {lib: {v: n * mb for v, n in row.items()}
                           for lib, row in count["launches"].items()}
        rec["argument_bytes"] = rec["argument_bytes_per_dev"]
        rec["peak_bytes"] = count["peak_bytes"] + (4 * n_params if mb > 1 else 0)
        rec["hbm_per_dev_bytes"] = rec["argument_bytes"] + rec["peak_bytes"]
    else:
        rec["hbm_per_dev_bytes"] = rec["argument_bytes_per_dev"]
    rec["hbm_ok"] = bool(rec["hbm_per_dev_bytes"] <= chip.hbm_bytes)
    rec["model_flops_total"] = model_flops(cfg, shape)
    attach_analytic(rec, cfg, shape, mesh_shape, moe_impl, chip)
    if "flops" in rec:
        rec["counted_over_analytic"] = rec["flops"] / rec["analytic"]["flops_per_dev"]
    return rec


def probe_config(cfg: ArchConfig) -> ArchConfig:
    """Shallow (1-2 unit) variant of an arch for unrolled probe lowering."""
    import dataclasses as dc

    if cfg.hybrid is not None:
        return dc.replace(cfg, n_layers=cfg.hybrid.attn_period)
    if cfg.moe is not None and cfg.moe.first_dense:
        return dc.replace(cfg, n_layers=cfg.moe.first_dense + 1)
    return dc.replace(cfg, n_layers=2)


def analytic_cores(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, float]:
    """The analytic model's attention core (QKᵀ and PV over all S² scores)
    and SSD core (conv and chunked scan), with train's multiplier, on one
    device: the components the kernels, their backward kernels and their
    VJPs count."""
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    mult_core = 4.0 if kind == "train" else 1.0
    attn, ssm = Terms(), Terms()
    for i in range(cfg.n_layers):
        if cfg.family == "ssm" or (cfg.hybrid and not cfg.is_attn_layer(i)):
            _ssm_layer(cfg, B, S, kind, ssm, 1, 0.0, mult_core)
        else:
            _attn_layer(cfg, B, S, kind, attn, 1, 1, 1, 0.0, mult_core)
    return {"attention_core": attn.flops, "ssd_core": ssm.flops}


def _core_flops(components: Dict[str, float], kernel: str) -> float:
    return sum(n for name, n in components.items() if name.split("[")[0].split(".")[0] == kernel)


def validate_probe(arch: str, kind: str, device="meta", seq: int = 1024, batch: int = 16,
                   moe_impl: str = "einsum", chip: Chip = H100,
                   timer: Optional[Callable[[Callable], float]] = None) -> Dict[str, Any]:
    """Count a probe (``probe_config`` depth, full width, one microbatch,
    f32 moments) on ``device`` and hold it against the analytic terms, in
    total and by component: the attention core (the flash kernel and its
    backward against all S² scores: the kernel's causal calls count only the
    pairs the mask leaves) and the SSD core (the scan and its backward, the
    ``wgmma_bwd`` kernel's ``work_bwd`` or the VJP's aten FLOPs, against the
    conv and the chunked scan); ``rest`` is everything else.
    ``finite``: the counted step's outputs are finite (they are not kept).
    With ``timer``, also ``ms``: ``timer(call)`` of the same step, called
    again."""
    cfg = probe_config(get_config(arch))
    shape = ShapeSpec(f"probe_{kind}", kind, seq, batch)
    step, args, meta = build_cell(cfg, shape, device, moe_impl, microbatches=1,
                                  bf16_moments=False)
    count = count_step(step, args)
    ok = finite(count.pop("outputs"))
    ana = analytic_terms(cfg, shape, CARD_MESH, moe_impl=moe_impl, microbatches=1,
                         bf16_moments=False, chip=chip)
    cores = analytic_cores(cfg, shape)
    counted = {"attention_core": _core_flops(count["components"], "flash_attention"),
               "ssd_core": _core_flops(count["components"], "ssd_scan")}
    counted["rest"] = count["flops"] - sum(counted.values())
    analytic = dict(cores, rest=ana["flops_per_dev"] - sum(cores.values()))
    rec = {
        "arch": arch, "kind": kind, "seq": seq, "batch": batch, "device": str(device),
        "meta": meta, "count": count, "finite": ok,
        "analytic": {"flops": ana["flops_per_dev"], "bytes": ana["bytes_per_dev"],
                     "step_time_bound_s": ana["step_time_bound_s"]},
        "model_flops": model_flops(cfg, shape),
        "ratio": {"flops": count["flops"] / ana["flops_per_dev"],
                  **{k: (counted[k] / analytic[k] if analytic[k] else None) for k in counted}},
    }
    if timer is not None:
        rec["ms"] = timer(lambda: step(*args))
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str = ART_DIR,
             force: bool = False, **kw) -> Dict[str, Any]:
    """One cell of the dry run, written to ``<out_dir>/<arch>__<shape>__<mesh>.json``
    (and read back from there unless ``force``)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape_name)
    if reason is not None:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": reason}
    else:
        try:
            rec = analyze_cell(cfg, SHAPES[shape_name], MESHES[mesh_kind], **kw)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            raise
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec
