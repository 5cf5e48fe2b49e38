"""The port's launch accounting (``launch/specs.py``, ``launch/analysis.py``,
``launch/dryrun.py``, ``launch/postprocess.py``, ``kernels/_work.py``) and
the ``meta`` path of the kernel entries, against the reference and against
themselves.

- ``input_specs``, ``microbatches_for`` and ``cell_pspecs`` give the
  reference's shapes, depths and partition specs (``cell_pspecs`` against
  the reference's ``tree_pspecs``/``logical_to_pspec`` on the card and both
  production meshes).
- ``ParamDef.materialize``/``init_tree`` draw what ``init_params`` draws.
- Each kernel entry takes ``meta`` tensors, forward and backward: empty
  outputs of the kernel's shapes, one count of the variant a CUDA call
  would launch, its ``work()`` recorded once.
- A step counted on ``meta`` equals the same step counted on the CPU, for
  prefill and decode of every family (on the CPU the plain versions run, and
  their aten ops are not counted again); train differs by design (the CPU
  trains through the plain versions, ``meta`` and the card through the
  kernels' VJPs).
- The count stands against the reference's XLA count (``analyze_cell`` on a
  1 x 1 mesh with Auto axes, every scan unrolled) within 10%, with the
  differences explained by component (``test_count_against_xla``).
- A kernel entry that records no work is caught.
"""
import dataclasses
import importlib
import json
import types

import numpy as np
import pytest
import torch

from _torch_cnn_cases import one_intra_op_thread  # noqa: F401  (autouse)
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models import transformer as jax_T
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import SHAPES, get_config, list_archs, runnable_cells
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import LIBRARIES
from repro_torch.kernels._work import WorkLog
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun, postprocess
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import CARD_MESH, production_mesh_shape
from repro_torch.models import init_params, layer_plan
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import ParamDef, init_tree
from repro_torch.train.loop import TrainConfig, make_train_step

fa = importlib.import_module("repro_torch.kernels.flash_attention")
sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
MESHES = {"card": CARD_MESH, "single": production_mesh_shape(False),
          "multi": production_mesh_shape(True)}
CELLS = [(a, s) for a in list_archs() for s in runnable_cells(get_config(a))]
# one arch of each family
FAMILIES = {"dense": "tinyllama-1.1b", "mla_moe": "deepseek-v2-lite-16b", "ssm": "mamba2-370m",
            "hybrid": "jamba-v0.1-52b", "encoder": "hubert-xlarge",
            "vlm": "llava-next-mistral-7b"}


def _fake_mesh(shape):
    """What the reference's ``microbatches_for`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(shape),
                                 devices=np.empty(tuple(shape.values())))


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of nested dicts; a spec as a plain tuple."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree) if not isinstance(tree, torch.Tensor) else tree}


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_microbatches_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = S.input_specs(cfg, SHAPES[shape])
    want = jax_specs.input_specs(jcfg, JAX_SHAPES[shape])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).split(".")[-1] == np.dtype(want[k].dtype).name
    for mesh in MESHES.values():
        assert S.microbatches_for(cfg, SHAPES[shape], mesh) == jax_specs.microbatches_for(
            jcfg, JAX_SHAPES[shape], _fake_mesh(mesh))


def test_input_values_on_a_device():
    cfg = get_config("llava-next-mistral-7b").reduced()
    got = S.input_specs(cfg, ShapeSpec("t", "train", 32, 3), "cpu",
                        torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "embeds": (3, 16, cfg.d_model), "tokens": (3, 16), "labels": (3, 16)}
    assert int(got["tokens"].min()) >= 0 and int(got["tokens"].max()) < cfg.vocab
    with pytest.raises(ValueError):
        S.input_specs(cfg, ShapeSpec("t", "train", 32, 3), "cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cell_pspecs_equal_the_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ms = MESHES[mesh]
    jdefs = jax_T.model_defs(jcfg)
    for shape in runnable_cells(cfg):
        sp = SHAPES[shape]
        cell = S.cell_pspecs(cfg, sp, ms)
        train = sp.kind == "train"
        rules = jax_sharding.TRAIN_RULES if train else jax_sharding.SERVE_RULES
        assert _flat(cell.pspecs[0]) == _flat(jax_sharding.tree_pspecs(jdefs, rules, ms))
        inputs = jax_specs.input_specs(jcfg, JAX_SHAPES[shape])

        def batch(v):
            axes = ["batch"] + [None] * (len(v.shape) - 1)
            return tuple(jax_sharding.logical_to_pspec(axes, v.shape,
                                                       jax_sharding.TRAIN_RULES, ms))
        if train:
            opt = jax_sharding.tree_pspecs(jdefs, jax_sharding.OPT_RULES, ms)
            assert _flat(cell.pspecs[1]["m"]) == _flat(opt) == _flat(cell.pspecs[1]["v"])
            assert cell.pspecs[1]["step"] == ()
            assert {k: tuple(v) for k, v in cell.pspecs[2].items()} == {
                k: batch(v) for k, v in inputs.items()}
            assert cell.donate_argnums == (0, 1)
            continue
        cache = jax_sharding.tree_pspecs(
            jax_T.cache_model_defs(jcfg, sp.global_batch, sp.seq_len),
            jax_sharding.SERVE_RULES, ms)["segments"]
        assert _flat(cell.pspecs[1]["segments"]) == _flat(cache)
        assert cell.pspecs[1]["pos"] == () and cell.donate_argnums == (1,)
        if sp.kind == "prefill":
            assert {k: tuple(v) for k, v in cell.pspecs[2].items()} == {
                k: batch(v) for k, v in inputs.items()}
        else:
            assert tuple(cell.pspecs[2]) == batch(inputs["tokens"])


@pytest.mark.parametrize("bf16_moments", [None, True, False])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b"])
def test_cell_moments_follow_adamw(arch, bf16_moments):
    """f32 moments, bf16 where ``bf16_moments`` says (by default above 2e11
    parameters: Arctic), as the reference's ``lower_cell`` sets them."""
    cfg = get_config(arch)
    cell = S.cell_pspecs(cfg, SHAPES["train_4k"], CARD_MESH, bf16_moments=bf16_moments)
    want = bf16_moments if bf16_moments is not None else arch == "arctic-480b"
    dtypes = {t.dtype for t in _flat(cell.abstract_args[1]["m"]).values()}
    assert dtypes == {torch.bfloat16 if want else torch.float32}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_per_device_bytes(arch, shape, mesh):
    """Each leaf's bytes over the ways the reference's spec splits it."""
    cfg, jcfg, ms = get_config(arch), jax_get_config(arch), MESHES[mesh]
    cell = S.cell_pspecs(cfg, SHAPES[shape], ms)
    want = 0.0
    for arg, spec in zip(cell.abstract_args, cell.pspecs):
        leaves, specs = _flat(arg), _flat(spec)
        for path, t in leaves.items():
            ways = 1
            for names in specs[path]:
                for nm in (() if names is None else
                           names if isinstance(names, tuple) else (names,)):
                    ways *= ms[nm]
            want += t.numel() * t.element_size() / ways
    assert S.per_device_bytes(cell, ms) == pytest.approx(want, rel=1e-12)
    if mesh == "card":
        assert S.per_device_bytes(cell, ms) == A.tensor_bytes(cell.abstract_args)


@pytest.mark.parametrize("arch", list(FAMILIES.values()))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_built_operands_are_the_cell_specs(arch, kind):
    """The step's operands, as ``build_cell`` makes them, hold the bytes the
    cell's specs hold (the port's int64 ``pos`` for the reference's int32)."""
    cfg = get_config(arch).reduced()
    if kind == "decode" and cfg.encoder_only:
        kind = "prefill"
    shape = ShapeSpec("s", kind, 64, 4)
    _, args, _ = A.build_cell(cfg, shape, "meta", microbatches=1, bf16_moments=False)
    cell = S.cell_pspecs(cfg, shape, CARD_MESH, bf16_moments=False)
    assert A.tensor_bytes(args) == A.tensor_bytes(cell.abstract_args)


# --------------------------------------------------------------------------- #
# materialize / init_tree
# --------------------------------------------------------------------------- #
def test_materialize():
    g = torch.Generator().manual_seed(3)
    d = ParamDef((5, 8), ("embed", "ffn"))
    want = (torch.randn((5, 8), generator=torch.Generator().manual_seed(3)) * 5 ** -0.5)
    got = d.materialize(g)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    g2 = torch.Generator().manual_seed(3)
    torch.randn((5, 8), generator=g2)
    assert torch.equal(d.materialize(g, dtype=torch.float32),
                       torch.randn((5, 8), generator=g2) * 5 ** -0.5)
    assert torch.equal(ParamDef((4,), (None,), init="ones").materialize(g),
                       torch.ones(4, dtype=torch.bfloat16))
    assert torch.equal(ParamDef((4,), (None,), init="zeros", dtype=torch.float32)
                       .materialize(g), torch.zeros(4))
    state = g.get_state()
    m = d.materialize(g, "meta")
    assert m.device.type == "meta" and tuple(m.shape) == (5, 8)
    assert torch.equal(g.get_state(), state)  # nothing drawn on meta
    with pytest.raises(ValueError):
        ParamDef((2,), (None,), init="uniform").materialize(g)


def test_init_tree_draws_in_tree_order():
    defs = {"a": ParamDef((3, 4), ("embed", None)),
            "b": {"c": ParamDef((2,), (None,), init="ones"),
                  "d": ParamDef((4, 2), (None, None), scale=0.5)}}
    got = init_tree(defs, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(1)
    a = (torch.randn((3, 4), generator=g) * 3 ** -0.5).to(torch.bfloat16)
    d = (torch.randn((4, 2), generator=g) * 0.5).to(torch.bfloat16)
    assert torch.equal(got["a"], a) and torch.equal(got["b"]["d"], d)
    assert torch.equal(got["b"]["c"], torch.ones(2, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_init_params_draws_each_leaf_through_materialize(arch, dtype):
    """``init_params`` = each named leaf materialised in parameter order from
    one generator (the draw ``tests/test_torch_serve.py`` pins)."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu", dtype=dtype)
    g = torch.Generator().manual_seed(5)
    defs = T.named_defs(cfg)
    for name, p in model.named_parameters():
        assert not p.requires_grad
        assert torch.equal(p, defs[name].materialize(g, "cpu", p.dtype)), name
    meta = init_params(cfg, torch.Generator(), device="meta")
    assert all(p.device.type == "meta" for p in meta.parameters())


# --------------------------------------------------------------------------- #
# the kernel entries on meta
# --------------------------------------------------------------------------- #
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)


def _one_launch(lib, variant, fn):
    before = dict(lib.counts)
    with WorkLog() as log:
        out = fn()
    moved = {v: n - before[v] for v, n in lib.counts.items() if n != before[v]}
    assert moved == {variant: 1}
    return out, log


@pytest.mark.parametrize("D,Dv,dtype,variant", [
    (64, 64, torch.bfloat16, "mma"), (192, 128, torch.bfloat16, "mma"),
    (64, 64, torch.float32, "cuda_core"), (40, 40, torch.bfloat16, "cuda_core")])
def test_flash_attention_on_meta(D, Dv, dtype, variant):
    q, k, v = _meta(6, 100, D, dtype=dtype), _meta(6, 130, D, dtype=dtype), _meta(
        6, 130, Dv, dtype=dtype)
    o, log = _one_launch(fa.LIBRARY, variant, lambda: fa.flash_attention(q, k, v, causal=True))
    assert (tuple(o.shape), o.dtype, o.device.type) == ((6, 100, Dv), dtype, "meta")
    assert log.calls == {("flash_attention", variant): [1, *fa.work(6, 100, 130, D, True,
                                                                     q.element_size(), Dv)]}
    with WorkLog() as log:
        o.sum().backward()
    assert [tuple(t.grad.shape) for t in (q, k, v)] == [(6, 100, D), (6, 130, D), (6, 130, Dv)]
    if variant == "mma":  # the backward kernel: its work, recorded once
        assert log.calls == {("flash_attention", "wgmma_bwd"): [
            1, *fa.work_bwd(6, 100, 130, D, True, q.element_size(), Dv)]}
    else:  # the explicit VJP: its aten FLOPs
        assert list(log.calls) == [("flash_attention", "vjp")] and log.calls[
            ("flash_attention", "vjp")][1] > 0


@pytest.mark.parametrize("M,D,F,dtype,variant", [
    (8, 256, 96, torch.bfloat16, "decode"), (64, 256, 96, torch.bfloat16, "wgmma"),
    (64, 256, 96, torch.float32, "cuda_core"), (64, 100, 70, torch.bfloat16, "cuda_core")])
def test_swiglu_on_meta(M, D, F, dtype, variant):
    x, wg, wu = _meta(M, D, dtype=dtype), _meta(D, F, dtype=dtype), _meta(D, F, dtype=dtype)
    o, log = _one_launch(sw.LIBRARY, variant, lambda: sw.swiglu_matmul(x, wg, wu))
    assert (tuple(o.shape), o.dtype, o.device.type) == ((M, F), dtype, "meta")
    assert log.calls == {("swiglu_matmul", variant): [1, *sw.work(M, D, F, x.element_size())]}
    o.sum().backward()
    assert [tuple(t.grad.shape) for t in (x, wg, wu)] == [(M, D), (D, F), (D, F)]
    E = 3
    x, wg, wu = (_meta(E, M, D, dtype=dtype), _meta(E, D, F, dtype=dtype),
                 _meta(E, D, F, dtype=dtype))
    o, log = _one_launch(sw.LIBRARY, "experts_" + variant, lambda: sw.swiglu_experts(x, wg, wu))
    assert tuple(o.shape) == (E, M, F)
    assert log.calls == {("swiglu_matmul", "experts_" + variant): [
        1, *sw.work(M, D, F, x.element_size(), E=E)]}
    with WorkLog() as log:
        o.sum().backward()
    assert tuple(x.grad.shape) == (E, M, D) and ("swiglu_matmul", "vjp") in log.calls
    assert (("swiglu_matmul", "experts_wgmma_bwd") in log.calls) == (dtype == torch.bfloat16
                                                                     and D % 8 == F % 8 == 0)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("P,N,dtype,variant", [(64, 128, torch.bfloat16, "wgmma"),
                                               (64, 16, torch.float32, "cuda_core"),
                                               (32, 16, torch.bfloat16, "cuda_core")])
def test_ssd_on_meta(P, N, dtype, variant, return_state):
    BH, Sq = 4, 100
    x, B, C = _meta(BH, Sq, P, dtype=dtype), _meta(BH, Sq, N, dtype=dtype), _meta(
        BH, Sq, N, dtype=dtype)
    dt, A2 = _meta(BH, Sq, dtype=torch.float32), _meta(BH, dtype=torch.float32)
    out, log = _one_launch(ssd.LIBRARY, variant,
                           lambda: ssd.ssd_scan(x, dt, A2, B, C, return_state=return_state))
    y = out[0] if return_state else out
    assert (tuple(y.shape), y.dtype, y.device.type) == ((BH, Sq, P), dtype, "meta")
    if return_state:
        assert tuple(out[1].shape) == (BH, P, N) and out[1].dtype == torch.float32
    assert log.calls == {("ssd_scan", variant): [
        1, *ssd.work(BH, BH, Sq, P, N, x.element_size(), ssd.CHUNK[variant])]}
    y.sum().backward()
    assert tuple(x.grad.shape) == (BH, Sq, P) and tuple(dt.grad.shape) == (BH, Sq)
    # the mixer's layout: head h reads group h // (H/G); one record a call
    Bsz, H, G = 2, 4, 2
    xm, dtm, Am = _meta(Bsz, Sq, H, P, dtype=dtype), _meta(Bsz, Sq, H), _meta(H)
    Bm, Cm = _meta(Bsz, Sq, G, N, dtype=dtype), _meta(Bsz, Sq, G, N, dtype=dtype)
    out, log = _one_launch(ssd.LIBRARY, variant, lambda: ssd.ssd_mixer(
        xm, dtm, Am, Bm, Cm, return_state=return_state))
    y = out[0] if return_state else out
    assert tuple(y.shape) == (Bsz, Sq, H, P)
    groups = Bsz * (G if variant == "wgmma" else H)
    assert log.calls == {("ssd_scan", variant): [
        1, *ssd.work(Bsz * H, groups, Sq, P, N, xm.element_size(), ssd.CHUNK[variant])]}
    with WorkLog() as log:
        y.sum().backward()
    # the backward's route for this dtype: the wgmma_bwd kernel's work behind
    # wgmma (bf16), the VJP's aten FLOPs behind cuda_core
    route = ssd.select_bwd_variant(P, N, dtype)
    assert route == ("wgmma_bwd" if variant == "wgmma" else "vjp")
    assert tuple(Bm.grad.shape) == (Bsz, Sq, G, N) and list(log.calls) == [("ssd_scan", route)]
    if route == "wgmma_bwd":
        assert log.calls[("ssd_scan", route)] == [
            1, *ssd.work_bwd(Bsz * H, Bsz * G, Sq, P, N, xm.element_size())]


def test_cpu_calls_record_the_cuda_variant_and_launch_nothing():
    """On the CPU the plain versions run: the entry records the work of the
    variant a CUDA call launches, and no count moves."""
    x = torch.randn(64, 256, dtype=torch.bfloat16)
    wg, wu = torch.randn(256, 96, dtype=torch.bfloat16), torch.randn(256, 96,
                                                                     dtype=torch.bfloat16)
    before = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    with WorkLog() as log:
        sw.swiglu_matmul(x, wg, wu)
    assert log.calls == {("swiglu_matmul", "wgmma"): [1, *sw.work(64, 256, 96, 2)]}
    assert log.aten == {}  # the plain version's products are the call's recorded work
    assert before == {lib.name: dict(lib.counts) for lib in LIBRARIES}


# --------------------------------------------------------------------------- #
# counted steps
# --------------------------------------------------------------------------- #
def _count(cfg, shape, device, **kw):
    step, args, _ = A.build_cell(cfg, shape, device, microbatches=1, bf16_moments=False, **kw)
    return A.count_step(step, args)


@pytest.mark.parametrize("family,kind", [(f, k) for f in FAMILIES for k in ("prefill", "decode")
                                         if (f, k) != ("encoder", "decode")])
def test_meta_count_equals_cpu_count(family, kind):
    cfg = get_config(FAMILIES[family]).reduced()
    shape = ShapeSpec("s", kind, 64, 2)
    meta, cpu = _count(cfg, shape, "meta"), _count(cfg, shape, "cpu")
    assert meta["components"] == cpu["components"] and meta["kernels"] == cpu["kernels"]
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["argument_bytes"] == cpu["argument_bytes"]
    calls = {}
    for name, row in meta["kernels"].items():
        kernel, variant = name[:-1].split("[")
        calls.setdefault(kernel, {})[variant] = row["calls"]
    assert {k: {v: n for v, n in row.items() if n} for k, row in meta["launches"].items()
            } == {lib.name: calls.get(lib.name, {}) for lib in LIBRARIES}
    assert all(n == 0 for row in cpu["launches"].values() for n in row.values())
    assert A.finite(cpu["outputs"])


def test_train_counts_the_vjps_on_meta_and_the_plain_versions_on_the_cpu():
    """The two counts differ by design: on ``meta`` (as on the card) the
    flash, SwiGLU and causal conv backwards are kernels
    (``flash_attention[wgmma_bwd]``, ``swiglu_matmul[wgmma_bwd]``,
    ``[experts_wgmma_bwd]``, ``causal_conv[bwd]`` and ``[bwd_reduce]``; the SwiGLU's four
    products around its kernel,
    and the SSD scan's backward, PyTorch, recorded as ``<kernel>.vjp``); on
    the CPU autograd runs through the plain versions, whose backward aten
    ops count as aten ops."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    shape = ShapeSpec("s", "train", 64, 2)
    meta, cpu = _count(cfg, shape, "meta"), _count(cfg, shape, "cpu")
    bwd = {k: row for k, row in meta["kernels"].items()
           if k.endswith(("_bwd]", "[bwd]", "[bwd_reduce]"))}
    assert set(bwd) == {"flash_attention[wgmma_bwd]", "swiglu_matmul[wgmma_bwd]",
                        "swiglu_matmul[experts_wgmma_bwd]", "causal_conv[bwd]",
                        "causal_conv[bwd_reduce]"}
    # the forwards (twice: remat) alike
    assert {k: row for k, row in meta["kernels"].items() if k not in bwd} == cpu["kernels"]
    plan = layer_plan(cfg)
    assert bwd["flash_attention[wgmma_bwd]"]["calls"] == sum(s.mixer == "attn" for s in plan)
    assert meta["launches"]["flash_attention"]["wgmma_bwd"] == sum(s.mixer == "attn" for s in plan)
    mixers = sum(s.mixer == "ssm" for s in plan)
    assert bwd["causal_conv[bwd]"]["calls"] == bwd["causal_conv[bwd_reduce]"]["calls"] == mixers
    assert meta["launches"]["causal_conv"] == {"fwd": 2 * mixers, "bwd": mixers,
                                               "bwd_reduce": mixers}
    vjps = {k for k in meta["components"] if k.endswith(".vjp")}
    assert vjps == {"swiglu_matmul.vjp", "ssd_scan.vjp"}
    assert not {k for k in cpu["components"] if k.endswith(".vjp")}
    assert A.finite(cpu["outputs"]) and torch.isfinite(cpu["outputs"][2]["loss"])


@pytest.mark.parametrize("module", ["flash_attention", "swiglu_matmul", "ssd_scan", "causal_conv"])
def test_an_entry_that_records_no_work_is_caught(monkeypatch, module):
    """Planted fault: one kernel module's entries record nothing on the
    device under test; its count then differs from the meta count."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    shape = ShapeSpec("s", "prefill", 64, 2)
    honest = _count(cfg, shape, "meta")
    monkeypatch.setattr(importlib.import_module(f"repro_torch.kernels.{module}"), "record",
                        lambda *a: None)
    faulty = _count(cfg, shape, "cpu")
    assert faulty["components"] != honest["components"]
    assert {k.split("[")[0] for k in honest["kernels"]} - {
        k.split("[")[0] for k in faulty["kernels"]} == {module}


def test_microbatched_train_cell_is_its_microbatch_times_the_depth():
    """``analyze_cell`` counts a train step of m microbatches as one
    microbatch's step times m: the step built with m microbatches counts
    the same FLOPs and launches."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    shape = ShapeSpec("s", "train", 64, 8)
    rec = A.analyze_cell(cfg, shape)
    assert rec["meta"]["microbatches"] == 2  # 4 sequences a microbatch below d_model 2048
    step, args, _ = A.build_cell(cfg, shape, "meta")
    whole = A.count_step(step, args)
    assert rec["flops"] == whole["flops"] and rec["launches"] == whole["launches"]
    assert rec["components"] == whole["components"]
    assert rec["argument_bytes"] == whole["argument_bytes"]
    assert rec["hbm_ok"] and rec["hbm_per_dev_bytes"] == rec["argument_bytes"] + rec[
        "peak_bytes"]
    assert rec["roofline"] == rec["analytic"]["roofline"]


def test_peak_counts_what_the_step_holds():
    """A step that allocates two 1 MiB tensors and keeps one while making a
    third peaks at 2 MiB; the operands it was given are not counted."""
    x = torch.empty(2**18, device="meta")

    def step(x):
        a = x * 2
        b = a + 1
        del a
        return b * 3

    count = A.count_step(step, (x,))
    assert count["peak_bytes"] == 2 * 2**20
    assert count["argument_bytes"] == 2**20
    assert count["device_peak_bytes"] is None  # the allocator's peak: on the card only


def test_unbatched_products():
    """Products with no batch dim (``mm``, a batch-of-one ``bmm``) and the
    dense SwiGLU kernel's are tallied; batched ``bmm`` is not."""
    a, b = torch.empty(8, 16, device="meta"), torch.empty(16, 4, device="meta")
    with WorkLog() as log:
        a @ b
        torch.bmm(a[None], b[None])
        torch.bmm(torch.empty(3, 8, 16, device="meta"), torch.empty(3, 16, 4, device="meta"))
        sw.swiglu_matmul(torch.empty(8, 16, device="meta", dtype=torch.bfloat16),
                         torch.empty(16, 8, device="meta", dtype=torch.bfloat16),
                         torch.empty(16, 8, device="meta", dtype=torch.bfloat16))
    assert log.unbatched == 2 * (2.0 * 8 * 16 * 4) + sw.work(8, 16, 8, 2)[0]


# --------------------------------------------------------------------------- #
# against the reference's XLA count
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def xla():
    """The reference's ``analyze_cell`` on a 1 x 1 mesh with Auto axes, every
    scan unrolled (its import sets a compilation cache, so it happens here)."""
    import jax

    from repro.launch import analysis as jax_analysis
    from repro.models import flags

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))

    def count(arch, shape):
        cfg = jax_analysis.probe_config(jax_get_config(arch))
        with flags.unrolled_scans():
            rec = jax_analysis.analyze_cell(cfg, shape, mesh, microbatches=1,
                                            bf16_moments=False)
        return rec["hlo_flops_per_dev"]
    return count


def _xla_comparable(arch, shape):
    """The port's count of the probe, less the work the port's train step
    does that the reference's does not (each term counted by the port):
    remat recomputes every forward product of a layer where the reference's
    policy (``dots_with_no_batch_dims_saveable``) saves the products with
    no batch dim, and the SwiGLU VJP recomputes the gate and up products
    that the reference's backward reads from the saved forward."""
    cfg = A.probe_config(get_config(arch))
    remat = _count(cfg, shape, "meta")
    if shape.kind != "train":
        return remat["flops"]
    _, args, _ = A.build_cell(cfg, shape, "meta", microbatches=1, bf16_moments=False)
    plain = A.count_step(make_train_step(cfg, TrainConfig(microbatches=1, remat=False)), args)
    recompute_saved = remat["unbatched_flops"] - plain["unbatched_flops"]
    dense_swiglu = sum(v for k, v in remat["components"].items()
                       if k.startswith("swiglu_matmul[") and "experts" not in k
                       and not k.endswith("_bwd]"))
    return remat["flops"] - recompute_saved - dense_swiglu / 2  # one VJP a forward and recompute


@pytest.mark.parametrize("arch,kind", [
    ("tinyllama-1.1b", "prefill"), ("tinyllama-1.1b", "train"),
    ("deepseek-v2-lite-16b", "prefill"), ("deepseek-v2-lite-16b", "train"),
    ("mamba2-370m", "prefill"), ("mamba2-370m", "train"),
    ("jamba-v0.1-52b", "prefill"), ("hubert-xlarge", "prefill"), ("hubert-xlarge", "train"),
    ("llava-next-mistral-7b", "prefill"), ("llava-next-mistral-7b", "train")])
def test_count_against_xla(xla, arch, kind):
    """Probe depth, full width, seq 256, batch 2: the port's count within 10%
    of XLA's.  What remains between them, by component: the flash kernel
    counts the (query, key) pairs its causal mask leaves, XLA all S² scores
    of the reference's masked attention (the attention core ≈ 0.5 of
    XLA's in a forward); XLA counts elementwise ops (norms, rope, softmax,
    silu, the loss), the port's counter products only; the port's MoE
    builds the [G, s, E, C] dispatch directly where the reference sums a
    [G, s, K, E, C] one-hot over K.  Jamba's train probe (20 s of XLA
    compile) is left out here; ``chip_smoke.py`` counts it on ``meta``."""
    shape = ShapeSpec(f"probe_{kind}", kind, 256, 2)
    got, want = _xla_comparable(arch, shape), xla(arch, shape)
    assert 0.9 <= got / want <= 1.1, (got, want, got / want)


# --------------------------------------------------------------------------- #
# analyze_cell, validate_probe, the command line
# --------------------------------------------------------------------------- #
def test_validate_probe_ratios():
    rec = A.validate_probe("tinyllama-1.1b", "prefill", "meta", seq=256, batch=2)
    assert rec["ratio"]["attention_core"] == pytest.approx(257 / 512)  # causal pairs of S²
    assert rec["ratio"]["rest"] == pytest.approx(1.0)
    assert rec["ratio"]["ssd_core"] is None
    assert rec["count"]["kernels"]["flash_attention[mma]"]["calls"] == 2
    assert rec["model_flops"] == A.model_flops(A.probe_config(get_config("tinyllama-1.1b")),
                                               ShapeSpec("p", "prefill", 256, 2))
    rec = A.validate_probe("mamba2-370m", "decode", "meta", seq=256, batch=2,
                           timer=lambda call: 1.5)
    # decode's one kernel: the causal conv, once in each of the two mixers
    assert rec["ms"] == 1.5 and list(rec["count"]["kernels"]) == ["causal_conv[fwd]"]
    assert rec["count"]["kernels"]["causal_conv[fwd]"]["calls"] == 2


def test_analyze_cell_on_a_production_mesh_runs_nothing():
    cfg = get_config("qwen2.5-32b")
    rec = A.analyze_cell(cfg, SHAPES["train_4k"], production_mesh_shape())
    assert "flops" not in rec and rec["n_devices"] == 256
    assert rec["hbm_per_dev_bytes"] == S.per_device_bytes(
        S.cell_pspecs(cfg, SHAPES["train_4k"], production_mesh_shape()), production_mesh_shape())
    assert rec["meta"]["microbatches"] == S.microbatches_for(cfg, SHAPES["train_4k"],
                                                             production_mesh_shape())


def test_dryrun_and_postprocess(tmp_path, capsys, monkeypatch):
    for mesh in ("card", "single"):
        monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "tinyllama-1.1b", "--shape",
                                         "decode_32k", "--mesh", mesh, "--out", str(tmp_path)])
        assert dryrun.main() == 0
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "hubert-xlarge", "--shape",
                                     "decode_32k", "--mesh", "card", "--out", str(tmp_path)])
    assert dryrun.main() == 0
    out = capsys.readouterr().out
    assert "[skip] hubert-xlarge" in out and out.count("[ ok ] tinyllama-1.1b") == 2
    card = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__card.json").read_text())
    # 128 slots a tick: the wgmma kernel, once in each of the 22 layers
    assert card["launches"]["swiglu_matmul"]["wgmma"] == 22 and card["hbm_ok"] is False
    single = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__single.json").read_text())
    assert single["mesh"] == "16x16" and "flops" not in single
    single["roofline"] = None
    (tmp_path / "tinyllama-1.1b__decode_32k__single.json").write_text(json.dumps(single))
    assert postprocess.process(str(tmp_path)) == 2
    again = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__single.json").read_text())
    assert again["roofline"] == again["analytic"]["roofline"]
