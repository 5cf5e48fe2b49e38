"""The port's ``parallel/sharding.py`` and its ``ParamDef`` trees against the
reference's.

The rules tables, ``mesh_axis_size`` and ``logical_to_pspec`` are copies, so
the scenarios of ``tests/test_sharding.py`` must give the same specs on both
packages (the port's ``PartitionSpec`` is a tuple with the reference's
entries).  ``model_defs`` and ``cache_model_defs`` must equal the
reference's for every registry config at full size, by key, shape, logical
axes, dtype, initializer and scale; ``abstract_params``/``abstract_cache``
build them as ``meta`` tensors, which allocate nothing.  The model and the
cache the port materialises (``init_params``, ``init_cache``) take their
shapes and dtypes from these trees."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP

import repro.parallel.sharding as jax_sharding
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import transformer as jax_T
from repro_torch import parallel
from repro_torch.configs import get_config
from repro_torch.convert import reference_tree
from repro_torch.models import init_cache, init_params
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (
    OPT_RULES, SERVE_RULES, TRAIN_RULES, ParamDef, PartitionSpec, logical_to_pspec,
    mesh_axis_size, tree_pspecs,
)

MESH1 = {"data": 16, "model": 16}
MESH2 = {"pod": 2, "data": 16, "model": 16}
MESHES = {"data16 x model16": MESH1, "pod2 x data16 x model16": MESH2,
          "data8 x model4": {"data": 8, "model": 4}, "model2": {"model": 2}}
RULES = {"train": (TRAIN_RULES, jax_sharding.TRAIN_RULES),
         "opt": (OPT_RULES, jax_sharding.OPT_RULES),
         "serve": (SERVE_RULES, jax_sharding.SERVE_RULES)}
TORCH_DTYPE = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}

# tests/test_sharding.py::TestResolution: (axes, shape, rules, mesh, the spec)
SCENARIOS = {
    "divisibility fallback": (("embed", "heads", None), (896, 14, 64), "train", MESH1,
                              ("data",)),
    "exclusivity, first wins": (("experts", "embed", "ffn"), (64, 2048, 1408), "train", MESH1,
                                ("model", "data")),
    "multi-axis dim": (("embed",), (5120,), "opt", MESH1, (("data", "model"),)),
    "multi-axis partial divisibility": (("embed",), (2048 * 16,), "opt",
                                        {"data": 16, "model": 10000}, ("data",)),
    "batch over pod and data": (("batch", None), (256, 4096), "train", MESH2,
                                (("pod", "data"),)),
    "batch of one replicated": (("batch", None), (1, 4096), "train", MESH2, ()),
    "serve qk fallback": (("embed", "heads", "qk"), (5120, 40, 128), "serve", MESH1,
                          (None, None, "model")),
}


@pytest.mark.parametrize("case", SCENARIOS, ids=list(SCENARIOS))
def test_resolution_equals_reference(case):
    axes, shape, rules, mesh, want = SCENARIOS[case]
    ours = logical_to_pspec(axes, shape, RULES[rules][0], mesh)
    ref = jax_sharding.logical_to_pspec(axes, shape, RULES[rules][1], mesh)
    assert isinstance(ours, PartitionSpec) and isinstance(ref, JaxP)
    assert tuple(ours) == tuple(ref) == want
    assert ours == PartitionSpec(*want)


def test_rank_mismatch_raises():
    with pytest.raises(ValueError):
        logical_to_pspec(("embed",), (4, 4), TRAIN_RULES, MESH1)
    with pytest.raises(ValueError):
        ParamDef((4, 4), ("embed",))


def test_copied_text_and_tables_equal_reference():
    """The rules tables are equal, and the resolver, ``AxisRules`` and
    ``mesh_axis_size`` are the reference's text."""
    for ours, ref in RULES.values():
        assert (ours.name, dict(ours.rules)) == (ref.name, dict(ref.rules))
    for name in ("logical_to_pspec", "mesh_axis_size", "AxisRules"):
        assert inspect.getsource(getattr(sharding, name)) == \
            inspect.getsource(getattr(jax_sharding, name))
    for mesh in MESHES.values():
        for axes in (("data",), ("pod", "data"), ("data", "model"), ("absent",)):
            assert mesh_axis_size(mesh, axes) == jax_sharding.mesh_axis_size(mesh, axes)
    assert set(parallel.__all__) >= set(jax_sharding.__all__) - {"tree_shardings", "constrain"}


def test_param_def_scale_and_abstract():
    """``default_scale`` keeps the reference's fan-in of shape[-2]; the
    abstract leaf is a ``meta`` tensor."""
    for shape, scale in (((4, 8), None), ((2048, 32, 64), None), ((7,), None), ((4, 8), 0.5)):
        ours = ParamDef(shape, (None,) * len(shape), scale=scale)
        ref = jax_sharding.ParamDef(shape, (None,) * len(shape), scale=scale)
        assert ours.default_scale() == ref.default_scale()
    a = ParamDef((4, 8), ("embed", "ffn"), dtype=torch.float32).abstract()
    assert a.shape == (4, 8) and a.dtype == torch.float32 and a.device.type == "meta"
    assert ParamDef((4, 8), ("embed", "ffn")).dtype == torch.bfloat16


def _flat(tree, is_def):
    """{path: leaf} of a tree of nested dicts."""
    out = {}

    def walk(node, path):
        if is_def(node):
            out[path] = node
        else:
            for k, v in node.items():
                walk(v, path + (k,))
    walk(tree, ())
    return out


def _same_defs(ours, ref):
    a = _flat(ours, lambda x: isinstance(x, ParamDef))
    b = _flat(ref, lambda x: isinstance(x, jax_sharding.ParamDef))
    assert list(a) and sorted(a) == sorted(b)
    for path, d in a.items():
        r = b[path]
        assert (d.shape, d.axes, d.init, d.scale) == (r.shape, r.axes, r.init, r.scale), path
        assert d.dtype == TORCH_DTYPE[jnp.dtype(r.dtype)], path


@pytest.mark.parametrize("arch", jax_list_archs())
def test_model_and_cache_defs_equal_reference(arch):
    """At full size, and the reduced config too."""
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        _same_defs(T.model_defs(cfg), jax_T.model_defs(jcfg))
        _same_defs(T.cache_model_defs(cfg, 4, 512), jax_T.cache_model_defs(jcfg, 4, 512))


@pytest.mark.parametrize("arch", jax_list_archs())
def test_abstract_trees_on_meta(arch):
    """``abstract_params``/``abstract_cache`` at full size: ``meta``
    tensors with the reference's shapes and dtypes (nothing allocated)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ours = _flat(T.abstract_params(cfg), torch.is_tensor)
    ref = _flat(jax_T.abstract_params(jcfg), lambda x: isinstance(x, jax.ShapeDtypeStruct))
    assert sorted(ours) == sorted(ref)
    for path, t in ours.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == ref[path].shape and t.dtype == TORCH_DTYPE[ref[path].dtype]
    cache = _flat(T.abstract_cache(cfg, 2, 256), torch.is_tensor)
    jcache = _flat(jax_T.abstract_cache(jcfg, 2, 256),
                   lambda x: isinstance(x, jax.ShapeDtypeStruct))
    assert sorted(cache) == sorted(jcache)
    assert all(t.device.type == "meta" and tuple(t.shape) == jcache[p].shape
               for p, t in cache.items())


@pytest.mark.parametrize("arch", jax_list_archs())
@pytest.mark.parametrize("rules", list(RULES))
def test_tree_pspecs_equal_reference(arch, rules):
    """Every leaf's spec on both meshes of ``tests/test_sharding.py`` (and
    two more), under each policy, as the reference resolves it."""
    defs, jdefs = T.model_defs(get_config(arch)), jax_T.model_defs(jax_get_config(arch))
    for mesh in MESHES.values():
        ours = _flat(tree_pspecs(defs, RULES[rules][0], mesh),
                     lambda x: isinstance(x, PartitionSpec))
        ref = _flat(jax_sharding.tree_pspecs(jdefs, RULES[rules][1], mesh),
                    lambda x: isinstance(x, JaxP))
        assert sorted(ours) == sorted(ref)
        for path, spec in ours.items():
            assert tuple(spec) == tuple(ref[path]), path


def test_moe_expert_sharded():
    """``TestModelSpecs.test_moe_expert_sharded`` on the port."""
    defs = T.model_defs(get_config("arctic-480b"))
    spec = defs["segments"]["moe"]["p0"]["moe"]["wg"].pspec(TRAIN_RULES, MESH1)
    assert spec == PartitionSpec(None, "model", None, "data")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-v0.1-52b", "arctic-480b"])
def test_model_and_cache_read_the_defs(arch):
    """``init_params`` and ``init_cache`` (reduced, CPU) stack back into
    ``model_defs``/``cache_model_defs``: every leaf's shape, and its dtype
    (the trees' f32 leaves f32, the rest the model's or cache's dtype)."""
    cfg = get_config(arch).reduced()
    for dtype in (torch.bfloat16, torch.float32):
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
        tree = _flat(reference_tree(cfg, dict(model.named_parameters()), device="meta"),
                     torch.is_tensor)
        defs = _flat(T.model_defs(cfg), lambda x: isinstance(x, ParamDef))
        assert sorted(tree) == sorted(defs)
        for path, t in tree.items():
            d = defs[path]
            want = torch.float32 if d.dtype == torch.float32 else dtype
            assert tuple(t.shape) == d.shape and t.dtype == want, path
        cache = _flat(init_cache(cfg, 2, 16, device="cpu", dtype=dtype), torch.is_tensor)
        cdefs = _flat(T.cache_model_defs(cfg, 2, 16), lambda x: isinstance(x, ParamDef))
        assert sorted(cache) == sorted([*cdefs, ("pos",)])
        for path, d in cdefs.items():
            want = torch.float32 if d.dtype == torch.float32 else dtype
            assert tuple(cache[path].shape) == d.shape and cache[path].dtype == want, path
            assert not cache[path].any()


def test_meta_model_allocates_nothing():
    """The full-size Arctic (482 B parameters) as ``meta`` tensors."""
    cfg = get_config("arctic-480b")
    n = sum(int(np.prod(t.shape)) for t in _flat(T.abstract_params(cfg), torch.is_tensor).values())
    assert n == sum(p.numel() for p in T.Transformer(cfg, device="meta").parameters())
    assert n > 4e11
