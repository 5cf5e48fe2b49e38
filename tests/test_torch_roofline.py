"""The port's ``launch/roofline_model.py`` and ``launch/mesh.py`` against the
reference's.

``analytic_terms`` is the reference's formulas with the chip a parameter:
with the reference's own constants passed in as a ``Chip`` it must return
the reference's record in every field, FLOPs, bytes and collective bytes
and the seconds derived from them, exactly (the parameter trees are walked
in ``jax.tree_util``'s order, so the sums run in the same order), for every
registry arch × runnable shape × the card and both production meshes × both
MoE dispatches.  ``param_stats``, ``_ways`` and ``model_flops`` likewise.
The H100's ``bound_ms`` over each kernel module's ``work()`` reproduces the
bound column that ``PERF.md``'s kernel table printed before the formulas
moved out of ``chip_smoke.py``."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.launch.roofline_model as jax_roofline
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_T
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import SHAPES, get_config, list_archs, runnable_cells
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline_model as R
from repro_torch.launch.analysis import model_flops
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding

# the modules (the package ``repro_torch.kernels`` exports functions of
# these names)
fa = importlib.import_module("repro_torch.kernels.flash_attention")
sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
conv = importlib.import_module("repro_torch.kernels.causal_conv")
# the reference's TPU constants, read from the reference itself (the port
# writes none of them down)
REF_CHIP = R.Chip("the reference's chip", jax_roofline.PEAK_FLOPS, jax_roofline.HBM_BW,
                  jax_roofline.ICI_BW, 16 * 2**30)
MESHES = {"card": M.CARD_MESH, "single": M.production_mesh_shape(False),
          "multi": M.production_mesh_shape(True)}
CELLS = [(a, s) for a in list_archs() for s in runnable_cells(get_config(a))]


@pytest.mark.parametrize("moe_impl", ["einsum", "scatter"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_equal_the_reference(arch, shape, mesh, moe_impl):
    want = jax_roofline.analytic_terms(jax_get_config(arch), JAX_SHAPES[shape], MESHES[mesh],
                                       moe_impl=moe_impl)
    got = R.analytic_terms(get_config(arch), SHAPES[shape], MESHES[mesh], moe_impl=moe_impl,
                           chip=REF_CHIP)
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_take_the_chip(arch, shape):
    """Under the H100 the work is the same and only the seconds change: each
    term is the work over the H100's rate."""
    cfg = get_config(arch)
    ref = R.analytic_terms(cfg, SHAPES[shape], M.CARD_MESH, chip=REF_CHIP)
    h100 = R.analytic_terms(cfg, SHAPES[shape], M.CARD_MESH)
    for k in ("flops_per_dev", "bytes_per_dev", "coll_per_dev", "model_flops_total"):
        assert h100[k] == ref[k]
    assert h100["roofline"]["compute_s"] == h100["flops_per_dev"] / R.H100.peak_flops
    assert h100["roofline"]["memory_s"] == h100["bytes_per_dev"] / R.H100.hbm_bw
    assert h100["step_time_bound_s"] == max(h100["roofline"].values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_stats_and_ways_equal_the_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for rules, jrules in ((sharding.TRAIN_RULES, jax_sharding.TRAIN_RULES),
                          (sharding.SERVE_RULES, jax_sharding.SERVE_RULES)):
        assert R.param_stats(cfg, rules, MESHES[mesh]) == jax_roofline.param_stats(
            jcfg, jrules, MESHES[mesh])
        got = R._ways(T.model_defs(cfg), rules, MESHES[mesh])
        want = jax_roofline._ways(jax_T.model_defs(jcfg), jrules, MESHES[mesh])
        assert {k: v[:3] for k, v in got.items()} == {k: v[:3] for k, v in want.items()}
        assert {k: str(v[3]).split(".")[-1] for k, v in got.items()} == {
            k: np.dtype(v[3]).name for k, v in want.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    from repro.launch.analysis import model_flops as jax_model_flops

    assert model_flops(get_config(arch), SHAPES[shape]) == jax_model_flops(
        jax_get_config(arch), JAX_SHAPES[shape])


def test_no_tpu_constant_in_the_port():
    """The port's roofline names no TPU constant: the reference's rates are
    only ever passed in."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        assert not hasattr(R, name)
    src = R.__file__
    text = open(src).read()
    for value in ("197e12", "819e9", "50e9"):
        assert value not in text


def test_meshes():
    assert M.production_mesh_shape() == {"data": 16, "model": 16}
    assert M.production_mesh_shape(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert M.CARD_MESH == {"data": 1, "model": 1}
    assert M.mesh_shape_dict({"data": np.int64(2), "model": 4}) == {"data": 2, "model": 4}
    assert M.mesh_name(M.production_mesh_shape(True)) == "2x16x16"


def test_h100_is_the_data_sheet():
    assert dataclasses.astuple(R.H100)[1:] == (989e12, 3.35e12, 900e9, 80e9, 67e12)


BF16, F32 = torch.bfloat16, torch.float32
# PERF.md's kernel table: shape, the module's work() call, dtype,
# and the bound column as it printed (4 decimals, then bytes or operations)
TABLE = [
    ("flash mma BH=32 S=1024 D=64", fa.work(32, 1024, 1024, 64, True, 2), BF16, "0.0050", "bytes"),
    ("flash mma MLA", fa.work(16, 1024, 1024, 192, True, 2, Dv=128), BF16, "0.0063", "bytes"),
    ("flash mma HuBERT", fa.work(128, 1500, 1500, 80, False, 2), BF16, "0.0932", "operations"),
    ("flash mma train", fa.work(128, 1024, 1024, 64, True, 2), BF16, "0.0200", "bytes"),
    ("flash cuda_core f32", fa.work(32, 1024, 1024, 64, True, 4), F32, "0.0642", "operations"),
    ("swiglu decode", sw.work(8, 2048, 5632, 2), BF16, "0.0138", "bytes"),
    ("swiglu decode 4096", sw.work(8, 4096, 14336, 2), BF16, "0.0702", "bytes"),
    ("swiglu decode 7168", sw.work(8, 7168, 4864, 2), BF16, "0.0417", "bytes"),
    ("swiglu wgmma", sw.work(512, 2048, 5632, 2), BF16, "0.0239", "operations"),
    ("swiglu wgmma 4096", sw.work(1024, 4096, 14336, 2), BF16, "0.2432", "operations"),
    ("swiglu wgmma HuBERT", sw.work(12000, 1280, 5120, 2), BF16, "0.3181", "operations"),
    ("swiglu wgmma 7168", sw.work(1024, 7168, 4864, 2), BF16, "0.1444", "operations"),
    ("swiglu wgmma train", sw.work(4096, 2048, 5632, 2), BF16, "0.1911", "operations"),
    ("swiglu cuda_core f32", sw.work(512, 2048, 5632, 4), F32, "0.3526", "operations"),
    ("experts_wgmma", sw.work(120, 2048, 1408, 2, E=64), BF16, "0.2362", "bytes"),
    ("experts_wgmma Jamba", sw.work(160, 4096, 14336, 2, E=16), BF16, "1.1500", "bytes"),
    ("experts_decode", sw.work(8, 2048, 1408, 2, E=64), BF16, "0.2214", "bytes"),
    ("experts_decode Jamba", sw.work(8, 4096, 14336, 2, E=16), BF16, "1.1232", "bytes"),
    ("experts_decode Arctic prefill", sw.work(20, 7168, 4864, 2, E=128), BF16, "5.3470", "bytes"),
    ("experts_decode Arctic tick", sw.work(8, 7168, 4864, 2, E=128), BF16, "5.3360", "bytes"),
    ("experts_cuda_core f32", sw.work(120, 2048, 1408, 4, E=64), F32, "1.3221", "operations"),
    ("ssd wgmma flat", ssd.work(32, 32, 1024, 64, 128, 2, 64), BF16, "0.0079", "bytes"),
    ("ssd wgmma mamba2 layout", ssd.work(32, 1, 1024, 64, 128, 2, 64), BF16, "0.0030", "bytes"),
    ("ssd wgmma Jamba layout", ssd.work(128, 1, 1024, 64, 16, 2, 64), BF16, "0.0103", "bytes"),
    ("ssd wgmma train layout", ssd.work(128, 4, 1024, 64, 128, 2, 64), BF16, "0.0121", "bytes"),
    ("ssd cuda_core f32", ssd.work(32, 32, 1024, 64, 128, 4, 32), F32, "0.0191", "operations"),
    ("ssd wgmma_bwd train layout", ssd.work_bwd(128, 4, 1024, 64, 128, 2), BF16, "0.0166",
     "bytes"),
    ("ssd wgmma_bwd Jamba train layout", ssd.work_bwd(256, 2, 1024, 64, 16, 2), BF16, "0.0308",
     "bytes"),
    ("conv fwd train layout", conv.work(16, 2048, 2304, 2), BF16, "0.0902", "bytes"),
    ("conv fwd Jamba prefill", conv.work(1, 4096, 8224, 2, 2, False, True), BF16, "0.0403",
     "bytes"),
    ("conv fwd Jamba decode", conv.work(16, 1, 8224, 2, 2, True, True), BF16, "0.0007", "bytes"),
    ("conv bwd train layout", conv.work_bwd(16, 2048, 2304, 2, 2), BF16, "0.1352", "bytes"),
    ("conv bwd_reduce train layout", conv.work_reduce(16, 2048, 2304, 2), BF16, "0.0035",
     "bytes"),
]


@pytest.mark.parametrize("name,work,dtype,printed,by", TABLE, ids=[r[0] for r in TABLE])
def test_bounds_read_as_the_kernel_table_printed(name, work, dtype, printed, by):
    ms, bound_by = R.H100.bound_ms(*work, dtype)
    assert (f"{ms:.4f}", bound_by) == (printed, by)


def _causal_pairs_by_loop(Sq, Sk):
    """The formula ``chip_smoke.py`` summed before it moved."""
    off = Sk - Sq
    return sum(min(Sk, max(0, i + off + 1)) for i in range(Sq))


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (7, 7), (100, 130), (130, 100), (1024, 1024),
                                   (9216, 9216), (3, 40), (40, 3), (0, 5), (5, 0)])
def test_flash_work_counts_the_causal_pairs(Sq, Sk):
    D, Dv = 64, 32
    flops, nbytes = fa.work(2, Sq, Sk, D, True, 2, Dv=Dv)
    assert flops == 2.0 * 2 * _causal_pairs_by_loop(Sq, Sk) * (D + Dv)
    assert nbytes == (2 * Sq * D + 2 * Sk * D + 2 * Sk * Dv + 2 * Sq * Dv) * 2
    assert fa.work(2, Sq, Sk, D, False, 2)[0] == 2.0 * 2 * Sq * Sk * 2 * D
