"""The port's checkpoints against the JAX package's, both ways.

The on-disk format is the reference's (``step_%09d/``, ``manifest.json``,
``shard_%05d.npz``, ``LATEST``), leaves in JAX's flatten order.  The state
is a reduced tinyllama's ``{"params", "opt": {"m", "v", "step"}}``: bf16
weights and f32 moments after one AdamW step, as the reference's
``Trainer`` saves it.  Every comparison is bit for bit (bf16 as its 16-bit
pattern): a checkpoint moves bytes and rounds nothing.
``tests/test_substrates.py::TestCheckpoint``'s scenarios run on the port too.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_T
from repro.optim import AdamWConfig as JaxAdamWConfig, adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import named_from_tree, params_from_numpy, reference_tree
from repro_torch.models import init_params

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def reference_state():
    """The reference's {params, opt} tree after one AdamW step."""
    cfg = jax_get_config(ARCH).reduced()
    params = jax_T.init_params(cfg, jax.random.PRNGKey(0))
    ocfg = JaxAdamWConfig(lr=1e-2, warmup_steps=1)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = jax_adamw_update(params, grads, jax_adamw_init(params, ocfg), ocfg)
    return {"params": params, "opt": opt}


def _bits(a):
    """A leaf's bytes as integers (bf16 as its 16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_state(cfg, ref_state):
    """The same state as the port holds it, then as the tree it saves."""
    host = jax.tree.map(np.asarray, ref_state)
    model = params_from_numpy(cfg, host["params"], device="cpu")
    m = {k: torch.from_numpy(np.array(v)) for k, v in named_from_tree(cfg, host["opt"]["m"]).items()}
    v = {k: torch.from_numpy(np.array(t)) for k, t in named_from_tree(cfg, host["opt"]["v"]).items()}
    step = torch.tensor(int(host["opt"]["step"]), dtype=torch.int32)
    return {"params": reference_tree(cfg, dict(model.named_parameters())),
            "opt": {"m": reference_tree(cfg, m), "v": reference_tree(cfg, v), "step": step}}


def _keys(tree):
    return ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_reference_checkpoint_restores_in_port(tmp_path, reference_state):
    cfg = get_config(ARCH).reduced()
    JaxCheckpointManager(str(tmp_path)).save(3, reference_state)
    ours = CheckpointManager(str(tmp_path))
    assert ours.latest_step() == 3
    like = _port_state(cfg, reference_state)
    like_meta = jax.tree.map(lambda t: t.to("meta"), like)
    restored, manifest = ours.restore(3, like=like_meta)
    assert manifest["step"] == 3
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["m"]["embed"].dtype == torch.float32
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 1
    flat_ref = jax.tree.leaves(reference_state)
    flat_ours = jax.tree.leaves(restored)
    assert len(flat_ref) == len(flat_ours)
    for r, o in zip(flat_ref, flat_ours):
        np.testing.assert_array_equal(_bits(o), _bits(r))


def test_port_checkpoint_restores_in_reference(tmp_path, reference_state):
    cfg = get_config(ARCH).reduced()
    state = _port_state(cfg, reference_state)
    CheckpointManager(str(tmp_path)).save(4, state, extra={"who": "port"})
    restored, manifest = JaxCheckpointManager(str(tmp_path)).restore(4, like=reference_state)
    assert manifest["extra"] == {"who": "port"}
    # the same keys, in JAX's flatten order
    assert [r["key"] for r in manifest["leaves"]] == _keys(reference_state)
    assert manifest["leaves"][0]["key"].startswith("opt/m/")
    for r, o in zip(jax.tree.leaves(reference_state), jax.tree.leaves(restored)):
        assert np.asarray(o).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(_bits(o), _bits(r))


def test_manifests_agree(tmp_path, reference_state):
    """Both packages write the same manifest for the same state."""
    cfg = get_config(ARCH).reduced()
    JaxCheckpointManager(str(tmp_path / "ref"), shard_bytes=2**14).save(1, reference_state)
    CheckpointManager(str(tmp_path / "port"), shard_bytes=2**14).save(
        1, _port_state(cfg, reference_state))
    ref = json.load(open(tmp_path / "ref" / "step_000000001" / "manifest.json"))
    ours = json.load(open(tmp_path / "port" / "step_000000001" / "manifest.json"))
    assert ref == ours
    assert ours["n_shards"] > 1


def test_trainer_state_round_trip(tmp_path):
    """The port's own tree (bf16 weights from init_params) back by name."""
    cfg = get_config(ARCH).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    named = dict(model.named_parameters())
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(2, {"params": reference_tree(cfg, named)})
    restored, _ = cm.restore(2, like={"params": reference_tree(cfg, named, "meta")})
    back = named_from_tree(cfg, restored["params"])
    for name, t in named.items():
        assert back[name].dtype == t.dtype
        assert torch.equal(back[name], t.detach())


def test_missing_leaf_or_wrong_shape_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": torch.zeros(3), "b": {"c": torch.ones(2, 2, dtype=torch.bfloat16)}})
    with pytest.raises(KeyError):
        cm.restore(1, like={"a": torch.zeros(3), "d": torch.zeros(1)})
    with pytest.raises(ValueError):
        cm.restore(1, like={"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        cm.restore(1, like={"b": {"c": torch.ones(2, 2)}})  # stored bf16, asked f32
    part, _ = cm.restore(1, like={"b": {"c": torch.empty(2, 2, dtype=torch.bfloat16,
                                                         device="meta")}})
    assert torch.equal(part["b"]["c"], torch.ones(2, 2, dtype=torch.bfloat16))


def test_save_snapshots_before_returning(tmp_path):
    """An async save writes the values of the call, not later ones: the
    trainer updates its tensors in place right after."""
    cm = CheckpointManager(str(tmp_path))
    t = torch.arange(1000, dtype=torch.float32)
    cm.save(1, {"t": t}, blocking=False)
    t.zero_()
    cm.wait()
    restored, _ = cm.restore(1)
    assert torch.equal(restored["t"], torch.arange(1000, dtype=torch.float32))


# tests/test_substrates.py::TestCheckpoint on the port
def _tree(k=0):
    return {"a": torch.arange(10) + k, "b": {"c": torch.ones((3, 3)) * k}}


def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(3)
    cm.save(7, t)
    assert cm.latest_step() == 7
    restored, manifest = cm.restore(7, like=t)
    assert manifest["step"] == 7
    assert torch.equal(restored["a"], t["a"]) and torch.equal(restored["b"]["c"], t["b"]["c"])


def test_keep_k_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    assert cm.all_steps() == [3, 4]


def test_async_save(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, _tree(1), blocking=False)
    cm.wait()
    assert cm.latest_step() == 1


def test_atomicity_tmp_never_visible(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(5, _tree())
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]


def test_sharded_manifest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=1, shard_bytes=40)
    cm.save(1, _tree())
    d = os.path.join(str(tmp_path), "step_000000001")
    assert len([f for f in os.listdir(d) if f.startswith("shard_")]) >= 2
    restored, _ = cm.restore(1, like=_tree())
    assert torch.equal(restored["a"], _tree()["a"])


def test_restore_without_like(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _tree())
    flat, _ = cm.restore(1)
    assert set(flat) == {"a", "b/c"}
