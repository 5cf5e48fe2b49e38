"""The port's training path against the JAX package's, on the CPU.

Both packages get the same weights (the reference's ``init_params`` tree in
f32, handed over as numpy through ``params_from_numpy``) and the same
numpy inputs.  On the CPU the kernel wrappers take their plain versions and
autograd runs through them; the CUDA route (kernel forward, explicit VJP
backward) is stood in for here by the same ``torch.autograd.Function``s with
the launch swapped for the plain version (``test_kernel_functions_*``), and
runs for real on the card (``tests/test_torch_card.py``, ``chip_smoke.py``).

Tolerances (f32 on both sides; the two differ in summation order, and in
attention: the port's flash plain version against the reference's chunked
``jnp``):
* ``loss_fn`` gradients, per leaf: 2e-4 of the leaf's largest magnitude
  (measured: <= 3.5e-5, the embedding's, over eight reduced configs);
* loss and accuracy: rel 1e-6; ``grad_norm``: rel 1e-5 (measured 9e-6);
* parameters after one AdamW step at lr 1e-3: within 1e-4, and at most
  0.1% of them more than 1e-6 apart.  Adam's first step moves each weight
  by ~lr·sign(g), so a weight whose gradient is ~0 moves by a different
  amount in each package (measured: 8 of ~100k weights, up to 3.3e-5);
* microbatches 1 against 4 on the same batch: rel 1e-4, the reference
  test's bound (``tests/test_train_serve_elastic.py``).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_T
from repro.optim import AdamWConfig as JaxAdamWConfig, adamw_init as jax_adamw_init
from repro.train import TrainConfig as JaxTrainConfig, loss_fn as jax_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_numpy, reference_tree
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels import ref as plain
from repro_torch.models import forward, frontend_token_split, init_params, layer_plan, synth_inputs
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import HealthMonitor, simulate_failure_recovery
from repro_torch.train import TrainConfig, Trainer, loss_fn, make_eval_step, make_train_step

from _torch_cnn_cases import one_intra_op_thread  # noqa: F401  (autouse)

# the wrappers' modules (the package exports functions of the same names)
flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")
swiglu_mod = importlib.import_module("repro_torch.kernels.swiglu_matmul")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")

GRAD_TOL = 2e-4
GRAD_ARCHS = ["tinyllama-1.1b", "deepseek-v2-lite-16b", "hubert-xlarge",
              "llava-next-mistral-7b", "mamba2-370m", "jamba-v0.1-52b"]


def _reference_f32(arch):
    jcfg = jax_get_config(arch).reduced()
    params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_config(arch).reduced(), jax.tree.map(lambda a: a.astype(jnp.float32), params)


def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _inputs(cfg, B=2, S=16, seed=1):
    """numpy inputs: tokens and/or frontend embeddings, and labels over the
    trailing positions (the text's; every frame for an audio encoder)."""
    rng = np.random.default_rng(seed)
    n_emb, n_txt = frontend_token_split(cfg, S)
    tokens = rng.integers(0, cfg.vocab, (B, n_txt)).astype(np.int32) if n_txt else None
    embeds = (rng.standard_normal((B, n_emb, cfg.d_model)) * 0.02).astype(np.float32) \
        if n_emb else None
    labels = rng.integers(0, cfg.vocab, (B, n_txt or S)).astype(np.int32)
    return tokens, embeds, labels


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port_grads(cfg, model, tokens, embeds, labels, **kw):
    model.requires_grad_(True)
    loss, metrics = loss_fn(model, cfg, _t(tokens), _t(labels), embeds=_t(embeds), **kw)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return loss, metrics, grads


def _assert_grads(ours_tree, ref_tree):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    flat_ours = jax.tree.leaves(ours_tree)
    assert len(flat_ref) == len(flat_ours)
    for (path, r), o in zip(flat_ref, flat_ours):
        r, o = np.asarray(r), o.numpy()
        assert r.shape == o.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(o, r, rtol=0, atol=GRAD_TOL * np.abs(r).max() + 1e-30,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_grads_equal_reference(arch):
    """f32 ``loss_fn`` gradients per leaf against ``jax.grad`` of the
    reference's: a dense model, MLA with routed and shared experts, HuBERT
    (every frame labelled), LLaVA (the image prefix unlabelled), mamba2,
    Jamba's hybrid period."""
    jcfg, cfg, params = _reference_f32(arch)
    tokens, embeds, labels = _inputs(cfg)

    def ref_loss(p):
        return jax_loss_fn(p, jcfg, _j(tokens), _j(labels), embeds=_j(embeds))

    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(params)
    loss, metrics, grads = _port_grads(cfg, _port(cfg, params), tokens, embeds, labels)
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=1e-6)
    assert float(metrics["accuracy"]) == pytest.approx(float(rmetrics["accuracy"]), rel=1e-6)
    _assert_grads(reference_tree(cfg, grads), rgrads)


def _feed(b):
    return {"tokens": b.inputs, "labels": b.labels}


@pytest.mark.parametrize("microbatches,remat", [(1, False), (1, True), (4, False), (4, True)])
def test_train_step_equals_reference(microbatches, remat):
    jcfg, cfg, params = _reference_f32("tinyllama-1.1b")
    feed = _feed(SyntheticLMDataset(cfg.vocab, seq_len=32, global_batch=8, seed=1).batch(0))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    jocfg = JaxAdamWConfig(**dataclasses.asdict(ocfg))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(microbatches=microbatches,
                                                            remat=remat, optim=jocfg)))
    rparams, ropt, rm = jstep(params, jax_adamw_init(params, jocfg),
                              {k: jnp.asarray(v) for k, v in feed.items()})
    model = _port(cfg, params)
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches, remat=remat, optim=ocfg))
    model, opt, m = step(model, adamw_init(dict(model.named_parameters()), ocfg),
                         {k: torch.from_numpy(v) for k, v in feed.items()})
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-6)
    assert float(m["accuracy"]) == pytest.approx(float(rm["accuracy"]), rel=1e-6, abs=1e-7)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-5)
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-7)
    assert int(opt["step"]) == int(ropt["step"]) == 1
    ours = jax.tree.leaves(reference_tree(cfg, dict(model.named_parameters())))
    ref = [np.asarray(r) for r in jax.tree.leaves(rparams)]
    assert len(ours) == len(ref)
    d = np.concatenate([np.abs(o.numpy() - r).ravel() for o, r in zip(ours, ref)])
    assert d.max() <= 1e-4
    assert (d > 1e-6).mean() <= 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_microbatches_agree(remat):
    """tests/test_train_serve_elastic.py::test_microbatch_equivalence on the
    port: one batch as 1 or 4 microbatches."""
    cfg = get_config("qwen2-0.5b").reduced()
    b = SyntheticLMDataset(cfg.vocab, seq_len=32, global_batch=8, seed=1).batch(0)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=500)
    out = []
    for acc in (1, 4):
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = make_train_step(cfg, TrainConfig(microbatches=acc, remat=remat, optim=ocfg))
        _, _, m = step(model, adamw_init(dict(model.named_parameters()), ocfg),
                       {"tokens": torch.from_numpy(b.inputs), "labels": torch.from_numpy(b.labels)})
        out.append(float(m["loss"]))
    assert out[0] == pytest.approx(out[1], rel=1e-4)


def test_bf16_step_near_reference():
    """bf16 weights on both sides.  The reference's MLP rounds the gate and
    up products and silu(g) to bf16 before multiplying, the port's fused
    SwiGLU does not, and XLA and PyTorch round bf16 products in other
    places: the loss agrees to rel 1e-4 (measured 1.9e-5) and the gradient
    norm to 5% (measured 1.2%)."""
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    feed = _feed(SyntheticLMDataset(cfg.vocab, seq_len=32, global_batch=8, seed=1).batch(0))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    jocfg = JaxAdamWConfig(**dataclasses.asdict(ocfg))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(microbatches=1, remat=False,
                                                            optim=jocfg)))
    _, _, rm = jstep(params, jax_adamw_init(params, jocfg),
                     {k: jnp.asarray(v) for k, v in feed.items()})
    model = _port(cfg, params)
    assert model.embed.dtype == torch.bfloat16
    step = make_train_step(cfg, TrainConfig(microbatches=1, remat=False, optim=ocfg))
    _, _, m = step(model, adamw_init(dict(model.named_parameters()), ocfg),
                   {k: torch.from_numpy(v) for k, v in feed.items()})
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-4)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=5e-2)


def test_remat_changes_no_values():
    """Recomputing each layer in the backward gives the same logits and
    gradients, bit for bit."""
    cfg = get_config("jamba-v0.1-52b").reduced()  # a segment of 4-layer repeats
    tokens, _, labels = _inputs(cfg)
    out = []
    for remat in (False, True):
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
        loss, _, grads = _port_grads(cfg, model, tokens, None, labels, remat=remat)
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name
    with pytest.raises(ValueError):
        forward(model, cfg, {"tokens": _t(tokens)}, mode="prefill", remat=True)


def test_eval_step():
    cfg = get_config("tinyllama-1.1b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens, _, labels = _inputs(cfg)
    m = make_eval_step(cfg, TrainConfig())(model, {"tokens": _t(tokens), "labels": _t(labels)})
    _, ref = loss_fn(model, cfg, _t(tokens), _t(labels))
    assert float(m["loss"]) == float(ref["loss"]) and float(m["accuracy"]) == float(ref["accuracy"])
    assert m["loss"].grad_fn is None


# --------------------------------------------------------------------------- #
# the kernels' autograd Functions, with the launch stood in for on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture
def stand_in_kernels(monkeypatch):
    """Route the CPU calls of the flash, SwiGLU and SSD-scan wrappers
    through their CUDA path's ``autograd.Function``s, with each launch
    replaced by the plain version under ``no_grad`` (what a kernel returns:
    a tensor with no history).  The backward is then the explicit VJP, as
    on the card.  The mixer's scan takes the ``wgmma`` route, on the views
    of the conv output with A expanded to [B, H]."""
    def flash_launch(q, k, v, causal, sc):
        with torch.no_grad():
            return plain.flash_attention_ref(q, k, v, causal=causal, scale=sc)

    def swiglu_launch(x, wg, wu):
        with torch.no_grad():
            ref = plain.swiglu_experts_ref if x.dim() == 3 else plain.swiglu_ref
            return ref(x, wg, wu)

    def ssd_launch(x, dt, A2, Bm, Cm, return_state):
        with torch.no_grad():
            y, h = plain.ssd_mixer_ref(x, dt, A2[0], Bm, Cm, return_state=True)
        return y, (h if return_state else None)

    def flash(q, k, v, causal=True, scale=None):
        return flash_mod._FlashAttention.apply(q, k, v, causal,
                                               scale if scale is not None else q.shape[-1] ** -0.5)

    def mixer(x, dt, A, Bm, Cm, return_state=False):
        return ssd_mod._SSDScan.apply(x, dt.float(), A.float()[None].expand(x.shape[0], -1),
                                      Bm, Cm, "wgmma", return_state)

    monkeypatch.setattr(flash_mod, "_launch", flash_launch)
    monkeypatch.setattr(swiglu_mod, "_launch", swiglu_launch)
    monkeypatch.setattr(ssd_mod, "_launch_wgmma", ssd_launch)
    import repro_torch.kernels.ops as ops
    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "swiglu_matmul", swiglu_mod._SwiGLU.apply)
    monkeypatch.setattr(ops, "swiglu_experts", swiglu_mod._SwiGLU.apply)
    import repro_torch.models.layers as layers
    monkeypatch.setattr(layers, "swiglu_experts", swiglu_mod._SwiGLU.apply)
    import repro_torch.models.ssm as ssm
    monkeypatch.setattr(ssm, "ssd_mixer", mixer)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b", "hubert-xlarge",
                                  "mamba2-370m", "jamba-v0.1-52b"])
def test_kernel_functions_carry_gradients(arch, stand_in_kernels):
    """Through the Functions (the card's route) the gradients equal
    ``jax.grad`` of the reference's loss in f32, and every parameter the
    loss reads gets one: a dense model (flash causal, SwiGLU), MLA with
    experts (flash at Dv != D, the expert entry), an encoder (non-causal
    flash), mamba2 (the SSD scan's Function on the mixer's views; A_log,
    dt_bias, Dskip and the conv among the leaves) and Jamba's hybrid period
    (attention, mixers, experts and dense FFNs in one backward)."""
    jcfg, cfg, params = _reference_f32(arch)
    tokens, embeds, labels = _inputs(cfg)
    vjp_calls = []
    vjp = ssd_mod.ssd_scan_vjp
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssd_mod, "ssd_scan_vjp", lambda *a: vjp_calls.append(1) or vjp(*a))
        _, _, grads = _port_grads(cfg, _port(cfg, params), tokens, embeds, labels)
    n_ssm = sum(slot.mixer == "ssm" for slot in layer_plan(cfg))
    assert len(vjp_calls) == n_ssm  # one VJP a mixer
    rgrads = jax.jit(jax.grad(lambda p: jax_loss_fn(p, jcfg, _j(tokens), _j(labels),
                                                   embeds=_j(embeds))[0]))(params)
    _assert_grads(reference_tree(cfg, grads), rgrads)
    unread = {"embed"} if cfg.frontend == "audio" else set()  # an encoder reads frames only
    for name, g in grads.items():
        if name not in unread:
            assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_detached_kernel_output_is_caught(stand_in_kernels, monkeypatch):
    """The planted fault: a kernel output with no gradient path (what the
    wrappers returned before they had Functions) leaves ln1, q/k/v, ln2 and
    the gate/up weights without a gradient."""
    monkeypatch.setattr(swiglu_mod._SwiGLU, "backward",
                        staticmethod(lambda ctx, dout: (None, None, None)))
    cfg = get_config("tinyllama-1.1b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tokens, _, labels = _inputs(cfg)
    _, _, grads = _port_grads(cfg, model, tokens, None, labels)
    zero = sorted(n.split(".", 2)[-1] for n, g in grads.items() if not g.abs().max() > 0)
    assert {"mlp.wg", "mlp.wu", "ln2.scale"} <= set(zero)


# --------------------------------------------------------------------------- #
# every registry arch, and the reference's training scenarios
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_one_train_step(arch):
    """tests/test_models_smoke.py::test_one_train_step on the port (bf16)."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    tcfg = TrainConfig(microbatches=1, remat=False, optim=AdamWConfig(lr=1e-3, warmup_steps=1))
    B, S = 2, 16
    batch = dict(synth_inputs(cfg, B, S, torch.Generator().manual_seed(1), device="cpu"))
    n_lab = batch["tokens"].shape[1] if "tokens" in batch else S
    batch["labels"] = torch.randint(0, cfg.vocab, (B, n_lab),
                                    generator=torch.Generator().manual_seed(2))
    model, _, metrics = make_train_step(cfg, tcfg)(
        model, adamw_init(dict(model.named_parameters()), tcfg.optim), batch)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    diff = sum(float((a.float() - b.float()).abs().sum())
               for a, b in zip(before, model.parameters()))
    assert diff > 0


CFG = get_config("qwen2-0.5b").reduced()
OPT = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=500)


def _trainer(tmp=None, **kw):
    ds = SyntheticLMDataset(CFG.vocab, seq_len=48, global_batch=4, seed=0)
    ckpt = CheckpointManager(tmp, keep=2) if tmp else None
    return Trainer(CFG, TrainConfig(microbatches=1, remat=False, optim=OPT), ds,
                   ckpt_manager=ckpt, device="cpu", **kw)


def test_loss_decreases():
    tr = _trainer(monitor=HealthMonitor(1))
    out = tr.run(25, log_every=0)
    assert out["steps"] == 25
    assert out["final_loss"] < tr.history[0]["loss"] - 0.3
    assert tr.monitor.workers[0].timings[-1][0] == 25  # the step hook ran


def test_checkpoint_resume_continues(tmp_path):
    res = simulate_failure_recovery(lambda: _trainer(str(tmp_path), ckpt_every=5),
                                    fail_at_step=12, total_steps=20, ckpt_every=5)
    assert res["resumed"] and res["resume_step"] == 10
    pre = res["pre_crash"][res["resume_step"] - 1]["loss"]
    post = res["post_crash"][0]["loss"]
    init_loss = res["pre_crash"][0]["loss"]
    assert post < init_loss - 0.2
    assert abs(post - pre) < abs(post - init_loss)
    # the CPU steps are deterministic: the resumed run is the uninterrupted one
    whole = _trainer()
    whole.run(20, log_every=0)
    assert [h["loss"] for h in res["post_crash"]] == [h["loss"] for h in whole.history[10:]]


def test_deterministic_restart_same_curve():
    a, b = _trainer(), _trainer()
    a.run(3, log_every=0)
    b.run(3, log_every=0)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
