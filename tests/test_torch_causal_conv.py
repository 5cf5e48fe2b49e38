"""The causal conv's wrapper (``kernels/causal_conv.py``) on the CPU.

* The CPU route is the plain version, the eager passes the model ran before
  the kernel, and matches the reference's ``_causal_conv``: within 1e-6 in
  f32 (the two write SiLU as x / (1 + e^-x) and x · sigmoid(x)) and one
  bf16 ulp in bf16; the new window bit for bit.  It launches nothing.
* On ``meta`` a call counts the launches the card makes: a mamba2-370m train
  step of 2 microbatches with remat, 48 layers × 2 × 2 = 192 forwards and 96
  backwards, each with its reduction; the SSD scan's counts as before.
* The ``autograd.Function`` around the launches, with the launches stood in
  for by the plain version: its gradients are autograd's through the plain
  version, and a call that read a carry has no backward.
* The CUDA kernels' walks (``csrc/causal_conv.cu``), emulated here as the
  source writes them: the forward's runs with their 3-row halo and sliding
  window, the carry read at t = 0 and the new window written by the run
  that ends at S; the backward's runs of 16 rows three rows past their end,
  dx three rows behind, dw and db summed a run, a CTA's 8 runs, then over
  the CTAs.  The forward against the plain version bit for bit (f32), the
  backward against autograd through it (f64, 1e-12); the planted faults
  (taps reversed, the carry ignored, the backward's look-ahead cut short)
  fail.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cnn_cases import one_intra_op_thread  # noqa: F401  (autouse)
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import CONV_LIBRARY, LIBRARIES, causal_conv
from repro_torch.kernels._work import WorkLog
from repro_torch.kernels.ref import causal_conv_ref
from repro_torch.launch import analysis as A

cc = importlib.import_module("repro_torch.kernels.causal_conv")
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64


def _operands(B, S, CH, dtype, seed=0, carry=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, CH)).astype(np.float32)
    w = (rng.standard_normal((4, CH)) / 2).astype(np.float32)
    b = (rng.standard_normal(CH) / 4).astype(np.float32)
    c = rng.standard_normal((B, 3, CH)).astype(np.float32) if carry else None
    t = [torch.from_numpy(a).to(dtype) for a in (x, w, b)]
    return (*t, None if c is None else torch.from_numpy(c).to(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("S,carry", [(1, True), (2, False), (2, True), (7, False), (33, True),
                                     (64, False)])
def test_cpu_route_matches_the_reference_conv(dtype, S, carry):
    x, w, b, c = _operands(2, S, 24, dtype, seed=S, carry=carry)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == BF16 else jnp.float32)
    cast = (lambda t: jnp.asarray(t.float().numpy()).astype(jx.dtype))
    want, jwin = jax_ssm._causal_conv({"conv_w": cast(w), "conv_b": cast(b)}, jx,
                                      None if c is None else cast(c))
    window = torch.full((2, 3, 24), float("nan"), dtype=dtype)
    before = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    out = causal_conv(x, w, b, c, window)
    assert {lib.name: dict(lib.counts) for lib in LIBRARIES} == before
    assert out.dtype == dtype and out.shape == x.shape
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    rtol = 2 ** -7 if dtype == BF16 else 1e-6
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=1e-6)
    assert torch.equal(window.float(), torch.from_numpy(np.array(jwin.astype(jnp.float32))))


def test_cpu_route_is_the_plain_version():
    """The CPU route returns the plain version's output bit for bit, writes
    its window, and records the forward's work once."""
    x, w, b, c = _operands(3, 50, 40, BF16, carry=True)
    window = torch.empty_like(c)
    with WorkLog() as log:
        out = causal_conv(x, w, b, c, window)
    want, want_window = causal_conv_ref(x, w, b, c)
    assert torch.equal(out, want) and torch.equal(window, want_window)
    assert log.calls == {("causal_conv", "fwd"): [1, *cc.work(3, 50, 40, 2, 2, True, True)]}
    assert log.aten == {}


def test_work_counts_the_bytes_once():
    ops, nbytes = cc.work(16, 2048, 2304, 2)
    assert nbytes == 2 * 16 * 2048 * 2304 * 2 + 5 * 2304 * 2
    assert ops == 16 * 2048 * 2304 * 13
    assert cc.work(16, 1, 8224, 2, 2, True, True)[1] == (2 * 16 * 8224 * 2 + 5 * 8224 * 2
                                                         + 2 * 16 * 3 * 8224 * 2)
    ops, nbytes = cc.work_bwd(16, 2048, 2304, 2, 2)
    assert nbytes == 3 * 16 * 2048 * 2304 * 2 + 5 * 2304 * 4
    assert ops == 16 * 2048 * 2304 * (13 + 5 + 16 + 1)
    tiles = 16 * 2048 // 128
    assert cc.work_reduce(16, 2048, 2304, 2) == (tiles * 5 * 2304, tiles * 5 * 2304 * 4
                                                 + 5 * 2304 * 2)


# --------------------------------------------------------------------------- #
# the launches a call counts on meta
# --------------------------------------------------------------------------- #
def test_meta_train_step_accounts_the_conv_launches():
    """mamba2-370m, 2 microbatches of 16 x 2048 with remat: each of the 48
    mixers runs the forward twice a microbatch and the backward once."""
    cfg = get_config("mamba2-370m")
    step, args, _ = A.build_cell(cfg, ShapeSpec("s", "train", 2048, 32), "meta",
                                 microbatches=2, bf16_moments=False)
    count = A.count_step(step, args)
    assert count["launches"]["causal_conv"] == {"fwd": 192, "bwd": 96, "bwd_reduce": 96}
    assert count["launches"]["ssd_scan"] == {"wgmma": 192, "cuda_core": 0, "wgmma_bwd": 96}
    assert count["kernels"]["causal_conv[fwd]"]["calls"] == 192
    assert count["kernels"]["causal_conv[bwd]"]["calls"] == 96
    assert count["kernels"]["causal_conv[bwd_reduce]"]["calls"] == 96
    assert count["kernels"]["causal_conv[bwd]"]["bytes"] == 96 * cc.work_bwd(16, 2048, 2304,
                                                                             2, 2)[1]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_meta_serving_steps_launch_one_forward_a_mixer(kind):
    cfg = get_config("mamba2-370m").reduced()
    step, args, _ = A.build_cell(cfg, ShapeSpec("s", kind, 64, 2), "meta")
    count = A.count_step(step, args)
    assert count["launches"]["causal_conv"] == {"fwd": cfg.n_layers, "bwd": 0, "bwd_reduce": 0}


def test_meta_checks():
    x = torch.empty(2, 5, 16, device="meta", dtype=BF16)
    w, b = torch.empty(4, 16, device="meta", dtype=BF16), torch.empty(16, device="meta",
                                                                      dtype=BF16)
    with pytest.raises(ValueError, match="taps"):
        cc._launch(x, w[:3], b)
    with pytest.raises(ValueError, match="carry"):
        cc._launch(x, w, b, torch.empty(2, 4, 16, device="meta", dtype=BF16))
    with pytest.raises(ValueError, match="mixed dtypes"):
        cc._launch(x, w.float(), b)
    with pytest.raises(ValueError, match="takes no carry"):
        cc._launch(x, w, b, torch.empty(2, 3, 16, device="meta", dtype=BF16,
                                        requires_grad=True))
    before = dict(CONV_LIBRARY.counts)
    out = cc._launch(x, w, b, torch.empty(2, 3, 16, device="meta"),
                     torch.empty(2, 3, 16, device="meta"))
    assert out.shape == x.shape and out.dtype == BF16
    assert CONV_LIBRARY.counts["fwd"] == before["fwd"] + 1


# --------------------------------------------------------------------------- #
# the autograd Function, the launches stood in for
# --------------------------------------------------------------------------- #
@pytest.fixture
def stand_in(monkeypatch):
    """The launches as the plain version (forward) and autograd through it
    (backward), on the CPU."""
    def launch(x, w, b, carry=None, carry_out=None):
        out, window = causal_conv_ref(x, w, b, carry)
        if carry_out is not None:
            carry_out.copy_(window)
        return out

    def launch_bwd(x, w, b, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, w, b)]
            return torch.autograd.grad(causal_conv_ref(*leaves)[0], leaves, dy)

    monkeypatch.setattr(cc, "_launch", launch)
    monkeypatch.setattr(cc, "_launch_bwd", launch_bwd)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_function_gradients(stand_in, dtype):
    x, w, b, _ = _operands(2, 20, 16, dtype)
    dy = torch.randn(2, 20, 16).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    window = torch.zeros(2, 3, 16, dtype=dtype)
    with WorkLog() as log:
        out = cc._ConvSiLU.apply(*leaves, None, window)
        got = torch.autograd.grad(out, leaves, dy)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(causal_conv_ref(*ref)[0], ref, dy)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=2 ** -7 if dtype == BF16 else 1e-6, atol=1e-6)
    assert torch.equal(window, causal_conv_ref(x, w, b)[1])
    assert log.calls == {
        ("causal_conv", "bwd"): [1, *cc.work_bwd(2, 20, 16, x.element_size(), w.element_size())],
        ("causal_conv", "bwd_reduce"): [1, *cc.work_reduce(2, 20, 16, w.element_size())]}


def test_no_backward_through_a_carry(stand_in):
    x, w, b, c = _operands(2, 1, 16, F32, carry=True)
    x.requires_grad_()
    out = cc._ConvSiLU.apply(x, w, b, c, c)
    with pytest.raises(RuntimeError, match="read a carry"):
        out.sum().backward()


# --------------------------------------------------------------------------- #
# the kernels' walks
# --------------------------------------------------------------------------- #
def _fwd_walk(x, w, b, carry=None, carry_out=None, tt=4, reverse_taps=False, use_carry=True):
    """conv_silu_fwd_kernel's walk, every (batch row, channel) at once: runs
    of ``tt`` rows, each from a 3-row window of x (rows before 0 from the
    carry, zeros without), the taps from the oldest row, f32.  SiLU over the
    whole output at the end (PyTorch's CPU exp differs in its last bit
    between vectorised and tail elements)."""
    B, S, CH = x.shape
    wf = (w.flip(0) if reverse_taps else w).to(F32)
    pre = torch.empty(x.shape, dtype=F32)
    for t0 in range(0, S, tt):
        win = []
        for j in range(3):
            r = t0 - 3 + j
            if r >= 0:
                win.append(x[:, r].to(F32))
            elif carry is not None and use_carry:
                win.append(carry[:, r + 3].to(F32))
            else:
                win.append(torch.zeros(B, CH))
        for t in range(t0, min(t0 + tt, S)):
            cur = x[:, t].to(F32)
            acc = torch.zeros(B, CH)
            for i in range(3):
                acc = acc + win[i] * wf[i]
            pre[:, t] = acc + cur * wf[3] + b.to(F32)
            win = win[1:] + [cur]
        if carry_out is not None and min(t0 + tt, S) == S:
            carry_out.copy_(torch.stack(win, dim=1))
    return F.silu(pre).to(x.dtype)


def _conv64(x, w, b):
    """The conv, bias and SiLU in x's dtype throughout (f64 here)."""
    padded = F.pad(x, (0, 0, 3, 0))
    pre = sum(padded[:, i:i + x.shape[1]] * w[i] for i in range(4)) + b
    return F.silu(pre)


def _bwd_walk(x, w, b, dy, rows=16, runs=8, lookahead=3):
    """conv_silu_bwd_kernel and its reduction: runs of ``rows`` rows walked
    ``lookahead`` rows past their end, dx written three rows behind; dw and
    db summed a run, a CTA's ``runs`` runs in order, then the CTAs in
    order.  In x's dtype (f64 here)."""
    B, S, CH = x.shape
    dx = torch.zeros_like(x)
    parts = []
    for cta in range(math.ceil(S / (rows * runs))):
        cta_sum = torch.zeros(B, 5, CH, dtype=x.dtype)
        for r in range(runs):
            t0 = (cta * runs + r) * rows
            acc = torch.zeros(B, 5, CH, dtype=x.dtype)
            if t0 < S:
                t1 = min(t0 + rows, S)
                xw = [x[:, t] if t >= 0 else torch.zeros(B, CH, dtype=x.dtype)
                      for t in range(t0 - 3, t0)]
                dp = [torch.zeros(B, CH, dtype=x.dtype)] * 3
                for t in range(t0, t1 + lookahead):
                    xc = x[:, t] if t < S else torch.zeros(B, CH, dtype=x.dtype)
                    d = torch.zeros(B, CH, dtype=x.dtype)
                    if t < S:
                        p = xw[0] * w[0] + xw[1] * w[1] + xw[2] * w[2] + xc * w[3] + b
                        sg = torch.sigmoid(p)
                        d = dy[:, t] * sg * (1 + p * (1 - sg))
                    if t < t1:
                        acc += torch.stack([d * xw[0], d * xw[1], d * xw[2], d * xc, d], dim=1)
                    g = d * w[0] + dp[2] * w[1] + dp[1] * w[2] + dp[0] * w[3]
                    if t - 3 >= t0:
                        dx[:, t - 3] = g
                    xw, dp = xw[1:] + [xc], dp[1:] + [d]
            cta_sum += acc
        parts.append(cta_sum)
    total = torch.zeros(5, CH, dtype=x.dtype)
    for bb in range(B):  # the C side's order: batch rows, then CTAs along time
        for part in parts:
            total += part[bb]
    return dx, total[:4], total[4]


@pytest.mark.parametrize("S,tt", [(1, 1), (2, 4), (3, 4), (4, 4), (9, 4), (33, 8), (64, 32)])
@pytest.mark.parametrize("carry", [False, True])
def test_forward_walk_is_the_plain_version(S, tt, carry):
    x, w, b, c = _operands(2, S, 8, F32, seed=S, carry=carry)
    window = torch.empty(2, 3, 8)
    got = _fwd_walk(x, w, b, c, window, tt=tt)
    want, want_window = causal_conv_ref(x, w, b, c)
    assert torch.equal(got, want) and torch.equal(window, want_window)


@pytest.mark.parametrize("fault", ["taps reversed", "carry ignored"])
def test_forward_walk_faults_fail(fault):
    x, w, b, c = _operands(2, 5, 8, F32, carry=True)
    got = _fwd_walk(x, w, b, c, tt=4, reverse_taps=fault == "taps reversed",
                    use_carry=fault != "carry ignored")
    assert not torch.allclose(got, causal_conv_ref(x, w, b, c)[0], atol=1e-2)


@pytest.mark.parametrize("S", [1, 2, 3, 16, 17, 130, 300])
def test_backward_walk_is_autograd(S):
    x, w, b, _ = _operands(3, S, 8, F64, seed=S)
    dy = torch.from_numpy(np.random.default_rng(S + 1).standard_normal((3, S, 8)))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(_conv64(*leaves), leaves, dy)
    got = _bwd_walk(x, w, b, dy)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


def test_backward_walk_needs_its_lookahead():
    x, w, b, _ = _operands(2, 40, 8, F64)
    dy = torch.ones(2, 40, 8, dtype=F64)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(_conv64(*leaves), leaves, dy)[0]
    assert not torch.allclose(_bwd_walk(x, w, b, dy, lookahead=2)[0][:, :16], want[:, :16])
