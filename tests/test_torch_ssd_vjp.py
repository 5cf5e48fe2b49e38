"""The SSD scan's VJP (``kernels/ssd_scan.py::ssd_scan_vjp``) and the
``autograd.Function`` that calls it, on the CPU.

The reference's Pallas kernel has no VJP: the reference trains its SSD
through ``_ssd_chunked`` (``repro/models/ssm.py``), which XLA
differentiates.  So the port's VJP is held against autograd through the
plain version, ``ref.ssd_scan_ref``, in f64 (both exact there: they agree to
f64 rounding, ~3e-15 of each gradient's largest magnitude; bound 1e-9), and
against ``jax.vjp`` of the reference's ``_ssd_chunked`` in f32 (summation
order only: bound 1e-5).  dt is drawn as softplus(N(0, 1) - dt_shift): at
dt_shift 0 a chunk of 64 positions decays by ~e^-50 and a dropped carry
hides, at dt_shift 4 (dt ~0.02) it shows.

On the card the Function's forward launches a kernel; here the launch is
stood in for by the plain version under ``no_grad`` (what a kernel returns:
a tensor with no history), so the backward is the VJP, as on the card in
f32 (bf16 at the kernel's shapes takes the ``wgmma_bwd`` kernel there:
``tests/test_torch_ssd_bwd.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels.ref import ssd_mixer_ref, ssd_scan_ref

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

VJP_TOL = 1e-9       # f64, against autograd through the plain version
JAX_TOL = 1e-5       # f32, against jax.vjp of the reference's _ssd_chunked
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _draw(seed, Bsz, S, H, G, P, N, dt_shift, dtype=np.float64):
    """x [B,S,H,P], dt [B,S,H], A [H], B and C [B,S,G,N] (at 0.5), as
    numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P))
    Bm, Cm = (rng.standard_normal((Bsz, S, G, N)) * 0.5 for _ in range(2))
    dt = np.logaddexp(0.0, rng.standard_normal((Bsz, S, H)) - dt_shift)
    A = -np.exp(rng.standard_normal(H) * 0.5)
    dy = rng.standard_normal((Bsz, S, H, P))
    dh = rng.standard_normal((Bsz, H, P, N))
    return [a.astype(dtype) for a in (x, dt, A, Bm, Cm, dy, dh)]


def _autograd(x, dt, A, Bm, Cm, dy, dh):
    """Autograd through the plain version on the mixer's layout."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    y, h = ssd_mixer_ref(*leaves, return_state=True)
    outs, cots = [y], [torch.from_numpy(dy)]
    if dh is not None:
        outs.append(h)
        cots.append(torch.from_numpy(dh))
    return torch.autograd.grad(outs, leaves, cots)


def _vjp(x, dt, A, Bm, Cm, dy, dh, chunk=ssd.VJP_CHUNK):
    """``ssd_scan_vjp`` with A as [B, H] (the wgmma launch's), dA summed back
    over the batch."""
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    A2 = t[2][None].expand(x.shape[0], -1)
    out = ssd.ssd_scan_vjp(t[0], t[1], A2, t[3], t[4], t[5],
                           None if dh is None else torch.from_numpy(dh), chunk)
    return out[0], out[1], out[2].sum(0), out[3], out[4]


def _errs(got, want):
    return {n: float((g - w).abs().max() / w.abs().max()) for n, g, w in zip(NAMES, got, want)}


CASES = {
    # Bsz, S, H, G, P, N, dt_shift, final-state cotangent, chunk
    "ragged S, G < H, dh": (2, 100, 4, 2, 8, 6, 4.0, True, 64),
    "ragged S, G < H, no dh": (2, 100, 4, 2, 8, 6, 4.0, False, 64),
    "S one short of two chunks": (1, 127, 3, 1, 5, 4, 4.0, True, 64),
    "S below one chunk": (2, 37, 3, 3, 5, 4, 0.0, True, 64),
    "chunk 16, dt_shift 0": (1, 70, 2, 1, 4, 8, 0.0, True, 16),
    "one position": (2, 1, 4, 2, 8, 6, 4.0, True, 64),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_vjp_matches_autograd_f64(case):
    Bsz, S, H, G, P, N, shift, with_dh, chunk = CASES[case]
    x, dt, A, Bm, Cm, dy, dh = _draw(1, Bsz, S, H, G, P, N, shift)
    dh = dh if with_dh else None
    want = _autograd(x, dt, A, Bm, Cm, dy, dh)
    got = _vjp(x, dt, A, Bm, Cm, dy, dh, chunk)
    assert all(g.dtype == torch.float64 and g.shape == w.shape for g, w in zip(got, want))
    errs = _errs(got, want)
    assert max(errs.values()) <= VJP_TOL, errs


@pytest.mark.parametrize("elems", [64 * 64, 3 * 64 * 64, 8 * 64 * 64])
def test_vjp_slices_give_the_same_gradients(monkeypatch, elems):
    """With ``VJP_CHUNK_ELEMS`` shrunk the work goes in slices of one head
    (within a group), of a group, or of batch rows; dB and dC sum over the
    heads of a group across slices."""
    x, dt, A, Bm, Cm, dy, dh = _draw(2, 3, 129, 6, 2, 8, 6, 4.0)
    want = _vjp(x, dt, A, Bm, Cm, dy, dh)
    monkeypatch.setattr(ssd, "VJP_CHUNK_ELEMS", elems)
    got = _vjp(x, dt, A, Bm, Cm, dy, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-13 * float(w.abs().max()))


def _no_carry(decay, r, dh_final):
    """dh not carried across chunks: each chunk ends with a zero cotangent
    but the last, which ends with ``dh_final``."""
    out = torch.zeros_like(r)
    if dh_final is not None:
        out[:, -1] = dh_final
    return out


FAULTS = {
    "dh not carried": ("_chunk_end_grads", _no_carry),
    "exp(cs) dropped from the inter-chunk dcs":
        ("_inter_chunk_dcs", lambda ecs, dy, h0C: (dy * h0C).sum(-1)),
}


@pytest.mark.parametrize("fault", list(FAULTS) + ["dA left out"])
def test_planted_faults_break_the_bound(monkeypatch, fault):
    """Each fault misses autograd by more than 10x the bound, at dt_shift 4
    over 5 chunks (the faults ``chip_smoke.py`` plants in its check (b))."""
    x, dt, A, Bm, Cm, dy, dh = _draw(3, 2, 300, 4, 2, 8, 6, 4.0)
    want = _autograd(x, dt, A, Bm, Cm, dy, dh)
    if fault in FAULTS:
        monkeypatch.setattr(ssd, *FAULTS[fault])
    got = list(_vjp(x, dt, A, Bm, Cm, dy, dh))
    if fault == "dA left out":
        got[2] = torch.zeros_like(got[2])
    assert max(_errs(got, want).values()) > 10 * VJP_TOL


@pytest.mark.parametrize("Bsz,S,H,G,P,N", [(2, 100, 4, 2, 8, 6), (1, 200, 2, 1, 64, 16)])
def test_vjp_matches_jax_ssd_chunked(Bsz, S, H, G, P, N):
    """f32: against ``jax.vjp`` of the reference's ``_ssd_chunked`` (the
    reference's training path), with cotangents for y and the final state."""
    x, dt, A, Bm, Cm, dy, dh = _draw(4, Bsz, S, H, G, P, N, 4.0, np.float32)
    _, pull = jax.vjp(lambda *a: jax_ssm._ssd_chunked(*a, chunk=64),
                           *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    want = [torch.from_numpy(np.array(g)) for g in pull((jnp.asarray(dy), jnp.asarray(dh)))]
    got = _vjp(x, dt, A, Bm, Cm, dy, dh)
    errs = _errs(got, want)
    assert max(errs.values()) <= JAX_TOL, errs


# --------------------------------------------------------------------------- #
# the autograd Function, its launch stood in for by the plain version
# --------------------------------------------------------------------------- #
def _plain(x, dt, A2, Bm, Cm):
    """The plain version on either launch's 4-D operands (A2 [B, H]): y and
    the final state."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    rep = H // Bm.shape[2]
    Bm, Cm = (t.repeat_interleave(rep, dim=2) for t in (Bm, Cm))

    def flat(t):
        return t.movedim(2, 1).reshape(Bsz * H, S, *t.shape[3:])

    y, h = ssd_scan_ref(flat(x), flat(dt), A2.reshape(-1), flat(Bm), flat(Cm),
                        return_state=True)
    return y.reshape(Bsz, H, S, P).movedim(1, 2), h.reshape(Bsz, H, P, N)


def _plain_launch(x, dt, A2, Bm, Cm, return_state):
    """What either launch returns: the plain version's, with no history."""
    with torch.no_grad():
        y, h = _plain(x, dt, A2, Bm, Cm)
    return y, (h if return_state else None)


@pytest.fixture
def stand_in_launches(monkeypatch):
    monkeypatch.setattr(ssd, "_launch_wgmma", _plain_launch)
    monkeypatch.setattr(ssd, "_launch_cuda_core", _plain_launch)


@pytest.mark.parametrize("variant", ["wgmma", "cuda_core"])
@pytest.mark.parametrize("return_state", [True, False])
def test_function_backward_is_the_vjp(stand_in_launches, variant, return_state):
    """Through ``_SSDScan`` on either launch's operands (the mixer's views
    of one conv output for ``wgmma``, one-head views of flat tensors for
    ``cuda_core``), the gradients equal autograd through the plain
    version: x, B and C reach the conv output through the views, A's comes
    back summed to [H] over the expand, and an unused final state gives no
    cotangent (``None``, not zeros)."""
    Bsz, S, H, G, P, N = 2, 90, 4, 2, 8, 6
    x, dt, A, Bm, Cm, dy, dh = _draw(5, Bsz, S, H, G, P, N, 4.0)
    if variant == "cuda_core":  # flat [BH, S, *] operands: one head, one group a row
        x, dy = (a.transpose(0, 2, 1, 3).reshape(Bsz * H, S, 1, P) for a in (x, dy))
        dt = dt.transpose(0, 2, 1).reshape(Bsz * H, S, 1)
        Bm, Cm = (np.repeat(a, H // G, axis=2).transpose(0, 2, 1, 3).reshape(Bsz * H, S, 1, N)
                  for a in (Bm, Cm))
        A = np.tile(A, Bsz)[:, None]
        dh = dh.reshape(Bsz * H, 1, P, N)
        Bsz, H, G = Bsz * H, 1, 1
    conv = torch.from_numpy(np.concatenate(
        [x.reshape(Bsz, S, H * P), Bm.reshape(Bsz, S, G * N), Cm.reshape(Bsz, S, G * N)],
        axis=-1)).requires_grad_(True)
    dtt = torch.from_numpy(dt).requires_grad_(True)
    At = torch.from_numpy(A[:, 0] if variant == "cuda_core" else A).requires_grad_(True)

    def split(c):
        return (c[..., :H * P].reshape(Bsz, S, H, P),
                c[..., H * P:H * P + G * N].reshape(Bsz, S, G, N),
                c[..., H * P + G * N:].reshape(Bsz, S, G, N))

    calls = []
    vjp = ssd.ssd_scan_vjp

    def spy(*args):
        calls.append(args[-1])  # dh_final
        return vjp(*args)

    xs, Bs, Cs = split(conv)
    A2 = At[:, None] if variant == "cuda_core" else At[None].expand(Bsz, H)
    out = ssd._SSDScan.apply(xs, dtt, A2, Bs, Cs, variant, return_state)
    y = out[0] if return_state else out
    assert y.grad_fn is not None
    cot = (torch.from_numpy(dy) * y).sum()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssd, "ssd_scan_vjp", spy)
        got = torch.autograd.grad(cot, (conv, dtt, At))
    assert calls == [None]  # the discarded final state: no cotangent made
    xs, Bs, Cs = split(conv)
    A2 = At[:, None] if variant == "cuda_core" else At[None].expand(Bsz, H)
    want_y = _plain(xs, dtt, A2, Bs, Cs)[0]
    want = torch.autograd.grad((torch.from_numpy(dy) * want_y).sum(), (conv, dtt, At))
    assert got[2].shape == At.shape
    errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    assert max(errs) <= VJP_TOL, errs


def test_function_carries_the_final_state_cotangent(stand_in_launches):
    """A loss that reads the final state: its cotangent reaches the VJP."""
    x, dt, A, Bm, Cm, dy, dh = _draw(6, 1, 150, 4, 1, 8, 6, 4.0)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    y, h = ssd._SSDScan.apply(leaves[0], leaves[1], leaves[2][None].expand(1, 4), leaves[3],
                              leaves[4], "wgmma", True)
    loss = (torch.from_numpy(dy) * y).sum() + (torch.from_numpy(dh) * h).sum()
    got = torch.autograd.grad(loss, leaves)
    want = _autograd(x, dt, A, Bm, Cm, dy, dh)
    assert max(_errs(got, want).values()) <= VJP_TOL


def test_ssd_module_has_no_fence():
    """The CUDA paths no longer raise under grad: the module holds no
    ``NotImplementedError``."""
    import inspect

    assert "NotImplementedError" not in inspect.getsource(ssd)
