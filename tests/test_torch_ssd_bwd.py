"""The SSD scan's backward kernel (``wgmma_bwd``) off the card: its plain
emulation ``ref.ssd_scan_bwd_phases``, its selector, its ``meta`` route and
the dispatch of ``_SSDScan.backward``.

The kernel itself runs only on the card (``tests/test_torch_card.py::
test_ssd_wgmma_bwd``, ``chip_smoke.py --only kernels,train_mamba2``).  Here
its arithmetic is emulated phase by phase (the same chunk-start states and
state cotangents kept as hi + lo bf16 halves, the same splits of every f32
operand, the same fixed-order sums: over the heads of a cluster rank, then
over the ranks) and held against ``jax.vjp`` of the reference's
``_ssd_chunked`` in f32.
The splits keep ~16 bits of each operand (2**-17 relative) and the two
differ in summation order: measured <= 6e-6 of each gradient's largest
magnitude over the cases below, bound 2e-5 (``test_torch_ssd_vjp.py`` holds
the f32 VJP, which splits nothing, to 1e-5).  In f64 the emulation splits
nothing and equals ``ssd_scan_vjp`` to f64 rounding (bound 1e-9).  Dropping
the lo halves (the planted fault) costs ~2e-3.  dt is drawn as
softplus(N(0, 1) - dt_shift): at dt_shift 4 (dt ~0.02) the state carried
across chunks counts, at 0 it decays by ~e^-50 a chunk.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels import select_ssd_bwd_variant
from repro_torch.kernels._work import WorkLog
from repro_torch.kernels.ref import BWD_CLUSTER, bwd_head_ranks, ssd_scan_bwd_phases, ssd_scan_ref

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

JAX_TOL = 2e-5   # f32 with hi + lo splits, against jax.vjp of _ssd_chunked
F64_TOL = 1e-9   # f64, no splits, against ssd_scan_vjp
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _draw(seed, Bsz, S, H, G, N, dt_shift, dtype=np.float32):
    """x [B,S,H,64], dt [B,S,H], A [H], B and C [B,S,G,N] (at 0.5), the
    cotangents dy and dh, as numpy."""
    P = 64
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P))
    Bm, Cm = (rng.standard_normal((Bsz, S, G, N)) * 0.5 for _ in range(2))
    dt = np.logaddexp(0.0, rng.standard_normal((Bsz, S, H)) - dt_shift)
    A = -np.exp(rng.standard_normal(H) * 0.5)
    dy = rng.standard_normal((Bsz, S, H, P))
    dh = rng.standard_normal((Bsz, H, P, N))
    return [a.astype(dtype) for a in (x, dt, A, Bm, Cm, dy, dh)]


def _phases(x, dt, A, Bm, Cm, dy, dh, lo=True, dropped_rank=None, ranks=BWD_CLUSTER):
    """The emulation with dA summed over the batch (A is [H] here)."""
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    out = ssd_scan_bwd_phases(*t, None if dh is None else torch.from_numpy(dh), lo=lo,
                              dropped_rank=dropped_rank, ranks=ranks)
    return out[0], out[1], out[2].sum(0), out[3], out[4]


def _jax_vjp(x, dt, A, Bm, Cm, dy, dh):
    _, pull = jax.vjp(lambda *a: jax_ssm._ssd_chunked(*a, chunk=64),
                      *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    dh = np.zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[3]), np.float32) \
        if dh is None else dh
    return [torch.from_numpy(np.array(g)) for g in pull((jnp.asarray(dy), jnp.asarray(dh)))]


def _errs(got, want):
    return {n: float((g.double() - w.double()).abs().max() / w.double().abs().max())
            for n, g, w in zip(NAMES, got, want)}


# H 4; G 1, 2 and H; S 100 (ragged: one full chunk and 36 positions)
SHAPES = [(N, G) for N in (16, 64, 128) for G in (1, 2, 4)]


@pytest.mark.parametrize("dt_shift", [0.0, 4.0])
@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("N,G", SHAPES, ids=[f"N{n}-G{g}" for n, g in SHAPES])
def test_phases_match_jax_vjp(N, G, with_dh, dt_shift):
    x, dt, A, Bm, Cm, dy, dh = _draw(7, 2, 100, 4, G, N, dt_shift)
    dh = dh if with_dh else None
    want = _jax_vjp(x, dt, A, Bm, Cm, dy, dh)
    got = _phases(x, dt, A, Bm, Cm, dy, dh)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    errs = _errs(got, want)
    assert max(errs.values()) <= JAX_TOL, errs


@pytest.mark.parametrize("Bsz,S,H,G,N", [(1, 64, 2, 1, 128), (2, 37, 4, 2, 16),
                                         (1, 200, 4, 4, 64), (2, 1, 2, 1, 16)])
def test_phases_match_jax_vjp_at_other_lengths(Bsz, S, H, G, N):
    """One whole chunk, a sequence shorter than one (the reference's chunk
    is then S itself), four chunks with a ragged end, one position."""
    x, dt, A, Bm, Cm, dy, dh = _draw(8, Bsz, S, H, G, N, 4.0)
    errs = _errs(_phases(x, dt, A, Bm, Cm, dy, dh), _jax_vjp(x, dt, A, Bm, Cm, dy, dh))
    assert max(errs.values()) <= JAX_TOL, errs


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("dt_shift", [0.0, 4.0])
@pytest.mark.parametrize("N,G", [(16, 1), (64, 2), (128, 4)])
def test_phases_equal_the_vjp_in_f64(N, G, dt_shift, with_dh):
    """In f64 nothing is split: the phases' algebra equals ``ssd_scan_vjp``'s."""
    x, dt, A, Bm, Cm, dy, dh = _draw(9, 2, 150, 4, G, N, dt_shift, np.float64)
    dh = dh if with_dh else None
    got = _phases(x, dt, A, Bm, Cm, dy, dh)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    want = list(ssd.ssd_scan_vjp(t[0], t[1], t[2][None].expand(2, -1), *t[3:],
                                 None if dh is None else torch.from_numpy(dh)))
    want[2] = want[2].sum(0)
    assert all(g.dtype == torch.float64 for g in got)
    errs = _errs(got, want)
    assert max(errs.values()) <= F64_TOL, errs


@pytest.mark.parametrize("N", [16, 128])
def test_dropped_lo_halves_break_the_bound(N):
    """Planted fault: the f32 operands enter as their hi halves only."""
    x, dt, A, Bm, Cm, dy, dh = _draw(10, 2, 150, 4, 1, N, 4.0)
    want = _jax_vjp(x, dt, A, Bm, Cm, dy, dh)
    assert max(_errs(_phases(x, dt, A, Bm, Cm, dy, dh), want).values()) <= JAX_TOL
    assert max(_errs(_phases(x, dt, A, Bm, Cm, dy, dh, lo=False), want).values()) > 10 * JAX_TOL


# the gradient phase's clusters: heads of a group the cluster size does not
# divide (12 = 8 ranks of 1 or 2, 10 = 8 of 1 or 2), G > 1 (3 groups of 3
# heads: 3 ranks of one), Jamba's N 16 with 24 heads of one group (8 ranks of 3)
RANK_SHAPES = [(12, 1, 64), (20, 2, 128), (9, 3, 16), (24, 1, 16)]
RANK_IDS = [f"H{h}-G{g}-N{n}" for h, g, n in RANK_SHAPES]


@pytest.mark.parametrize("ranks", [8, 7, 4])
@pytest.mark.parametrize("dt_shift", [0.0, 4.0])
@pytest.mark.parametrize("H,G,N", RANK_SHAPES, ids=RANK_IDS)
def test_phases_match_jax_vjp_over_cluster_ranks(H, G, N, dt_shift, ranks):
    """dB and dC summed within each rank's heads, then over the ranks (8, 7
    or 4 of them, as the kernel may pick by occupancy)."""
    x, dt, A, Bm, Cm, dy, dh = _draw(13, 1, 130, H, G, N, dt_shift)
    errs = _errs(_phases(x, dt, A, Bm, Cm, dy, dh, ranks=ranks),
                 _jax_vjp(x, dt, A, Bm, Cm, dy, dh))
    assert max(errs.values()) <= JAX_TOL, errs


@pytest.mark.parametrize("H,G,N", RANK_SHAPES, ids=RANK_IDS)
def test_rank_order_equals_the_vjp_in_f64(H, G, N):
    """The new summation order (heads within a rank, dCB summed before its
    products, then the ranks) is the VJP's algebra: equal in f64."""
    x, dt, A, Bm, Cm, dy, dh = _draw(14, 2, 100, H, G, N, 4.0, np.float64)
    got = _phases(x, dt, A, Bm, Cm, dy, dh)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    want = list(ssd.ssd_scan_vjp(t[0], t[1], t[2][None].expand(2, -1), *t[3:],
                                 torch.from_numpy(dh)))
    want[2] = want[2].sum(0)
    errs = _errs(got, want)
    assert max(errs.values()) <= F64_TOL, errs


@pytest.mark.parametrize("n", [8, 7, 4, 3, 1])
@pytest.mark.parametrize("R", [1, 2, 3, 7, 8, 9, 12, 32, 128])
def test_head_ranks_cover_each_head_once(R, n):
    """min(n, R) ranks of contiguous runs, in order, none empty, sizes
    within one of each other."""
    ranks = bwd_head_ranks(R, n)
    assert len(ranks) == min(n, R)
    assert [h for r in ranks for h in r] == list(range(R))
    assert min(len(r) for r in ranks) >= max(1, max(len(r) for r in ranks) - 1)


@pytest.mark.parametrize("H,N", [(32, 128), (24, 16)])
def test_dropped_rank_breaks_the_bound(H, N):
    """Planted fault: one rank's share of the on-chip head sum left out of
    dB and dC (the kernel's own is in ``chip_smoke.py``)."""
    x, dt, A, Bm, Cm, dy, dh = _draw(15, 1, 100, H, 1, N, 4.0)
    want = _jax_vjp(x, dt, A, Bm, Cm, dy, dh)
    errs = _errs(_phases(x, dt, A, Bm, Cm, dy, dh, dropped_rank=BWD_CLUSTER - 1), want)
    assert errs["dx"] <= JAX_TOL and min(errs["dB"], errs["dC"]) > 100 * JAX_TOL, errs


# --------------------------------------------------------------------------- #
# the selector, the meta route, the dispatch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("P,N,dtype,variant", [
    (64, 128, torch.bfloat16, "wgmma_bwd"), (64, 16, torch.bfloat16, "wgmma_bwd"),
    (64, 80, torch.bfloat16, "wgmma_bwd"), (64, 128, torch.float32, "vjp"),
    (32, 128, torch.bfloat16, "vjp"), (64, 24, torch.bfloat16, "vjp"),
    (64, 256, torch.bfloat16, "vjp")])
def test_select_bwd_variant(P, N, dtype, variant):
    """``wgmma_bwd`` exactly where the forward is ``wgmma``."""
    assert ssd.select_bwd_variant(P, N, dtype) == select_ssd_bwd_variant(P, N, dtype) == variant
    assert (variant == "wgmma_bwd") == (ssd.select_variant(P, N, dtype) == "wgmma")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)


@pytest.mark.parametrize("G,N", [(1, 128), (2, 16)])
def test_meta_backward_counts_one_launch_and_records_its_work(G, N):
    Bsz, S, H, P = 2, 100, 4, 64
    x, dt, A = _meta(Bsz, S, H, P, dtype=torch.bfloat16), _meta(Bsz, S, H), _meta(H)
    Bm, Cm = (_meta(Bsz, S, G, N, dtype=torch.bfloat16) for _ in range(2))
    y = ssd.ssd_mixer(x, dt, A, Bm, Cm)
    before = dict(ssd.LIBRARY.counts)
    with WorkLog() as log:
        y.sum().backward()
    assert {v: n - before[v] for v, n in ssd.LIBRARY.counts.items()} == {
        "wgmma": 0, "cuda_core": 0, "wgmma_bwd": 1}
    assert log.calls == {("ssd_scan", "wgmma_bwd"): [
        1, *ssd.work_bwd(Bsz * H, Bsz * G, S, P, N, 2)]}
    assert [tuple(t.grad.shape) for t in (x, dt, A, Bm, Cm)] == [
        (Bsz, S, H, P), (Bsz, S, H), (H,), (Bsz, S, G, N), (Bsz, S, G, N)]
    assert x.grad.dtype == Bm.grad.dtype == torch.bfloat16 and dt.grad.dtype == torch.float32


@pytest.mark.parametrize("Bsz,S,H,G,N", [(4, 1024, 32, 1, 128), (2, 1024, 128, 1, 16),
                                         (2, 100, 12, 2, 32)])
def test_no_per_head_partials(monkeypatch, Bsz, S, H, G, N):
    """``_launch_bwd`` on ``meta`` allocates its outputs alone, and the CUDA
    route's scratch (``bwd_scratch``) is the states' halves (as many bytes as
    f32 states) and dA's per-chunk shares: nothing of [B, S, H, N], since dB
    and dC are summed over the heads on chip."""
    P = 64
    x, dy = (torch.zeros((Bsz, S, H, P), dtype=torch.bfloat16, device="meta") for _ in range(2))
    dt = torch.zeros((Bsz, S, H), device="meta")
    A2 = torch.zeros((Bsz, H), device="meta")
    Bm, Cm = (torch.zeros((Bsz, S, G, N), dtype=torch.bfloat16, device="meta") for _ in range(2))
    made = []
    empty = torch.empty

    def recording(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t
    monkeypatch.setattr(torch, "empty", recording)
    ssd._launch_bwd(x, dt, A2, Bm, Cm, dy, None)
    assert sorted(made, key=str) == sorted([
        ((Bsz, S, H, P), torch.bfloat16), ((Bsz, S, H), torch.float32), ((Bsz, H), torch.float32),
        ((Bsz, S, G, N), torch.bfloat16), ((Bsz, S, G, N), torch.bfloat16)], key=str)
    scratch = ssd.bwd_scratch(Bsz, S, H, P, N, "meta")
    nch, W = -(-S // 64), 2 * P * (64 if N <= 64 else 128)
    assert [(tuple(t.shape), t.dtype) for t in scratch] == [
        ((Bsz * H, nch, W), torch.bfloat16), ((Bsz * H, nch, W), torch.bfloat16),
        ((Bsz * H, nch), torch.float32)]
    assert all(t.shape != (Bsz, S, H, N) for t in scratch)


def test_launch_bwd_raises_on_cpu_tensors():
    """The wrapper launches or raises: CPU tensors are no kernel's."""
    x, dt, A2, Bm, Cm, dy, dh = (torch.from_numpy(a) for a in _draw(11, 1, 70, 2, 1, 16, 4.0))
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="CPU, CUDA or meta"):
        ssd._launch_bwd(x.to(bf), dt, A2[None], Bm.to(bf), Cm.to(bf), dy.to(bf), dh)


def test_work_bwd_at_mamba2s_train_layout():
    """B 4, S 1024, 32 heads of 64, N 128, one group: 55.6 MB, the
    0.0166 ms bound the VJP was held to."""
    from repro_torch.launch.roofline_model import H100

    ops, nbytes = ssd.work_bwd(4 * 32, 4, 1024, 64, 128, 2)
    assert nbytes == 3 * 4 * 1024 * 32 * 64 * 2 + 4 * 4 * 1024 * 128 * 2 + 2 * 4 * 1024 * 32 * 4 \
        + 2 * 4 * 32 * 4
    assert ops == 2.0 * 4 * 16 * (32 * (6 * 64 * 64 * 128 + 2 * 64 * 64 * 64) + 3 * 64 * 64 * 128)
    assert H100.bound_ms(ops, nbytes, torch.bfloat16) == pytest.approx((0.0166, "bytes"), abs=5e-5)


def _launch_stand_in(calls):
    """``_launch_bwd`` stood in for by ``ssd_scan_vjp`` under ``no_grad``
    (what a kernel returns: tensors with no history), recording its call."""
    vjp = ssd.ssd_scan_vjp

    def launch(x, dt, A2, Bm, Cm, dy, dh):
        calls.append(("wgmma_bwd", x.dtype, dh is None))
        with torch.no_grad():
            return vjp(x, dt, A2, Bm, Cm, dy, dh)
    return launch


def _plain_launch(x, dt, A2, Bm, Cm, return_state):
    """What the forward launch returns: the plain version's, no history."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    rep = H // Bm.shape[2]
    Bf, Cf = (t.repeat_interleave(rep, dim=2) for t in (Bm, Cm))

    def flat(t):
        return t.movedim(2, 1).reshape(Bsz * H, S, *t.shape[3:])

    with torch.no_grad():
        y, h = ssd_scan_ref(flat(x), flat(dt), A2.reshape(-1), flat(Bf), flat(Cf),
                            return_state=True)
    return y.reshape(Bsz, H, S, P).movedim(1, 2), (h.reshape(Bsz, H, P, N) if return_state
                                                   else None)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma_bwd"), (torch.float32, "vjp")])
def test_function_backward_dispatch(monkeypatch, dtype, route):
    """Through ``_SSDScan`` on the ``wgmma`` forward: bf16 at the kernel's
    shapes reaches ``_launch_bwd`` (its work recorded as
    ``("ssd_scan", "wgmma_bwd")``, no VJP record), f32 reaches
    ``ssd_scan_vjp`` (recorded as ``("ssd_scan", "vjp")``); the gradients
    equal autograd through the plain version."""
    calls = []
    monkeypatch.setattr(ssd, "_launch_wgmma", _plain_launch)
    monkeypatch.setattr(ssd, "_launch_bwd", _launch_stand_in(calls))
    vjp = ssd.ssd_scan_vjp

    def vjp_spy(*args):
        calls.append(("vjp", args[0].dtype, args[-1] is None))
        return vjp(*args)
    monkeypatch.setattr(ssd, "ssd_scan_vjp", vjp_spy)
    Bsz, S, H, G, N = 1, 80, 2, 1, 16
    x, dt, A, Bm, Cm, dy, _ = (torch.from_numpy(a) for a in _draw(12, Bsz, S, H, G, N, 4.0))
    leaves = [x.to(dtype).requires_grad_(True), dt.requires_grad_(True), A.requires_grad_(True),
              Bm.to(dtype).requires_grad_(True), Cm.to(dtype).requires_grad_(True)]
    y = ssd._SSDScan.apply(leaves[0], leaves[1], leaves[2][None].expand(Bsz, H), leaves[3],
                           leaves[4], "wgmma", False)
    with WorkLog() as log:
        got = torch.autograd.grad((dy.to(dtype) * y).float().sum(), leaves)
    assert calls == [(route, dtype, True)]
    assert set(log.calls) == {("ssd_scan", route)}
    if route == "wgmma_bwd":
        assert log.calls[("ssd_scan", route)] == [1, *ssd.work_bwd(Bsz * H, Bsz * G, S, 64, N, 2)]
    f32 = [t.detach().float().requires_grad_(True) for t in leaves]
    want_y = ssd.ssd_mixer(*f32)
    want = torch.autograd.grad((dy * want_y).sum(), f32)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5  # bf16: dx, dB, dC rounded once
    for leaf, g, w in zip(leaves, got, want):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        assert float((g.float() - w).abs().max() / w.abs().max()) <= tol
