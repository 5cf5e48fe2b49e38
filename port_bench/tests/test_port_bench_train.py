"""The training traffic kind at a tiny size on the CPU: a run comes out
correct; a step that leaves the state unchanged and a loss over half of the
rows come out not correct; the float8 control reads above the program."""
import importlib

import pytest

from port_bench_tiny import tiny_cell


def test_a_run_is_correct():
    cell, traffic = tiny_cell("mamba2.train", "bfloat16", trace=True)
    rec = traffic.run(cell)
    assert rec.correct, rec.checks
    assert rec.end_to_end["train_tokens_per_s"] > 0 and rec.readings["traced_steps"] == 1


def test_state_left_unchanged_reads_one(monkeypatch):
    """The step's update skipped after the first moment is written: the
    parameters never move, so the change reads 1 on every moved leaf."""
    optim = importlib.import_module("repro_torch.train.loop")
    real = optim.adamw_update

    def no_update(params, grads, state, cfg):
        saved = {k: p.detach().clone() for k, p in params.items()}
        out = real(params, grads, state, cfg)
        for k, p in params.items():
            p.data.copy_(saved[k])
        return out
    monkeypatch.setattr(optim, "adamw_update", no_update)
    cell, traffic = tiny_cell("mamba2.train", "bfloat16")
    rec = traffic.run(cell)
    assert rec.checks["delta_gap"]["value"] == pytest.approx(1.0)
    assert not rec.correct


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    loop = importlib.import_module("repro_torch.train.loop")
    cell, traffic = tiny_cell("mamba2.train", "bfloat16")
    monkeypatch.setattr(loop, "loss_fn", traffic.half_batch(loop.loss_fn))
    rec = traffic.run(cell)
    assert not rec.correct, rec.checks


def test_the_control_reads_above_the_program():
    cell, traffic = tiny_cell("mamba2.train", "bfloat16")
    prog = traffic.limit_readings(cell, "program", 5)
    ctl = traffic.limit_readings(cell, "control", 5)
    keys = ("loss_gap", "grad_gap", "delta_gap")
    assert max(ctl["control_" + k] / max(prog[k], 1e-12) for k in keys) > 3
