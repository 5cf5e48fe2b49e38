"""The port's data pipeline against the JAX package's.

``repro_torch/data/pipeline.py`` is the reference's text with ``repro``
renamed (``tests/test_torch_imports.py`` holds it so); these tests hold its
batches equal to the reference's, step by step and host by host, and run
``tests/test_substrates.py``'s data scenarios on the port.  Everything is
numpy integers: equality is exact.
"""
import numpy as np
import pytest

from repro.data import SyntheticLMDataset as JaxDataset
from repro_torch.data import Batch, SyntheticLMDataset, prefetch

CASES = [  # (vocab, seq_len, global_batch, seed, n_hosts, induction_period)
    (100, 32, 4, 7, 1, 64),
    (32000, 1024, 8, 0, 1, 64),   # chip_smoke.py's train phase
    (1000, 256, 8, 1, 2, 64),
    (512, 48, 8, 3, 4, 16),
]


@pytest.mark.parametrize("vocab,seq_len,batch,seed,n_hosts,period", CASES)
def test_batches_equal_reference(vocab, seq_len, batch, seed, n_hosts, period):
    for host in range(n_hosts):
        ours = SyntheticLMDataset(vocab, seq_len, batch, seed=seed, host_id=host,
                                  n_hosts=n_hosts, induction_period=period)
        ref = JaxDataset(vocab, seq_len, batch, seed=seed, host_id=host, n_hosts=n_hosts,
                         induction_period=period)
        for step in (0, 1, 5, 12):
            a, b = ours.batch(step), ref.batch(step)
            assert a.step == b.step == step
            assert a.tokens.dtype == b.tokens.dtype == np.int32
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.inputs, b.inputs)
            np.testing.assert_array_equal(a.labels, b.labels)


def test_iteration_equals_reference():
    ours, ref = SyntheticLMDataset(100, 16, 2, seed=4), JaxDataset(100, 16, 2, seed=4)
    for a, b, _ in zip(ours, ref, range(4)):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# tests/test_substrates.py::TestData on the port
def test_deterministic_addressing():
    ds = SyntheticLMDataset(vocab=100, seq_len=32, global_batch=4, seed=7)
    a, b = ds.batch(5), ds.batch(5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(ds.batch(5).tokens, ds.batch(6).tokens)


def test_host_sharding_disjoint():
    h0 = SyntheticLMDataset(100, 32, 8, seed=1, host_id=0, n_hosts=2)
    h1 = SyntheticLMDataset(100, 32, 8, seed=1, host_id=1, n_hosts=2)
    assert h0.local_batch == h1.local_batch == 4
    assert not np.array_equal(h0.batch(0).tokens, h1.batch(0).tokens)


def test_labels_shifted():
    b = SyntheticLMDataset(100, 16, 2, seed=0).batch(0)
    assert isinstance(b, Batch)
    np.testing.assert_array_equal(b.inputs[:, 1:], b.labels[:, :-1])


def test_induction_signal_present():
    t = SyntheticLMDataset(1000, 256, 2, seed=0, induction_period=64).batch(0).tokens
    np.testing.assert_array_equal(t[:, 64:96], t[:, :32])


def test_prefetch_order():
    it = iter(SyntheticLMDataset(100, 16, 2, seed=0))
    assert [b.step for b, _ in zip(prefetch(it, depth=2), range(5))] == [0, 1, 2, 3, 4]


def test_batch_divisibility_check():
    with pytest.raises(ValueError):
        SyntheticLMDataset(100, 16, 5, n_hosts=2)
