"""The port's `BatchLoader`, which holds the current epoch's permutation
and draws it again only when the state's (seed, epoch) changes: the same
batches as the reference's loader and as the benchmark's order rule
(`bench/yardstick/gen.py:batch_rows`), after any assignment of its
state, and one draw an epoch on the tracer's counters."""
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench.yardstick.gen import batch_rows  # noqa: E402
from repro.data import BatchLoader as JBatchLoader  # noqa: E402
from repro_torch.data.loader import BatchLoader, LoaderState  # noqa: E402
from repro_torch.obs.trace import Tracer, tracing  # noqa: E402

BIG_SEED = 2**31 + 12_345  # the benchmark's seeds pass 32 signed bits


def _arrays(n: int) -> dict[str, np.ndarray]:
    return {"x": np.arange(n) * 3, "y": np.arange(2 * n, dtype=np.float32).reshape(n, 2)}


def _fresh(arrays, batch, state: LoaderState, **kw) -> BatchLoader:
    loader = BatchLoader(arrays, batch, **kw)
    loader.state = LoaderState(**state.to_dict())
    return loader


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n,batch,num_hosts,host_id", [
    (100, 16, 1, 0),   # 6 batches an epoch, 4 rows dropped
    (101, 7, 2, 1),    # 50 rows a host, 7 batches, 1 dropped
    (96, 8, 4, 3),     # no remainder
])
def test_cached_loader_is_the_reference_bit_for_bit(n, batch, num_hosts, host_id):
    arrays = _arrays(n)
    kw = dict(host_id=host_id, num_hosts=num_hosts, seed=BIG_SEED)
    tl, jl = BatchLoader(arrays, batch, **kw), JBatchLoader(arrays, batch, **kw)
    for _ in range(3 * tl.batches_per_epoch + 1):  # three epochs and into a fourth
        _assert_same(tl.next_batch(), jl.next_batch())
        assert tl.state.to_dict() == jl.state.to_dict()
    assert tl.state.epoch == 3


@pytest.mark.parametrize("n,batch,seed", [(100, 16, 0), (4096 + 5, 512, BIG_SEED)])
def test_loader_follows_the_yardsticks_batch_rows(n, batch, seed):
    arrays = {"row": np.arange(n)}
    loader = BatchLoader(arrays, batch, seed=seed)
    for step in range(2 * loader.batches_per_epoch + 2):  # steps 0 to 2 epochs + 1
        np.testing.assert_array_equal(loader.next_batch()["row"],
                                      batch_rows(n, batch, seed, step))


def test_state_replaced_mid_epoch_rolled_back_and_reseeded():
    arrays, batch = _arrays(100), 16  # 6 batches an epoch
    loader = BatchLoader(arrays, batch, seed=7)
    for _ in range(8):  # into epoch 1
        loader.next_batch()
    for state, steps in (
        (LoaderState(epoch=3, position=2, seed=7), 2),  # a restore, mid-epoch
        (LoaderState(epoch=3, position=1, seed=7), 2),  # the same epoch, an earlier position
        (LoaderState(epoch=1, position=2, seed=7), 2),  # a rollback to an earlier epoch
        (LoaderState(epoch=1, position=4, seed=8), 9),  # the seed changed last, same epoch
    ):
        loader.state = LoaderState(**state.to_dict())
        want = _fresh(arrays, batch, state)
        for _ in range(steps):  # the last one past the next epoch's start
            _assert_same(loader.next_batch(), want.next_batch())
    assert loader.state.epoch == 3


def test_mutating_a_batch_leaves_later_batches_alone():
    arrays, batch = _arrays(100), 16
    loader, want = BatchLoader(arrays, batch, seed=3), BatchLoader(arrays, batch, seed=3)
    for _ in range(2 * loader.batches_per_epoch + 1):
        got = loader.next_batch()
        _assert_same(got, want.next_batch())
        for v in got.values():
            v[...] = -1
    np.testing.assert_array_equal(arrays["x"], np.arange(100) * 3)


def test_counters_count_one_permutation_an_epoch():
    arrays, batch = _arrays(100), 16
    loader = BatchLoader(arrays, batch, seed=5)
    calls = 3 * loader.batches_per_epoch + 2  # epochs 0-3 entered
    with tracing(Tracer()) as t:
        for _ in range(calls):
            loader.next_batch()
        totals = t.counter_totals()
        assert totals["loader.batches"] == calls
        assert totals["loader.permutations"] == 4
        assert sum(e["name"] == "permute" for e in t.events) == 4
        assert sum(e["name"] == "gather" for e in t.events) == calls
        loader.state = LoaderState(epoch=0, position=1, seed=5)  # back to epoch 0
        loader.next_batch()
        loader.state = LoaderState(epoch=0, position=3, seed=5)  # same key: held
        loader.next_batch()
        totals = t.counter_totals()
    assert totals["loader.batches"] == calls + 2
    assert totals["loader.permutations"] == 5
