"""The port's checkpoints (`repro_torch.train.checkpoint`) and the
trainer's resume, on the CPU: the reference's cases
(`tests/test_checkpoint.py`, the checkpoint drills of
`tests/test_health.py`) on the port.

Round trips are bitwise (`torch.equal`, dtype and device kept). A run
killed and resumed from its checkpoint must equal an uninterrupted one
bitwise: parameters, Adam state and, with index refresh, the whole
maintained `RefreshState`.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import FOPOConfig  # noqa: E402
from repro_torch.data import SyntheticConfig, generate_sessions  # noqa: E402
from repro_torch.health import (  # noqa: E402
    FaultPlan,
    HealthConfig,
    SimulatedPreemption,
    corrupt_checkpoint,
    torn_checkpoint_writes,
    transient_save_failures,
)
from repro_torch.mips.ivf import build_ivf  # noqa: E402
from repro_torch.mips.refresh import RefreshConfig, RefreshState  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.train import (  # noqa: E402
    CheckpointCorruptError,
    FOPOTrainer,
    TrainerConfig,
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)


def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g), "b": torch.zeros(8)},
        "opt": {"step": torch.tensor(seed, dtype=torch.int32), "m": torch.ones((8, 8)),
                "half": torch.randn((3, 5), generator=g).to(torch.bfloat16)},
        "gen": g.get_state(),
        "guard": (torch.tensor(1.5), None, [torch.arange(4, dtype=torch.int64)]),
    }


def assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


@pytest.fixture(scope="module")
def ds():
    full = generate_sessions(SyntheticConfig(
        num_items=300, num_users=200, embed_dim=16, session_len=8, seed=0
    ))
    return full.split(0.85, seed=0)[0]


def make_trainer(ds, health=None, fault=None, *, steps=6, ckpt_dir=None, ckpt_every=0,
                 refresh=False):
    kw = {}
    fopo = FOPOConfig(num_items=300, num_samples=32, top_k=16, epsilon=0.8, retriever="exact")
    if refresh:
        index = build_ivf(torch.from_numpy(ds.item_embeddings), num_clusters=8, cap=128,
                          kmeans_iters=3, cap_tile=32, seed=1, device="cpu")
        fopo = FOPOConfig(num_items=300, num_samples=32, top_k=16, epsilon=0.8,
                          retriever="ivf_pallas", index_refresh=RefreshConfig(
                              every=2, minibatch=64, compact_every=3, delta_cap=16))
        kw["retriever_kwargs"] = {"index": index, "n_probe": 4, "cap_tile": 32}
    tc = TrainerConfig(estimator="fopo", fopo=fopo, batch_size=8, learning_rate=3e-3,
                       num_steps=steps, checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                       seed=0, health=health)
    return FOPOTrainer(tc, ds, fault_plan=fault, device="cpu", **kw)


# -- the reference's tests/test_checkpoint.py cases ---------------------------------------

def test_roundtrip(tmp_path):
    d = str(tmp_path)
    st = _state(3)
    save_checkpoint(d, 100, st)
    step, restored, extra = restore_checkpoint(d, _state(0))
    assert step == 100 and extra == {}
    assert_tree_equal(st, restored)


def test_rotation_keeps_last_n(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        save_checkpoint(d, s * 10, _state(s), keep=3)
    assert list_checkpoints(d) == [30, 40, 50]
    assert latest_checkpoint(d) == 50


def test_extra_payload_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 7, _state(0), extra={"loader": {"epoch": 2, "position": 5, "seed": 0}})
    _, _, extra = restore_checkpoint(d, _state(0))
    assert extra["loader"] == {"epoch": 2, "position": 5, "seed": 0}


@pytest.mark.parametrize("template", [
    {"just_one_leaf": torch.zeros(3)},
    {"params": {"w": torch.zeros(8, 8), "b": torch.zeros(8)},
     "opt": {"step": torch.tensor(0), "m": torch.zeros(8, 8), "half": torch.zeros(3, 5)},
     "gen": torch.zeros(8), "guard": [torch.tensor(0.0), None, [torch.zeros(4)]]},
], ids=["leaf_count", "structure"])
def test_restore_validates_structure(tmp_path, template):
    d = str(tmp_path)
    save_checkpoint(d, 1, _state(0))
    with pytest.raises(ValueError):
        restore_checkpoint(d, template)


def test_no_partial_checkpoint_on_failure(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, _state(1))
    for name in os.listdir(d):
        assert not name.startswith(".ckpt_tmp_")
        if name.startswith("step_"):
            assert os.path.exists(os.path.join(d, name, "manifest.json"))


def test_restore_puts_leaves_on_the_template_device_and_dtype(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 2, {"a": np.arange(5, dtype=np.int32), "b": torch.ones(2)})
    _, out, _ = restore_checkpoint(d, {"a": np.zeros(5, np.int64),
                                       "b": torch.zeros(2, dtype=torch.float64)})
    assert out["a"].dtype == np.int64 and out["a"].tolist() == list(range(5))
    assert out["b"].dtype == torch.float64 and out["b"].tolist() == [1.0, 1.0]


# -- integrity: checksums, fallback, retries, torn writes (tests/test_health.py) ---------

def test_checkpoint_checksum_roundtrip(tmp_path):
    d = str(tmp_path)
    s = _state(0)
    save_checkpoint(d, 5, s)
    with open(os.path.join(d, "step_0000000005", "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest["checksums"]) == len(tree_leaves(s))
    step, out, _ = restore_checkpoint(d, s)
    assert step == 5
    assert_tree_equal(s, out)


def test_checkpoint_without_checksums_still_loads(tmp_path):
    d = str(tmp_path)
    s = _state(0)
    save_checkpoint(d, 1, s)
    mpath = os.path.join(d, "step_0000000001", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["checksums"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    step, out, _ = restore_checkpoint(d, s)
    assert step == 1
    assert_tree_equal(s, out)


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_checkpoint_detected(tmp_path, mode):
    d = str(tmp_path)
    s = _state(0)
    save_checkpoint(d, 7, s)
    corrupt_checkpoint(d, 7, mode=mode)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, s)


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_latest_falls_back_to_previous(tmp_path, mode):
    d = str(tmp_path)
    s = _state(0)
    save_checkpoint(d, 2, s)
    save_checkpoint(d, 4, _state(1))
    corrupt_checkpoint(d, 4, mode=mode)
    step, out, _ = restore_checkpoint(d, s, fallback=True)
    assert step == 2
    assert_tree_equal(s, out)
    corrupt_checkpoint(d, 2, mode=mode)
    with pytest.raises(CheckpointCorruptError, match="all candidate"):
        restore_checkpoint(d, s, fallback=True)


def test_corrupt_checkpoint_rejects_unknown_mode(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _state(0))
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_checkpoint(d, 1, mode="shred")


def test_trainer_resumes_past_corrupt_checkpoint(ds, tmp_path):
    d = str(tmp_path / "ckpt")
    make_trainer(ds, health=HealthConfig(), steps=4, ckpt_dir=d, ckpt_every=2).train()
    corrupt_checkpoint(d, 4, mode="bitflip")
    t2 = make_trainer(ds, health=HealthConfig(), steps=4, ckpt_dir=d, ckpt_every=2)
    assert t2.maybe_restore()
    assert t2.step == 2  # fell back past the corrupt step-4 checkpoint


def test_transient_save_failures_retried(tmp_path):
    d = str(tmp_path)
    s = _state(0)
    with transient_save_failures(2):
        save_checkpoint(d, 3, s, retries=2, backoff=0.001)
    step, _, _ = restore_checkpoint(d, s)
    assert step == 3
    with transient_save_failures(1):
        with pytest.raises(OSError, match="injected"):
            save_checkpoint(d, 9, s, retries=0)
    assert not os.path.exists(os.path.join(d, "step_0000000009"))


def test_torn_write_leaves_no_partial_checkpoint(tmp_path):
    d = str(tmp_path)
    with torn_checkpoint_writes():
        with pytest.raises(OSError):
            save_checkpoint(d, 1, _state(0), retries=1, backoff=0.001)
    assert [p for p in os.listdir(d) if p.startswith("step_")] == []


def test_trainer_save_retries_via_health_config(ds, tmp_path):
    d = str(tmp_path / "ckpt")
    h = HealthConfig(save_retries=2, save_backoff=0.001)
    t = make_trainer(ds, health=h, steps=2, ckpt_dir=d, ckpt_every=2)
    with transient_save_failures(2):
        t.train()
    t2 = make_trainer(ds, health=h, steps=2, ckpt_dir=d, ckpt_every=2)
    assert t2.maybe_restore() and t2.step == 2


# -- kill and resume: bitwise trajectory parity -----------------------------------------

@pytest.mark.parametrize("refresh", [False, True], ids=["exact", "index_refresh"])
def test_preemption_resume_trajectory_parity(ds, tmp_path, refresh):
    """Kill before step 4, resume from the step-4 checkpoint, finish: the
    final parameters, Adam state and (with index refresh) the maintained
    index, overflow counter included, equal an uninterrupted run's bit
    for bit (the step-seed and refresh generators and the loader ride
    the checkpoint)."""
    d = str(tmp_path / "ckpt")
    a = make_trainer(ds, steps=6, refresh=refresh)
    a.train()

    b = make_trainer(ds, steps=6, ckpt_dir=d, ckpt_every=2, fault=FaultPlan(kill_at=4),
                     refresh=refresh)
    with pytest.raises(SimulatedPreemption):
        b.train()

    c = make_trainer(ds, steps=6, ckpt_dir=d, ckpt_every=2, refresh=refresh)
    assert c.maybe_restore()
    assert c.step == 4
    c.train(2)
    assert_tree_equal(a.params, c.params)
    assert_tree_equal(a.opt_state, c.opt_state)
    if refresh:
        assert isinstance(c.index_state, RefreshState)
        assert_tree_equal(list(a.index_state), list(c.index_state))
        assert not torch.equal(a.index_state.centroids, b.plan.initial_index_state.centroids)


def test_guarded_resume_carries_the_guard_and_the_degraded_flag(ds, tmp_path):
    from repro_torch.health import IndexHealthConfig

    d = str(tmp_path / "ckpt")
    ih = IndexHealthConfig(probe_every=1, probe_rows=32, probe_k=16, recall_floor=1.01,
                           cooldown=0)
    t = make_trainer(ds, health=HealthConfig(index=ih), steps=4, ckpt_dir=d, ckpt_every=4,
                     refresh=True)
    t.train()
    assert t._degraded
    r = make_trainer(ds, health=HealthConfig(index=ih), steps=4, ckpt_dir=d, ckpt_every=4,
                     refresh=True)
    assert r.maybe_restore() and r._degraded and r.plan.degraded
    assert_tree_equal(list(t.guard_state), list(r.guard_state))
