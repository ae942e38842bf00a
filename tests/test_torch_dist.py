"""The port's multi-device FOPO step (`repro_torch.dist`) on a gloo world
of four processes on the CPU (data 2 x model 2), against the reference's
single-device fused path and stacked ops, and the port's own
single-process step.

The world: the module fixture writes the inputs only JAX can make (the
reference trainer's step seeds and theta, its refresh rows) to a
temporary directory, then starts this file as a script four times
(``python tests/test_torch_dist.py RANK DIR``); the ranks meet over a
`FileStore` in that directory, run every case below in one order, and
each writes its outputs as numpy arrays. While they run, the parent
computes the reference's answers on the same numpy inputs (made from
seeds, the same on both sides). The ranks import neither JAX nor the
reference.

Tolerances: sampled scores equal to the port's single-process scores bit
for bit; scores, loss, diagnostics and grad_h against the reference's
rtol 1e-6 / atol 1e-6 (sums of terms of both signs taken in another
order: a value near 0 from cancelling terms keeps the absolute error of
the terms); theta gradients rtol 1e-5 /
atol 1e-6 (the reference's dist tests); trainer trajectories rtol 1e-4 /
atol 1e-6 (`tests/test_dist.py`); maintained states as
`tests/test_torch_refresh.py` (ids, lists, slots exact; centroids and
counts rtol 1e-5 / atol 1e-6); top-K scores rtol 1e-5 / atol 1e-6, ids as
sets (the IVF route's catalog repeats embeddings: ids tied with the K-th
score may differ).

The generator-driven mixture sampler draws from a `torch.Generator`
where the reference draws from `jax.random`, so its trajectory (and the
uniform-eps branch) is held to the port's single-process trainer; the
in-kernel sampler's stream is the reference's, and its trajectory is
held to the reference's trainer.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

DATA, MODEL = 2, 2
WORLD = DATA * MODEL
SRC = Path(__file__).resolve().parents[1] / "src"
# (seed, B, S, L, P): ragged P and S; everything divides; S under a tile
SHAPES = [(0, 4, 37, 12, 203), (1, 8, 24, 8, 64), (2, 4, 5, 16, 301)]
ROUTINGS = ("gather", "replicate")
TRAJ = dict(num_items=400, num_users=128, embed_dim=16, session_len=8, seed=1)
TRAJ_STEPS = 4
MAINT = dict(num_items=400, num_users=64, embed_dim=12, session_len=8, seed=2)
MAINT_ROWS, MAINT_STEPS, MAINT_C, MAINT_DCAP = 16, 3, 8, 8


def problem(seed, b=4, s=37, l=12, p=203):
    """The reference test's problem, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return dict(
        beta=rng.standard_normal((p, l)).astype(np.float32),
        x=rng.standard_normal((b, l)).astype(np.float32),
        w=(rng.standard_normal((l, l)) / np.sqrt(l)).astype(np.float32),
        actions=rng.integers(0, p, (b, s)).astype(np.int32),
        log_q=(rng.standard_normal((b, s)) - 5).astype(np.float32),
        rewards=(rng.random((b, s)) < 0.3).astype(np.float32),
        positives=rng.integers(0, p, (b, 8)).astype(np.int32),
    )


def sampler_inputs():
    """(ids [4, 16], scores [4, 16]) of the K5 hash twin, P 500."""
    rng = np.random.default_rng(31)
    scores = (rng.standard_normal((4, 16)) * 2).astype(np.float32)
    ids = np.stack([rng.permutation(500)[:16] for _ in range(4)]).astype(np.int32)
    return ids, scores


def topk_problem(negative: bool):
    rng = np.random.default_rng(3 if negative else 0)
    beta = rng.standard_normal((203, 8)).astype(np.float32)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    if negative:  # every real score negative: the zero pad rows would win
        beta, h = -np.abs(beta) - 0.1, np.abs(h) + 0.1
    return beta, h


def churn():
    """update_items' rows in the maintained run: 10 unique ids."""
    rng = np.random.default_rng(7)
    return (rng.choice(MAINT["num_items"], 10, replace=False).astype(np.int32),
            rng.standard_normal((10, MAINT["embed_dim"])).astype(np.float32))


# ---------------------------------------------------------------------------
# one rank of the world (run as a script; imports no JAX)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, tmp: str) -> None:
    import torch.distributed as tdist

    from repro_torch.core import FOPOConfig, SoftmaxPolicy
    from repro_torch.core.fopo import fopo_loss
    from repro_torch.core.gradients import covariance_surrogate
    from repro_torch.core.policy import linear_tower_apply
    from repro_torch.core.rewards import make_session_reward
    from repro_torch.data import SyntheticConfig, generate_sessions
    from repro_torch.dist import collectives as C
    from repro_torch.dist.fopo import (
        data_rows,
        dist_fused_covariance_loss,
        dist_fused_mixture_sample,
        dist_ivf_topk,
        dist_score_partials,
        dist_scores,
        dist_sharded_topk,
        make_debug_dist,
        shard_rows,
    )
    from repro_torch.health.faults import FaultPlan
    from repro_torch.health.guard import HealthConfig
    from repro_torch.mips import refresh as R
    from repro_torch.mips.exact import TopK
    from repro_torch.mips.ivf import build_ivf_sharded
    from repro_torch.train import FOPOTrainer, TrainerConfig

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=WORLD,
                             rank=rank)
    inputs = dict(np.load(f"{tmp}/inputs.npz"))
    d = make_debug_dist(DATA, MODEL)
    T = torch.from_numpy
    out = {}
    policy = SoftmaxPolicy(tower=linear_tower_apply, item_dim=None)

    # surrogate-level: scores, loss and grad_h, both routings x 3 shapes
    for seed, b, s, l, p in SHAPES:
        pr = problem(seed, b, s, l, p)
        slab = shard_rows(T(pr["beta"]), d)
        h = data_rows(T(pr["x"]) @ T(pr["w"]), d)
        acts, lq, rw = (data_rows(T(pr[k]), d) for k in ("actions", "log_q", "rewards"))
        for routing in ROUTINGS:
            dd = dataclasses.replace(d, routing=routing)
            key = f"loss{seed}{routing}"
            out[f"{key}/partial"] = dist_score_partials(h, slab, acts, lq, rw, dist=dd,
                                                        sample_tile=8).numpy()
            out[f"{key}/scores"] = dist_scores(h, slab, acts, lq, rw, dist=dd,
                                               sample_tile=8).numpy()
            hh = h.clone().requires_grad_(True)
            loss, aux = dist_fused_covariance_loss(hh, slab, acts, lq, rw, dist=dd,
                                                   sample_tile=8)
            (g,) = torch.autograd.grad(loss, hh)
            out[f"{key}/loss"] = np.array([loss.item()] + [aux[k].item() for k in
                                                            ("ess", "rbar", "max_wbar")])
            out[f"{key}/grad_h"] = g.numpy()

    # a shard that owns none of the sampled ids gives exact zeros
    pr = problem(5, p=200)
    acts = data_rows(T(pr["actions"] % 100), d)
    h = data_rows(T(pr["x"]) @ T(pr["w"]), d)
    out["foreign/partial"] = dist_score_partials(
        h, shard_rows(T(pr["beta"]), d), acts, data_rows(T(pr["log_q"]), d),
        data_rows(T(pr["rewards"]), d), dist=d, sample_tile=8).numpy()

    # the normaliser's one reduction (routing="replicate": no other collective
    # on the model group in the forward)
    pr = problem(6, p=64)
    C.reset_stats()
    with torch.no_grad():
        dist_fused_covariance_loss(
            data_rows(T(pr["x"]) @ T(pr["w"]), d), shard_rows(T(pr["beta"]), d),
            *(data_rows(T(pr[k]), d) for k in ("actions", "log_q", "rewards")),
            dist=dataclasses.replace(d, routing="replicate"), sample_tile=8)
    out["once/calls"] = np.array([C.STATS.get(n, {}).get("calls", 0)
                                  for n in ("psum_scores", "gather_samples", "loss_sums")])

    # B not divisible by the data axis raises, in the cut and in the trainer
    raised = []
    try:
        data_rows(torch.zeros((3, 2)), d)
    except ValueError as e:
        raised.append("data-axis" in str(e))
    ds = generate_sessions(SyntheticConfig(**TRAJ))
    try:
        FOPOTrainer(TrainerConfig(fopo=FOPOConfig(num_items=400, dist=d), batch_size=3), ds,
                    device="cpu")
    except ValueError as e:
        raised.append("data-axis" in str(e))
    out["divides/raised"] = np.array(raised)

    # the sharded top-K over a ragged catalog, and with every score negative
    for neg in (False, True):
        beta, hq = topk_problem(neg)
        top = dist_sharded_topk(data_rows(T(hq), d), shard_rows(T(beta), d), 64, d,
                                num_items=beta.shape[0])
        out[f"topk{int(neg)}/scores"] = top.scores.numpy()
        out[f"topk{int(neg)}/ids"] = top.indices.numpy()

    # the 2-D top-K (rows over data, items over model) and a gather from a
    # row-sharded table
    from repro_torch.mips.sharded import context_sharded_topk, sharded_gather_rows

    beta, hq = topk_problem(False)
    top = context_sharded_topk(data_rows(T(hq), d), shard_rows(T(beta), d), 64, dist=d,
                               num_valid=beta.shape[0])
    out["context/scores"], out["context/ids"] = top.scores.numpy(), top.indices.numpy()
    ids = np.random.default_rng(12).integers(0, beta.shape[0], (4, 6))
    out["gather_rows"] = sharded_gather_rows(shard_rows(T(beta), d), T(ids),
                                             d.model_group).numpy()

    # covariance_surrogate(dist=)
    pr = problem(7, p=64)
    loss, _ = covariance_surrogate(
        policy, {"w": T(pr["w"])}, data_rows(T(pr["x"]), d), shard_rows(T(pr["beta"]), d),
        *(data_rows(T(pr[k]), d) for k in ("actions", "log_q", "rewards")),
        sample_tile=8, dist=d)
    out["surrogate/loss"] = np.array([loss.item()])

    # the K5 hash twin: each data rank draws its rows at its row offset
    ids, sc = sampler_inputs()
    smp = dist_fused_mixture_sample(
        int(inputs["sampler_seed"]), TopK(data_rows(T(sc), d), data_rows(T(ids), d)),
        num_samples=37, epsilon=0.45, num_items=500, sample_tile=8, dist=d)
    for k, v in smp._asdict().items():
        out[f"twin/{k}"] = v.numpy()

    # the whole dist step with the in-kernel sampler: loss, aux, theta grads
    pr = problem(8, b=6, l=16, p=501)
    cfg = FOPOConfig(num_items=501, num_samples=50, top_k=32, epsilon=0.5,
                     retriever="streaming", fused_sampler=True, sample_tile=8, dist=d)
    params = {"w": T(pr["w"]).requires_grad_(True)}
    loss, aux = fopo_loss(policy, params, int(inputs["fopo_seed"]), data_rows(T(pr["x"]), d),
                          shard_rows(T(pr["beta"]), d),
                          make_session_reward(data_rows(T(pr["positives"]), d)), cfg)
    (g,) = torch.autograd.grad(loss, params["w"])
    out["fopo/loss"] = np.array([loss.item()] + [aux[k].item() for k in
                                                  ("ess", "rbar", "max_wbar")])
    out["fopo/grad_w"] = C.all_reduce(g, group=d.data_group).numpy()

    # the uniform-eps branch (no retrieval; the full draw, this rank's rows)
    pr = problem(4, p=203)
    cfg = FOPOConfig(num_items=203, num_samples=40, top_k=16, epsilon=1.0,
                     retriever="exact", fused=True, dist=d)
    loss, _ = fopo_loss(policy, {"w": T(pr["w"])}, 11, data_rows(T(pr["x"]), d),
                        shard_rows(T(pr["beta"]), d),
                        make_session_reward(data_rows(T(pr["positives"]), d)), cfg)
    out["uniform/loss"] = np.array([loss.item()])

    # trainer trajectories: the mixture sampler, then the in-kernel sampler
    tc = dict(batch_size=8, learning_rate=3e-3, num_steps=TRAJ_STEPS, checkpoint_every=0)
    base = FOPOConfig(num_items=400, num_samples=48, top_k=24, epsilon=0.8,
                      retriever="streaming", fused=False, dist=d)
    tr = FOPOTrainer(TrainerConfig(estimator="fopo", fopo=base, **tc), ds, device="cpu")
    hist = tr.train(TRAJ_STEPS)
    out["traj_mixture/loss"] = np.asarray(hist["loss"])
    out["traj_mixture/w"] = tr.params["w"].numpy()
    out["traj_mixture/eval"] = np.array([tr.evaluate()])
    seeds = inputs["traj_seeds"]
    tr = FOPOTrainer(
        TrainerConfig(estimator="fopo", fopo=dataclasses.replace(
            base, fused_sampler=True, sample_tile=16), **tc),
        ds, device="cpu", params={"w": T(inputs["traj_w0"])},
        step_seeds=lambda step: int(seeds[step]))
    hist = tr.train(TRAJ_STEPS)
    out["traj_fused/loss"] = np.asarray(hist["loss"])
    out["traj_fused/w"] = tr.params["w"].numpy()

    # the guard: rank 3's gradients are NaN at step 1; every rank skips it
    tr = FOPOTrainer(
        TrainerConfig(estimator="fopo", fopo=dataclasses.replace(
            base, fused_sampler=True, sample_tile=16), health=HealthConfig(), **tc),
        ds, device="cpu", fault_plan=FaultPlan(nan_grads_at=(1,)) if rank == 3 else None)
    ws, verdicts = [tr.params["w"].numpy().copy()], []
    for _ in range(3):
        tr.train(1)
        ws.append(tr.params["w"].numpy().copy())
        verdicts.append(int(tr.guard_state.last_verdict))
    out["guard/w"] = np.stack(ws)
    out["guard/verdicts"] = np.array(verdicts)
    out["guard/bad_total"] = np.array([int(tr.guard_state.bad_total)])

    # the IVF kernel route over a sharded index, with and without a delta
    mds = generate_sessions(SyntheticConfig(**MAINT))
    items = T(mds.item_embeddings)
    index = build_ivf_sharded(items, MODEL, MAINT_C, seed=0, device="cpu")
    for k, v in index._asdict().items():
        out[f"ivf/index_{k}"] = np.asarray(v)
    stacked = R.init_refresh_sharded(index, MAINT_DCAP)
    cids, cembs = churn()
    stacked = R.delta_append_sharded(stacked, T(cids), T(cembs), MAINT["num_items"])
    out["ivf/delta_lists"] = stacked.delta_lists.numpy()
    out["ivf/delta_embs"] = stacked.delta_embs.numpy()
    # the world's own data: generate_sessions' float sums depend on the
    # thread count, which differs between the ranks and the parent
    out["ivf/q"] = mds.contexts[:8]
    out["maint/items0"] = mds.item_embeddings
    q = data_rows(T(mds.contexts[:8]), d)
    for tag, delta in (("main", None), ("delta", stacked.delta())):
        top = dist_ivf_topk(q, index, 10, d, n_probe=3, delta=delta)
        out[f"ivf_{tag}/scores"] = top.scores.numpy()
        out[f"ivf_{tag}/ids"] = top.indices.numpy()

    # a sharded maintained trainer, refresh rows injected, one update_items
    rows = inputs["maint_rows"]  # [steps, n_model, minibatch]
    cfg = FOPOConfig(num_items=MAINT["num_items"], num_samples=24, top_k=12, epsilon=0.8,
                     retriever="ivf_pallas", fused=True, fused_sampler=True, sample_tile=8,
                     index_refresh=R.RefreshConfig(every=1, minibatch=MAINT_ROWS,
                                                   compact_every=3, delta_cap=MAINT_DCAP),
                     dist=d)
    tr = FOPOTrainer(TrainerConfig(estimator="fopo", fopo=cfg, batch_size=8,
                                   learning_rate=3e-3, checkpoint_every=0), mds,
                     device="cpu", retriever_kwargs={"index": index},
                     refresh_rows=lambda step: rows[step])
    losses = tr.train(1)["loss"]
    tr.update_items(cids, cembs)
    losses += tr.train(MAINT_STEPS - 1)["loss"]
    for k, v in tr.index_state._asdict().items():
        out[f"maint/state_{k}"] = v.numpy()
    out["maint/loss"] = np.asarray(losses)
    out["maint/w"] = tr.params["w"].numpy()
    probe = tr.policy.user_embedding(tr.params, T(mds.contexts[:16]))
    out["maint/recall"] = np.array([R.sampled_recall(tr.index_state, tr.beta, probe, 8,
                                                     n_probe=4, dist=d)])
    out["maint/probe"] = probe.numpy()
    out["maint/beta"] = tr.beta.numpy()

    np.savez(f"{tmp}/rank{rank}.npz", **out)
    tdist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(int(sys.argv[1]), sys.argv[2])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    sys.exit(0)


# ---------------------------------------------------------------------------
# the parent: the world, and the reference's answers while it runs
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import FOPOConfig as JFOPOConfig  # noqa: E402
from repro.core.fopo import fopo_loss as j_fopo_loss  # noqa: E402
from repro.core.fopo import make_retriever as j_make_retriever  # noqa: E402
from repro.core.gradients import covariance_surrogate as j_surrogate  # noqa: E402
from repro.core.gradients import fused_covariance_loss as j_fused_loss  # noqa: E402
from repro.core.policy import SoftmaxPolicy as JPolicy  # noqa: E402
from repro.core.policy import linear_tower_apply as j_linear  # noqa: E402
from repro.core.policy import linear_tower_init as j_linear_init  # noqa: E402
from repro.core.rewards import make_session_reward as j_reward  # noqa: E402
from repro.data import SyntheticConfig as JSyntheticConfig  # noqa: E402
from repro.data import generate_sessions as j_generate  # noqa: E402
from repro.kernels.fused_sampler import fused_sampler_ref, key_to_seed  # noqa: E402
from repro.kernels.ivf_topk import ivf_topk as j_ivf_topk  # noqa: E402
from repro.mips import refresh as jr  # noqa: E402
from repro.mips.exact import merge_topk as j_merge_topk  # noqa: E402
from repro.mips.exact import topk_exact as j_topk_exact  # noqa: E402
from repro.mips.ivf import IVFIndex as JIVFIndex  # noqa: E402
from repro.mips.ivf import ShardedIVFIndex as JShardedIVFIndex  # noqa: E402
from repro.train import FOPOTrainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.core import FOPOConfig, SoftmaxPolicy  # noqa: E402
from repro_torch.core.fopo import fopo_loss  # noqa: E402
from repro_torch.core.gradients import covariance_surrogate  # noqa: E402
from repro_torch.core.policy import linear_tower_apply  # noqa: E402
from repro_torch.core.rewards import make_session_reward  # noqa: E402
from repro_torch.data import SyntheticConfig, generate_sessions  # noqa: E402
from repro_torch.kernels.snis_covgrad.ops import snis_scores_fused  # noqa: E402
from repro_torch.mips import refresh as tr_refresh  # noqa: E402
from repro_torch.train import FOPOTrainer, TrainerConfig  # noqa: E402

REF_TOL = dict(rtol=1e-6, atol=1e-6)
EXACT_FIELDS = ("lists", "list_embs", "delta_lists", "delta_embs", "delta_sizes",
                "slot_of", "overflow")


def _rank_of(d: int, m: int) -> int:
    return d * MODEL + m


def _traj_seeds() -> list[int]:
    """The reference trainer's sampler seeds at seed 0 (its training key
    PRNGKey(17) split once a step, each sub-key folded)."""
    key, out = jax.random.PRNGKey(17), []
    for _ in range(TRAJ_STEPS):
        key, sub = jax.random.split(key)
        out.append(int(key_to_seed(sub)))
    return out


def _maint_keys():
    return [jax.random.PRNGKey(100 + t) for t in range(MAINT_STEPS)]


def _maint_rows() -> np.ndarray:
    """[steps, n, minibatch]: the rows the reference's
    `refresh_step_sharded` draws from each step's key, shard by shard."""
    rows = MAINT["num_items"] // MODEL
    return np.stack([
        np.stack([np.asarray(jax.random.randint(k, (MAINT_ROWS,), 0, rows))
                  for k in jax.random.split(key, MODEL)])
        for key in _maint_keys()
    ]).astype(np.int64)


def _reference(inputs) -> dict:
    """The reference's answers on the world's inputs (computed while the
    world runs)."""
    ref = {}
    # under jit: the interpret-mode kernels compile once instead of op by op
    loss_grad = jax.jit(jax.value_and_grad(
        lambda *a: j_fused_loss(*a, interpret=True, sample_tile=8), has_aux=True))
    for seed, b, s, l, p in SHAPES:
        pr = problem(seed, b, s, l, p)
        h = jnp.asarray(pr["x"]) @ jnp.asarray(pr["w"])
        args = [jnp.asarray(pr[k]) for k in ("beta", "actions", "log_q", "rewards")]
        # the sampled scores h . beta[a], the function the reference's K2 computes
        # (held to it in tests/test_torch_snis_covgrad.py), in plain jnp
        ref[f"scores{seed}"] = np.asarray(
            jnp.einsum("bl,bsl->bs", h, args[0][jnp.maximum(args[1], 0)]))
        (loss, aux), g = loss_grad(h, *args)
        ref[f"loss{seed}"] = np.array([float(loss)] + [float(aux[k]) for k in
                                                       ("ess", "rbar", "max_wbar")])
        ref[f"grad_h{seed}"] = np.asarray(g)
    jpolicy = JPolicy(tower=j_linear, item_dim=None)
    pr = problem(7, p=64)
    ref["surrogate"] = float(jax.jit(lambda *a: j_surrogate(
        jpolicy, {"w": a[0]}, *a[1:], fused=True, fused_interpret=True, sample_tile=8)[0])(
        *(jnp.asarray(pr[k]) for k in ("w", "x", "beta", "actions", "log_q", "rewards"))))
    ids, sc = sampler_inputs()
    ref["twin"] = fused_sampler_ref(
        jnp.int32(inputs["sampler_seed"]), 0.45, jnp.asarray(ids), jnp.asarray(sc),
        num_samples=37, num_items=500, sample_tile=8)
    pr = problem(8, b=6, l=16, p=501)
    cfg = JFOPOConfig(num_items=501, num_samples=50, top_k=32, epsilon=0.5,
                      retriever="streaming", fused=True, fused_sampler=True,
                      fused_interpret=True, sample_tile=8)
    retr = j_make_retriever(cfg)
    args = (jax.random.PRNGKey(7), jnp.asarray(pr["x"]), jnp.asarray(pr["beta"]),
            j_reward(jnp.asarray(pr["positives"])), cfg, retr)

    def f(w):
        return j_fopo_loss(jpolicy, {"w": w}, *args)

    (loss, aux), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(pr["w"]))
    ref["fopo"] = np.array([float(loss)] + [float(aux[k]) for k in ("ess", "rbar", "max_wbar")])
    ref["fopo_grad"] = np.asarray(g)
    ds = j_generate(JSyntheticConfig(**TRAJ))
    jtr = JTrainer(JTrainerConfig(
        estimator="fopo", fopo=JFOPOConfig(
            num_items=400, num_samples=48, top_k=24, epsilon=0.8, retriever="exact",
            fused=True, fused_sampler=True, sample_tile=16),
        batch_size=8, learning_rate=3e-3, num_steps=TRAJ_STEPS, checkpoint_every=0), ds)
    np.testing.assert_array_equal(np.asarray(jtr.params["w"]), inputs["traj_w0"])
    ref["traj_fused"] = (np.asarray(jtr.train(TRAJ_STEPS)["loss"]), np.asarray(jtr.params["w"]))
    return ref


@pytest.fixture(scope="module")
def world():
    """(each rank's outputs, the reference's answers)."""
    tmp = tempfile.mkdtemp(prefix="torch_dist_")
    jtr_w0 = np.asarray(j_linear_init(jax.random.PRNGKey(0), 16, 16)["w"])
    inputs = dict(
        sampler_seed=np.int64(key_to_seed(jax.random.PRNGKey(13))),
        fopo_seed=np.int64(key_to_seed(jax.random.PRNGKey(7))),
        traj_seeds=np.array(_traj_seeds(), np.int64),
        traj_w0=jtr_w0,
        maint_rows=_maint_rows(),
    )
    np.savez(f"{tmp}/inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), tmp], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        ref = _reference(inputs)
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = "\n".join(Path(f"{tmp}/rank{r}.log").read_text()[-3000:] for r in range(WORLD))
        pytest.fail(f"the world failed (exit codes {rcs}):\n{tails}")
    outs = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(WORLD)]
    return outs, ref, inputs


def _rows(outs, key: str, m: int = 0) -> np.ndarray:
    """The global batch of a per-rank output: the data ranks' rows, in
    order, from model coordinate ``m``."""
    return np.concatenate([outs[_rank_of(d, m)][key] for d in range(DATA)])


def _same_on(outs, key: str, ranks) -> np.ndarray:
    first = outs[ranks[0]][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(outs[r][key], first, err_msg=f"{key} rank {r}")
    return first


def _port_policy():
    return SoftmaxPolicy(tower=linear_tower_apply, item_dim=None)


# -- the surrogate ---------------------------------------------------------------------

@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("seed,b,s,l,p", SHAPES)
def test_dist_loss_and_grads_match_single_device(world, routing, seed, b, s, l, p):
    outs, ref, _ = world
    key = f"loss{seed}{routing}"
    pr = problem(seed, b, s, l, p)
    T = torch.from_numpy
    h = T(pr["x"]) @ T(pr["w"])
    single = snis_scores_fused(h, *(T(pr[k]) for k in ("beta", "actions", "log_q", "rewards")),
                               sample_tile=8).numpy()
    # the partials (owner value + exact zeros) sum to the scores; both model
    # ranks hold the same sum; the scores equal the port's single-process K2
    # bit for bit and the reference's within rtol 1e-6
    parts = [np.concatenate([outs[_rank_of(dd, m)][f"{key}/partial"] for dd in range(DATA)])
             for m in range(MODEL)]
    np.testing.assert_array_equal(sum(parts)[:, :s], single)
    for m in range(MODEL):
        np.testing.assert_array_equal(_rows(outs, f"{key}/scores", m), single)
    np.testing.assert_allclose(single, ref[f"scores{seed}"], **REF_TOL)
    loss = _same_on(outs, f"{key}/loss", list(range(WORLD)))
    np.testing.assert_allclose(loss, ref[f"loss{seed}"], **REF_TOL)
    for m in range(MODEL):
        np.testing.assert_allclose(_rows(outs, f"{key}/grad_h", m), ref[f"grad_h{seed}"],
                                   **REF_TOL)


def test_all_foreign_ids_shard_contributes_exact_zero(world):
    outs = world[0]
    for d in range(DATA):
        assert np.all(outs[_rank_of(d, 1)]["foreign/partial"] == 0.0)  # exact zeros
    assert np.any(_rows(outs, "foreign/partial", 0) != 0.0)


def test_snis_normalizer_psum_exactly_once(world):
    for o in world[0]:
        # one score reduction over model, no routing gather, one over data
        np.testing.assert_array_equal(o["once/calls"], [1, 0, 1])


def test_batch_must_divide_data_axis(world):
    for o in world[0]:
        assert o["divides/raised"].tolist() == [True, True]


@pytest.mark.parametrize("negative", [False, True], ids=["ragged", "ragged_all_negative"])
def test_dist_sharded_topk_masks_ragged_padding(world, negative):
    """Pad rows score exactly 0: the widened local K and the demotion
    before the merge keep them out, even when every real score is
    negative."""
    outs = world[0]
    beta, h = topk_problem(negative)
    want = j_topk_exact(jnp.asarray(h), jnp.asarray(beta), 64)
    for m in range(MODEL):
        ids, scores = _rows(outs, f"topk{int(negative)}/ids", m), _rows(
            outs, f"topk{int(negative)}/scores", m)
        assert ids.min() >= 0 and ids.max() < beta.shape[0]
        np.testing.assert_array_equal(np.sort(ids, -1), np.sort(np.asarray(want.indices), -1))
        np.testing.assert_allclose(scores, np.asarray(want.scores), rtol=1e-5, atol=1e-6)
        if negative:
            assert scores.max() < 0.0


def test_context_sharded_topk_and_sharded_gather_rows(world):
    """The 2-D top-K equals the dist route's (and so the dense oracle's);
    the gather from a row-sharded table gives every rank the table's rows,
    bit for bit (the owner's row plus exact zeros)."""
    outs = world[0]
    beta, _ = topk_problem(False)
    for m in range(MODEL):
        np.testing.assert_array_equal(_rows(outs, "context/ids", m), _rows(outs, "topk0/ids", m))
        np.testing.assert_array_equal(_rows(outs, "context/scores", m),
                                      _rows(outs, "topk0/scores", m))
    ids = np.random.default_rng(12).integers(0, beta.shape[0], (4, 6))
    np.testing.assert_array_equal(_same_on(outs, "gather_rows", list(range(WORLD))), beta[ids])


def test_covariance_surrogate_dist_kwarg(world):
    outs, ref, _ = world
    pr = problem(7, p=64)
    T = torch.from_numpy
    single, _ = covariance_surrogate(
        _port_policy(), {"w": T(pr["w"])}, T(pr["x"]),
        *(T(pr[k]) for k in ("beta", "actions", "log_q", "rewards")), fused=True, sample_tile=8)
    got = _same_on(outs, "surrogate/loss", list(range(WORLD)))[0]
    np.testing.assert_allclose(got, single.item(), rtol=1e-6)
    np.testing.assert_allclose(got, ref["surrogate"], **REF_TOL)


def test_dist_uniform_eps_branch(world):
    """eps 1 skips retrieval: the full uniform draw from the same
    generator state, each rank's rows; the loss equals the port's
    single-process step."""
    pr = problem(4, p=203)
    T = torch.from_numpy
    cfg = FOPOConfig(num_items=203, num_samples=40, top_k=16, epsilon=1.0, retriever="exact",
                     fused=True)
    single, _ = fopo_loss(_port_policy(), {"w": T(pr["w"])}, 11, T(pr["x"]), T(pr["beta"]),
                          make_session_reward(T(pr["positives"])), cfg)
    got = _same_on(world[0], "uniform/loss", list(range(WORLD)))[0]
    np.testing.assert_allclose(got, single.item(), rtol=1e-6)


# -- the in-kernel sampler on the grid ---------------------------------------------------

def test_dist_fused_sampler_hash_twin(world):
    """Each data rank's K5 rows, at its row offset, are the reference's
    `fused_sampler_ref` rows bit for bit (log q within 1e-6)."""
    outs, ref, _ = world
    ra, rq, rs = (np.asarray(t) for t in ref["twin"])
    for m in range(MODEL):
        np.testing.assert_array_equal(_rows(outs, "twin/actions", m), ra)
        np.testing.assert_allclose(_rows(outs, "twin/log_q", m), rq, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_rows(outs, "twin/topk_slot", m), rs)


def test_dist_fused_sampler_loss_and_grads_match_single_device(world):
    outs, ref, _ = world
    loss = _same_on(outs, "fopo/loss", list(range(WORLD)))
    np.testing.assert_allclose(loss, ref["fopo"], **REF_TOL)
    g = _same_on(outs, "fopo/grad_w", list(range(WORLD)))
    np.testing.assert_allclose(g, ref["fopo_grad"], rtol=1e-5, atol=1e-6)


# -- the trainer -------------------------------------------------------------------------

def test_dist_trainer_trajectory_matches_single_device(world):
    """The mixture sampler (a generator): the dist trainer walks the port's
    single-process fused trainer's trajectory, and evaluates the same.
    The catalog repeats embeddings (tied scores), so the single-process
    trainer retrieves with the streaming scan: its K-merge orders ties as
    the sharded merge does (`merge_topk`, lower id first)."""
    outs = world[0]
    ds = generate_sessions(SyntheticConfig(**TRAJ))
    tr = FOPOTrainer(TrainerConfig(
        estimator="fopo", fopo=FOPOConfig(num_items=400, num_samples=48, top_k=24, epsilon=0.8,
                                          retriever="streaming", fused=True),
        batch_size=8, learning_rate=3e-3, num_steps=TRAJ_STEPS, checkpoint_every=0),
        ds, device="cpu")
    hist = tr.train(TRAJ_STEPS)
    np.testing.assert_allclose(_same_on(outs, "traj_mixture/loss", list(range(WORLD))),
                               hist["loss"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_same_on(outs, "traj_mixture/w", list(range(WORLD))),
                               tr.params["w"].numpy(), rtol=1e-4, atol=1e-6)
    assert _same_on(outs, "traj_mixture/eval", list(range(WORLD)))[0] == tr.evaluate()


def test_dist_trainer_fused_sampler_trajectory_matches_reference(world):
    """The in-kernel sampler: the dist trainer (the reference's theta and
    step seeds) walks the reference's single-device trajectory."""
    outs, ref, _ = world
    jloss, jw = ref["traj_fused"]
    np.testing.assert_allclose(_same_on(outs, "traj_fused/loss", list(range(WORLD))), jloss,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_same_on(outs, "traj_fused/w", list(range(WORLD))), jw,
                               rtol=1e-4, atol=1e-6)


def test_guard_one_bad_rank_makes_every_rank_skip(world):
    outs = world[0]
    ws = _same_on(outs, "guard/w", list(range(WORLD)))  # theta equal on every rank
    np.testing.assert_array_equal(ws[2], ws[1])  # step 1 skipped everywhere
    assert not np.array_equal(ws[1], ws[0]) and not np.array_equal(ws[3], ws[2])
    for o in outs:
        v = o["guard/verdicts"]
        assert v[0] == 0 and v[1] != 0 and v[2] == 0
        assert o["guard/bad_total"][0] == 1


# -- the sharded IVF index and its maintenance ---------------------------------------------

def _j_index(o) -> "JShardedIVFIndex":
    return JShardedIVFIndex(
        jnp.asarray(o["ivf/index_centroids"]), jnp.asarray(o["ivf/index_lists"]),
        jnp.asarray(o["ivf/index_list_embs"]), int(o["ivf/index_num_items"]))


@pytest.mark.parametrize("tag", ["main", "delta"])
def test_dist_ivf_topk_matches_reference_shard_by_shard(world, tag):
    """The IVF kernel route's merged top-K against the reference's per-shard
    `ivf_topk` (interpret mode) and `merge_topk`, run shard by shard."""
    outs = world[0]
    o = outs[0]
    index = _j_index(o)
    q = jnp.asarray(o["ivf/q"])
    per = []
    for m in range(MODEL):
        delta = (jnp.asarray(o["ivf/delta_lists"][m]), jnp.asarray(o["ivf/delta_embs"][m])) \
            if tag == "delta" else None
        per.append(j_ivf_topk(q, index.shard(m), 10, n_probe=3, interpret=True, delta=delta))
    want = j_merge_topk(jnp.concatenate([t.scores for t in per], axis=1),
                        jnp.concatenate([t.indices for t in per], axis=1), 10)
    ws, wi = np.asarray(want.scores), np.asarray(want.indices)
    for m in range(MODEL):
        gs, gi = _rows(outs, f"ivf_{tag}/scores", m), _rows(outs, f"ivf_{tag}/ids", m)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
        # the catalog repeats embeddings: an id may differ only where its
        # score ties the K-th (either side may keep either of equal items)
        for row in range(gi.shape[0]):
            kth = ws[row, -1]
            for ids, scores, only in ((gi[row], gs[row], set(gi[row]) - set(wi[row])),
                                      (wi[row], ws[row], set(wi[row]) - set(gi[row]))):
                for i in only:
                    assert abs(scores[list(ids).index(i)] - kth) <= 1e-6 + 1e-5 * abs(kth)


def test_dist_maintained_trainer_matches_reference_stacked_ops(world):
    """3 steps of the sharded maintained trainer with injected refresh rows
    and one update_items: each rank's shard state equals that shard of the
    reference's stacked ops on the same rows (refresh, delta append,
    refresh twice, compaction), on both data replicas; theta is the same
    on every rank; the merged recall equals the stacked state's."""
    outs, _, inputs = world
    o = outs[0]
    beta = jnp.asarray(o["maint/items0"])
    cids, cembs = churn()
    # the reference's ops under one jit each: its eager vmaps compile op by op
    refresh = jax.jit(jr.refresh_step_sharded, static_argnames=("minibatch",))
    append = jax.jit(jr.delta_append_sharded, static_argnums=3)
    st = jr.init_refresh_sharded(_j_index(o), MAINT_DCAP)
    for t, key in enumerate(_maint_keys()):
        if t == 1:
            beta = beta.at[cids].set(jnp.asarray(cembs))
            st = append(st, jnp.asarray(cids), jnp.asarray(cembs), MAINT["num_items"])
        st = refresh(st, key, beta, minibatch=MAINT_ROWS)
    st = jax.jit(jr.compact_sharded)(st, beta)
    np.testing.assert_array_equal(inputs["maint_rows"], _maint_rows())
    for m in range(MODEL):
        for f in tr_refresh.RefreshState._fields:
            got = _same_on(outs, f"maint/state_{f}", [_rank_of(d, m) for d in range(DATA)])
            want = np.asarray(getattr(st, f))[m]
            if f in EXACT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f)
    _same_on(outs, "maint/w", list(range(WORLD)))
    assert np.all(np.isfinite(_same_on(outs, "maint/loss", list(range(WORLD)))))
    stacked = tr_refresh.stack_states([tr_refresh.RefreshState(
        *(torch.from_numpy(outs[_rank_of(0, m)][f"maint/state_{f}"])
          for f in tr_refresh.RefreshState._fields)) for m in range(MODEL)])
    full_beta = torch.from_numpy(np.concatenate([outs[_rank_of(0, m)]["maint/beta"]
                                                 for m in range(MODEL)]))
    want = tr_refresh.sampled_recall(stacked, full_beta, torch.from_numpy(o["maint/probe"]), 8,
                                     n_probe=4)
    assert _same_on(outs, "maint/recall", list(range(WORLD)))[0] == pytest.approx(want)
