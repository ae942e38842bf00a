"""int8 gradient compression (`repro_torch.optim.compression`) against
the reference's `repro.optim.compression`, on the CPU.

`quantize_int8`, `dequantize_int8` and `error_feedback_compress` bit for
bit (all-zero leaves and .5 ties included: both round half to even).
`compressed_all_reduce` on gloo worlds of 2 and 4 processes (this file
run as a script, one process a rank, over a file store): each rank's
result equals the formula built from the ranks' own `quantize_int8`
outputs (the int32 sum of q exactly, times the mean of the scales) and
the reference's `compressed_psum` over the same trees (its psum under
`jax.vmap`), and `collectives.STATS` counts the bytes it moved: 4 bytes
an element, as a plain fp32 all-reduce of the same tree, plus 4 a leaf.
"""
import os
import sys
import tempfile
import traceback
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = {"enc": [(24, 16), (16,)], "layers": [(3, 16, 16), (3, 16)], "out": [()]}


def _tree(rank: int) -> dict:
    """A gradient-shaped tree of numpy fp32 leaves drawn from ``rank``'s
    seed: lists of leaves under names, one all-zero leaf on rank 1."""
    rng = np.random.default_rng(100 + rank)
    tree = {k: [np.asarray(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2), np.float32)
                for s in shapes] for k, shapes in SHAPES.items()}
    if rank == 1:
        tree["enc"][1] = np.zeros((16,), np.float32)
    return tree


def _leaves(tree: dict) -> list:
    return [leaf for k in SHAPES for leaf in tree[k]]


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as tdist

    from repro_torch.dist import collectives as C
    from repro_torch.optim import compressed_all_reduce
    from repro_torch.optim.optimizers import tree_map

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world,
                             rank=rank)
    grads = tree_map(torch.from_numpy, _tree(rank))
    C.reset_stats()
    got = compressed_all_reduce(grads)
    compressed = {k: dict(v) for k, v in C.STATS.items()}
    C.reset_stats()
    plain = tree_map(lambda g: C.all_reduce(g, name="plain"), grads)
    out = {f"got{i}": t.numpy() for i, t in enumerate(_leaves(got))}
    out.update({f"plain{i}": t.numpy() for i, t in enumerate(_leaves(plain))})
    for name, s in {**compressed, **C.STATS}.items():
        out[f"stats/{name}"] = np.asarray([s["calls"], s["bytes"]], np.int64)
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    tdist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.optimizers import tree_map  # noqa: E402


def _ties() -> np.ndarray:
    """max |x| 127 makes the scale 1 (127 / 127 + 1e-12 rounds to 1 in
    fp32), so x / scale hits every .5 exactly."""
    return np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0, 3.49], np.float32)


@pytest.mark.parametrize("case", ["normal", "zeros", "ties", "tiny", "huge"])
def test_quantize_and_dequantize_bit_for_bit(case):
    rng = np.random.default_rng(7)
    x = {"normal": rng.standard_normal((33, 17)).astype(np.float32),
         "zeros": np.zeros((5, 4), np.float32),
         "ties": _ties(),
         "tiny": (rng.standard_normal(64) * 1e-30).astype(np.float32),
         "huge": (rng.standard_normal(64) * 1e30).astype(np.float32)}[case]
    q, scale = compression.quantize_int8(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and scale.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    deq = compression.dequantize_int8(q, scale)
    assert deq.numpy().tobytes() == np.asarray(jcomp.dequantize_int8(jq, jscale)).tobytes()
    if case == "ties":  # round half to even, clipped to +-127
        np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, 126, -127, 3])
    if case == "zeros":
        assert not q.any() and not deq.any()


def test_error_feedback_compress_bit_for_bit():
    """Three steps of error feedback, the residual carried: (q, scale)
    pairs shaped like the gradients and the residual, bit for bit."""
    trees = [_tree(r) for r in range(3)]
    res_t = tree_map(lambda a: torch.zeros(a.shape), trees[0])
    res_j = jax.tree.map(jnp.zeros_like, trees[0])
    for g in trees:
        qs_t, res_t = compression.error_feedback_compress(tree_map(torch.from_numpy, g), res_t)
        qs_j, res_j = jcomp.error_feedback_compress(jax.tree.map(jnp.asarray, g), res_j)
        for k in SHAPES:
            for (q, s), (jq, js) in zip(qs_t[k], qs_j[k]):
                np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
                assert s.numpy().tobytes() == np.asarray(js).tobytes()
            for r, jr in zip(res_t[k], res_j[k]):
                assert r.numpy().tobytes() == np.asarray(jr).tobytes()
    # the residual is what the quantisation lost: at most half a step a leaf
    for k in SHAPES:
        for (_, s), r in zip(qs_t[k], res_t[k]):
            assert float(r.abs().max()) <= 0.5 * float(s) * (1 + 1e-5)


def _world(world: int) -> list[dict]:
    """Run the ranks; their outputs."""
    import subprocess

    tmp = tempfile.mkdtemp(prefix="torch_compress_")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), tmp], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = "\n".join(Path(f"{tmp}/rank{r}.log").read_text()[-3000:] for r in range(world))
        pytest.fail(f"the world failed (exit codes {rcs}):\n{tails}")
    return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_all_reduce_on_gloo_equals_the_formula(world):
    outs = _world(world)
    trees = [_tree(r) for r in range(world)]
    per_rank = [[compression.quantize_int8(torch.from_numpy(x)) for x in _leaves(t)]
                for t in trees]
    # the reference's compressed_psum over the stacked trees (its psum under vmap)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    ref = _leaves(jax.vmap(lambda g: jcomp.compressed_psum(g, "i"), axis_name="i")(stacked))
    n_leaves = len(per_rank[0])
    numel = sum(int(np.prod(s)) for shapes in SHAPES.values() for s in shapes)
    for i in range(n_leaves):
        q_sum = sum(p[i][0].to(torch.int32) for p in per_rank)
        scales = [p[i][1] for p in per_rank]
        mean_scale = sum(scales[1:], scales[0]) / world
        want = (q_sum.to(torch.float32) * mean_scale).numpy()
        for r, out in enumerate(outs):
            got = out[f"got{i}"]
            assert got.dtype == np.float32 and got.shape == want.shape
            # the int32 sum is exact: got / scale gives back sum q
            np.testing.assert_array_equal(np.rint(got / mean_scale.numpy()), q_sum.numpy())
            # gloo may add the scales in another order: a few ulp
            np.testing.assert_allclose(got, want, rtol=4e-7, atol=0, err_msg=f"rank {r}")
            np.testing.assert_allclose(got, np.asarray(ref[i][r]), rtol=4e-7, atol=0)
            assert np.array_equal(got, outs[0][f"got{i}"])  # every rank holds the same
    for out in outs:
        stats = {k[6:]: tuple(v) for k, v in out.items() if k.startswith("stats/")}
        assert stats == {"compressed_q": (n_leaves, 4 * numel),
                         "compressed_scale": (n_leaves, 4 * n_leaves),
                         "plain": (n_leaves, 4 * numel)}
