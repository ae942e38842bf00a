"""The port's `ivf_topk` (`repro_torch.kernels.ivf_topk`) against the JAX
reference's, on the CPU.

The port's wrapper runs its plain PyTorch version here (CPU tensors);
the reference runs its Pallas kernel in interpret mode. Both query the
SAME index: the reference builds it and `repro_torch.convert` carries it
across, because the two packages seed k-means from different RNGs.
Tolerances are `test_torch_common.assert_topk_equal`'s. The kernel itself is
held to the plain version on the card by `chip_smoke.py`.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_common import assert_topk_equal, data, jax_index, to_port  # noqa: E402

from repro.kernels.ivf_topk import ivf_topk as jax_ivf_topk  # noqa: E402
from repro_torch.kernels.ivf_topk import ivf_topk, ops, tile_align_index  # noqa: E402


@pytest.mark.parametrize(
    "p,l,c,b,k,n_probe,cap_tile",
    [
        (500, 16, 8, 4, 16, 3, 8),     # ragged clusters, CT | cap
        (777, 8, 16, 5, 32, 8, 16),    # odd P
        (256, 32, 4, 3, 8, 2, 128),    # CT > cap -> clamped to cap
        (300, 16, 8, 4, 16, 5, 7),     # CT does not divide cap -> pad path
        (64, 8, 64, 2, 8, 64, 8),      # one item per cluster (C == P region)
    ],
)
def test_ivf_topk_matches_reference(p, l, c, b, k, n_probe, cap_tile):
    _, jindex = jax_index(p, l, c, seed=p + k, key=3, kmeans_iters=6)
    _, q = data(p, l, b, seed=p + k)
    ref = jax_ivf_topk(
        jnp.asarray(q), jindex, k, n_probe=n_probe, cap_tile=cap_tile,
        interpret=True,
    )
    index, _ = tile_align_index(to_port(jindex), cap_tile)
    out = ivf_topk(torch.from_numpy(q), index, k, n_probe=n_probe)
    assert_topk_equal(out, ref)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and never the kernel."""
    _, jindex = jax_index(100, 8, 8, seed=1, key=2)
    _, q = data(100, 8, 3, seed=1)
    kernel_before = ops._kernel.ivf_probe_topk_cuda.launches
    plain_before = ops._ref.ivf_probe_topk_ref.calls
    ivf_topk(torch.from_numpy(q), to_port(jindex), 4, n_probe=2)
    assert ops._kernel.ivf_probe_topk_cuda.launches == kernel_before
    assert ops._ref.ivf_probe_topk_ref.calls == plain_before + 1
