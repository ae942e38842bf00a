"""The port's in-kernel mixture sampler (`repro_torch.kernels
.fused_sampler`) against the JAX reference's, on the CPU.

The port's wrapper runs its plain PyTorch version here; the reference
runs its Pallas kernel in interpret mode. Both draw from the same
splitmix32 counter stream for the same int32 seed, so:
  * the integer hash is equal bit for bit;
  * the arm choice and the uniform-arm actions are exactly equal;
  * the kappa-arm actions agree at a rate reported and held >= 0.999:
    the fp32 `log` of the Gumbel noise may differ by an ulp between the
    two libraries and flip a near-tie;
  * slot is equal wherever the actions are, and log q within 1e-6
    (rtol 1e-6 beside it: an ulp of fp32 at |log q| ~ 14 is 9.5e-7).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_sampler.kernel import _hash_u32, fused_sampler_pallas  # noqa: E402
from repro_torch.constants import LOG_Q_PAD  # noqa: E402
from repro_torch.core.proposals import MixtureProposal  # noqa: E402
from repro_torch.kernels.fused_sampler import fused_mixture_sample, ops, ref  # noqa: E402


def _topk_problem(b, p, k, seed):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(p)[:k] for _ in range(b)]).astype(np.int32)
    scores = (2 * rng.standard_normal((b, k))).astype(np.float32)
    return ids, scores


def test_hash_is_the_reference_bit_for_bit():
    """10^5 counters, including the top of the uint32 range (wraparound)
    and a seed past 2^31."""
    ctr = np.concatenate([
        np.arange(50_000), np.arange(2**32 - 50_000, 2**32),
    ]).astype(np.uint32)
    for seed in (0, 7, 2**31 + 5, 2**32 - 1):
        want = np.asarray(_hash_u32(jnp.uint32(seed), jnp.asarray(ctr))).astype(np.int64)
        got = ref.hash_u32(seed, torch.from_numpy(ctr.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "b,s,ts,k,p,eps,row_offset,seed",
    [
        (4, 37, 8, 16, 300, 0.6, 0, 123456789),  # S not a multiple of TS
        (4, 37, 8, 16, 300, 0.6, 3, 123456789),  # a shard's row offset
        (3, 64, 16, 40, 5000, 0.8, 0, 2**31 - 2),
        (2, 50, 1, 6, 40, 0.25, 5, 1),           # per-sample tiling
    ],
)
def test_sampler_matches_reference(b, s, ts, k, p, eps, row_offset, seed):
    ids, scores = _topk_problem(b, p, k, seed=s + k)
    ja, jq, js = map(np.asarray, fused_sampler_pallas(
        jnp.int32(seed), jnp.float32(eps), jnp.asarray(ids), jnp.asarray(scores),
        num_samples=s, num_items=p, sample_tile=ts, interpret=True,
        row_offset=row_offset,
    ))
    ta, tq, tsl = (t.numpy() for t in fused_mixture_sample(
        seed, torch.from_numpy(ids), torch.from_numpy(scores), num_samples=s,
        epsilon=eps, num_items=p, sample_tile=ts, row_offset=row_offset,
    ))
    sp = -(-s // ts) * ts
    assert ta.shape == tq.shape == tsl.shape == (b, sp)
    uniform = js == -1
    np.testing.assert_array_equal(tsl == -1, uniform)  # arm choice (and tail)
    np.testing.assert_array_equal(ta[uniform], ja[uniform])  # uniform arm, exactly
    kappa = ~uniform
    agree = float((ta[kappa] == ja[kappa]).mean())
    print(f"kappa-arm agreement {agree:.6f} over {int(kappa.sum())} draws")
    assert agree >= 0.999
    same = ta == ja
    np.testing.assert_array_equal(tsl[same], js[same])
    np.testing.assert_allclose(tq[same], jq[same], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ta[:, s:], -1)
    np.testing.assert_array_equal(tq[:, s:], np.float32(LOG_Q_PAD))


def test_seed_from_a_generator_and_eps_as_a_tensor():
    """A CPU generator yields one int32 seed per call, from the range the
    reference folds a JAX key into (randint(key, (), 0, int32 max)); a
    0-d tensor eps draws exactly what the float does."""
    assert ops.INT32_MAX == int(jnp.iinfo(jnp.int32).max)
    ids, scores = _topk_problem(2, 100, 8, seed=0)
    ids_t, sc_t = torch.from_numpy(ids), torch.from_numpy(scores)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    seed = ops.seed_from(g1)
    assert 0 <= seed < ops.INT32_MAX and ops.seed_from(g1) != seed
    kw = dict(num_samples=30, num_items=100, sample_tile=8)
    a = fused_mixture_sample(g2, ids_t, sc_t, epsilon=0.3, **kw)
    b = fused_mixture_sample(seed, ids_t, sc_t, epsilon=torch.tensor(0.3), **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("eps", [0.25, 0.8])
def test_logq_matches_the_mixture_pmf_at_its_draws(eps):
    """log q from the sampler equals `MixtureProposal.log_prob` (the
    port's generator-driven mixture) at the sampler's own draws."""
    ids, scores = _topk_problem(3, 50, 8, seed=3)
    ids_t, sc_t = torch.from_numpy(ids), torch.from_numpy(scores)
    acts, logq, _ = fused_mixture_sample(
        11, ids_t, sc_t, num_samples=300, epsilon=eps, num_items=50, sample_tile=32
    )
    live = acts >= 0
    want = MixtureProposal(50, eps).log_prob(acts.clamp(min=0), ids_t, sc_t)
    torch.testing.assert_close(logq[live], want[live], rtol=1e-6, atol=1e-6)


def test_draw_marginals_match_the_mixture_pmf():
    """The counter-hash draws follow the mixture pmf (the reference's
    statistical acceptance test, on the port's plain version)."""
    p, k, eps, s = 30, 5, 0.4, 49_152
    ids, scores = _topk_problem(1, p, k, seed=5)
    ids_t, sc_t = torch.from_numpy(ids), torch.from_numpy(scores)
    acts, _, _ = fused_mixture_sample(
        2, ids_t, sc_t, num_samples=s, epsilon=eps, num_items=p, sample_tile=128
    )
    counts = np.bincount(acts[0].numpy(), minlength=p) / s
    pmf = np.exp(MixtureProposal(p, eps).log_prob(
        torch.arange(p)[None], ids_t, sc_t)[0].numpy())
    np.testing.assert_allclose(pmf.sum(), 1.0, atol=1e-5)
    # 4 binomial standard deviations per item
    np.testing.assert_array_less(np.abs(counts - pmf), 4 * np.sqrt(pmf * (1 - pmf) / s) + 1e-4)


def test_cpu_tensors_take_the_plain_version():
    ids, scores = _topk_problem(2, 40, 6, seed=1)
    kernel_before = ops._kernel.fused_sampler_cuda.launches
    plain_before = ops._ref.fused_sampler_ref.calls
    fused_mixture_sample(0, torch.from_numpy(ids), torch.from_numpy(scores),
                         num_samples=8, epsilon=0.5, num_items=40, sample_tile=8)
    assert ops._kernel.fused_sampler_cuda.launches == kernel_before
    assert ops._ref.fused_sampler_ref.calls == plain_before + 1



def _membership_problem(case):
    """(ids [B, K], scores [B, K], P) for the membership cases: ids that
    repeat in a row; K > P with the empty slots at id -1 (what `mips_topk`
    gives there), scored as the retrieval scores them and as a caller
    might; an odd K."""
    rng = np.random.default_rng(7)
    if case == "duplicates":
        p, ids = 12, rng.integers(0, 12, (3, 40))
    elif case.startswith("k_above_p"):
        p = 20
        ids = np.stack([np.concatenate([rng.permutation(p), np.full(12, -1)]) for _ in range(3)])
    else:  # odd K
        p, ids = 500, np.stack([rng.permutation(500)[:37] for _ in range(3)])
    scores = (2 * rng.standard_normal(ids.shape)).astype(np.float32)
    if case == "k_above_p_dead":
        scores[ids < 0] = -3.0e38
    return ids.astype(np.int32), scores, p


@pytest.mark.parametrize("fill", ["quarter", "fullest"])
@pytest.mark.parametrize("case", ["duplicates", "k_above_p_dead", "k_above_p_scored", "odd_k"])
def test_membership_table_matches_the_compares_and_the_reference(case, fill):
    """The kernel's membership lookup in plain torch (`ref.membership_table`:
    the open-addressing table, duplicate flags, each slot's log kappa summed
    over its id in slot order) against the plain version's K compares, on
    the plain version's draws and on every id of the row, in a table a
    quarter full (the kernel's where shared memory allows) and in the
    smallest the lookup takes (2^bits > K, fuller than the kernel's half:
    long probe chains); and the log q it gives against the reference's
    (interpret mode) where the draws agree."""
    ids, scores, p = _membership_problem(case)
    b, k = ids.shape
    bits = (4 * k - 1).bit_length() if fill == "quarter" else k.bit_length()
    s, ts, eps, seed = 300, 8, 0.4, 99
    ids_t, sc_t = torch.from_numpy(ids), torch.from_numpy(scores)
    ta, tq, tsl = ref.fused_sampler_ref(seed, torch.tensor(eps), ids_t, sc_t, num_samples=s,
                                        num_items=p, sample_tile=ts)
    acts = torch.cat([ta[:, :s], ids_t, torch.full((b, 1), p)], dim=1)  # p: never in the row
    in_topk, log_kappa = ref.membership_table(ids_t, sc_t, acts, bits)
    hit = acts[:, :, None] == ids_t[:, None, :]
    np.testing.assert_array_equal(in_topk.numpy(), hit.any(-1).numpy())
    assert not in_topk[:, -1].any()
    dense = torch.where(hit, ref._log_kappa_full(sc_t)[:, None, :], 0.0).sum(-1)
    torch.testing.assert_close(log_kappa, dense, rtol=1e-6, atol=1e-6)
    if case == "duplicates":
        assert (hit.sum(-1) > 1).any()
    if case == "k_above_p_scored":
        assert ((ta == -1) & (tsl >= 0)).any()  # a kappa draw of id -1, summed over 12 slots
    lq = ref.mixture_log_q(in_topk[:, :s], log_kappa[:, :s], torch.tensor(eps), p)
    np.testing.assert_allclose(lq.numpy(), tq[:, :s].numpy(), rtol=1e-6, atol=1e-6)

    ja, jq, _ = map(np.asarray, fused_sampler_pallas(
        jnp.int32(seed), jnp.float32(eps), jnp.asarray(ids), jnp.asarray(scores),
        num_samples=s, num_items=p, sample_tile=ts, interpret=True,
    ))
    same = ta[:, :s].numpy() == ja[:, :s]
    assert same.mean() >= 0.999
    np.testing.assert_allclose(lq.numpy()[same], jq[:, :s][same], rtol=1e-6, atol=1e-6)


# A kernel's SASS as cuobjdump prints it, cut down: a slot loop of two
# hashes, the last barrier, a padded-tail exit, the two arms, and log q's
# exp that only a draw in the row reaches.
_SASS = """
        Function : _ZN4anon20fused_sampler_kernelEiPKfiPKiS1_PiPfS4_iiiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD R2, R2, 0x21f0aaad, RZ ;
        /*0020*/                   FFMA R3, R3, R3, R3 ;
        /*0030*/                   IMAD R4, R4, 0x21f0aaad, RZ ;
        /*0040*/                   IMAD R5, R5, 0x21f0aaad, RZ ;
        /*0050*/                   IMAD.MOV.U32 R6, RZ, RZ, R7 ;
        /*0060*/               @P0 BRA 0x20 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/               @P0 EXIT ;
        /*0090*/               @P1 BRA 0xd0 ;
        /*00a0*/                   POPC R8, R9 ;
        /*00b0*/                   IADD3 R8, R8, 0x1, RZ ;
        /*00c0*/                   BRA 0xf0 ;
        /*00d0*/                   IMAD R10, R10, 0x21f0aaad, RZ ;
        /*00e0*/                   LOP3.LUT R10, R10, R11, RZ, 0x3c, !PT ;
        /*00f0*/               @P2 BRA 0x120 ;
        /*0100*/                   MUFU.EX2 R12, R12 ;
        /*0110*/                   FADD R12, R12, 1 ;
        /*0120*/                   STG.E desc[UR4][R2.64], R12 ;
        /*0130*/                   EXIT ;
        /*0140*/                   BRA 0x140;
"""


def test_bound_charges_each_arm_its_own_path():
    """`chip_smoke.sampler_instructions`, K5's bound's count: a slot is the
    slot loop's computing instructions (no moves, no branch) over its
    hashes, 3 / 2; a kappa-arm draw the fewest after the last barrier on
    a path through its rank's POPC and log q's MUFU.EX2 (5: POPC, IADD3,
    MUFU, FADD, STG); a uniform-arm draw on a path through its hash (3:
    IMAD, LOP3, STG, skipping the exp as a draw outside the row does)."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    assert chip_smoke.sampler_instructions(_SASS) == (1.5, 5, 3)
    with pytest.raises(chip_smoke.CheckFailed, match="no path"):
        chip_smoke.sampler_instructions(_SASS.replace("POPC", "IADD3"))
