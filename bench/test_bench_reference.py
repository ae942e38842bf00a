"""The references against the program's CPU path (the kernels' plain
versions) at a tiny size: the whole judge agrees to rounding, and the
index and the tower the reference works out again are the program's."""
from __future__ import annotations

import pytest
import torch

from bench.reference import sasrec as sasrec_ref
from bench.tinycells import TINY, tiny_driver, tiny_run
from bench.yardstick import gen


@pytest.mark.parametrize("workload", list(TINY))
def test_judge_agrees_with_the_program_on_the_cpu(workload):
    result, _ = tiny_run(workload, seed=3_000_000_019)
    assert result["correct"]
    for name, check in result["checks"].items():
        assert check["value"] <= 1e-6, name


def test_reference_index_and_tower_are_the_programs():
    from repro_torch.configs.sasrec import CONFIG
    from repro_torch.mips.ivf import build_ivf
    from repro_torch.models.recsys import sasrec_user_vector

    g = torch.Generator().manual_seed(5)
    params = gen.sasrec_params(4000, 16, 12, 2, g)
    with sasrec_ref.deterministic():
        index = build_ivf(params["items"], num_clusters=64, seed=77, device="cpu")
        cents, lists = sasrec_ref.build_index(params["items"], 64, 77, "fp32")
    assert torch.equal(index.centroids, cents) and torch.equal(index.lists, lists)
    hist = gen.zipf_histories(32, 12, 4000, 1.1, g)
    cfg = CONFIG.__class__(**{**CONFIG.__dict__, "item_vocab": 4000, "embed_dim": 16,
                              "seq_len": 12})
    assert torch.equal(sasrec_user_vector(cfg, params, hist),
                       sasrec_ref.user_vectors(params, hist, 1, "fp32"))


def test_training_reference_follows_the_programs_batches():
    """The first steps' losses of the program, on the rows its loader
    picked, are the reference's on the rows `batch_rows` picks."""
    run = tiny_driver("fopo-paper.exact-b4096", seed=17)
    run.release()
    ref = run.reference(run.program, follow=False)
    assert len(ref["losses"]) == len(run.program["losses"]) == run.ref_steps
    assert ref["losses"] == pytest.approx(run.program["losses"], rel=1e-6, abs=0)


def test_training_reference_follows_the_window_from_the_programs_state():
    """The window's last call's first steps, followed from the state the
    program had before them, on the batches `batch_rows` picks for their
    step numbers: the same losses and the same parameters after them."""
    run = tiny_driver("fopo-paper.exact-b4096", seed=19)
    for _ in range(3):
        run.run_unit()
    last = run.segments()[-1]
    assert last["first_step"] == run.ref_steps + 3 * run.steps_per_call
    assert len(last["losses"]) == len(last["topk"]) == run.window_steps
    run.release()
    ref = run.reference(last, follow=False)
    assert ref["losses"] == pytest.approx(last["losses"], rel=1e-6, abs=0)
    assert torch.allclose(ref["params"], last["params"], rtol=1e-6, atol=1e-7)
    assert not torch.equal(last["params"], last["start"])
