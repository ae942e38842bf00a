"""Training launcher of the port, at smoke scale, as the reference's CLI:

* ``--arch fopo-paper`` trains the paper's linear policy with
  `FOPOTrainer` on its SMOKE_CONFIG (P 3000, L 24, S 128, K 64) over a
  synthetic session dataset, on the exact retriever and the plain-torch
  step; `chip_smoke.py` drives the kernel path at full width.
* an LM arch (gemma2-2b, olmoe-1b-7b, arctic-480b, granite-8b,
  mistral-large-123b) runs the reference's `_train_lm` recipe: the
  SMOKE_CONFIG LM (random weights from seed 0), `adam(1e-3)`, batches of
  4 x 32 tokens drawn from ``np.random.default_rng(0)``, one ``step i:
  loss=... (... ms)`` line per step; `chip_smoke.py` trains Gemma-2 2B
  and OLMoE-1B-7B at full width through the flash-attention kernels.
* a recsys arch (sasrec, din, dien, wide-deep) runs the reference's
  `_train_recsys` recipe: SMOKE_CONFIG (random weights from seed 0),
  `adam(1e-3)`, batches of 64 drawn from ``np.random.default_rng(0)``,
  sasrec on the FOPO objective (step i draws from seed i), the others on
  BCE, one ``step i: loss=... [objective]`` line per step.
* graphcast (the GNN) runs the reference's `_train_gnn` recipe:
  SMOKE_CONFIG (random weights from seed 0) over ``random_graph(512,
  avg_degree=8, seed=0)`` (src = the CSR's indices mod 512, dst = each
  CSR row repeated), 16 input features and the targets drawn from
  ``np.random.default_rng(0)``, `adam(1e-3)`, every node in the loss,
  one ``step i: loss=...`` line per step; `chip_smoke.py` trains
  GraphCast at full width.

    PYTHONPATH=src python -m repro_torch.launch.train --arch fopo-paper --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch graphcast --steps 3 --device cpu

The run needs CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data import SyntheticConfig, generate_sessions
from repro_torch.device import resolve_device
from repro_torch.optim import adam
from repro_torch.train import FOPOTrainer, TrainerConfig


def _train_lm(mod, steps: int, device: torch.device) -> None:
    from repro_torch.models import lm

    cfg = mod.SMOKE_CONFIG
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt = adam(1e-3)
    step = lm.make_train_step(cfg, opt)
    st = opt.init(params)
    b, s = 4, 32
    rng = np.random.default_rng(0)
    for i in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1))).to(device)
        t0 = time.perf_counter()
        params, st, loss = step(params, st, toks[:, :-1], toks[:, 1:])
        loss = float(loss)  # waits for the step
        print(f"step {i}: loss={loss:.4f} ({(time.perf_counter() - t0) * 1e3:.0f} ms)")


def _train_gnn(mod, steps: int, device: torch.device) -> None:
    from repro_torch.data import random_graph
    from repro_torch.models import gnn

    cfg = mod.SMOKE_CONFIG
    g = random_graph(512, avg_degree=8, seed=0)
    d_feat = 16
    params = gnn.init_params(cfg, torch.Generator(device=device).manual_seed(0), d_feat=d_feat)
    opt = adam(1e-3)
    step = gnn.make_train_step(cfg, opt)
    st = opt.init(params)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(512, d_feat)).astype(np.float32)).to(device)
    targets = torch.from_numpy(rng.normal(size=(512, cfg.n_vars)).astype(np.float32)).to(device)
    src = torch.from_numpy((g.indices % 512).astype(np.int32)).to(device)
    dst = torch.from_numpy(np.repeat(np.arange(512), np.diff(g.indptr)).astype(np.int32)).to(device)
    mask = torch.ones((512,), device=device)
    for i in range(steps):
        params, st, loss = step(params, st, feats, src, dst, targets, mask)
        print(f"step {i}: loss={float(loss):.4f}")


def recsys_batch(cfg, rng: np.random.Generator, objective: str, b: int = 64) -> dict:
    """One training batch of ``b`` rows as numpy arrays, drawn from ``rng``
    in the reference launcher's order: Wide&Deep's sparse ids in [0, 10^6),
    dense features and labels; FOPO's histories in [-1, item_vocab) and 4
    positives a row; BCE's histories, targets and labels (30 % positive)."""
    if cfg.kind == "wide_deep":
        return {
            "sparse": rng.integers(0, 10**6, (b, cfg.n_sparse)),
            "dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            "label": (rng.random(b) < 0.3).astype(np.float32),
        }
    if objective == "fopo":
        return {
            "hist": rng.integers(-1, cfg.item_vocab, (b, cfg.seq_len)),
            "positives": rng.integers(0, cfg.item_vocab, (b, 4)),
        }
    return {
        "hist": rng.integers(-1, cfg.item_vocab, (b, cfg.seq_len)),
        "target": rng.integers(0, cfg.item_vocab, (b,)),
        "label": (rng.random(b) < 0.3).astype(np.float32),
    }


def _train_recsys(mod, steps: int, device: torch.device) -> None:
    from repro_torch.models import recsys

    cfg = mod.SMOKE_CONFIG
    params = recsys.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    objective = "fopo" if cfg.kind == "sasrec" else "bce"
    opt = adam(1e-3)
    step = recsys.make_train_step(cfg, opt, objective=objective)
    st = opt.init(params)
    rng = np.random.default_rng(0)
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in recsys_batch(cfg, rng, objective).items()}
        params, st, loss = step(params, st, batch, i)
        print(f"step {i}: loss={float(loss):.5f} [{objective}]")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mod = get_arch(args.arch)
    device = resolve_device(args.device)
    print(f"arch={args.arch} family={mod.FAMILY} (smoke scale on {device})")
    if mod.FAMILY == "lm":
        _train_lm(mod, args.steps, device)
        return
    if mod.FAMILY == "recsys":
        _train_recsys(mod, args.steps, device)
        return
    if mod.FAMILY == "gnn":
        _train_gnn(mod, args.steps, device)
        return
    cfg = mod.SMOKE_CONFIG
    data = generate_sessions(
        SyntheticConfig(num_items=cfg.num_items, num_users=2000,
                        embed_dim=cfg.embed_dim, session_len=16)
    )
    train_ds, test_ds = data.split(0.9)
    tr = FOPOTrainer(
        TrainerConfig(estimator="fopo", fopo=cfg.fopo, batch_size=32,
                      learning_rate=3e-3, num_steps=args.steps),
        train_ds,
        device=device,
    )
    print(f"R_test before: {tr.evaluate(test_ds):.4f}")
    tr.train(args.steps, log_every=max(1, args.steps // 5))
    print(f"R_test after:  {tr.evaluate(test_ds):.4f}")


if __name__ == "__main__":
    main()
