"""Training launcher of the port, at smoke scale, as the reference's CLI:

* ``--arch fopo-paper`` trains the paper's linear policy with
  `FOPOTrainer` on its SMOKE_CONFIG (P 3000, L 24, S 128, K 64) over a
  synthetic session dataset, on the exact retriever and the plain-torch
  step; `chip_smoke.py` drives the kernel path at full width.
* ``--arch gemma2-2b`` runs the reference's `_train_lm` recipe: the
  SMOKE_CONFIG LM (random weights from seed 0), `adam(1e-3)`, batches of
  4 x 32 tokens drawn from ``np.random.default_rng(0)``, one ``step i:
  loss=... (... ms)`` line per step; `chip_smoke.py` trains the full
  width through the flash-attention kernels.

    PYTHONPATH=src python -m repro_torch.launch.train --arch fopo-paper --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 2 --device cpu

The run needs CUDA unless ``--device cpu`` is given. The other arches
raise, naming the slice that brings their training.
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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch not in ("fopo-paper", "gemma2-2b"):
        raise SystemExit(
            f"training --arch {args.arch} is not ported to repro_torch yet; it "
            "comes with the models slice (ROADMAP Queue A item 6: recsys BCE and "
            "FOPO training, then the other arches)"
        )
    mod = get_arch(args.arch)
    device = resolve_device(args.device)
    if args.arch == "gemma2-2b":
        print(f"arch={args.arch} family={mod.FAMILY} (smoke scale on {device})")
        _train_lm(mod, args.steps, device)
        return
    cfg = mod.SMOKE_CONFIG
    print(f"arch={args.arch} family={mod.FAMILY} (smoke scale on {device})")
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
