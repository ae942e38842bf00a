"""Training launcher of the port: ``--arch fopo-paper`` trains the
paper's linear policy with `FOPOTrainer` on its SMOKE_CONFIG (P 3000,
L 24, S 128, K 64) over a synthetic session dataset, as the reference's
CLI does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch fopo-paper --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch fopo-paper --steps 2 --device cpu

The run needs CUDA unless ``--device cpu`` is given. The smoke config
runs the exact retriever and the plain-torch step, as the reference's
CLI does; `chip_smoke.py` drives the kernel path (retriever="pallas",
fused=True, fused_sampler=True) at full width. The other arches raise,
naming the slice that brings their training.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data import SyntheticConfig, generate_sessions
from repro_torch.device import resolve_device
from repro_torch.train import FOPOTrainer, TrainerConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch != "fopo-paper":
        raise SystemExit(
            f"training --arch {args.arch} is not ported to repro_torch yet; it "
            "comes with the models slice"
        )
    mod = get_arch(args.arch)
    device = resolve_device(args.device)
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
