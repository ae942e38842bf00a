"""fopo-paper: the paper's own experiment, a linear policy
h_theta = theta^T x over SVD item embeddings at Twitch scale.

The same configuration as the reference's `repro/configs/fopo_paper.py`:
`CONFIG` is the full width (P 750,000, L 100, S 1000, K 256, eps 0.8,
batch 32, lr 1e-4), `SMOKE_CONFIG` the small one the CLI and the tests
use."""
from __future__ import annotations

import dataclasses

from repro_torch.core.fopo import FOPOConfig
from repro_torch.models.configs_base import ShapeCell

FAMILY = "fopo"


@dataclasses.dataclass(frozen=True)
class FopoPaperConfig:
    name: str = "fopo-paper"
    num_items: int = 750_000  # Twitch-scale
    embed_dim: int = 100  # L
    batch_size: int = 32  # paper
    learning_rate: float = 1e-4  # paper (twitch)
    fopo: FOPOConfig = dataclasses.field(
        default_factory=lambda: FOPOConfig(
            num_items=750_000, num_samples=1000, top_k=256, epsilon=0.8,
            retriever="streaming",
        )
    )


CONFIG = FopoPaperConfig()

SHAPES = {
    "train_paper": ShapeCell(name="train_paper", kind="train", global_batch=32),
    "train_large_batch": ShapeCell(name="train_large_batch", kind="train", global_batch=4096),
    "serve_argmax": ShapeCell(
        name="serve_argmax", kind="retrieval", global_batch=1024, n_candidates=750_000
    ),
}
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_items=3000,
    embed_dim=24,
    fopo=FOPOConfig(num_items=3000, num_samples=128, top_k=64, epsilon=0.8, retriever="exact"),
)
