"""Data of the port: the synthetic session-completion generator and the
checkpointable batch loader (numpy, host-side)."""
from repro_torch.data.loader import BatchLoader, LoaderState
from repro_torch.data.synthetic import (
    SessionDataset,
    SyntheticConfig,
    clustered_catalog,
    generate_sessions,
    goodreads_like,
    twitch_like,
)

__all__ = [
    "BatchLoader",
    "LoaderState",
    "SessionDataset",
    "SyntheticConfig",
    "clustered_catalog",
    "generate_sessions",
    "goodreads_like",
    "twitch_like",
]
