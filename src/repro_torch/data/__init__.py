"""Data of the port: the synthetic session-completion generator, the
checkpointable batch loader and the GNN's neighbour sampler (numpy,
host-side)."""
from repro_torch.data.graph_sampling import (
    CSRGraph,
    SampledSubgraph,
    random_graph,
    sample_neighbors,
)
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
    "CSRGraph",
    "LoaderState",
    "SampledSubgraph",
    "SessionDataset",
    "SyntheticConfig",
    "clustered_catalog",
    "generate_sessions",
    "goodreads_like",
    "random_graph",
    "sample_neighbors",
    "twitch_like",
]
