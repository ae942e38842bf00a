"""Core of the port: the policy, SNIS, proposals, gradients, the FOPO
config and loss, and the execution plan."""
from repro_torch.core.fopo import FOPOConfig, fopo_loss, make_retriever, reinforce_loss
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.policy import SoftmaxPolicy

__all__ = [
    "ExecutionPlan",
    "FOPOConfig",
    "SoftmaxPolicy",
    "fopo_loss",
    "make_retriever",
    "reinforce_loss",
]
