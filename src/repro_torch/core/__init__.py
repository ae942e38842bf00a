"""Core of the port: the policy, SNIS, proposals, gradients, the FOPO
config and loss, the execution plan, and the FOPO LM head."""
from repro_torch.core.fopo import FOPOConfig, fopo_loss, make_retriever, reinforce_loss
from repro_torch.core.lm_head import FopoLMHeadConfig, fopo_lm_head_loss
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.policy import SoftmaxPolicy

__all__ = [
    "ExecutionPlan",
    "FOPOConfig",
    "FopoLMHeadConfig",
    "SoftmaxPolicy",
    "fopo_lm_head_loss",
    "fopo_loss",
    "make_retriever",
    "reinforce_loss",
]
