"""Core of the port: the policy, SNIS, proposals, gradients, the FOPO
config and loss, the execution plan, and the FOPO LM head."""
from repro_torch.core.fopo import FOPOConfig, fopo_loss, make_retriever, reinforce_loss
from repro_torch.core.gradients import covariance_gradient_dense_reference, exact_objective
from repro_torch.core.lm_head import FopoLMHeadConfig, fopo_lm_head_loss
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.policy import SoftmaxPolicy, make_linear_policy, make_mlp_policy

__all__ = [
    "ExecutionPlan",
    "FOPOConfig",
    "FopoLMHeadConfig",
    "SoftmaxPolicy",
    "covariance_gradient_dense_reference",
    "exact_objective",
    "fopo_lm_head_loss",
    "fopo_loss",
    "make_linear_policy",
    "make_mlp_policy",
    "make_retriever",
    "reinforce_loss",
]
