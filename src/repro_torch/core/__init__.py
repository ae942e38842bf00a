"""Core of the port: the policy, the FOPO config and the execution plan."""
from repro_torch.core.fopo import FOPOConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.policy import SoftmaxPolicy

__all__ = ["ExecutionPlan", "FOPOConfig", "SoftmaxPolicy"]
