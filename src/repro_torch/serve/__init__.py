"""repro_torch.serve — the continuous-batching inference engine.

Requests -> queue -> coalesced padded micro-batches -> one route
(retrieval through the resolved ExecutionPlan; for the LM route, a
prefill and greedy decoding whose next tokens go through it). See
`repro_torch.launch.serve` for the CLI.
"""
from repro_torch.serve.coalescer import CoalescePolicy, Request, next_batch, pad_payloads
from repro_torch.serve.engine import DrainResult, RequestRecord, ServingEngine
from repro_torch.serve.planner import QueryPlanner
from repro_torch.serve.routes import DenseCandidateRoute, LMGenerateRoute, RecsysMIPSRoute

__all__ = [
    "CoalescePolicy",
    "DenseCandidateRoute",
    "DrainResult",
    "LMGenerateRoute",
    "QueryPlanner",
    "RecsysMIPSRoute",
    "Request",
    "RequestRecord",
    "ServingEngine",
    "next_batch",
    "pad_payloads",
]
