"""repro_torch.tucker — the plan/execute decomposition front-end.

    from repro_torch import tucker

    spec = tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16))
    res = tucker.plan(spec)(coo)                  # on the card
    res = tucker.decompose(coo, (16, 16, 16), device="cpu")

    res = tucker.decompose(dense, (16, 16, 16), method="svd")      # Alg. 1
    res = tucker.decompose(coo, (16, 16, 16), algorithm="complete")
    res = tucker.decompose(coo, (16, 16, 16), pipeline="python")   # per sweep
"""
from repro_torch.tucker.planning import TuckerPlan, clear_plan_cache, decompose, plan
from repro_torch.tucker.result import TuckerResult
from repro_torch.tucker.spec import ALGORITHMS, METHODS, TuckerSpec, spec_for

__all__ = [
    "ALGORITHMS",
    "METHODS",
    "TuckerPlan",
    "TuckerResult",
    "TuckerSpec",
    "clear_plan_cache",
    "decompose",
    "plan",
    "spec_for",
]
