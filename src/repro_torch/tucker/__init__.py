"""repro_torch.tucker — the plan/execute decomposition front-end.

    from repro_torch import tucker

    spec = tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16))
    res = tucker.plan(spec)(coo)                  # on the card
    results = tucker.plan(spec).batch([coo_a, coo_b])   # one program for k tensors
    res = tucker.decompose(coo, (16, 16, 16), device="cpu")

    res = tucker.decompose(dense, (16, 16, 16), method="svd")      # Alg. 1
    res = tucker.decompose(coo, (16, 16, 16), algorithm="complete")
    res = tucker.decompose(coo, (16, 16, 16), pipeline="python")   # per sweep

    # a long fit that survives its process: snapshot every 5 sweeps, resume
    ft = tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16),
                           snapshot=tucker.SnapshotSpec(every_n_sweeps=5,
                                                        directory="ckpt/job"))
    res = tucker.plan(ft)(coo)              # snapshots as it sweeps
    res = tucker.resume(ft, coo)            # picks up from the latest one

    # tuned launch parameters, kept in REPRO_TORCH_AUTOTUNE_TABLE
    res = tucker.plan(tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16),
                                        autotune=True))(coo)

    # the nonzeros split over 4 ranks (torchrun --nproc-per-node=4; each rank
    # calls torch.cuda.set_device(LOCAL_RANK) and init_process_group first)
    res = tucker.plan(tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16),
                                        shard=tucker.ShardSpec(num_devices=4)))(coo)

    # float64 on the card (kernels 1-5 in f64), and the paper's Kron reuse
    # on the torch engine (ignored on cuda)
    res = tucker.plan(tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16),
                                        dtype="float64"))(coo)
    res = tucker.plan(tucker.TuckerSpec(shape=coo.shape, ranks=(16, 16, 16),
                                        engine="torch", use_kron_reuse=True))(coo)

    # the program contracts (no host sync in a sweep, precision,
    # collectives, write-disjoint schedules) and the modelled roofline terms
    findings = tucker.plan(spec).lint(coo)        # [] when every one holds
    terms = tucker.plan(spec).analyze(coo)        # flops, bytes per sweep
"""
from repro_torch.tucker.planning import (
    PlanCache,
    PlanStats,
    TuckerPlan,
    add_plan_eviction_hook,
    clear_plan_cache,
    decompose,
    engine_for_spec,
    mesh_fingerprint,
    mesh_for_shard,
    plan,
    plan_cache_info,
    resume,
    set_plan_cache_capacity,
)
from repro_torch.tucker.result import RequestTiming, TuckerResult
from repro_torch.tucker.snapshot import SnapshotState, load_snapshot
from repro_torch.tucker.spec import (
    ALGORITHMS,
    METHODS,
    ShardSpec,
    SnapshotSpec,
    TuckerSpec,
    spec_for,
)

__all__ = [
    "ALGORITHMS",
    "METHODS",
    "PlanCache",
    "PlanStats",
    "RequestTiming",
    "ShardSpec",
    "SnapshotSpec",
    "SnapshotState",
    "TuckerPlan",
    "TuckerResult",
    "TuckerSpec",
    "add_plan_eviction_hook",
    "clear_plan_cache",
    "decompose",
    "engine_for_spec",
    "load_snapshot",
    "mesh_fingerprint",
    "mesh_for_shard",
    "plan",
    "plan_cache_info",
    "resume",
    "set_plan_cache_capacity",
    "spec_for",
]
