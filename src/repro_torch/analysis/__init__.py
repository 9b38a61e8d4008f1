"""Program-contract checks for the port's Tucker sweeps.

Port of ``repro.analysis``. The reference lints the closed jaxpr and the
optimized HLO of each compiled program; eager PyTorch has no compiled
program, so the port checks the same contracts while the sweeps run (a
dynamic check) where that makes sense:

  ==============  =====================================================
  check           contract
  ==============  =====================================================
  transfer        no host sync inside a sweep: on the card the sweep
                  runs under ``torch.cuda.set_sync_debug_mode``, and on
                  any device a ``TorchFunctionMode`` flags host reads
                  (``.item()``, ``.cpu()``, ``bool(t)``, ...)
  donation        no twin for the per-tensor pipelines (eager PyTorch
                  donates no buffer, so no port cell emits it); a
                  batched flush must leave its members' buffers as they
                  were (the reference's inverse contract)
  retrace-hazard  plan-cache key classes are frozen, hashable, NaN-safe
                  and deeply immutable
  precision       bf16_fp32acc keeps Y_(n), the factors and G in the
                  working dtype, bf16 only as kernel operands; fp32
                  sweeps make no bf16 tensor at all
  collective      a sharded sweep all-reduces exactly once per mode,
                  bytes matching ``distributed.psum_bytes_per_sweep``;
                  an unsharded one makes no collective
  scatter-race    kernels 1 and 5 sum without atomics: the schedule's
                  slots, rows and row split (``parts``) are proved
                  write-disjoint; the launch fits the card's shared
                  memory
  ==============  =====================================================

Surfaces: ``TuckerPlan.lint()`` / ``lint_batch()`` (findings for one plan),
``TuckerPlan.analyze()`` (the modelled flops and bytes of a sweep),
``python -m repro_torch.analysis --all-configs`` (the config matrix and the
port's baseline, ``repro_torch/analysis/baseline.json``).
"""
from repro_torch.analysis.findings import (
    CHECKS,
    SEVERITIES,
    Baseline,
    Finding,
    Suppression,
)
from repro_torch.analysis.runner import (
    Cell,
    CellReport,
    MatrixReport,
    default_baseline_path,
    default_matrix,
    lint_batch_plan,
    lint_plan,
    run_matrix,
)
from repro_torch.analysis.schedule_lints import (
    scatter_race_lint,
    scatter_race_lint_device,
    scatter_race_lint_schedule,
)
from repro_torch.analysis.spec_lints import retrace_hazard_lint
from repro_torch.analysis.sweep_lints import (
    collective_lint,
    precision_lint,
    sweep_lint,
    transfer_lint,
    watch_sweeps,
)

__all__ = [
    "CHECKS",
    "SEVERITIES",
    "Baseline",
    "Cell",
    "CellReport",
    "Finding",
    "MatrixReport",
    "Suppression",
    "collective_lint",
    "default_baseline_path",
    "default_matrix",
    "lint_batch_plan",
    "lint_plan",
    "precision_lint",
    "retrace_hazard_lint",
    "run_matrix",
    "scatter_race_lint",
    "scatter_race_lint_device",
    "scatter_race_lint_schedule",
    "sweep_lint",
    "transfer_lint",
    "watch_sweeps",
]
