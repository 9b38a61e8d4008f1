"""CLI for the port's program-contract checks.

Usage::

    python -m repro_torch.analysis --all-configs                 # on the card
    python -m repro_torch.analysis --all-configs --device cpu
    python -m repro_torch.analysis --cell cuda/scan/fused --json report.json
    python -m repro_torch.analysis --list

Exit code 0 when every cell is clean after baseline suppression, 1 on any
remaining finding. The sharded cells run only under a process group of at
least 2 ranks (``torchrun --nproc-per-node=2 -m repro_torch.analysis
--all-configs``, which initialises the group from its environment);
otherwise they are skipped.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.analysis.findings import Baseline
    from repro_torch.analysis.runner import default_baseline_path, default_matrix, run_matrix

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="check the program contracts of the port's Tucker sweeps",
    )
    p.add_argument("--all-configs", action="store_true",
                   help="run every cell of the default config matrix")
    p.add_argument("--cell", action="append", default=[],
                   help="run only the named cell(s) (repeatable; see --list)")
    p.add_argument("--list", action="store_true", help="print the matrix cells and exit")
    p.add_argument("--baseline", default=None,
                   help="suppression file (default: the port's "
                   "repro_torch/analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report every finding)")
    p.add_argument("--json", default=None, help="write the report as JSON")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the cells run: 'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    cells = default_matrix()
    if args.list:
        for c in cells:
            extra = f"  (needs {c.min_ranks} ranks)" if c.min_ranks > 1 else ""
            print(f"{c.name}{extra}")
        return 0
    if args.cell:
        by_name = {c.name: c for c in cells}
        unknown = [n for n in args.cell if n not in by_name]
        if unknown:
            p.error(f"unknown cell(s) {unknown}; see --list")
        cells = [by_name[n] for n in args.cell]
    elif not args.all_configs:
        p.error("pass --all-configs, --cell NAME or --list")

    baseline = None
    if not args.no_baseline:
        path = args.baseline or default_baseline_path()
        if os.path.exists(path):
            baseline = Baseline.load(path)
            print(f"baseline: {path} ({len(baseline.suppressions)} suppression(s))")
        elif args.baseline:
            p.error(f"baseline file not found: {args.baseline}")

    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        import torch.distributed as dist

        if not dist.is_initialized():  # started by torchrun
            dist.init_process_group("gloo")
    report = run_matrix(cells if args.cell else None, baseline=baseline, seed=args.seed,
                        device=args.device)
    for cell in report.cells:
        if cell.skipped is not None:
            print(f"SKIP {cell.name}: {cell.skipped}")
            continue
        sup = f" ({cell.suppressed} suppressed)" if cell.suppressed else ""
        ran = f" [{cell.engine}]" if cell.engine else ""
        if cell.findings:
            print(f"FAIL {cell.name}{ran}{sup}")
            for f in cell.findings:
                print(f"  {f}")
        else:
            print(f"ok   {cell.name}{ran}{sup}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report.to_json(), fh, indent=2)
        print(f"wrote {args.json}")

    n = len(report.findings)
    if n:
        print(f"{n} finding(s) — the program contracts do not hold")
        return 1
    print("all program contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
