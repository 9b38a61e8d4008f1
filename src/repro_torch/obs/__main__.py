"""Inspect an observability session: ``python -m repro_torch.obs [session.json]``.

Two modes:

* **Offline** — pass a session file written by
  ``repro_torch.obs.dump_session`` (or the ``REPRO_TORCH_TRACE=/path``
  atexit hook): the spans and metrics in the dump are summarized/exported
  without touching a device.
* **Live demo** — with no session argument, run a small traced
  decomposition in-process through the port's ``decompose`` on
  ``--device`` (the card by default) and report on it; a quick way to
  eyeball the span taxonomy and check a Perfetto export end to end.

Flags compose: ``--summary`` prints a per-span-name table, ``--perfetto
OUT`` writes Chrome trace-event JSON (open at https://ui.perfetto.dev),
``--prom`` prints the Prometheus text exposition. Default is ``--summary``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def _summary_from_spans(spans: List[dict]) -> Dict[str, Dict[str, float]]:
    agg: Dict[str, Dict[str, float]] = {}
    for ev in spans:
        ms = (ev["t1"] - ev["t0"]) * 1e3
        s = agg.setdefault(
            ev["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
        )
        s["count"] += 1
        s["total_ms"] += ms
        s["max_ms"] = max(s["max_ms"], ms)
    for s in agg.values():
        s["mean_ms"] = s["total_ms"] / max(1, s["count"])
    return agg


def _print_summary(agg: Dict[str, Dict[str, float]]) -> None:
    if not agg:
        print("no spans recorded (is tracing enabled? REPRO_TORCH_TRACE=1)")
        return
    name_w = max(len(n) for n in agg) + 2
    header = (
        f"{'span':<{name_w}} {'count':>7} {'total_ms':>10} "
        f"{'mean_ms':>9} {'max_ms':>9}"
    )
    print(header)
    print("-" * len(header))
    for name in sorted(agg, key=lambda n: -agg[n]["total_ms"]):
        s = agg[name]
        print(
            f"{name:<{name_w}} {int(s['count']):>7} {s['total_ms']:>10.3f} "
            f"{s['mean_ms']:>9.3f} {s['max_ms']:>9.3f}"
        )


def _perfetto_from_spans(spans: List[dict], pid: int, path: str) -> int:
    """Re-export dumped span dicts as Chrome trace-event JSON. The dump's
    t0/t1 are perf_counter seconds; relative placement is what matters, so
    export them as microseconds from the dump's own origin."""
    if spans:
        origin = min(ev["t0"] for ev in spans)
    else:
        origin = 0.0
    events = []
    seen_tids: Dict[int, str] = {}
    for ev in spans:
        seen_tids.setdefault(ev["thread_id"], ev.get("thread_name", ""))
        rec = {
            "name": ev["name"],
            "cat": ev["name"].split(".", 1)[0],
            "ph": "X" if ev["t1"] > ev["t0"] else "i",
            "ts": (ev["t0"] - origin) * 1e6,
            "pid": pid,
            "tid": ev["thread_id"],
            "args": dict(
                ev.get("attrs", {}),
                span_id=ev["span_id"],
                parent_id=ev.get("parent_id"),
            ),
        }
        if rec["ph"] == "X":
            rec["dur"] = (ev["t1"] - ev["t0"]) * 1e6
        else:
            rec["s"] = "t"
        events.append(rec)
    meta = [
        {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": tname},
        }
        for tid, tname in seen_tids.items()
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms"}, f)
        f.write("\n")
    return len(events)


def _prom_from_snapshot(snap: Dict[str, object]) -> str:
    """Best-effort exposition from a dumped ``registry.snapshot()`` dict
    (type info is not in the dump, so scalars render untyped and histogram
    dicts expand to _bucket/_sum/_count)."""
    lines: List[str] = []
    for key in sorted(snap):
        val = snap[key]
        if isinstance(val, dict) and "buckets" in val:
            name, _, labels = key.partition("{")
            labels = ("{" + labels) if labels else ""
            base = labels[1:-1] if labels else ""
            for le, count in val["buckets"].items():  # type: ignore[union-attr]
                inner = (base + "," if base else "") + f'le="{le}"'
                lines.append(f"{name}_bucket{{{inner}}} {count}")
            lines.append(f"{name}_sum{labels} {val['sum']}")
            lines.append(f"{name}_count{labels} {val['count']}")
        else:
            lines.append(f"{key} {val}")
    return "\n".join(lines) + ("\n" if lines else "")


def _run_live_demo(device: str) -> None:
    """A tiny traced decomposition so the live mode has something to show."""
    import repro_torch.obs as obs

    obs.configure(enabled=True)
    from repro_torch.sparse.generators import random_sparse_tensor
    from repro_torch.tucker import decompose

    coo = random_sparse_tensor((24, 20, 16), 0.05, seed=0)
    res = decompose(coo, (4, 3, 2), n_iter=3, device=device)
    print(
        f"demo sweep done: rel_error={res.rel_error:.4f}  "
        f"(trace_summary stages: {sorted((res.trace_summary or {}))})",
        file=sys.stderr,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="inspect a live or dumped observability session",
    )
    ap.add_argument(
        "session", nargs="?", default=None,
        help="session JSON written by repro_torch.obs.dump_session / "
             "REPRO_TORCH_TRACE=<path> (omit to run a small traced demo "
             "decomposition in-process)",
    )
    ap.add_argument("--device", default="cuda",
                    help="device of the live demo (default: the card)")
    ap.add_argument("--summary", action="store_true",
                    help="print a per-span-name aggregate table")
    ap.add_argument("--perfetto", metavar="OUT", default=None,
                    help="write Chrome trace-event JSON to OUT")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text exposition")
    args = ap.parse_args(argv)
    if not (args.summary or args.perfetto or args.prom):
        args.summary = True

    if args.session is not None:
        import repro_torch.obs as obs

        data = obs.load_session(args.session)
        spans = data.get("spans", [])
        if args.summary:
            _print_summary(_summary_from_spans(spans))
        if args.perfetto:
            n = _perfetto_from_spans(
                spans, int(data.get("pid", 0)), args.perfetto
            )
            print(f"wrote {n} events to {args.perfetto}", file=sys.stderr)
        if args.prom:
            sys.stdout.write(_prom_from_snapshot(data.get("metrics", {})))
        return 0

    # live mode: trace a demo sweep, then report from the default tracer
    import repro_torch.obs as obs

    _run_live_demo(args.device)
    if args.summary:
        _print_summary(
            {
                name: dict(stats)
                for name, stats in obs.tracer.summary().items()
            }
        )
    if args.perfetto:
        n = obs.tracer.export_perfetto(args.perfetto)
        print(f"wrote {n} events to {args.perfetto}", file=sys.stderr)
    if args.prom:
        sys.stdout.write(obs.registry.render_prometheus())
    return 0


if __name__ == "__main__":
    sys.exit(main())
