"""Retrace-hazard lint: a static audit of the plan-cache key types.

Port of ``repro.analysis.spec_lints`` (pure Python; the port keeps its own
copy), on the port's :class:`~repro_torch.tucker.spec.TuckerSpec`,
``ShardSpec`` and ``SnapshotSpec``. ``tucker.plan`` keys its cache on
these frozen dataclasses. Three member classes of bugs silently defeat that
cache and turn every call into a new plan, with its engine and schedules
built anew (the port never traces, but a miss costs the set-up the cache
exists to save):

  * an unhashable or mutable member (list/dict/ndarray field) — the key
    either raises or drifts after insertion;
  * a NaN-valued float member — IEEE ``NaN != NaN`` makes the spec unequal
    to an identical copy, so every lookup misses while the table grows;
  * a non-frozen dataclass in the chain — field writes after keying
    corrupt the bucket.

The audit is structural (class introspection + template-instance probes),
so it runs without building a single plan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding

_IMMUTABLE_SCALARS = (type(None), bool, int, float, str, bytes)
# type-annotation fragments that name mutable containers. Annotations are
# audited as strings (PEP 563 keeps them unevaluated in the spec module).
_MUTABLE_TYPE_MARKERS = (
    "List[", "list[", "Dict[", "dict[", "Set[", "set[",
    "bytearray", "ndarray", "Array",
)
_MUTABLE_TYPE_EXACT = ("list", "dict", "set")


def _deeply_immutable(value: Any) -> Tuple[bool, str]:
    """(ok, offending type name) — recursing through tuples, frozensets and
    frozen dataclasses."""
    if isinstance(value, _IMMUTABLE_SCALARS):
        return True, ""
    if isinstance(value, (tuple, frozenset)):
        for v in value:
            ok, name = _deeply_immutable(v)
            if not ok:
                return False, name
        return True, ""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        if not type(value).__dataclass_params__.frozen:
            return False, f"non-frozen dataclass {type(value).__name__}"
        for f in dataclasses.fields(value):
            ok, name = _deeply_immutable(getattr(value, f.name))
            if not ok:
                return False, name
        return True, ""
    return False, type(value).__name__


def _nan_paths(value: Any, path: str) -> Iterable[str]:
    if isinstance(value, float) and math.isnan(value):
        yield path
    elif isinstance(value, (tuple, frozenset)):
        for i, v in enumerate(value):
            yield from _nan_paths(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _nan_paths(getattr(value, f.name), f"{path}.{f.name}")


def _default_classes_and_templates() -> Tuple[Tuple[type, ...], Tuple[object, ...]]:
    from repro_torch.tucker.spec import ShardSpec, SnapshotSpec, TuckerSpec

    classes = (TuckerSpec, ShardSpec, SnapshotSpec)
    templates = (
        TuckerSpec(shape=(8, 6, 4), ranks=(2, 2, 2), method="gram"),
        ShardSpec(num_devices=2),
        SnapshotSpec(every_n_sweeps=2, directory="repro-torch-lint-probe"),
    )
    return classes, templates


def retrace_hazard_lint(
    classes: Optional[Sequence[type]] = None,
    templates: Optional[Sequence[object]] = None,
    *,
    where: str = "plan-cache",
) -> List[Finding]:
    """Audit the plan-cache key classes (default: TuckerSpec/ShardSpec/
    SnapshotSpec) and representative instances for cache-defeating members.
    Pass custom ``classes``/``templates`` to audit another key type (the
    seeded-violation tests do)."""
    if classes is None and templates is None:
        classes, templates = _default_classes_and_templates()
    classes = tuple(classes or ())
    templates = tuple(templates or ())
    findings: List[Finding] = []

    for cls in classes:
        loc = f"{where}/{cls.__name__}"
        if not dataclasses.is_dataclass(cls):
            findings.append(
                Finding(
                    "retrace-hazard", "error", loc,
                    "cache key class is not a dataclass — field-wise "
                    "equality/hash are not guaranteed",
                )
            )
            continue
        if not cls.__dataclass_params__.frozen:
            findings.append(
                Finding(
                    "retrace-hazard", "error", loc,
                    "cache key dataclass is not frozen — members can "
                    "mutate after the plan is keyed, stranding the entry",
                )
            )
        if cls.__hash__ is None:
            findings.append(
                Finding(
                    "retrace-hazard", "error", loc,
                    "cache key class is unhashable (eq without frozen/"
                    "unsafe_hash) — plan() would raise on every call",
                )
            )
        for f in dataclasses.fields(cls):
            if isinstance(f.type, str):
                ann = f.type
            else:
                # a live annotation object: bare classes render as their
                # name ("list"), generics via repr ("list[int]").
                ann = getattr(f.type, "__name__", None) or repr(f.type)
            if ann in _MUTABLE_TYPE_EXACT or any(
                marker in ann for marker in _MUTABLE_TYPE_MARKERS
            ):
                findings.append(
                    Finding(
                        "retrace-hazard", "error", f"{loc}.{f.name}",
                        f"field annotated {ann!r} is a mutable container — "
                        "hash/eq of the cache key can drift after insertion",
                    )
                )

    for t in templates:
        loc = f"{where}/{type(t).__name__}"
        try:
            hash(t)
        except TypeError as e:
            findings.append(
                Finding(
                    "retrace-hazard", "error", loc,
                    f"template instance is unhashable: {e}",
                )
            )
            continue
        # live NaN members: the instance is already never equal to itself.
        for path in _nan_paths(t, loc):
            findings.append(
                Finding(
                    "retrace-hazard", "error", path,
                    "NaN-valued member: NaN != NaN makes this key unequal "
                    "to an identical copy — every plan() call misses the "
                    "cache and retraces",
                )
            )
        if dataclasses.is_dataclass(t):
            if t != dataclasses.replace(t):
                findings.append(
                    Finding(
                        "retrace-hazard", "error", loc,
                        "instance is not equal to an identical copy of "
                        "itself — the cache can never hit on this key",
                    )
                )
            for f in dataclasses.fields(t):
                value = getattr(t, f.name)
                ok, offender = _deeply_immutable(value)
                if not ok:
                    findings.append(
                        Finding(
                            "retrace-hazard", "error", f"{loc}.{f.name}",
                            f"field holds mutable value of type {offender} "
                            "— mutating it after keying corrupts the "
                            "cache bucket",
                        )
                    )
                # NaN-acceptance probe: a validator must reject NaN in
                # every float field, or a caller can build a
                # cache-defeating key.
                if isinstance(value, float):
                    try:
                        probe = dataclasses.replace(
                            t, **{f.name: float("nan")}
                        )
                    except Exception:
                        continue  # rejected — the validator holds
                    if isinstance(getattr(probe, f.name), float) and (
                        math.isnan(getattr(probe, f.name))
                    ):
                        findings.append(
                            Finding(
                                "retrace-hazard", "error",
                                f"{loc}.{f.name}",
                                "constructor accepts NaN in this float "
                                "field — a NaN-valued key never equals "
                                "itself, so the plan cache misses on "
                                "every call (silent retrace storm)",
                            )
                        )
    return findings
