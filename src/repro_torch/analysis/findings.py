"""Structured lint findings and the committed suppression baseline.

Port of ``repro.analysis.findings`` (pure Python; the port keeps its own
copy). Every contract check in ``repro_torch.analysis`` reports
:class:`Finding` records — (check, severity, where, message) — instead of
raising, so the CLI can diff a run against a committed :class:`Baseline`
file and fail only on findings it does not list. The baseline is a list of
:class:`Suppression` patterns (exact check, ``fnmatch`` on the location,
substring on the message, free-text reason) reviewed like any other code:
suppressing a finding is a diff, not a flag. The port's baseline is
``repro_torch/analysis/baseline.json``.

The check names are the reference's, so baselines stay compatible.
``donation`` stays among them although no port cell emits it: eager
PyTorch donates no buffer, so there is no alias to check.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Iterable, List, Tuple

SEVERITIES = ("error", "warning")
CHECKS = (
    "transfer",
    "donation",
    "retrace-hazard",
    "precision",
    "collective",
    "scatter-race",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated program contract.

    Attributes:
      check: the lint family (one of :data:`CHECKS`).
      severity: ``"error"`` (contract broken) or ``"warning"`` (suspicious
        but not disqualifying).
      where: location — ``cell@device``, ``cell@device/mode0``, a spec
        field path. Baselines match it with ``fnmatch``.
      message: human-readable statement of what broke and why it matters.
    """

    check: str
    severity: str
    where: str
    message: str

    def __post_init__(self) -> None:
        if self.check not in CHECKS:
            raise ValueError(f"unknown check {self.check!r}, not in {CHECKS}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}, not in {SEVERITIES}"
            )

    def __str__(self) -> str:
        return f"[{self.severity}] {self.check} @ {self.where}: {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One baseline entry: which findings are accepted, and why."""

    check: str  # exact check name, or "*" for any
    where: str = "*"  # fnmatch pattern over Finding.where
    match: str = ""  # substring of Finding.message ("" matches all)
    reason: str = ""

    def covers(self, finding: Finding) -> bool:
        return (
            self.check in ("*", finding.check)
            and fnmatch.fnmatch(finding.where, self.where)
            and self.match in finding.message
        )


@dataclasses.dataclass
class Baseline:
    """A suppression file (the port's: ``repro_torch/analysis/baseline.json``)."""

    suppressions: List[Suppression] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as f:
            raw = json.load(f)
        sups = [
            Suppression(
                check=e["check"],
                where=e.get("where", "*"),
                match=e.get("match", ""),
                reason=e.get("reason", ""),
            )
            for e in raw.get("suppressions", [])
        ]
        return cls(suppressions=sups)

    def save(self, path: str) -> None:
        payload = {
            "version": 1,
            "suppressions": [dataclasses.asdict(s) for s in self.suppressions],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")

    def filter(
        self, findings: Iterable[Finding]
    ) -> Tuple[List[Finding], List[Finding]]:
        """Split ``findings`` into (kept, suppressed)."""
        kept: List[Finding] = []
        suppressed: List[Finding] = []
        for f in findings:
            if any(s.covers(f) for s in self.suppressions):
                suppressed.append(f)
            else:
                kept.append(f)
        return kept, suppressed
