"""Roofline analysis over records of measured cells.

Port of ``repro.launch.roofline``. Three terms per (arch x shape x mesh), in
seconds per step:

  compute    = FLOPs / (chips * peak FLOP/s)
  memory     = HBM bytes / (chips * HBM bytes/s)
  collective = collective bytes per device / link bandwidth

FLOPs and HBM bytes come from the analytic cell model
(``repro_torch.models.flops.cell_cost``), the collective bytes from the
record (``hlo.total_coll_bytes``, per device) and the peak memory from the
record (``memory.peak_tpu_est_bytes``, held against the preset's capacity).
Also reported, as in the reference: the useful ratio MODEL_FLOPS / FLOPs,
the dominant term and the roofline fraction (useful time over the dominant
term's time).

The reference reads records written by its ``launch/dryrun.py``, which
compiles each cell ahead of time for 256- and 512-chip TPU meshes; that
tool has no twin here. The port's records come from measured runs on the
card (``chip_smoke.py`` phase 24), in the same schema, and a record the
reference's ``dryrun.py`` wrote gives the same table through either
package. Two deviations from the reference, both additive:

  * a record may carry ``"chips"``, which :func:`chips` prefers over the
    mesh rule (512 chips for "2x16x16", else 256): a measured cell names
    the cards it ran on;
  * ``"shape"`` may be a :class:`~repro_torch.configs.base.ShapeConfig`
    as a dict (``name``, ``seq_len``, ``global_batch``, ``kind``) instead
    of a name in ``SHAPES``, for the depth- or batch-cut cells the card
    runs.

Presets: the reference's four TPU presets, copied, and ``"h100-sxm"``,
NVIDIA's H100 SXM5 data sheet: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of
HBM3, 450e9 B/s of NVLink 4 a direction as the link, one NDR 400 Gb/s NIC
(50e9 B/s) as the pod-crossing link, 80 GB. ``chip_smoke.py`` takes the
card's peaks from that preset.

  python -m repro_torch.launch.roofline RECORDS.json --arch h100-sxm [--md OUT.md]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Peak machine numbers the roofline terms divide by. The module-level
    constants below mirror the default ('tpu-v5e') preset, as in the
    reference; pick another preset with ``--arch`` or override any single
    number with the ``--peak-flops/--hbm-bw/--ici-bw`` flags."""

    peak_flops: float  # matmul FLOP/s per chip (bf16)
    hbm_bw: float  # HBM bytes/s per chip
    ici_bw: float  # interconnect bytes/s per link
    dcn_bw: float  # pod-crossing bytes/s
    hbm_per_chip: int  # HBM capacity per chip (bytes)


ARCH_PRESETS: Dict[str, ArchSpec] = {
    "tpu-v5e": ArchSpec(197e12, 819e9, 50e9, 25e9, 16 * 2**30),
    "tpu-v5p": ArchSpec(459e12, 2765e9, 100e9, 25e9, 95 * 2**30),
    "tpu-v4": ArchSpec(275e12, 1228e9, 50e9, 25e9, 32 * 2**30),
    "tpu-v6e": ArchSpec(918e12, 1640e9, 100e9, 25e9, 32 * 2**30),
    "h100-sxm": ArchSpec(989e12, 3.35e12, 450e9, 50e9, 80 * 10**9),
}
DEFAULT_ARCH = "tpu-v5e"

# the reference's module-level constants (== the default preset)
PEAK_FLOPS = ARCH_PRESETS[DEFAULT_ARCH].peak_flops  # bf16 / chip
HBM_BW = ARCH_PRESETS[DEFAULT_ARCH].hbm_bw  # bytes/s / chip
ICI_BW = ARCH_PRESETS[DEFAULT_ARCH].ici_bw  # bytes/s/link
DCN_BW = ARCH_PRESETS[DEFAULT_ARCH].dcn_bw  # pod-crossing axis
HBM_PER_CHIP = ARCH_PRESETS[DEFAULT_ARCH].hbm_per_chip


def resolve_arch(
    arch: str = DEFAULT_ARCH,
    *,
    peak_flops: float = 0.0,
    hbm_bw: float = 0.0,
    ici_bw: float = 0.0,
) -> ArchSpec:
    """The preset named ``arch`` with any nonzero override applied on top."""
    if arch not in ARCH_PRESETS:
        raise ValueError(
            f"unknown arch {arch!r}; presets: {sorted(ARCH_PRESETS)}"
        )
    spec = ARCH_PRESETS[arch]
    return dataclasses.replace(
        spec,
        peak_flops=peak_flops or spec.peak_flops,
        hbm_bw=hbm_bw or spec.hbm_bw,
        ici_bw=ici_bw or spec.ici_bw,
    )


def chips(rec: dict) -> int:
    """The record's ``"chips"`` where it has one, else the reference's
    mesh rule."""
    if "chips" in rec:
        return int(rec["chips"])
    return 512 if rec["mesh"] == "2x16x16" else 256


def shape_of(rec: dict):
    """The record's :class:`ShapeConfig`: a name in ``SHAPES``, or a dict."""
    from repro_torch.configs import SHAPES, ShapeConfig

    shape = rec["shape"]
    return ShapeConfig(**shape) if isinstance(shape, dict) else SHAPES[shape]


def shape_name(rec: dict) -> str:
    shape = rec["shape"]
    return shape["name"] if isinstance(shape, dict) else shape


def roofline_terms(rec: dict, arch: ArchSpec = None) -> Dict[str, float]:
    from repro_torch.configs import get_config
    from repro_torch.models.flops import cell_cost

    if arch is None:
        arch = ARCH_PRESETS[DEFAULT_ARCH]
    cfg = get_config(rec["arch"])
    cost = cell_cost(cfg, shape_of(rec))
    c = chips(rec)
    compute_s = cost.flops / (c * arch.peak_flops)
    memory_s = cost.hbm_bytes / (c * arch.hbm_bw)
    coll_bytes = rec["hlo"]["total_coll_bytes"]  # per device, measured
    collective_s = coll_bytes / arch.ici_bw
    mf = cost.model_flops
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dominant = max(terms.items(), key=lambda kv: kv[1])[0].replace("_s", "")
    bound = max(terms.values())
    useful = mf / cost.flops if cost.flops else 0.0
    mfu_bound = (mf / c / arch.peak_flops) / bound if bound else 0.0
    mem = rec.get("memory", {})
    return dict(
        **terms,
        dominant=dominant,
        model_flops=mf,
        useful_ratio=useful,
        roofline_frac=mfu_bound,
        hlo_dot_flops=rec["hlo"]["dot_flops"] * c,  # diagnostic (global)
        fits=(mem.get("peak_tpu_est_bytes", 0) or 0) <= arch.hbm_per_chip,
        peak_gib=(mem.get("peak_tpu_est_bytes", 0) or 0) / 2**30,
    )


HEADER = (
    "| arch | shape | mesh | compute ms | memory ms | collective ms "
    "| dominant | useful | roofline | peak GiB (tpu est) | fits |\n"
    "|---|---|---|---|---|---|---|---|---|---|---|"
)


def fmt_row(rec: dict, arch: ArchSpec = None) -> str:
    t = roofline_terms(rec, arch)
    return (
        f"| {rec['arch']} | {shape_name(rec)} | {rec['mesh']} "
        f"| {t['compute_s']*1e3:9.2f} | {t['memory_s']*1e3:9.2f} "
        f"| {t['collective_s']*1e3:9.2f} | {t['dominant']:10s} "
        f"| {t['useful_ratio']:6.3f} | {t['roofline_frac']:6.3f} "
        f"| {t['peak_gib']:6.2f} | {'y' if t['fits'] else 'NO'} |"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("records", help="records JSON (a list)")
    ap.add_argument("--md", default="", help="write markdown table here")
    ap.add_argument("--arch", default=DEFAULT_ARCH,
                    choices=sorted(ARCH_PRESETS),
                    help="peak-number preset the roofline divides by")
    ap.add_argument("--peak-flops", type=float, default=0.0,
                    help="override peak matmul FLOP/s per chip")
    ap.add_argument("--hbm-bw", type=float, default=0.0,
                    help="override HBM bytes/s per chip")
    ap.add_argument("--ici-bw", type=float, default=0.0,
                    help="override interconnect bytes/s per link")
    args = ap.parse_args(argv)
    arch = resolve_arch(
        args.arch, peak_flops=args.peak_flops, hbm_bw=args.hbm_bw,
        ici_bw=args.ici_bw,
    )
    recs = json.loads(Path(args.records).read_text())
    lines = [HEADER]
    for rec in recs:
        if rec.get("status") == "skipped":
            lines.append(
                f"| {rec['arch']} | {shape_name(rec)} | {rec.get('mesh','-')} "
                f"| skipped: {rec.get('reason','')[:58]} | | | | | | | |"
            )
            continue
        if rec.get("status") != "ok":
            lines.append(
                f"| {rec['arch']} | {shape_name(rec)} | {rec.get('mesh','-')} "
                f"| ERROR {rec.get('error','')[:60]} | | | | | | | |"
            )
            continue
        lines.append(fmt_row(rec, arch))
    out = "\n".join(lines)
    print(out)
    if args.md:
        Path(args.md).write_text(out + "\n")


if __name__ == "__main__":
    main()
