"""The roofline in repro_torch (``launch/roofline.py``) on the CPU, against the
reference's ``repro.launch.roofline`` on the same hand-written records.

Every record here has the schema the reference's ``launch/dryrun.py``
writes (``arch``, ``shape``, ``mesh``, ``status``, ``hlo.total_coll_bytes``,
``hlo.dot_flops``, ``memory.peak_tpu_est_bytes``). ``roofline_terms`` and
``fmt_row`` must give the reference's numbers and rows under every preset
the reference has and with overrides, and the CLI the same table. The
port's own additions are checked beside: the ``h100-sxm`` preset (against
the reference's ``ArchSpec`` holding the same numbers), a record's
``"chips"`` and a ``ShapeConfig`` dict as its shape.
"""
import json
import sys

import pytest

from repro.launch import roofline as jroof
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import roofline as roof
from repro_torch.models.flops import cell_cost

ARCHS = ("qwen2-7b", "granite-moe-1b-a400m", "zamba2-2.7b", "mamba2-1.3b", "grok-1-314b")


def _records():
    recs = []
    for i, arch in enumerate(ARCHS):
        for j, shape in enumerate(("train_4k", "prefill_32k", "decode_32k")):
            recs.append({"arch": arch, "shape": shape, "mesh": "2x16x16" if j % 2 else "16x16",
                         "status": "ok",
                         "hlo": {"total_coll_bytes": 1.5e8 * (i + 1) * (j + 1),
                                 "dot_flops": 3.1e12 * (i + j + 1)},
                         "memory": {"peak_tpu_est_bytes": (4 + 7 * i + 3 * j) * 2**30}})
    recs.append({"arch": "zamba2-2.7b", "shape": "long_500k", "mesh": "16x16", "status": "ok",
                 "hlo": {"total_coll_bytes": 0, "dot_flops": 0.0}, "memory": {}})
    return recs


EXTRA = [{"arch": "qwen2-7b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
          "reason": "long_500k needs sub-quadratic attention"},
         {"arch": "yi-6b", "shape": "train_4k", "status": "error", "error": "compile failed"}]


def _arch_pairs():
    pairs = [(name, roof.resolve_arch(name), jroof.resolve_arch(name))
             for name in sorted(jroof.ARCH_PRESETS)]
    kw = dict(peak_flops=123e12, hbm_bw=456e9, ici_bw=7e9)
    pairs.append(("v5e+overrides", roof.resolve_arch("tpu-v5e", **kw),
                  jroof.resolve_arch("tpu-v5e", **kw)))
    h = roof.ARCH_PRESETS["h100-sxm"]
    pairs.append(("h100-sxm", h, jroof.ArchSpec(h.peak_flops, h.hbm_bw, h.ici_bw, h.dcn_bw,
                                                 h.hbm_per_chip)))
    return pairs


def test_presets_copy_the_references_and_add_the_h100():
    for name, spec in jroof.ARCH_PRESETS.items():
        assert dataclass_tuple(roof.ARCH_PRESETS[name]) == dataclass_tuple(spec)
    assert roof.DEFAULT_ARCH == jroof.DEFAULT_ARCH
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.ICI_BW, roof.DCN_BW, roof.HBM_PER_CHIP) == (
        jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW, jroof.DCN_BW, jroof.HBM_PER_CHIP)
    h = roof.resolve_arch("h100-sxm")
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.dcn_bw, h.hbm_per_chip) == (
        989e12, 3.35e12, 450e9, 50e9, 80 * 10**9)
    assert roof.resolve_arch("h100-sxm", hbm_bw=2e12).hbm_bw == 2e12
    with pytest.raises(ValueError, match="unknown arch"):
        roof.resolve_arch("tpu-v9")


def dataclass_tuple(spec):
    return (spec.peak_flops, spec.hbm_bw, spec.ici_bw, spec.dcn_bw, spec.hbm_per_chip)


@pytest.mark.parametrize("name,arch,jarch", _arch_pairs(), ids=[p[0] for p in _arch_pairs()])
def test_terms_and_rows_are_the_references(name, arch, jarch):
    for rec in _records():
        got, want = roof.roofline_terms(rec, arch), jroof.roofline_terms(rec, jarch)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-12, abs=0), (rec["shape"], k)
            else:
                assert got[k] == v, (rec["arch"], rec["shape"], k)
        assert roof.fmt_row(rec, arch) == jroof.fmt_row(rec, jarch)
    # no arch: both default to the same preset
    rec = _records()[0]
    assert roof.fmt_row(rec) == jroof.fmt_row(rec)


@pytest.mark.parametrize("arch", ["tpu-v5e", "tpu-v6e"])
def test_the_cli_prints_the_references_table(arch, tmp_path, monkeypatch, capsys):
    path = tmp_path / "records.json"
    path.write_text(json.dumps(_records() + EXTRA))
    argv = [str(path), "--arch", arch, "--peak-flops", "3e14", "--md", str(tmp_path / "j.md")]
    monkeypatch.setattr(sys, "argv", ["roofline"] + argv)
    jroof.main()
    want = capsys.readouterr().out
    roof.main(argv[:-1] + [str(tmp_path / "p.md")])
    got = capsys.readouterr().out
    assert got == want and got.startswith(roof.HEADER)
    assert (tmp_path / "p.md").read_text() == (tmp_path / "j.md").read_text()
    assert "skipped: long_500k" in got and "ERROR compile failed" in got


def test_a_measured_record_with_chips_and_a_dict_shape():
    """A cut cell the card ran: one chip, a (2 x 4,096) train step."""
    shape = {"name": "train_2x4k", "seq_len": 4096, "global_batch": 2, "kind": "train"}
    rec = {"arch": "zamba2-2.7b", "shape": shape, "mesh": "1", "chips": 1, "status": "ok",
           "hlo": {"total_coll_bytes": 0, "dot_flops": 2.0e14},
           "memory": {"peak_tpu_est_bytes": 58.7e9}}
    h = roof.resolve_arch("h100-sxm")
    cost = cell_cost(get_config("zamba2-2.7b"), ShapeConfig(**shape))
    t = roof.roofline_terms(rec, h)
    assert roof.chips(rec) == 1
    assert t["compute_s"] == cost.flops / h.peak_flops
    assert t["memory_s"] == cost.hbm_bytes / h.hbm_bw
    assert t["collective_s"] == 0.0 and t["dominant"] == "compute"
    assert t["fits"] and t["hlo_dot_flops"] == 2.0e14
    assert t["roofline_frac"] == pytest.approx(cost.model_flops / cost.flops)
    row = roof.fmt_row(rec, h)
    assert row.startswith("| zamba2-2.7b | train_2x4k | 1 |") and row.endswith("| y |")
    # without "chips" the reference's mesh rule holds
    assert roof.chips({"mesh": "2x16x16"}) == 512 and roof.chips({"mesh": "16x16"}) == 256
    too_big = dict(rec, memory={"peak_tpu_est_bytes": 81e9})
    assert not roof.roofline_terms(too_big, h)["fits"]
    assert roof.fmt_row(too_big, h).endswith("| NO |")
