"""repro_torch and chip_smoke.py stay free of JAX and of the repro package
(and of ``ml_dtypes``, which the card machine does not have)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b"
                       r"|import\s+repro\.|from\s+repro\.)", re.M)


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.tucker, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.kernels.kron_kernel, repro_torch.kernels.ttm_kernel\n"
        "import repro_torch.core.engine, repro_torch.core.hooi\n"
        "import repro_torch.sparse.generators, repro_torch.core.reconstruct\n"
        "import repro_torch.sparse, repro_torch.sparse.datasets\n"
        "import repro_torch.models.model, repro_torch.serve.engine, repro_torch.configs\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.obs, repro_torch.obs.__main__, repro_torch.serve\n"
        "import repro_torch.serve.tucker_service, repro_torch.kernels.launch_count\n"
        "import repro_torch.runtime.fault_tolerance, repro_torch.checkpoint.manager\n"
        "import repro_torch.tucker.snapshot, repro_torch.kernels.autotune\n"
        "import repro_torch.core, repro_torch.core.distributed\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.analysis.sweep_lints, repro_torch.analysis.schedule_lints\n"
        "import repro_torch.models.tucker_layers, repro_torch.models.transformer\n"
        "import repro_torch.models.moe, repro_torch.models.flops\n"
        "import repro_torch.optim.adamw, repro_torch.data.pipeline\n"
        "import repro_torch.train.step, repro_torch.train.trainer, repro_torch.train.__main__\n"
        "import repro_torch.optim.compression, repro_torch.launch\n"
        "import repro_torch.launch.compress_bench, repro_torch.launch.roofline\n"
        "import repro_torch.launch.mesh, repro_torch.models.sharding\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []
