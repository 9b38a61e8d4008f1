"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/kernels/lib<name>-<hash>.so`` in the checkout (git-ignored),
where ``<hash>`` covers the source, the shared ``csrc/*.cuh`` headers and
the compiler flags, so an edited source is rebuilt and an unchanged one is loaded as it is. All missing
libraries are compiled together, one ``nvcc`` process each. ``ptxas``
prints each kernel's registers, shared memory and spills into
``build/kernels/<name>.ptxas.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("kron_scatter", "ttm", "kron_contrib", "scatter_rows", "kron_scatter_ttm",
           "flash_attention", "flash_attention_wgmma", "ssd_chunk", "flash_attention_bwd",
           "ssd_chunk_bwd", "flash_attention_bwd_wgmma", "kron_chain_scatter")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per-source link flags, after the source: the tensor-core attention (forward
# and backward) looks up libcuda's cuTensorMapEncodeTiled with dlopen/dlsym
# (no -lcuda)
EXTRA_FLAGS = {"flash_attention_wgmma": ("-ldl",), "flash_attention_bwd_wgmma": ("-ldl",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels of "
            f"repro_torch are built from source at first use"
        )
    return str(path)


def library_path(name: str) -> Path:
    # the shared headers count too: an edit to one rebuilds every library.
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode()
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers + flags
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every kernel library that is missing (all of them with
    ``force``), all ``nvcc`` processes at once. Returns the seconds each
    build took; an ``nvcc`` failure raises with its output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if force or not library_path(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
             *EXTRA_FLAGS.get(name, ())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    seconds, failed = {}, {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.log").write_text(log)
        if proc.returncode != 0:
            failed[name] = log
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic: no half-written .so
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(failed.values())
        )
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _LOCK:
        lib: Optional[ctypes.CDLL] = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
