"""Build and load the hand-written CUDA kernels of this package.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``build/repro_torch_kernels/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it); a library's file name carries a
hash of its sources and flags, so a changed source rebuilds and an
unchanged one is reused. All sources build in parallel, one ``nvcc`` each,
at the first launch of any kernel. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build_all", "load", "build_dir"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = ("dequant_tile.cuh",)
# library name -> source file
SOURCES: Dict[str, str] = {
    "eqm_grouped": "expert_quant_matmul_grouped.cu",
    "eqm_expert": "expert_quant_matmul.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/quant_matmul/_build.py -> repository root
    return Path(__file__).resolve().parents[4] / "build" / \
        "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "need the CUDA toolkit to build")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Build every missing library, all ``nvcc`` runs started together.
    Returns {name: compiler output} for the libraries built by this call
    (with ``ptxas_verbose``, the per-kernel register/shared-memory
    report). Raises RuntimeError with the compiler's output on failure."""
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                    else []),
               "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every library on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "eqm_grouped":
        fn = lib.eqm_grouped_launch
        fn.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    elif name == "eqm_expert":
        fn = lib.eqm_expert_launch
        fn.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    else:  # pragma: no cover - SOURCES and this table move together
        raise KeyError(name)
    fn.restype = i
