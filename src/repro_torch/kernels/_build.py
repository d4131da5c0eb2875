"""Build and load the hand-written CUDA kernels of ``repro_torch.kernels``.

Each library is one ``<kernel dir>/csrc/*.cu`` source, compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes``. The libraries go to ``build/repro_torch_kernels/``
at the repository root (``REPRO_TORCH_BUILD_DIR`` overrides it); a
library's file name carries a hash of its source, the headers it includes
and the flags, so a changed source rebuilds and an unchanged one is
reused. All sources build in parallel, one ``nvcc`` each, at the first
launch of any kernel. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["LIBS", "build_all", "load", "load_attrs", "build_dir",
           "raise_on_error"]

_KERNELS = Path(__file__).resolve().parent
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Lib:
    directory: str              # kernel directory under repro_torch/kernels
    source: str                 # csrc/<source>
    headers: Tuple[str, ...]    # headers it includes, from csrc/ (hashed)
    entry: str                  # its extern "C" launch function
    argtypes: tuple

    def path(self, name: str) -> Path:
        return _KERNELS / self.directory / "csrc" / name


# K4/K5's score tile and the MMA primitives it shares with K1-K3's tile
_ATTN_HEADERS = ("score_tile.cuh", "../../quant_matmul/csrc/mma_tile.cuh")

# library name -> what it is built from and how its entry point is called
LIBS: Dict[str, Lib] = {
    "eqm_grouped": Lib(
        "quant_matmul", "expert_quant_matmul_grouped.cu",
        ("mma_tile.cuh",), "eqm_grouped_launch",
        (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _P)),
    "eqm_expert": Lib(
        "quant_matmul", "expert_quant_matmul.cu", ("mma_tile.cuh",),
        "eqm_expert_launch",
        (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "qm_dense": Lib(
        "quant_matmul", "quant_matmul.cu", ("mma_tile.cuh",),
        "qm_dense_launch", (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "attn_flash_fwd": Lib(
        "attn_scores", "flash_fwd.cu", _ATTN_HEADERS, "flash_fwd_launch",
        (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P)),
    "attn_key_mass": Lib(
        "attn_scores", "key_mass.cu", _ATTN_HEADERS, "key_mass_launch",
        (_P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P)),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_entries: Dict[str, ctypes._CFuncPtr] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> repository root
    return _KERNELS.parents[2] / "build" / "repro_torch_kernels"


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
    lib = LIBS[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (lib.source,) + lib.headers:
        h.update(lib.path(f).read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Build every missing library, all ``nvcc`` runs started together.
    Returns {name: compiler output} for the libraries built by this call
    (with ``ptxas_verbose``, the per-kernel register/shared-memory
    report). Raises RuntimeError with the compiler's output on failure."""
    todo = {n: _lib_path(n) for n in LIBS if not _lib_path(n).exists()}
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
               "-o", str(tmp), str(LIBS[name].path(LIBS[name].source))]
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


def _cdll(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def load(name: str):
    """The launch function of library ``name``, its argument types set
    (building every library on first use)."""
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            fn = getattr(_cdll(name), LIBS[name].entry)
            fn.argtypes = LIBS[name].argtypes
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return fn


def load_attrs(name: str):
    """Library ``name``'s ``<name>_attrs(which, int out[5])`` entry:
    ``cudaFuncGetAttributes`` of one of its kernel instantiations (see
    ``repro_torch.analysis.resources``)."""
    with _lock:
        fn = getattr(_cdll(name), f"{name}_attrs")
        fn.argtypes = (_I, ctypes.POINTER(ctypes.c_int))
        fn.restype = ctypes.c_int
        return fn


def raise_on_error(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error (a refused launch
    never runs, and no later synchronisation would report it)."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
