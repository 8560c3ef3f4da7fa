"""Build and load the port's kernels from ``vision_ft_tpu_torch/csrc``.

Two routes, both at first use and from the package's own sources only:

- CUDA C++ (``csrc/<name>.cu``): ``nvcc`` compiles the file into a shared
  library with a plain C interface, for ``sm_90a``, and ``ctypes`` loads
  it. The library lands in ``vision_ft_tpu_torch/_build/`` under a name
  that carries a hash of the source and flags, so an edited source is
  rebuilt; it is written to a temporary name and renamed, so two
  processes that build at once never load half a file.
- Triton (``csrc/<name>.py``): the module is loaded from its file. It
  sits outside the package's import graph because it imports ``triton``
  at the top, and importing the package must work where Triton is
  absent; Triton compiles its kernels at their first launch, into
  ``_build/triton/`` unless ``TRITON_CACHE_DIR`` names another place.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import ModuleType

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_cuda_libs: dict[str, ctypes.CDLL] = {}
_triton_modules: dict[str, ModuleType] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cuda_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it."""
    if name in _cuda_libs:
        return _cuda_libs[name]
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _cuda_libs[name] = lib
    return lib


def triton_module(name: str) -> ModuleType:
    """Load ``csrc/<name>.py`` (a module of ``@triton.jit`` kernels)."""
    if name in _triton_modules:
        return _triton_modules[name]
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    path = CSRC / f"{name}.py"
    mod_name = f"vision_ft_tpu_torch._kernels.{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    _triton_modules[name] = module
    return module
