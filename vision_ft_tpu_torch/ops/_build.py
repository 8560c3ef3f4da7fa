"""Build and load the port's kernels from ``vision_ft_tpu_torch/csrc``.

Every kernel is CUDA C++ (``csrc/<name>.cu``), built at first use and from
the package's own sources only: ``nvcc`` compiles the file into a shared
library with a plain C interface, for ``sm_90a``, and ``ctypes`` loads it.
The library lands in ``vision_ft_tpu_torch/_build/`` under a name that
carries a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source is rebuilt; it is written to a temporary name
and renamed, so two processes that build at once never load half a file.
``build_cuda_libraries`` compiles several sources at once. ``launch`` calls
a C entry on PyTorch's current stream.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_cuda_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[Path, Path]:
    """(source, library) of ``csrc/<name>.cu``; the library's name hashes
    the source, the shared headers (``csrc/*.cuh``) and the flags."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return source, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_nvcc(source: Path, target: Path) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp


def _finish_nvcc(proc: subprocess.Popen, tmp: Path, source: Path, target: Path) -> None:
    _, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{stderr}")
    os.replace(tmp, target)


def build_cuda_libraries(names: Sequence[str]) -> None:
    """Compile every ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together."""
    running = []
    for name in names:
        source, target = _target(name)
        if name not in _cuda_libs and not target.exists():
            running.append((*_start_nvcc(source, target), source, target))
    for job in running:
        _finish_nvcc(*job)


def cuda_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it."""
    if name in _cuda_libs:
        return _cuda_libs[name]
    source, target = _target(name)
    if not target.exists():
        _finish_nvcc(*_start_nvcc(source, target), source, target)
    lib = ctypes.CDLL(str(target))
    _cuda_libs[name] = lib
    return lib


def launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)``: a C entry on PyTorch's current stream of card
    ``index`` (a raw handle, no ``torch.cuda.Stream`` object), with that card
    made current only where it is not already; returns the entry's error
    code."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():  # torch.cuda.current_device(), 0.3 us less a call
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` (a ``torch.device``
    or its index): what the kernels' persistent grids and launch plans are
    sized by."""
    return torch.cuda.get_device_properties(device).multi_processor_count
