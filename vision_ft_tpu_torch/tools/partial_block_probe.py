"""Probe: does a tile whose last block overhangs the array read zeros and
write nothing past the end?

Counterpart of ``tools/bench/partial_block_probe.py``, with its four cases,
keys and block sizes, and a fifth case of the port's own. There the question was whether the TPU compiler
takes grid blocks that do not divide the array; on Hopper it is how a
kernel masks a ragged tile. Kernel L (``csrc/partial_block_probe.cu``)
copies (S, C) rows in blocks of 512 rows, each block a thread-block
cluster of 16 CTAs (``copy_plan``), loading rows past S as zeros (cp.async
with source size 0) and storing only rows below S; and computes
``x * 2 + 1`` over (8, S) in blocks of 512 columns (8.5 blocks at
S = 4352), a block's rows spread over a cluster (``lastaxis_plan``). Each case writes into a buffer longer than its output, filled
with a sentinel, and holds the output against its input, the tail against
the sentinel and the overhang's staged values against zero. A fifth case
asks the question for TMA, which kernel F's loads and stores rely on: a
2-D tensor map over (4360, 256) bf16 with (128, 64) boxes and 128-byte
swizzle (kernel F's mode) loads every box, the last one holding 8 valid
rows, and stores it back through a map of 4360 rows over a longer
sentinel-filled buffer; rows past S must arrive as zeros, nothing past S
may be written, the copy must be exact and every staged element must sit
where the swizzle formula of ``csrc/hopper_gemm.cuh`` puts it. Run:

    python -m vision_ft_tpu_torch.tools.partial_block_probe [--device cpu]

Prints one JSON line ``{"partial_blocks": true/false, "cases": [...]}``
and exits 0 only when every case passed. On the CPU the wrappers take
their plain versions; on the card they launch kernel L or raise. Any
failure of a case, a build or a launch included, makes ``partial_blocks``
false and carries its error, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build

SENTINEL = 1000.0  # the tail's fill: exact in fp32 and bf16, far from N(0, 1) draws
_MAX_ROW_BYTES = 32768  # the copy kernel's widest row (and stage)
TMA_BOX = (128, 64)  # rows, bf16 columns (128 bytes: one swizzle row) of the TMA case's boxes
_CLUSTER = 8  # CTAs of a cluster at most: the portable size ...
_WIDE_CLUSTER = 16  # ... or 16 for the copy where its ring is small (non-portable)
_STAGE_BYTES = 8192  # about the bytes of one stage of the copy kernel's ring of 4


class CopyPlan(NamedTuple):
    tiles: int       # clusters: one a tile of block_rows rows
    cluster: int     # CTAs of a cluster: 1, 2, 4, 8 or 16
    cta_rows: int    # rows of a CTA's slice of its tile (the last slices may be short or empty)
    chunk_rows: int  # rows of one cp.async stage


class LastAxisPlan(NamedTuple):
    tiles: int     # clusters: one a tile of block_cols columns
    cluster: int   # CTAs of a cluster: 1, 2, 4 or 8
    cta_rows: int  # rows of the tile a CTA stages (the last CTAs may have fewer or none)


def _cluster(n: int, most: int = _CLUSTER) -> int:
    """The largest power of two up to ``most`` and up to n: CTAs of a cluster."""
    return min(most, 1 << (max(1, n).bit_length() - 1))


@functools.lru_cache(maxsize=256)
def copy_plan(rows: int, row_bytes: int, block_rows: int) -> CopyPlan:
    """Kernel L's copy: one cluster a tile of ``block_rows`` rows, its CTAs
    owning consecutive slices of the tile's rows, each staged through a ring
    of 4 stages of about 8 KB (at least one row). 16 CTAs a cluster where
    the ring is at most 32 KB (rows of up to 8 KB: traced on the card at
    (4360, 256) bf16, 4.21 us a call against 5.03 with 8), else 8, the
    portable size. A function of the shape alone."""
    cluster = _cluster(block_rows, _WIDE_CLUSTER if row_bytes <= _STAGE_BYTES else _CLUSTER)
    cta_rows = -(-block_rows // cluster)
    return CopyPlan(-(-rows // block_rows), cluster, cta_rows,
                    max(1, min(cta_rows, _STAGE_BYTES // row_bytes)))


@functools.lru_cache(maxsize=256)
def lastaxis_plan(rows: int, cols: int, block_cols: int) -> LastAxisPlan:
    """Kernel L's last-axis case: one cluster a tile of ``block_cols``
    columns, its CTAs owning consecutive rows of the tile."""
    cluster = _cluster(rows)
    return LastAxisPlan(-(-cols // block_cols), cluster, -(-rows // cluster))


@functools.cache
def _kernels():
    lib = _build.cuda_library("partial_block_probe")
    lib.partial_block_copy.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    lib.partial_block_lastaxis.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.partial_block_tma.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    for fn in (lib.partial_block_copy, lib.partial_block_lastaxis, lib.partial_block_tma):
        fn.restype = ctypes.c_int
    return lib.partial_block_copy, lib.partial_block_lastaxis, lib.partial_block_tma


def _blocks(n: int, block: int) -> int:
    return -(-n // block)


def _check_out(x: torch.Tensor, out: torch.Tensor) -> None:
    if (out.dtype != x.dtype or out.get_device() != x.get_device() or not out.is_contiguous()
            or out.numel() < x.numel()):
        raise ValueError(f"out must be a contiguous {x.dtype} buffer on {x.device} of at least "
                         f"{x.numel()} elements")


def _nonzero_words(staged: torch.Tensor) -> int:
    """Nonzero 16-byte words among staged values (the copy kernel's count)."""
    raw = staged.contiguous().reshape(-1).view(torch.uint8)
    raw = torch.nn.functional.pad(raw, (0, -raw.numel() % 16)).reshape(-1, 16)
    return int(raw.ne(0).any(1).sum())


def partial_block_copy_reference(x, block_rows: int, out):
    """Plain version of :func:`partial_block_copy`: zero-padded tiles of
    ``block_rows`` rows, the rows below S written to ``out``."""
    s = x.shape[0]
    blocks = _blocks(s, block_rows)
    tiles = x.new_zeros((blocks * block_rows, *x.shape[1:]))
    tiles[:s] = x
    out.view(-1)[: x.numel()] = tiles[:s].reshape(-1)
    overhang = torch.zeros(blocks, dtype=torch.int32, device=x.device)
    overhang[-1] = _nonzero_words(tiles[s:])
    return overhang


def partial_block_copy(x: torch.Tensor, block_rows: int, out: torch.Tensor) -> torch.Tensor:
    """Copy x (S, C) into the first S rows of ``out`` (a contiguous buffer of
    at least x.numel() elements) in blocks of ``block_rows`` rows; return
    each block's count of nonzero 16-byte words staged past S (int32)."""
    if not x.is_cuda:
        return partial_block_copy_reference(x, block_rows, out)
    _check_out(x, out)
    row_bytes = x.shape[1] * x.element_size() if x.ndim == 2 else 0
    if (x.ndim != 2 or not x.is_contiguous() or row_bytes % 16 or not 0 < row_bytes <= _MAX_ROW_BYTES
            or x.shape[0] < 1 or block_rows < 1 or x.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError(f"partial_block_copy takes a contiguous 16-byte aligned (S, C) tensor "
                         f"with 16 to {_MAX_ROW_BYTES} bytes a row, got {tuple(x.shape)} {x.dtype}")
    plan = copy_plan(x.shape[0], row_bytes, block_rows)
    overhang = torch.empty(plan.tiles, dtype=torch.int32, device=x.device)
    err = _build.launch(_kernels()[0], x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0],
                        row_bytes, block_rows, *plan[1:], overhang.data_ptr())
    if err != 0:
        raise RuntimeError(f"partial_block_copy launch failed: CUDA error {err}")
    partial_block_copy.launches += 1
    return overhang


def partial_block_lastaxis_reference(x, block_cols: int, out):
    """Plain version of :func:`partial_block_lastaxis`."""
    rows, cols = x.shape
    blocks = _blocks(cols, block_cols)
    tiles = x.new_zeros((rows, blocks * block_cols))
    tiles[:, :cols] = x
    out.view(-1)[: x.numel()] = (tiles[:, :cols] * 2.0 + 1.0).reshape(-1)
    overhang = torch.zeros(blocks, dtype=torch.int32, device=x.device)
    overhang[-1] = int(tiles[:, cols:].ne(0).sum())
    return overhang


def partial_block_lastaxis(x: torch.Tensor, block_cols: int, out: torch.Tensor) -> torch.Tensor:
    """``x * 2 + 1`` of fp32 x (R, S) into the first R * S elements of
    ``out``, in blocks of ``block_cols`` columns; return each block's count
    of nonzero values staged past S (int32)."""
    if not x.is_cuda:
        return partial_block_lastaxis_reference(x, block_cols, out)
    _check_out(x, out)
    if (x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0
            or block_cols < 1 or x.shape[0] * block_cols * 4 > 48 * 1024):
        raise ValueError(f"partial_block_lastaxis takes a contiguous fp32 (R, S) tensor with "
                         f"R * block_cols * 4 <= 48 KB, got {tuple(x.shape)} {x.dtype}")
    plan = lastaxis_plan(*x.shape, block_cols)
    overhang = torch.empty(plan.tiles, dtype=torch.int32, device=x.device)
    err = _build.launch(_kernels()[1], x.get_device(), x.data_ptr(), out.data_ptr(), *x.shape,
                        block_cols, *plan[1:], overhang.data_ptr())
    if err != 0:
        raise RuntimeError(f"partial_block_lastaxis launch failed: CUDA error {err}")
    partial_block_lastaxis.launches += 1
    return overhang


def partial_block_tma_reference(x, out):
    """Plain version of :func:`partial_block_tma`: zero-padded (128, 64)
    boxes, the rows below S written to ``out``."""
    s, c = x.shape
    rows, cols = TMA_BOX
    row_blocks = _blocks(s, rows)
    tiles = x.new_zeros((row_blocks * rows, c))
    tiles[:s] = x
    out.view(-1)[: x.numel()] = tiles[:s].reshape(-1)
    counts = torch.zeros(row_blocks, c // cols, 2, dtype=torch.int32, device=x.device)
    for j in range(c // cols):
        counts[-1, j, 0] = _nonzero_words(tiles[s:, j * cols:(j + 1) * cols])
    return counts.reshape(-1, 2)


def partial_block_tma(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Copy bf16 x (S, C), C % 64 == 0, into the first S rows of ``out``
    through shared memory, in (128, 64) boxes of 2-D tensor maps with
    128-byte swizzle (TMA load, TMA store through a map of S rows). Returns
    (boxes, 2) int32: per box, the nonzero 16-byte words staged past S and
    the valid pairs of elements found off the place the swizzle formula
    gives. The C entry keeps the tensor maps it encodes in a cache keyed by
    all they encode."""
    if not x.is_cuda:
        return partial_block_tma_reference(x, out)
    _check_out(x, out)
    if (x.ndim != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.shape[0] < 1
            or x.shape[1] < TMA_BOX[1] or x.shape[1] % TMA_BOX[1] or x.data_ptr() % 16
            or out.data_ptr() % 16):
        raise ValueError(f"partial_block_tma takes a contiguous 16-byte aligned bf16 (S, C) tensor "
                         f"with C % {TMA_BOX[1]} == 0, got {tuple(x.shape)} {x.dtype}")
    boxes = _blocks(x.shape[0], TMA_BOX[0]) * (x.shape[1] // TMA_BOX[1])
    counts = torch.empty(boxes, 2, dtype=torch.int32, device=x.device)
    err = _build.launch(_kernels()[2], x.get_device(), x.data_ptr(), out.data_ptr(), *x.shape,
                        counts.data_ptr())
    if err != 0:
        raise RuntimeError(f"partial_block_tma launch failed: CUDA error {err}")
    partial_block_tma.launches += 1
    return counts


partial_block_copy.launches = 0
partial_block_lastaxis.launches = 0
partial_block_tma.launches = 0


def _error(exc: Exception) -> str:
    return f"{type(exc).__name__}: {exc}"[:160]


def _case(x_np, block_rows, dtype_name, device):
    s, c = x_np.shape
    try:
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x = torch.from_numpy(x_np).to(dtype).to(device)
        out = torch.full((s + block_rows, c), SENTINEL, dtype=dtype, device=device)
        overhang = partial_block_copy(x, block_rows, out)
        ok = bool(torch.equal(out[:s], x)
                  and torch.equal(out[s:], torch.full_like(out[s:], SENTINEL))
                  and int(overhang.sum()) == 0)
        err = None
    except Exception as exc:  # a build, a launch or a check refused
        ok, err = False, _error(exc)
    return {"dtype": dtype_name, "shape": [s, c], "block_rows": block_rows,
            "ok": ok, "error": err}


def _case_lastaxis(s, block_cols, device):
    """The ragged block on the last axis: the (b*h, 8, sq) lse layout of
    the flash kernels when sq % block_q != 0."""
    x_np = np.random.default_rng(1).standard_normal((8, s))
    try:
        x = torch.from_numpy(x_np).float().to(device)
        out = torch.full((8 * s + block_cols,), SENTINEL, device=device)
        overhang = partial_block_lastaxis(x, block_cols, out)
        ok = bool(torch.allclose(out[: 8 * s].view(8, s), x * 2.0 + 1.0, atol=1e-6, rtol=0)
                  and torch.equal(out[8 * s:], torch.full_like(out[8 * s:], SENTINEL))
                  and int(overhang.sum()) == 0)
        err = None
    except Exception as exc:
        ok, err = False, _error(exc)
    return {"dtype": "f32-lastaxis", "shape": [8, s], "block_cols": block_cols,
            "ok": ok, "error": err}


def _case_tma(x_np, device):
    """The TMA case: (128, 64) boxes of a 128-byte swizzled 2-D tensor map,
    the last row of boxes holding S % 128 valid rows."""
    s, c = x_np.shape
    try:
        x = torch.from_numpy(x_np).to(torch.bfloat16).to(device)
        out = torch.full((s + TMA_BOX[0], c), SENTINEL, dtype=torch.bfloat16, device=device)
        counts = partial_block_tma(x, out)
        ok = bool(torch.equal(out[:s], x)
                  and torch.equal(out[s:], torch.full_like(out[s:], SENTINEL))
                  and int(counts.sum()) == 0)
        err = None
    except Exception as exc:
        ok, err = False, _error(exc)
    return {"dtype": "bf16-tma", "shape": [s, c], "box": list(TMA_BOX), "swizzle": "128B",
            "ok": ok, "error": err}


def run(device="cuda") -> dict:
    """The JAX tool's four cases and the TMA case on ``device``:
    {"partial_blocks": bool, "cases": [...]}."""
    rng = np.random.default_rng(0)
    cases = [
        # f32, remainder 264 rows (8-aligned): the Lumina2-style q axis
        _case(rng.standard_normal((4360, 256)), 512, "f32", device),
        # bf16, remainder 264 (8-aligned, not 16-aligned): AuraFlow's S = 4360
        _case(rng.standard_normal((4360, 256)), 512, "bf16", device),
        # bf16, an odd remainder
        _case(rng.standard_normal((1219, 256)), 512, "bf16-odd", device),
        _case_lastaxis(4352, 512, device),
        # TMA, 4360 = 34 * 128 + 8: the last boxes hold 8 valid rows
        _case_tma(np.random.default_rng(2).standard_normal((4360, 256)), device),
    ]
    return {"partial_blocks": all(c["ok"] for c in cases), "cases": cases}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (kernel L, the default) or cpu (the plain versions)")
    result = run(parser.parse_args(argv).device)
    print(json.dumps(result))
    return 0 if result["partial_blocks"] else 1


if __name__ == "__main__":
    sys.exit(main())
