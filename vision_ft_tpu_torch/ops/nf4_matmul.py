"""Packed 4-bit (NF4 / FP4) matmul, forward and dx: wrappers and plain versions.

Counterpart of ``vision_ft_tpu/ops/pallas/nf4_matmul.py``. The kernels are
CUDA C++, ``csrc/nf4_matmul.cu`` (one TMA + wgmma template whose B tile a
warpgroup dequantizes into shared memory: a forward and a dx instance),
built for ``sm_90a`` by ``ops/_build.py`` and bound with ``ctypes``.

``y = x @ dequant(W)^T`` with W (n, k) stored as ``packed`` ((n*k/2, 1) or
(n, k/2) uint8 codes), ``absmax`` (one fp32 scale per ``blocksize``
consecutive elements of the flattened weight) and ``code`` (the 16-entry
codebook). Two byte layouts: bnb (byte t of a row = columns 2t, 2t+1, high
nibble first) and, with ``split=True``, the split device layout (byte j =
columns j and k/2+j), which the JAX package's device trees carry.

- :func:`nf4_matmul_reference` and :func:`nf4_matmul_dx_reference` are the
  plain PyTorch versions: ``dequantize_4bit`` to the input's dtype, an fp32
  product, the output rounded once.
- :func:`nf4_matmul_forward` and :func:`nf4_matmul_dx` are the kernels'
  wrappers over 2-D inputs. For CPU tensors they return the plain versions.
  For CUDA tensors they launch their kernel or raise (bf16 and a shape
  :func:`supports` accepts, or a ``ValueError``). Each counts its launches
  in its ``launches`` attribute. Where the output has too few 128 x 128
  tiles to fill the card, the kernel splits the contraction
  (:func:`contraction_splits`) into fp32 partials that a second launch of
  the same C call sums in split order.
- :func:`nf4_matmul` takes ``x`` of any leading shape and is differentiable
  in ``x`` only: the quantized base is frozen, so ``packed``, ``absmax`` and
  ``code`` get no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..modules.quant.nf4 import dequantize_4bit
from . import _build
from .flash_attention import saved_output


def to_split_layout(packed, shape: tuple[int, int]) -> torch.Tensor:
    """bnb byte layout -> split layout (one-time, at quantization or load).

    Input bytes: byte t of a row packs columns (2t, 2t+1) as (hi, lo).
    Output bytes: byte j packs columns (j, k/2+j) as (hi, lo), so each
    nibble plane covers a contiguous half of the K axis. absmax needs no
    change: scales stay indexed by ORIGINAL flat element position.

    bnb pads the flat element array to a block multiple before packing;
    those trailing pad bytes carry no real codes and are dropped here (the
    split device layout is always exactly n*k/2 bytes). Returns (n, k/2)
    uint8 on the input's device.
    """
    n, k = shape
    if k % 2:
        raise ValueError(f"split layout needs even in_features, got {k}")
    p = torch.as_tensor(packed).reshape(-1)[: n * k // 2].reshape(n, k // 2)
    codes = torch.stack([p >> 4, p & 0xF], dim=-1).reshape(n, k)
    return (codes[:, : k // 2] << 4) | codes[:, k // 2:]


def from_split_layout(packed_split, shape: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`to_split_layout` (split -> bnb bytes, unpadded:
    any bnb pad bytes were dropped by the forward transform)."""
    n, k = shape
    p = torch.as_tensor(packed_split).reshape(n, k // 2)
    codes = torch.cat([p >> 4, p & 0xF], dim=1)  # column order
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def supports(m: int, k: int, n: int, blocksize: int) -> bool:
    """Whether the kernels take this Linear: 128-wide output tiles both
    ways (n for the forward, k for dx), and k % 128 == 0 keeps every
    64-element absmax block and every 64-column step inside one nibble
    plane of the split layout. Wider than the JAX package's contract
    (k % 256 == 0 and n % 128 == 0), which it contains."""
    return k % 128 == 0 and n % 128 == 0 and blocksize == 64 and m >= 1


TILE = 128  # output rows and columns of a kernel work item
MIN_SPLIT_STAGES = 4  # contraction stages a part keeps at least


def contraction_stages(k: int, n: int, dx: bool) -> int:
    """Contraction steps of one output tile: 128 columns of k a step
    forward (64 packed bytes of each W row), 128 rows of W a step for dx."""
    return (n if dx else k) // 128


def contraction_splits(m: int, p: int, stages: int, sms: int) -> int:
    """Parts the kernels cut the contraction into for an (m, p) output of
    ``stages`` steps: enough that the (row tile, column tile, part) items
    fill ``sms`` SMs, each part at least MIN_SPLIT_STAGES steps deep; 1
    where the tiles alone fill the card."""
    tiles = -(-m // TILE) * (p // TILE)
    return max(1, min(sms // tiles, stages // MIN_SPLIT_STAGES))


def _weight(packed, code, absmax, shape, blocksize, dtype, split):
    dtype = dtype if dtype in (torch.bfloat16, torch.float16) else torch.float32
    return dequantize_4bit(packed, code, absmax, shape, blocksize, dtype, split)


def nf4_matmul_reference(x, packed, code, absmax, shape, blocksize: int = 64, split: bool = False):
    """x (..., k) @ dequant(W)^T by plain PyTorch: the weight rounded to
    x's dtype, an fp32 product, the output rounded once."""
    w = _weight(packed, code, absmax, shape, blocksize, x.dtype, split)
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def nf4_matmul_dx_reference(dy, packed, code, absmax, shape, blocksize: int = 64, split: bool = False):
    """dy (..., n) @ dequant(W) by plain PyTorch, the same way."""
    w = _weight(packed, code, absmax, shape, blocksize, dy.dtype, split)
    return torch.matmul(dy.float(), w.float()).to(dy.dtype)


@functools.cache
def _kernels():
    """The C entries: (forward, dx) and their split-contraction forms."""
    lib = _build.cuda_library("nf4_matmul")
    for fn in (lib.nf4_matmul_fwd, lib.nf4_matmul_dx):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.nf4_matmul_fwd_split, lib.nf4_matmul_dx_split):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return ((lib.nf4_matmul_fwd, lib.nf4_matmul_dx),
            (lib.nf4_matmul_fwd_split, lib.nf4_matmul_dx_split))


def _check(name, a, packed, code, absmax, shape, blocksize, width):
    """Raise on what the kernels do not take; ``a`` is the 2-D bf16 operand
    whose row length must be ``width``."""
    n, k = shape
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected (m, {width})")
    if not supports(a.shape[0], k, n, blocksize):
        raise ValueError(
            f"nf4_matmul kernels take k % 128 == 0, n % 128 == 0, blocksize 64 and m >= 1; "
            f"got m={a.shape[0]} k={k} n={n} blocksize={blocksize}"
        )
    if a.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bf16 on the card, got {a.dtype}")
    wants = (
        ("packed", packed, torch.uint8, n * k // 2), ("absmax", absmax, torch.float32, n * k // 64),
        ("code", code, torch.float32, 16),
    )
    for label, t, dtype, numel in ((name, a, torch.bfloat16, a.numel()), *wants):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{label} must be on {a.device}, got {t.device}")
        if t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
            raise ValueError(
                f"{label} must be contiguous {dtype} with {numel} elements, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{label} must be 16-byte aligned")


def _launch(which, index, a, packed, code, absmax, shape, split, out):
    """Launch the forward (index 0) or dx (1) kernel into ``out``, split
    over the contraction where :func:`contraction_splits` says."""
    n, k = shape
    m, dx = a.shape[0], index == 1
    splits = contraction_splits(m, out.shape[1], contraction_stages(k, n, dx), _build.sm_count(a.device))
    tensors = [a.data_ptr(), packed.data_ptr(), absmax.data_ptr(), code.data_ptr(), out.data_ptr()]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if splits == 1:
            err = _kernels()[0][index](*tensors, m, n, k, int(bool(split)), stream)
        else:
            partial = torch.empty(splits, *out.shape, device=a.device, dtype=torch.float32)
            err = _kernels()[1][index](*tensors, partial.data_ptr(), splits, m, n, k,
                                       int(bool(split)), stream)
    if err != 0:
        raise RuntimeError(f"nf4_matmul {which} launch failed: CUDA error {err}")


def nf4_matmul_forward(x2d, packed, code, absmax, shape, blocksize: int = 64, split: bool = False):
    """y (m, n) = x2d (m, k) @ dequant(W)^T: the forward kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if not x2d.is_cuda:
        return nf4_matmul_reference(x2d, packed, code, absmax, shape, blocksize, split)
    _check("x", x2d, packed, code, absmax, shape, blocksize, shape[1])
    out = torch.empty((x2d.shape[0], shape[0]), device=x2d.device, dtype=x2d.dtype)
    _launch("forward", 0, x2d, packed, code, absmax, shape, split, out)
    nf4_matmul_forward.launches += 1
    return out


def nf4_matmul_dx(dy2d, packed, code, absmax, shape, blocksize: int = 64, split: bool = False):
    """dx (m, k) = dy2d (m, n) @ dequant(W): the dx kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not dy2d.is_cuda:
        return nf4_matmul_dx_reference(dy2d, packed, code, absmax, shape, blocksize, split)
    _check("dy", dy2d, packed, code, absmax, shape, blocksize, shape[0])
    out = torch.empty((dy2d.shape[0], shape[1]), device=dy2d.device, dtype=dy2d.dtype)
    _launch("dx", 1, dy2d, packed, code, absmax, shape, split, out)
    nf4_matmul_dx.launches += 1
    return out


nf4_matmul_forward.launches = 0
nf4_matmul_dx.launches = 0


class _NF4Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, packed, code, absmax, shape, blocksize, split, saved):
        ctx.save_for_backward(packed, code, absmax)
        ctx.meta = (shape, blocksize, split, x2d.dtype)
        if saved is not None:  # a checkpointed region's recomputation
            return saved.detach()
        return nf4_matmul_forward(x2d, packed, code, absmax, shape, blocksize, split)

    @staticmethod
    def backward(ctx, dy):
        packed, code, absmax = ctx.saved_tensors
        shape, blocksize, split, dtype = ctx.meta
        dx = nf4_matmul_dx(
            dy.to(dtype).contiguous(), packed, code, absmax, shape, blocksize, split
        )
        # the quantized base is frozen: no gradient for packed, code, absmax
        return dx, None, None, None, None, None, None, None


def nf4_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    code: torch.Tensor,
    absmax: torch.Tensor,
    shape: tuple[int, int],
    blocksize: int = 64,
    split: bool = False,
) -> torch.Tensor:
    """x @ W^T with W stored packed 4-bit; returns (..., out_features).

    ``packed`` holds n*k/2 bytes, in bnb byte order or, with
    ``split=True``, in the split device layout (:func:`to_split_layout`).
    ``absmax`` is the flat fp32 per-block scales (already
    un-double-quantized), ``code`` the 16-entry codebook, ``shape`` the
    logical (out_features, in_features). Callers check :func:`supports`
    first; ``x`` may have any leading shape and is made contiguous where
    it is not."""
    n, k = shape
    x2d = x.reshape(-1, k).contiguous()
    packed, code, absmax = packed.reshape(n, k // 2), code.float(), absmax.float()
    if torch.is_grad_enabled() and x.requires_grad:
        y = saved_output(lambda saved: _NF4Matmul.apply(
            x2d, packed, code, absmax, (n, k), blocksize, bool(split), saved
        ))
    else:
        y = nf4_matmul_forward(x2d, packed, code, absmax, (n, k), blocksize, bool(split))
    return y.reshape(*x.shape[:-1], n)
