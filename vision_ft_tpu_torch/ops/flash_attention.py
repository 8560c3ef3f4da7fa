"""Flash attention: wrappers, plain versions and the (B, H, S, D) routing.

Counterpart of ``vision_ft_tpu/ops/pallas/flash_attention.py`` (the
kernels' entries) and ``vision_ft_tpu/ops/flash_attention.py`` (the
routing). The kernels are CUDA C++, built for ``sm_90a`` by
``ops/_build.py`` and bound with ``ctypes``:

- ``csrc/flash_attention_bshd.cu`` (forward) and
  ``csrc/flash_attention_bshd_bwd.cu`` (backward: a dk/dv kernel and a dq
  kernel) over heads-packed tensors, no mask, head dims 64, 128 and 256:
  the JAX ``flash_attention_bshd`` and its custom VJP;
- ``csrc/flash_attention_masked.cu`` (forward) and
  ``csrc/flash_attention_masked_bwd.cu`` (backward: a dk/dv kernel that
  sums over the query heads of each kv head, and a dq kernel) over
  (B, H, S, D) with an optional (B, Sk) key mask, causal masking and
  grouped-query heads, head dims 64, 96 and 128: the JAX
  ``flash_attention_tpu`` and its custom VJP.

BSHD layout: q (B, Sq, H*D), k and v (B, Sk, H*D), heads packed along the
last axis (head h is columns [h*D, (h+1)*D)); the output has q's shape
and dtype; lse is the fp32 natural log-sum-exp of the scaled scores,
(B, H, Sq).

- :func:`flash_attention_bshd_reference` and
  :func:`flash_attention_bshd_backward_reference` are the plain PyTorch
  versions: the heads are split by views and the kernels' arithmetic is
  repeated step by step, with the same casts.
- :func:`flash_attention_bshd` is the forward kernel's wrapper,
  :func:`flash_attention_bshd_dkv` and :func:`flash_attention_bshd_dq` are
  the two backward kernels' wrappers. For CPU tensors they return the
  plain versions. For CUDA tensors they launch their kernel or raise.
  Each counts its launches in its ``launches`` attribute.
- :func:`flash_attention_bshd_backward` is the whole backward: delta =
  rowsum(dO * O) per head in plain PyTorch (as the JAX package computes it
  outside its kernels), then the two kernels.
- When gradients are wanted, :func:`flash_attention_bshd` goes through a
  ``torch.autograd.Function`` that keeps (q, k, v, out, lse) and whose
  backward is :func:`flash_attention_bshd_backward`.
- :func:`kernel_saves` is what gradient checkpointing (``nn.core.
  remat_layer``) uses to keep (out, lse) of every call in a region, so
  that the recomputation before the backward does not launch the forward
  kernel again.
- :func:`flash_attention_masked` is the key-masked (B, H, S, D) forward
  kernel's wrapper and :func:`flash_attention_reference` its plain version;
  :func:`flash_attention_masked_dkv` and :func:`flash_attention_masked_dq`
  wrap its backward kernels, :func:`flash_attention_masked_backward` is the
  whole backward (plain delta, then the two kernels) and
  :func:`flash_attention_masked_backward_reference` its plain version. With
  gradients wanted, :func:`flash_attention_masked` goes through an autograd
  function that keeps (q, k, v, mask, out, lse), and :func:`kernel_saves`
  covers its calls too.
- :func:`flash_attention_shortk` is the short-K forward kernel's wrapper
  (keys <= ``SHORTK_MAX``, the whole key context on chip; SDXL's
  cross-attention) and :func:`flash_attention_shortk_reference` its plain
  version; :func:`flash_attention_shortk_bwd` wraps its backward kernel,
  :func:`flash_attention_shortk_backward` is the whole backward (plain
  delta, then the kernel) and :func:`flash_attention_shortk_backward_reference`
  its plain version (``csrc/flash_attention_shortk.cu``: the JAX
  ``flash_attention_shortk`` and its custom VJP). With gradients wanted,
  :func:`flash_attention_shortk` goes through an autograd function that
  keeps (q, k, v, out, lse), and :func:`kernel_saves` covers its calls too.
- :func:`flash_attention` is the routing between these kernels and the
  plain formula of ``ops/attention.py``; :func:`set_flash_shortk` opens the
  short-K route, as ``VFT_FLASH_SHORTK=1`` does in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional

import torch

from . import _build

# head dims each kernel is built for
BSHD_FWD_HEAD_DIMS = (64, 128, 256)  # forward over heads-packed tensors
BSHD_BWD_HEAD_DIMS = (64, 128, 256)  # backward over heads-packed tensors
MASKED_HEAD_DIMS = (64, 96, 128)  # key-masked forward over (B, H, S, D)
SHORTK_HEAD_DIMS = (64, 128)      # short-K forward and backward over (B, H, S, D)
SHORTK_MAX = 192  # the most keys the short-K kernels hold on chip, as in the JAX package
NEG_INF = -1e30  # the finite score of a masked key, as in the JAX package's kernel


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D), a view."""
    b, s, inner = t.shape
    return t.reshape(b, s, num_heads, inner // num_heads).transpose(1, 2)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def flash_attention_bshd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: Optional[float] = None, return_lse: bool = False,
):
    from .attention import plain_attention

    d = q.shape[-1] // num_heads
    scale = d**-0.5 if scale is None else scale
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    out = _packed(plain_attention(qh, kh, vh, None, scale, False))
    if not return_lse:
        return out
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    return out, torch.logsumexp(scores, dim=-1)


def flash_attention_bshd_delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int):
    """delta = rowsum(dO * O) over each head's columns, fp32 (B, H, Sq)."""
    b, sq, inner = out.shape
    prod = dout.float() * out.float()
    return prod.view(b, sq, num_heads, inner // num_heads).sum(dim=-1).permute(0, 2, 1).contiguous()


def _backward_reference(q, k, v, lse, delta, dout, num_heads, scale):
    d = q.shape[-1] // num_heads
    scale = d**-0.5 if scale is None else scale
    dtype = q.dtype
    qh, kh, vh, doh = (_heads(t, num_heads).float() for t in (q, k, v, dout))
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (p * (dp - delta.unsqueeze(-1)) * scale).to(dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dq = torch.matmul(ds, kh)
    return _packed(dq).to(q.dtype), _packed(dk).to(k.dtype), _packed(dv).to(v.dtype)


def flash_attention_bshd_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: Optional[float] = None,
):
    """(dq, dk, dv) by the backward kernels' arithmetic: P recomputed as
    exp(S - lse) in fp32, P and dS rounded to the inputs' dtype before their
    products, fp32 accumulation, outputs in the inputs' dtypes."""
    delta = flash_attention_bshd_delta(out, dout, num_heads)
    return _backward_reference(q, k, v, lse, delta, dout, num_heads, scale)


@functools.cache
def _forward_kernel():
    fn = _build.cuda_library("flash_attention_bshd").flash_attention_bshd_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_kernels():
    lib = _build.cuda_library("flash_attention_bshd_bwd")
    dkv, dq = lib.flash_attention_bshd_bwd_dkv, lib.flash_attention_bshd_bwd_dq
    dkv.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    dq.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def supports(num_heads: int, head_dim: int) -> bool:
    """Whether the BSHD forward kernel takes this head layout."""
    return num_heads > 0 and head_dim in BSHD_FWD_HEAD_DIMS


def supports_backward(num_heads: int, head_dim: int) -> bool:
    """Whether the BSHD backward kernels take this head layout."""
    return num_heads > 0 and head_dim in BSHD_BWD_HEAD_DIMS


@functools.cache
def forward_config(head_dim: int) -> dict:
    """The forward kernel's launch shape at ``head_dim``, as its library
    reports it: keys a tile, ring stages, passes over the output's columns
    and dynamic shared-memory bytes."""
    fn = _build.cuda_library("flash_attention_bshd").flash_attention_bshd_fwd_config
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(head_dim, out)
    if err != 0:
        raise ValueError(f"flash_attention_bshd kernel has no head dim {head_dim}: CUDA error {err}")
    return dict(zip(("keys", "stages", "passes", "smem_bytes"), out))


def _check(q, k, v, num_heads, backward=False, **more) -> int:
    """Raise on what the kernels do not take (the backward kernels' head
    dims where ``backward``); ``more`` are further bf16 tensors of q's
    shape (out, dout). Returns the head dim."""
    b, sq, inner = q.shape
    dims = BSHD_BWD_HEAD_DIMS if backward else BSHD_FWD_HEAD_DIMS
    if inner % num_heads or not (supports_backward if backward else supports)(
            num_heads, inner // num_heads):
        raise ValueError(
            f"flash_attention_bshd {'backward kernels take' if backward else 'kernel takes'} "
            f"head dims {dims}, got {inner} columns over {num_heads} heads"
        )
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_cuda or t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if t.ndim != 3 or t.shape[0] != b or t.shape[2] != inner:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (B, S, {inner})")
        # 16-byte vector loads and TMA tensor maps: unit last stride, 8-element
        # row and batch strides, a 16-byte aligned base
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last axis and 16-byte aligned rows")
    if k.shape[1] != v.shape[1] or min(sq, k.shape[1]) < 1:
        raise ValueError(f"need sq >= 1 and one k/v length >= 1, got {sq}, {k.shape[1]}, {v.shape[1]}")
    if any(t.shape[1] != sq for t in more.values()):
        raise ValueError(f"{sorted(more)} must have q's length {sq}")
    if max(q.shape[1], k.shape[1]) >= 2**31 or b >= 2**16 or num_heads >= 2**16:
        raise ValueError("shape beyond the kernel's grid or int32 row index")
    return inner // num_heads


def _forward(q, k, v, num_heads, scale, return_lse):
    """(out, lse or None): the kernel for CUDA tensors, else the plain version."""
    if not q.is_cuda:
        if return_lse:
            return flash_attention_bshd_reference(q, k, v, num_heads, scale, return_lse=True)
        return flash_attention_bshd_reference(q, k, v, num_heads, scale), None
    d = _check(q, k, v, num_heads)
    scale = d**-0.5 if scale is None else scale
    # the kernel's running max is taken on the raw scores q k^T: the max of
    # the scaled scores only where scale > 0
    if not scale > 0:
        raise ValueError(f"flash_attention_bshd kernel takes a scale > 0, got {scale}")
    b, sq, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (
        torch.empty((b, num_heads, sq), device=q.device, dtype=torch.float32)
        if return_lse else None
    )
    kernel = _forward_kernel()
    with torch.cuda.device(q.device):
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, sq, k.shape[1], num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bshd launch failed: CUDA error {err}")
    flash_attention_bshd.launches += 1
    return out, lse


def _check_row_stats(want: tuple, device: torch.device, **stats) -> None:
    """Raise unless each of ``stats`` (lse, delta) is contiguous fp32 of
    shape (B, H, Sq) = ``want`` on ``device``."""
    for name, t in stats.items():
        if tuple(t.shape) != want or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 {want}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")


def _check_backward(q, k, v, dout, lse, delta, num_heads) -> int:
    d = _check(q, k, v, num_heads, backward=True, dout=dout)
    _check_row_stats((q.shape[0], num_heads, q.shape[1]), q.device, lse=lse, delta=delta)
    return d


def _launch(which, kernel, outputs, q, k, v, dout, lse, delta, num_heads, d, scale):
    b, sq, _ = q.shape
    with torch.cuda.device(q.device):
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outputs),
            b, sq, k.shape[1], num_heads, d,
            *(stride for t in (q, k, v, dout, *outputs) for stride in (t.stride(0), t.stride(1))),
            float(d**-0.5 if scale is None else scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bshd {which} launch failed: CUDA error {err}")


def flash_attention_bshd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, num_heads: int, scale: Optional[float] = None,
):
    """(dk, dv) of the attention from q, k, v, the output's gradient
    (contiguous), lse and delta."""
    if not q.is_cuda:
        return _backward_reference(q, k, v, lse, delta, dout, num_heads, scale)[1:]
    d = _check_backward(q, k, v, dout, lse, delta, num_heads)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("dk/dv", _backward_kernels()[0], (dk, dv), q, k, v, dout, lse, delta, num_heads, d, scale)
    flash_attention_bshd_dkv.launches += 1
    return dk, dv


def flash_attention_bshd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, num_heads: int, scale: Optional[float] = None,
):
    """dq of the attention from the same inputs as :func:`flash_attention_bshd_dkv`."""
    if not q.is_cuda:
        return _backward_reference(q, k, v, lse, delta, dout, num_heads, scale)[0]
    d = _check_backward(q, k, v, dout, lse, delta, num_heads)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("dq", _backward_kernels()[1], (dq,), q, k, v, dout, lse, delta, num_heads, d, scale)
    flash_attention_bshd_dq.launches += 1
    return dq


flash_attention_bshd_dkv.launches = 0
flash_attention_bshd_dq.launches = 0


def flash_attention_bshd_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: Optional[float] = None,
):
    """(dq, dk, dv) of :func:`flash_attention_bshd` from its inputs, its
    output, its lse and the output's gradient (any layout: it is made
    contiguous here). On the card it launches the two backward kernels or
    raises: it has no plain fallback."""
    dout = dout.contiguous()
    if q.is_cuda:
        _check(q, k, v, num_heads, backward=True, out=out, dout=dout)
    delta = flash_attention_bshd_delta(out, dout, num_heads)
    dk, dv = flash_attention_bshd_dkv(q, k, v, dout, lse, delta, num_heads, scale)
    dq = flash_attention_bshd_dq(q, k, v, dout, lse, delta, num_heads, scale)
    return dq, dk, dv


class _KernelSaves:
    """What gradient checkpointing keeps of the forward kernels in one
    region: a context manager that is the current one while the region
    runs, in mode "record" (the first forward appends each call's
    (out, lse), and with ``outputs`` each fused or 4-bit kernel call's
    output and the marked layers' products, ``nn.core.saved_products``)
    or "replay" (the recomputation reads them back in order). It can be
    entered again: a graph walked twice is recomputed twice."""

    current: Optional["_KernelSaves"] = None

    def __init__(self, mode: str, saves: list, outputs: bool = False, products=None):
        self.mode, self.saves, self.outputs, self.position = mode, saves, outputs, 0
        self.products, self.product_position = products, 0

    def __enter__(self):
        self.previous, self.position, self.product_position = _KernelSaves.current, 0, 0
        _KernelSaves.current = self
        return self

    def __exit__(self, *exc):
        _KernelSaves.current = self.previous
        return False


def kernel_saves(outputs: bool = False):
    """Two context managers for one checkpointed region, ``(forward,
    recompute)``. Under ``forward`` every differentiable
    :func:`flash_attention_bshd`, :func:`flash_attention_masked` and
    :func:`flash_attention_shortk` call records its (out, lse), detached;
    under ``recompute`` the calls, made again in the same order, take them
    back instead of launching the forward kernel, while the backward still
    sees the recomputed q, k and v. With ``outputs`` the differentiable
    calls of the fused gated-MLP kernel (``ops.fused_mlp``) and of the
    4-bit matmul kernel (``ops.nf4_matmul``) are recorded and replayed
    likewise, and so are the products ``nn.core.saved_products`` marks (the
    "activations" mode of ``nn.core.set_remat_saves``)."""
    saves: list = []
    products: list = []
    return (_KernelSaves("record", saves, outputs, products),
            _KernelSaves("replay", saves, outputs, products))


def current_region() -> Optional[_KernelSaves]:
    """The checkpointed region whose forward or recomputation runs, if any."""
    return _KernelSaves.current


def _replayed_saves(output: bool = False):
    """(region, what it saved for this call or None) of the checkpointed
    region that is current, for a differentiable kernel call: a flash
    attention call, or with ``output`` a fused or 4-bit kernel call, which
    only a region that keeps outputs takes part in."""
    region = _KernelSaves.current
    if region is None or (output and not region.outputs):
        return None, None
    if region.mode != "replay":
        return region, None
    saved = region.saves[region.position]
    region.position += 1
    return region, saved


def saved_output(run):
    """``run(saved)`` for a differentiable fused or 4-bit kernel call:
    ``saved`` is the output recorded by the first forward of the current
    region when this is its recomputation (the call then launches
    nothing), else None; the output of a first forward is recorded."""
    region, saved = _replayed_saves(output=True)
    out = run(saved)
    if region is not None and region.mode == "record":
        region.saves.append(out.detach())
    return out


class _FlashAttentionBSHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale, saved):
        if saved is None:
            out, lse = _forward(q, k, v, num_heads, scale, return_lse=True)
        else:
            out, lse = saved[0].detach(), saved[1].detach()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bshd_backward(
            q, k, v, out, lse, dout, ctx.num_heads, ctx.scale
        )
        return dq, dk, dv, None, None, None


def flash_attention_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """softmax(q k^T * scale) v per head over heads-packed tensors.

    With ``return_lse`` also returns the fp32 log-sum-exp of the scaled
    scores as (B, H, Sq). Differentiable in q, k and v. On the card the
    kernel takes scale > 0."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        out, lse = _forward(q, k, v, num_heads, scale, return_lse)
        return (out, lse) if return_lse else out
    region, saved = _replayed_saves()
    out, lse = _FlashAttentionBSHD.apply(q, k, v, num_heads, scale, saved)
    if region is not None and region.mode == "record":
        region.saves.append((out.detach(), lse))
    return (out, lse) if return_lse else out


flash_attention_bshd.launches = 0


# -- key-masked attention over (B, H, S, D): forward and backward --------------------


def _expand_kv_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, H, S, D): kv head j serves query heads
    [j * r, (j + 1) * r), as ``repeat`` along the head axis does."""
    if t.shape[1] == num_heads:
        return t
    if num_heads % t.shape[1]:
        raise ValueError(f"{t.shape[1]} k/v heads do not divide {num_heads} query heads")
    return t.repeat_interleave(num_heads // t.shape[1], dim=1)


def _masked_scores(scores: torch.Tensor, key_mask, is_causal: bool) -> torch.Tensor:
    """The kernels' masking of fp32 scores (B, H, Sq, Sk), in place: a
    masked or causally excluded key scores a finite -1e30."""
    b, _, sq, sk = scores.shape
    if key_mask is not None:
        scores.masked_fill_(~key_mask.bool().reshape(b, 1, 1, sk), NEG_INF)
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=scores.device).tril()
        scores.masked_fill_(~keep, NEG_INF)
    return scores


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None, is_causal: bool = False, return_lse: bool = False,
):
    """The plain version of :func:`flash_attention_masked`, with the
    kernel's masked-row rule: a masked or causally excluded key scores a
    finite -1e30, so a query row with no key left gives the mean of v (and
    an lse of about -1e30), not 0."""
    h, d = q.shape[1], q.shape[3]
    scale = d**-0.5 if scale is None else scale
    k, v = _expand_kv_heads(k, h), _expand_kv_heads(v, h)
    scores = _masked_scores(
        torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, key_mask, is_causal
    )
    out = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1)


def flash_attention_masked_delta(
    out: torch.Tensor, dout: torch.Tensor, dlse: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """delta = rowsum(dO * O) - dlse, fp32 contiguous (B, H, Sq). ``dlse``,
    the gradient of the returned lse, shifts delta: d lse / d s = p, so it
    adds p * dlse to dS, the JAX package's ``g_lse`` term."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _masked_backward_reference(q, k, v, key_mask, lse, delta, dout, scale, is_causal):
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    dtype = q.dtype
    qf, dof = q.float(), dout.float()
    kf, vf = _expand_kv_heads(k, h).float(), _expand_kv_heads(v, h).float()
    scores = _masked_scores(torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale), key_mask, is_causal)
    p = scores.sub_(lse.unsqueeze(-1)).exp_()
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), dof)
    ds = torch.matmul(dof, vf.transpose(-1, -2)).sub_(delta.unsqueeze(-1)).mul_(p).mul_(scale)
    del p
    ds = ds.to(dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    # the query heads of a kv head sum into its gradient, in fp32
    dk = dk.view(b, hk, h // hk, sk, d).sum(dim=2)
    dv = dv.view(b, hk, h // hk, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_masked_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor],
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, scale: Optional[float] = None,
    is_causal: bool = False, dlse: Optional[torch.Tensor] = None,
):
    """(dq, dk, dv) by the backward kernels' arithmetic: P recomputed as
    exp(S + mask - lse) in fp32 (so a row with every key masked, lse -1e30,
    gets P = 1 on each key, as in the TPU kernel), P and dS rounded to the
    inputs' dtype before their products, fp32 accumulation, dk and dv
    summed over the query heads of each kv head, outputs in the inputs'
    dtypes."""
    delta = flash_attention_masked_delta(out, dout, dlse)
    return _masked_backward_reference(q, k, v, key_mask, lse, delta, dout, scale, is_causal)


@functools.cache
def _masked_kernel():
    fn = _build.cuda_library("flash_attention_masked").flash_attention_masked_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _masked_backward_kernels():
    lib = _build.cuda_library("flash_attention_masked_bwd")
    dkv, dq = lib.flash_attention_masked_bwd_dkv, lib.flash_attention_masked_bwd_dq
    dkv.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 18
        + [ctypes.c_float, ctypes.c_void_p]
    )
    dq.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 15
        + [ctypes.c_float, ctypes.c_void_p]
    )
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def _aligned(t: torch.Tensor) -> bool:
    """The TMA tensor maps of kernels E and G: unit
    last stride, 8-element batch, head and row strides, a 16-byte aligned
    start."""
    s = t.stride()
    return s[3] == 1 and s[0] % 8 == 0 and s[1] % 8 == 0 and s[2] % 8 == 0 and t.data_ptr() % 16 == 0


def _check_masked(q, k, v, key_mask, **more) -> None:
    """Raise on what the key-masked kernels do not take; ``more`` are
    further bf16 tensors of q's shape (dout)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    if d not in MASKED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention_masked kernel takes head dims {MASKED_HEAD_DIMS}, got {d}"
        )
    hk, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hk, sk, d) or v.shape != k.shape or hk < 1 or h % hk:
        raise ValueError(
            f"k and v must be (B, Hkv, Sk, D) with Hkv dividing {h}, got {tuple(k.shape)}, "
            f"{tuple(v.shape)} for q {tuple(q.shape)}"
        )
    if min(sq, sk) < 1 or max(sq, sk) >= 2**31 or b >= 2**16 or h >= 2**16:
        raise ValueError("shape beyond the kernel's grid or int32 row index")
    if key_mask is not None and (
        key_mask.shape != (b, sk) or key_mask.dtype != torch.bool or key_mask.device != q.device
    ):
        raise ValueError(f"key_mask must be bool (B, Sk) = {(b, sk)} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_cuda or t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if not _aligned(t):
            raise ValueError(f"{name} needs a contiguous last axis and 16-byte aligned rows")
    if any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"{sorted(more)} must have q's shape {tuple(q.shape)}")


def _masked_forward(q, k, v, key_mask, scale, is_causal, return_lse):
    """The kernel for CUDA tensors, else the plain version."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, key_mask, scale, is_causal, return_lse)
    _check_masked(q, k, v, key_mask)
    b, h, sq, d = q.shape
    scale = d**-0.5 if scale is None else scale
    mask = None if key_mask is None else key_mask.contiguous()
    out = torch.empty_like(q)  # q's strides where q is dense: (B, S, H, D) memory stays so
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32) if return_lse else None
    with torch.cuda.device(q.device):
        err = _masked_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, k.shape[2], h, k.shape[1], d, int(is_causal),
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_masked launch failed: CUDA error {err}")
    flash_attention_masked.launches += 1
    return (out, lse) if return_lse else out


def _check_masked_backward(q, k, v, key_mask, dout, lse, delta) -> None:
    _check_masked(q, k, v, key_mask, dout=dout)
    _check_row_stats(tuple(q.shape[:3]), q.device, lse=lse, delta=delta)


def _launch_masked(which, kernel, outputs, q, k, v, key_mask, dout, lse, delta, scale, is_causal):
    b, h, sq, d = q.shape
    mask = None if key_mask is None else key_mask.contiguous()
    with torch.cuda.device(q.device):
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
            b, sq, k.shape[2], h, k.shape[1], d, int(is_causal),
            *(t.stride(i) for t in (q, k, v, dout, *outputs) for i in range(3)),
            float(d**-0.5 if scale is None else scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_masked {which} launch failed: CUDA error {err}")


def flash_attention_masked_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor],
    dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, scale: Optional[float] = None,
    is_causal: bool = False,
):
    """(dk, dv) of :func:`flash_attention_masked` from q, k, v, the key
    mask, the output's gradient, lse and delta (B, H, Sq); each kv head's
    gradient sums over its query heads. Both keep k's strides where k is
    dense."""
    if not q.is_cuda:
        return _masked_backward_reference(q, k, v, key_mask, lse, delta, dout, scale, is_causal)[1:]
    _check_masked_backward(q, k, v, key_mask, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_masked("dk/dv", _masked_backward_kernels()[0], (dk, dv), q, k, v, key_mask, dout,
                   lse, delta, scale, is_causal)
    flash_attention_masked_dkv.launches += 1
    return dk, dv


def flash_attention_masked_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor],
    dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, scale: Optional[float] = None,
    is_causal: bool = False,
):
    """dq of :func:`flash_attention_masked` from the same inputs as
    :func:`flash_attention_masked_dkv`, in q's strides where q is dense."""
    if not q.is_cuda:
        return _masked_backward_reference(q, k, v, key_mask, lse, delta, dout, scale, is_causal)[0]
    _check_masked_backward(q, k, v, key_mask, dout, lse, delta)
    dq = torch.empty_like(q)
    _launch_masked("dq", _masked_backward_kernels()[1], (dq,), q, k, v, key_mask, dout,
                   lse, delta, scale, is_causal)
    flash_attention_masked_dq.launches += 1
    return dq


flash_attention_masked_dkv.launches = 0
flash_attention_masked_dq.launches = 0


def flash_attention_masked_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor],
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, scale: Optional[float] = None,
    is_causal: bool = False, dlse: Optional[torch.Tensor] = None,
):
    """(dq, dk, dv) of :func:`flash_attention_masked` from its inputs, its
    output and lse, the output's gradient (any layout: copied only where
    the kernels cannot read it in place) and, optionally, the lse's
    gradient. Plain delta, then the dk/dv kernel and the dq kernel."""
    if q.is_cuda and not _aligned(dout):
        dout = dout.contiguous()
    delta = flash_attention_masked_delta(out, dout, dlse)
    dk, dv = flash_attention_masked_dkv(q, k, v, key_mask, dout, lse, delta, scale, is_causal)
    dq = flash_attention_masked_dq(q, k, v, key_mask, dout, lse, delta, scale, is_causal)
    return dq, dk, dv


class _FlashAttentionMasked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, is_causal, saved):
        if saved is None:
            out, lse = _masked_forward(q, k, v, key_mask, scale, is_causal, return_lse=True)
        else:
            out, lse = saved[0].detach(), saved[1].detach()
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale, ctx.is_causal = scale, is_causal
        ctx.set_materialize_grads(False)  # an unused lse brings no gradient
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_masked_backward(
            q, k, v, key_mask, out, lse, dout, ctx.scale, ctx.is_causal, dlse
        )
        return dq, dk, dv, None, None, None, None


def flash_attention_masked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None, is_causal: bool = False, return_lse: bool = False,
):
    """softmax(q k^T * scale + mask [causal]) v over q (B, H, Sq, D) and
    k, v (B, Hkv, Sk, D), Hkv a divisor of H (query head h reads kv head
    h // (H // Hkv); nothing is repeated in memory). ``key_mask``: bool
    (B, Sk), True = attend. Any batch, head and row strides with a
    contiguous last axis are read in place; the output has q's shape and,
    where q is dense, q's strides. With ``return_lse`` also the fp32
    log-sum-exp of the scores, (B, H, Sq).

    Masked-row rule (the kernel's, not ``plain_attention``'s): masked keys
    score a finite -1e30, so a query row with every key masked gives the
    mean of v. Causal masking is key position <= query position with no
    Sk - Sq offset, so it is taken at sq == sk only. Differentiable in q, k
    and v (and through the returned lse): on the card the backward is the
    two kernels of :func:`flash_attention_masked_backward`. Other head dims
    than ``MASKED_HEAD_DIMS``, other dtypes than bf16 and unaligned rows
    raise ``ValueError`` on the card."""
    if is_causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal attention needs sq == sk here, got {q.shape[2]} and {k.shape[2]}")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return _masked_forward(q, k, v, key_mask, scale, is_causal, return_lse)
    region, saved = _replayed_saves()
    out, lse = _FlashAttentionMasked.apply(q, k, v, key_mask, scale, is_causal, saved)
    if region is not None and region.mode == "record":
        region.saves.append((out.detach(), lse.detach()))
    return (out, lse) if return_lse else out


flash_attention_masked.launches = 0


# -- short-K attention over (B, H, S, D): forward and backward -----------------------

_flash_shortk = False


def set_flash_shortk(enabled: bool) -> None:
    """Whether :func:`flash_attention` sends calls with at most
    ``SHORTK_MAX`` keys, no mask and no causal masking to the short-K
    kernels on the card (SDXL's cross-attention): off by default, as
    ``VFT_FLASH_SHORTK`` is in the JAX package."""
    global _flash_shortk
    _flash_shortk = bool(enabled)


def flash_attention_shortk_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    return_lse: bool = False,
):
    """The plain version of :func:`flash_attention_shortk`: fp32 scores,
    softmax, the weights rounded to v's dtype before P V; with
    ``return_lse`` also the fp32 log-sum-exp of the scores (B, H, Sq)."""
    return flash_attention_reference(q, k, v, None, scale, False, return_lse)


def flash_attention_shortk_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
):
    """(dq, dk, dv) by the backward kernel's arithmetic: P recomputed as
    exp(S - lse) in fp32, P and dS rounded to the inputs' dtype before their
    products, fp32 accumulation, outputs in the inputs' dtypes."""
    return flash_attention_masked_backward_reference(q, k, v, None, out, lse, dout, scale)


def _shortk_padded(sk: int) -> int:
    """The key count the kernels are built for: sk rounded up to 32."""
    return max(32, -(-sk // 32) * 32)


def shortk_fwd_plan(b: int, h: int, sq: int, sms: int) -> tuple[int, int]:
    """(q tiles a head, blocks) of kernel H: its work items are (batch,
    head, 64-row q tile), B * H * tiles of them, walked in head order by
    one persistent block an SM (never more blocks than items), each taking
    the contiguous run ``[i * items // blocks, (i + 1) * items // blocks)``
    and handing its items to its warpgroups in turn. A function of the
    shape and the card alone."""
    tiles = -(-sq // 64)
    return tiles, max(1, min(b * h * tiles, sms))


class ShortkBwdPlan(NamedTuple):
    """Kernel I's launch plan (see :func:`shortk_bwd_plan`)."""

    tiles: int  # 64-row q tiles a unit
    units: int  # (batch, head, 64-column half of D): B * H * D / 64
    blocks: int
    # per unit: (unit, its partial slots in the order they are summed)
    reduction: tuple


@functools.lru_cache(maxsize=256)
def shortk_bwd_plan(b: int, h: int, sq: int, d: int, sms: int) -> ShortkBwdPlan:
    """Kernel I's plan, a function of the shape and the card alone. Its
    work items are (batch, head, half, 64-row q tile), half the 64 columns
    of dq, dk and dv an item writes (D / 64 of them), walked in that order
    by one persistent block an SM (never more blocks than items), each
    taking the contiguous run ``[i * items // blocks, (i + 1) * items //
    blocks)`` as kernel H's do. A unit, (batch, head, half), sums dk and dv
    over its tiles; where those fall to blocks first to last, each block i
    writes fp32 partials to slot i + unit (distinct for every (block,
    unit) a run meets, below blocks + units), and after a grid barrier the
    grid sums each unit's slots in ascending order."""
    tiles = -(-sq // 64)
    units = b * h * (d // 64)
    items = units * tiles
    blocks = max(1, min(items, sms))

    def block_of(item):  # the block whose run holds the item
        return ((item + 1) * blocks - 1) // items

    reduction = tuple(
        (unit, tuple(range(block_of(unit * tiles) + unit, block_of((unit + 1) * tiles - 1) + unit + 1)))
        for unit in range(units)
    )
    return ShortkBwdPlan(tiles, units, blocks, reduction)


def _shortk_scratch_bytes(plan: ShortkBwdPlan, sk: int) -> int:
    """Kernel I's scratch: blocks + units partial slots of 2 x 64 x (its
    padded keys) fp32."""
    width = 64 if sk <= 64 else 80 if sk <= 80 else _shortk_padded(sk)
    return (plan.blocks + plan.units) * 2 * 64 * width * 4


@functools.cache
def _shortk_kernels():
    lib = _build.cuda_library("flash_attention_shortk")
    fwd, bwd = lib.flash_attention_shortk_fwd, lib.flash_attention_shortk_bwd
    fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    # pointers, the packed dims and strides (27 int64), scale, stream
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_float, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_shortk(q, k, v, **more) -> None:
    """Raise on what the short-K kernels do not take; ``more`` are further
    bf16 tensors of q's shape (dout)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    if d not in SHORTK_HEAD_DIMS:
        raise ValueError(f"flash_attention_shortk kernels take head dims {SHORTK_HEAD_DIMS}, got {d}")
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"k and v must be (B, H, Sk, D) = {(b, h, sk, d)}, got {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not 1 <= sk <= SHORTK_MAX:
        raise ValueError(f"flash_attention_shortk takes 1 to {SHORTK_MAX} keys, got {sk}")
    if sq < 1 or b >= 2**16 or h >= 2**16 or b * h * -(-sq // 64) >= 2**31:
        raise ValueError("shape beyond the kernels' grid or int32 work-item index")
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != torch.bfloat16 or t.device != device or not t.is_cuda:
            raise ValueError(f"{name} must be bf16 on {device}, got {t.dtype} on {t.device}")
        if not _aligned(t):
            raise ValueError(f"{name} needs a contiguous last axis and 16-byte aligned rows")
    if any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"{sorted(more)} must have q's shape {tuple(q.shape)}")


def _shortk_forward(q, k, v, scale, return_lse):
    """(out, lse or None): kernel H for CUDA tensors, else the plain version."""
    if not q.is_cuda:
        if return_lse:
            return flash_attention_shortk_reference(q, k, v, scale, return_lse=True)
        return flash_attention_shortk_reference(q, k, v, scale), None
    _check_shortk(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    # kernel H takes its row max on the raw scores, the max of the scaled
    # scores only where scale > 0
    if not scale > 0:
        raise ValueError(f"flash_attention_shortk kernel takes a scale > 0, got {scale}")
    device = q.device
    out = torch.empty_like(q)  # q's strides where q is dense: (B, S, H, D) memory stays so
    lse = q.new_empty((b, h, sq), dtype=torch.float32) if return_lse else None
    _, blocks = shortk_fwd_plan(b, h, sq, _build.sm_count(device))
    with torch.cuda.device(device):
        err = _shortk_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, sk, _shortk_padded(sk), h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), blocks, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_shortk launch failed: CUDA error {err}")
    flash_attention_shortk.launches += 1
    return out, lse


def flash_attention_shortk_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: Optional[float] = None,
):
    """(dq, dk, dv) of :func:`flash_attention_shortk` from q, k, v, the
    output's gradient, lse and delta (B, H, Sq): kernel I, one launch (its
    plan :func:`shortk_bwd_plan`), for CUDA tensors, else the plain
    version. Each output keeps its input's strides where the input is
    dense."""
    if not q.is_cuda:
        return _masked_backward_reference(q, k, v, None, lse, delta, dout, scale, False)
    _check_shortk(q, k, v, dout=dout)
    b, h, sq, d = q.shape
    _check_row_stats((b, h, sq), q.device, lse=lse, delta=delta)
    if lse.data_ptr() % 16 or delta.data_ptr() % 16 or b * h * sq >= 2**31:
        raise ValueError("lse and delta must start 16-byte aligned, B * H * Sq below 2**31")
    sk = k.shape[2]
    index = q.get_device()
    plan = shortk_bwd_plan(b, h, sq, d, _build.sm_count(index))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(_shortk_scratch_bytes(plan, sk), device=q.device, dtype=torch.uint8)
    dims = struct.pack("27q", b, h, sq, sk, d, plan.blocks, *q.stride()[:3], *k.stride()[:3],
                       *v.stride()[:3], *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
                       *dv.stride()[:3])
    err = _build.launch(
        _shortk_kernels()[1], index, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), dims,
        float(d**-0.5 if scale is None else scale),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_shortk backward launch failed: CUDA error {err}")
    flash_attention_shortk_bwd.launches += 1
    return dq, dk, dv


flash_attention_shortk_bwd.launches = 0


def flash_attention_shortk_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
):
    """(dq, dk, dv) of :func:`flash_attention_shortk` from its inputs, its
    output and lse and the output's gradient (any layout: copied only where
    the kernel cannot read it in place). Plain delta, then kernel I."""
    if q.is_cuda and not _aligned(dout):
        dout = dout.contiguous()
    delta = flash_attention_masked_delta(out, dout)
    return flash_attention_shortk_bwd(q, k, v, dout, lse, delta, scale)


class _FlashAttentionShortK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, saved):
        if saved is None:
            out, lse = _shortk_forward(q, k, v, scale, return_lse=True)
        else:
            out, lse = saved[0].detach(), saved[1].detach()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_shortk_backward(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_shortk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    return_lse: bool = False,
):
    """softmax(q k^T * scale) v over q (B, H, Sq, D) and k, v (B, H, Sk, D)
    with Sk <= ``SHORTK_MAX``, no mask and no causal masking: the whole key
    context is held on chip (kernel H). Any batch, head and row strides with
    a contiguous last axis are read in place; the output has q's shape and,
    where q is dense, q's strides. With ``return_lse`` also the fp32
    log-sum-exp of the scores, (B, H, Sq). Differentiable in q, k and v: on
    the card the backward is kernel I (:func:`flash_attention_shortk_bwd`).
    Other head dims than ``SHORTK_HEAD_DIMS``, more keys, other dtypes than
    bf16, unaligned rows and a scale <= 0 raise ``ValueError`` on the card."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        out, lse = _shortk_forward(q, k, v, scale, return_lse)
        return (out, lse) if return_lse else out
    region, saved = _replayed_saves()
    out, lse = _FlashAttentionShortK.apply(q, k, v, scale, saved)
    if region is not None and region.mode == "record":
        region.saves.append((out.detach(), lse))
    return (out, lse) if return_lse else out


flash_attention_shortk.launches = 0


def _as_key_mask(mask: Optional[torch.Tensor], b: int, sk: int) -> Optional[torch.Tensor]:
    """Reduce a mask the kernel takes to (B, Sk) bool; None for any other."""
    if mask is None or mask.dtype != torch.bool:
        return None  # additive float masks take the plain formula
    shape = tuple(mask.shape)
    if shape == (b, sk) or shape == (sk,):
        return mask.reshape(-1, sk).expand(b, sk)
    if len(shape) == 4 and shape[0] in (1, b) and shape[1] == 1 and shape[2] == 1:
        return mask.reshape(shape[0], sk).expand(b, sk)
    return None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None, is_causal: bool = False,
) -> torch.Tensor:
    """Flash attention over (B, H, S, D), k and v with H heads or a divisor
    of H. The JAX package's rule with ``is_cuda`` for its TPU check: on
    the card, sk >= 256 and no mask or a boolean (B, Sk) / (B, 1, 1, Sk) key
    mask go to the key-masked kernel, which raises on what it does not
    take (see :func:`flash_attention_masked`); with :func:`set_flash_shortk`
    on, sk <= ``SHORTK_MAX`` with no mask and no causal masking goes to the
    short-K kernels, which raise likewise (see :func:`flash_attention_shortk`);
    every other call, and every CPU call, takes
    ``ops.attention.plain_attention``."""
    from .attention import plain_attention

    b, h, _, d = q.shape
    sk = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    if q.is_cuda and sk >= 256:
        key_mask = _as_key_mask(mask, b, sk)
        if mask is None or key_mask is not None:
            return flash_attention_masked(q, k, v, key_mask, scale, is_causal)
    if q.is_cuda and _flash_shortk and sk <= SHORTK_MAX and mask is None and not is_causal:
        return flash_attention_shortk(q, _expand_kv_heads(k, h), _expand_kv_heads(v, h), scale)
    return plain_attention(
        q, _expand_kv_heads(k, h), _expand_kv_heads(v, h), mask, scale, is_causal
    )
