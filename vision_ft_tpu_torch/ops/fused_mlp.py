"""Fused gated MLP (GeGLU / SwiGLU feed-forward): wrapper and plain version.

Counterpart of ``vision_ft_tpu/ops/pallas/fused_mlp.py``. The kernel is
CUDA C++, ``csrc/fused_mlp.cu``, built for ``sm_90a`` by ``ops/_build.py``
and bound with ``ctypes``. It computes

    (act(x @ w_act^T + b_act) * (x @ w_gate^T + b_gate)) @ w_down^T + b_down

with bf16 operands, fp32 accumulation, fp32 biases (absent = zero), the
gated product rounded to bf16 before the down-projection and a bf16
output; the (M, inner) intermediates never reach device memory. Weights
stay in torch (out, in) layout.

- :func:`gated_mlp_reference` is the plain PyTorch version, with the
  kernel's arithmetic (fp32 accumulation, the gated product rounded to the
  input's dtype).
- :func:`gated_mlp` (separate act / gate weights: SwiGLU) and
  :func:`geglu_mlp` (one fused (2*inner, C) up-projection whose first half
  is the linear stream and second half the gelu gate; the halves are read
  in place through views, no sliced copies) are the wrappers. For CPU
  tensors they return the plain version. For CUDA tensors they launch the
  kernel or raise. ``gated_mlp.launches`` counts the launches of both.
- The backward is the plain formula through autograd, as in the JAX
  package (its ``custom_vjp`` differentiates the plain formulation; there
  is no backward kernel).
- :func:`supported` and :func:`fused_ff_enabled` are the gate the models'
  feed-forwards ask; :func:`set_fused_ff` takes the place of the JAX
  package's ``VFT_FUSED_FF`` environment variable.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

ACTS = ("silu", "gelu_tanh", "gelu")
FUSED_FF_MODES = ("auto", "on", "off")
# the 16-row x tile sits in shared memory beside the weight ring
MAX_C = 3712
_fused_ff = "auto"


def set_fused_ff(mode: str) -> None:
    """Whether the models' gated feed-forwards take the fused kernel:
    "auto" (default) takes it where the inner width is at least 8192 (the
    JAX package's width rule: Lumina2's 9216, not SDXL's <= 5120), "on"
    wherever :func:`fused_ff_enabled`'s other conditions hold, "off"
    nowhere."""
    global _fused_ff
    if mode not in FUSED_FF_MODES:
        raise ValueError(f"unknown fused_ff mode: {mode!r}")
    _fused_ff = mode


def fused_ff() -> str:
    return _fused_ff


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(h)
    if act == "gelu_tanh":
        return F.gelu(h, approximate="tanh")
    if act == "gelu":
        return F.gelu(h)
    raise ValueError(f"unknown activation {act!r}, expected one of {ACTS}")


def gated_mlp_reference(
    x: torch.Tensor,
    w_act: torch.Tensor,
    w_gate: torch.Tensor,
    w_down: torch.Tensor,
    b_act: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,
    b_down: Optional[torch.Tensor] = None,
    act: str = "silu",
) -> torch.Tensor:
    """The plain version: fp32 products and sums of the inputs' values, the
    gated product rounded to x's dtype, the output in x's dtype."""
    xf = x.float()
    h = F.linear(xf, w_act.float(), None if b_act is None else b_act.float())
    g = F.linear(xf, w_gate.float(), None if b_gate is None else b_gate.float())
    a = (_act(h, act) * g).to(x.dtype)
    out = F.linear(a.float(), w_down.float(), None if b_down is None else b_down.float())
    return out.to(x.dtype)


def supported(c: int, inner: int) -> bool:
    """Shapes the kernel takes: the JAX package's rule (c % 128 == 0,
    inner % 256 == 0), and c <= 3712 so that the x tile fits in shared
    memory. Everything else keeps the plain route."""
    return c % 128 == 0 and inner % 256 == 0 and 0 < c <= MAX_C and inner > 0


def fused_ff_enabled(x: torch.Tensor, *layers, inner: Optional[int] = None) -> bool:
    """The shared gate of the families' feed-forwards: bf16 activations on
    the card, and every ``Linear`` a plain dense bf16 weight (a quantized
    or fp8 weight or an attached LoRA / LoHa adapter keeps the plain
    route). Width rule of :func:`set_fused_ff`: in "auto" only
    ``inner`` >= 8192."""
    if _fused_ff == "off":
        return False
    if _fused_ff != "on" and (inner is None or inner < 8192):
        return False
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        return False
    for layer in layers:
        if layer.is_quantized or layer.weight.dtype != torch.bfloat16:
            return False
        if "lora_down" in layer._modules or "hada_w1_a" in layer._parameters:
            return False
    return True


@functools.cache
def _kernel():
    fn = _build.cuda_library("fused_mlp").fused_gated_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward(x2, w_act, b_act, w_gate, b_gate, w_down, b_down, act):
    """x2 (M, C) -> (M, C): the kernel for CUDA tensors, else the plain version."""
    if not x2.is_cuda:
        return gated_mlp_reference(x2, w_act, w_gate, w_down, b_act, b_gate, b_down, act)
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}, expected one of {ACTS}")
    m, c = x2.shape
    inner = w_down.shape[1]
    if not supported(c, inner) or m < 1:
        raise ValueError(
            f"fused gated MLP kernel takes c % 128 == 0, c <= {MAX_C}, inner % 256 == 0 and "
            f"at least one row, got m={m}, c={c}, inner={inner}"
        )
    for name, t, shape in (
        ("x", x2, (m, c)), ("w_act", w_act, (inner, c)), ("w_gate", w_gate, (inner, c)),
        ("w_down", w_down, (c, inner)),
    ):
        if not t.is_cuda or t.device != x2.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {x2.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous, 16-byte aligned and of shape {shape}, "
                f"got {tuple(t.shape)} with strides {t.stride()}"
            )
    biases = []
    for name, bias, n in (("b_act", b_act, inner), ("b_gate", b_gate, inner), ("b_down", b_down, c)):
        if bias is None:
            biases.append(None)
            continue
        if bias.device != x2.device or tuple(bias.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},) on {x2.device}")
        biases.append(bias.float().contiguous())
    out = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = _kernel()(
            x2.data_ptr(), w_act.data_ptr(), None if biases[0] is None else biases[0].data_ptr(),
            w_gate.data_ptr(), None if biases[1] is None else biases[1].data_ptr(),
            w_down.data_ptr(), None if biases[2] is None else biases[2].data_ptr(),
            out.data_ptr(), m, c, inner, ACTS.index(act),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_gated_mlp launch failed: CUDA error {err}")
    gated_mlp.launches += 1
    return out


class _GatedMLP(torch.autograd.Function):
    """The forward is :func:`_forward`; the backward differentiates the
    plain formula in the inputs' dtype (the JAX ``_gated_ref``), from the
    saved inputs."""

    @staticmethod
    def forward(ctx, x2, w_act, b_act, w_gate, b_gate, w_down, b_down, act):
        ctx.save_for_backward(x2, w_act, b_act, w_gate, b_gate, w_down, b_down)
        ctx.act = act
        return _forward(x2, w_act, b_act, w_gate, b_gate, w_down, b_down, act)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [
                None if t is None else t.detach().requires_grad_(need)
                for t, need in zip(saved, ctx.needs_input_grad)
            ]
            x2, w_act, b_act, w_gate, b_gate, w_down, b_down = leaves
            h = F.linear(x2, w_act, b_act)
            g = F.linear(x2, w_gate, b_gate)
            out = F.linear(_act(h, ctx.act) * g, w_down, b_down)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout.to(out.dtype)))
        return (
            *(next(grads) if t is not None and t.requires_grad else None for t in leaves),
            None,
        )


def _apply(x, w_act, b_act, w_gate, b_gate, w_down, b_down, act):
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    tensors = (x2, w_act, b_act, w_gate, b_gate, w_down, b_down)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        out = _GatedMLP.apply(*tensors, act)
    else:
        out = _forward(*tensors, act)
    return out.reshape(*x.shape[:-1], c)


def gated_mlp(
    x: torch.Tensor,
    w_act: torch.Tensor,
    w_gate: torch.Tensor,
    w_down: torch.Tensor,
    b_act: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,
    b_down: Optional[torch.Tensor] = None,
    act: str = "silu",
) -> torch.Tensor:
    """Fused gated feed-forward over x (..., C); ``w_act`` / ``w_gate``
    (inner, C) and ``w_down`` (C, inner) in torch layout, biases optional.
    Differentiable in every tensor."""
    return _apply(x, w_act, b_act, w_gate, b_gate, w_down, b_down, act)


def geglu_mlp(
    x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor], w2: torch.Tensor,
    b2: Optional[torch.Tensor],
) -> torch.Tensor:
    """SDXL GeGLU layout: ``w1`` is the fused (2*inner, C) up-projection
    whose first row half is the linear stream and second half the gelu
    gate (``h * gelu_tanh(gate)``), ``w2`` the (C, inner) down-projection.
    The kernel reads both halves of ``w1`` in place."""
    inner = w2.shape[1]
    return _apply(
        x, w1[inner:], None if b1 is None else b1[inner:], w1[:inner],
        None if b1 is None else b1[:inner], w2, b2, "gelu_tanh",
    )


gated_mlp.launches = 0
