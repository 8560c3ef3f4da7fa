"""Fused gated MLP (GeGLU / SwiGLU feed-forward): wrappers and plain versions.

Counterpart of ``vision_ft_tpu/ops/pallas/fused_mlp.py``; kernel F replaces
its ``_gated_kernel`` (``ops/pallas/fused_mlp.py:63``). It computes

    (act(x @ w_act^T + b_act) * (x @ w_gate^T + b_gate)) @ w_down^T + b_down

with bf16 operands, fp32 accumulation, fp32 copies of the biases (absent
= zero), the gated product rounded to bf16 before the down-projection and
a bf16 output. Weights stay in torch (out, in) layout. Its bound on an H100 is
operations: 6 * M * C * inner at 989 TFLOP/s.

Kernel F is two hand-written Hopper GEMMs in CUDA C++,
``csrc/fused_mlp.cu`` (on ``csrc/hopper_gemm.cuh``: TMA, mbarriers, wgmma),
built for ``sm_90a`` by ``ops/_build.py`` and bound with ``ctypes``:

- F-up, ``a = bf16(act(x w_act^T + b_act) * (x w_gate^T + b_gate))``: one
  wgmma over the tile's act rows stacked on its gate rows, the gate in the
  epilogue. Plain version: :func:`gated_up_reference`; alone:
  :func:`gated_up`.
- F-down, ``out = bf16(a w_down^T + b_down)``, split over inner when the
  output has too few tiles to fill the card (fp32 partials summed in split
  order by a second launch). Plain version: :func:`gated_down_reference`;
  alone: :func:`gated_down`.

The gated product ``a`` (M, inner) makes one round trip through device
memory (allocated here with ``torch.empty``), where the TPU kernel keeps a
(256, C) fp32 accumulator in VMEM across its inner chunks: an SM has far
too little memory for an accumulator tile that reuses the weights.

- :func:`gated_mlp_reference` is the plain version of the whole call, the
  composition of the two above.
- :func:`gated_mlp` (separate act / gate weights: SwiGLU) and
  :func:`geglu_mlp` (one fused (2*inner, C) up-projection whose first half
  is the linear stream and second half the gelu gate; the halves are read
  in place through views, no sliced copies) are the wrappers. For CPU
  tensors they return the plain version. For CUDA tensors they launch F-up
  then F-down (one C call) or raise. ``gated_mlp.launches`` counts those
  calls, one per feed-forward, for both.
- The backward is the plain formula through autograd, as in the JAX
  package (its ``custom_vjp`` differentiates the plain formulation; there
  is no backward kernel).
- :func:`supported` (the JAX package's rule) and :func:`fused_ff_enabled`
  are the gate the models' feed-forwards ask; :func:`set_fused_ff` takes
  the place of the JAX package's ``VFT_FUSED_FF`` environment variable.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import saved_output

ACTS = ("silu", "gelu_tanh", "gelu")
FUSED_FF_MODES = ("auto", "on", "off")
# rows and K depth of kernel F's tiles; F-down's output tiles are 256 wide
# where C % 256 == 0, else 128
TILE_M, TILE_K = 128, 64
# F-down splits inner only into parts of at least this many K tiles
MIN_SPLIT_K_TILES = 16
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


def gated_up_reference(
    x: torch.Tensor,
    w_act: torch.Tensor,
    w_gate: torch.Tensor,
    b_act: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,
    act: str = "silu",
) -> torch.Tensor:
    """Plain version of F-up: fp32 products and sums of the inputs' values,
    the gated product rounded to x's dtype."""
    xf = x.float()
    h = F.linear(xf, w_act.float(), None if b_act is None else b_act.float())
    g = F.linear(xf, w_gate.float(), None if b_gate is None else b_gate.float())
    return (_act(h, act) * g).to(x.dtype)


def gated_down_reference(
    a: torch.Tensor, w_down: torch.Tensor, b_down: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of F-down: fp32 products and sums, the output in a's dtype."""
    out = F.linear(a.float(), w_down.float(), None if b_down is None else b_down.float())
    return out.to(a.dtype)


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
    """The plain version of the whole call: F-up's, then F-down's."""
    return gated_down_reference(gated_up_reference(x, w_act, w_gate, b_act, b_gate, act), w_down,
                                b_down)


def supported(c: int, inner: int) -> bool:
    """Shapes the kernel takes: the JAX package's rule (c % 128 == 0,
    inner % 256 == 0). Everything else keeps the plain route."""
    return c % 128 == 0 and inner % 256 == 0


def down_splits(m: int, c: int, inner: int, sms: int) -> int:
    """Parts F-down cuts inner into: enough that its (row tile, column
    tile) blocks fill ``sms`` SMs, each part at least MIN_SPLIT_K_TILES K
    tiles deep; 1 where the tiles alone fill the card."""
    tiles = -(-m // TILE_M) * (c // (256 if c % 256 == 0 else 128))
    return max(1, min(sms // tiles, inner // TILE_K // MIN_SPLIT_K_TILES))


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


# each C entry's arguments before the stream: p a pointer, i an int
_ENTRIES = {
    "fused_gated_mlp_up": "ppppppiiii",
    "fused_gated_mlp_down": "piiippppi",
    "fused_gated_mlp_fwd": "ppppppiiiippppi",
}


@functools.cache
def _entry(name: str):
    fn = getattr(_build.cuda_library("fused_mlp"), name)
    fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int for k in _ENTRIES[name]]
    fn.argtypes += [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(m, c, inner, device, named):
    """Raise unless the kernels take these shapes and every ``(name, tensor,
    shape)`` is a contiguous, 16-byte aligned bf16 tensor on ``device``."""
    if not supported(c, inner) or m < 1 or c < 1 or inner < 1:
        raise ValueError(
            f"fused gated MLP kernel takes c % 128 == 0, inner % 256 == 0 and at least one row, "
            f"got m={m}, c={c}, inner={inner}"
        )
    for name, t, shape in named:
        if not t.is_cuda or t.device != device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous, 16-byte aligned and of shape {shape}, "
                f"got {tuple(t.shape)} with strides {t.stride()}"
            )


def _bias(name, bias, n, device):
    """``bias`` as the kernels read it: an fp32 copy, or None."""
    if bias is None:
        return None
    if bias.device != device or tuple(bias.shape) != (n,):
        raise ValueError(f"{name} must have shape ({n},) on {device}")
    return bias.float().contiguous()


def _up_args(x2, w_act, b_act, w_gate, b_gate, act):
    """F-up's C arguments for checked inputs, its output ``a`` (new) the
    sixth: x, w_act, b_act, w_gate, b_gate, a, m, c, inner, act."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}, expected one of {ACTS}")
    m, c = x2.shape
    inner = w_act.shape[0]
    _check(m, c, inner, x2.device, (("x", x2, (m, c)), ("w_act", w_act, (inner, c)),
                                    ("w_gate", w_gate, (inner, c))))
    a = torch.empty(m, inner, device=x2.device, dtype=torch.bfloat16)
    return [x2, w_act, _bias("b_act", b_act, inner, x2.device), w_gate,
            _bias("b_gate", b_gate, inner, x2.device), a, m, c, inner, ACTS.index(act)]


def _down_args(a, w_down, b_down):
    """F-down's C arguments for checked inputs, its output (new) the
    seventh: a, m, c, inner, w_down, b_down, out, partial, splits."""
    m, inner = a.shape
    c = w_down.shape[0]
    _check(m, c, inner, a.device, (("a", a, (m, inner)), ("w_down", w_down, (c, inner))))
    splits = down_splits(m, c, inner, _build.sm_count(a.device))
    out = torch.empty(m, c, device=a.device, dtype=torch.bfloat16)
    partial = torch.empty(splits, m, c, device=a.device) if splits > 1 else None
    return [a, m, c, inner, w_down, _bias("b_down", b_down, c, a.device), out, partial, splits]


def _launch(name, device, args):
    """Call C entry ``name`` on the current stream (tensors as their
    addresses) and raise on its error."""
    with torch.cuda.device(device):
        err = _entry(name)(
            *(t.data_ptr() if isinstance(t, torch.Tensor) else t for t in args),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def gated_up(x2, w_act, w_gate, b_act=None, b_gate=None, act="silu"):
    """F-up alone: ``a = bf16(act(x2 w_act^T + b_act) * (x2 w_gate^T +
    b_gate))`` for x2 (M, C); the plain version for CPU tensors."""
    if not x2.is_cuda:
        return gated_up_reference(x2, w_act, w_gate, b_act, b_gate, act)
    args = _up_args(x2, w_act, b_act, w_gate, b_gate, act)
    _launch("fused_gated_mlp_up", x2.device, args)
    gated_up.launches += 1
    return args[5]


def gated_down(a, w_down, b_down=None):
    """F-down alone (split over inner where :func:`down_splits` says):
    ``bf16(a w_down^T + b_down)`` for a (M, inner); the plain version for
    CPU tensors."""
    if not a.is_cuda:
        return gated_down_reference(a, w_down, b_down)
    args = _down_args(a, w_down, b_down)
    _launch("fused_gated_mlp_down", a.device, args)
    gated_down.launches += 1
    return args[6]


def _forward(x2, w_act, b_act, w_gate, b_gate, w_down, b_down, act):
    """x2 (M, C) -> (M, C): F-up then F-down in one C call for CUDA
    tensors, else the plain version."""
    if not x2.is_cuda:
        return gated_mlp_reference(x2, w_act, w_gate, w_down, b_act, b_gate, b_down, act)
    up = _up_args(x2, w_act, b_act, w_gate, b_gate, act)
    down = _down_args(up[5], w_down, b_down)
    # the whole call's C entry takes F-up's arguments, then F-down's past
    # (a, m, c, inner)
    _launch("fused_gated_mlp_fwd", x2.device, up + down[4:])
    gated_mlp.launches += 1
    return down[6]


class _GatedMLP(torch.autograd.Function):
    """The forward is :func:`_forward`; the backward differentiates the
    plain formula in the inputs' dtype (the JAX ``_gated_ref``), from the
    saved inputs."""

    @staticmethod
    def forward(ctx, x2, w_act, b_act, w_gate, b_gate, w_down, b_down, act, saved):
        ctx.save_for_backward(x2, w_act, b_act, w_gate, b_gate, w_down, b_down)
        ctx.act = act
        if saved is not None:  # a checkpointed region's recomputation
            return saved.detach()
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
            None,
        )


def _apply(x, w_act, b_act, w_gate, b_gate, w_down, b_down, act):
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    tensors = (x2, w_act, b_act, w_gate, b_gate, w_down, b_down)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        out = saved_output(lambda saved: _GatedMLP.apply(*tensors, act, saved))
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
gated_up.launches = 0
gated_down.launches = 0
