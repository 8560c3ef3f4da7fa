"""Layer set of the port (``vision_ft_tpu/nn/core.py`` counterpart).

Dense or quantized weights with optional LoRA / LoHa adapters, and the
gradient checkpointing helpers (``remat_layer``, ``set_remat_saves``,
``save_name``). Parameter names and shapes are the JAX package's, so a
module's ``state_dict()`` keys equal ``nn.core.flatten_params`` of the JAX
module's params:

  - Linear weight: (out_features, in_features) (+ bias (out,)); a
    quantized weight (``modules/quant``) is a child module ``weight``
    (:class:`QuantizedWeight`) whose buffers are the leaves ``packed`` /
    ``absmax`` / ``code`` / ``_meta`` / ``split`` (4-bit) or ``data`` /
    ``scale`` / ``SCB`` / ``shift`` / ``w8a8`` (int8, int4), or a tensor
    of an fp8 dtype. :func:`set_nf4_route` picks how a packed 4-bit weight
    is multiplied.
  - Conv2d weight: (out_ch, in_ch, kh, kw) (OIHW)
  - norm scales/offsets: ``weight``/``bias`` (``RMSNorm``: ``weight`` only)
  - adapters on a Linear or Conv2d (kohya layout): ``lora_down.weight``,
    ``lora_up.weight`` (+ ``lora_up.bias``) and the ``alpha`` buffer, or
    ``hada_w1_a`` / ``hada_w1_b`` / ``hada_w2_a`` / ``hada_w2_b`` and
    ``alpha``. ``modules/peft`` attaches them; the layers apply them when
    present and enabled (``set_peft_enabled``).

Layout: ``Conv2d`` and ``GroupNorm`` take and return NHWC activations,
like the JAX package. Inside, the NHWC tensor is handed to PyTorch as an
NCHW view with channels-last strides, so no copy is made around a conv.

Random init goes through :func:`init_parameters_` with an explicit
``torch.Generator`` (the JAX ``init(key, dtype)`` counterpart); the
distributions are the JAX package's.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..ops import flash_attention
from ..ops.layer_norm import layer_norm, layer_norm_reference

ADAPTER_LEAF_NAMES = (
    "lora_down",
    "lora_up",
    "alpha",
    "hada_w1_a",
    "hada_w1_b",
    "hada_w2_a",
    "hada_w2_b",
)
_HADA_NAMES = ADAPTER_LEAF_NAMES[3:]

# -- gradient checkpointing ---------------------------------------------------

REMAT_SAVE_MODES = ("activations", "kernel", "none")
_remat_saves = "activations"

# the products the "activations" mode keeps: the base matmul or convolution
# of a Linear or Conv2d (F.linear reaches mm or addmm, F.conv2d convolution)
# called inside saved_products(), the producers of the JAX mode's tags
_SAVED_PRODUCTS = frozenset((
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.convolution.default,
))
_product_scopes = 0  # saved_products() depth


def set_remat_saves(mode: str) -> None:
    """What :func:`remat_layer` keeps across the forward/backward boundary
    besides a region's inputs (the JAX package's ``remat_saves``):

    - "activations" (default, as in the JAX package): the flash, fused and
      4-bit kernels' outputs, and the base products of the Linear and
      Conv2d layers that run inside :func:`saved_products`: the attention
      modules' q/k/v and out-projections (the JAX mode's ``flash_qkv``
      and the producers of ``res_stream``) and the resnet's first conv
      (``conv_out``'s), so the recomputation before the backward runs
      those GEMMs no more. Eager PyTorch cannot drop a producer from the
      recomputation, so the port keeps products, not the tagged tensors;
      the feed-forward (``ff_inner``) and the adapters' products are
      recomputed.
    - "kernel": the flash attention forward's (out, lse) only, so the
      recomputation does not launch that kernel again.
    - "none": nothing (full recomputation).

    The gradients are the same, bit for bit, in every mode; memory and
    launches differ."""
    global _remat_saves
    if mode not in REMAT_SAVE_MODES:
        raise ValueError(f"unknown remat_saves mode: {mode!r}")
    _remat_saves = mode


def remat_saves() -> str:
    return _remat_saves


def save_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` as a tensor the JAX package's "activations" policy keeps
    (its ``checkpoint_name``: "ff_inner", "res_stream", "conv_out"). It
    returns ``x`` itself, never a copy: the port's "activations" mode keeps
    the producers' products instead (:func:`saved_products`)."""
    return x


@contextlib.contextmanager
def saved_products():
    """Inside, the base product of every Linear and Conv2d is kept by a
    checkpointed region in the "activations" mode (a context and a
    decorator: the attention modules' forwards, the resnet's first conv)."""
    global _product_scopes
    _product_scopes += 1
    try:
        yield
    finally:
        _product_scopes -= 1


class _ProductTape(TorchDispatchMode):
    """While a marked layer computes its base product in a checkpointed
    region of the "activations" mode: in the first forward, each product's
    output is recorded (a detached alias); in the recomputation the same
    products, met in the same order, return the recorded outputs without
    running. Autograd above still records the product's own backward, so
    the gradients are those of the other modes, bit for bit. The
    recordings live on the region (``ops.flash_attention.kernel_saves``)."""

    def __init__(self, region):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _SAVED_PRODUCTS:
            return func(*args, **(kwargs or {}))
        region = self.region
        if region.mode == "record":
            out = func(*args, **(kwargs or {}))
            # an alias that shares the version counter, as checkpointing's own saves do
            with torch._C._SetExcludeDispatchKeyGuard(torch._C.DispatchKey.ADInplaceOrView, False):
                region.products.append((out.detach(), out._version))
            return out
        saved, version = region.products[region.product_position]
        region.product_position += 1
        if saved._version != version:
            raise RuntimeError("a product kept by remat_saves='activations' was changed in place")
        return saved


def _base_product(run):
    """``run()``, a layer's base product: kept by the "activations" mode
    when inside :func:`saved_products` and a checkpointed region."""
    region = flash_attention.current_region()
    if not _product_scopes or region is None or not region.outputs:
        return run()
    with _ProductTape(region):
        return run()


def remat_layer(fn: Callable) -> Callable:
    """Gradient-checkpoint ``fn``: its intermediates are dropped after the
    forward and recomputed before the backward, except what the mode of
    :func:`set_remat_saves` keeps. In the "kernel" mode the flash
    attention (out, lse) of the region are kept, so the forward attention
    kernel runs once; the recomputed q, k and v feed its backward. In the
    "activations" mode the marked products and the kernels' outputs are
    kept as well. ``fn`` takes and returns tensors (or None)."""

    def run(*args):
        context_fn = {
            "activations": functools.partial(flash_attention.kernel_saves, outputs=True),
            "kernel": flash_attention.kernel_saves,
        }.get(_remat_saves, noop_context_fn)
        # no dropout or other random op inside the port's layers: the RNG
        # state need not be carried to the recomputation
        return checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False, context_fn=context_fn
        )

    return run


_remat_group = 1


def set_remat_group(group: int) -> None:
    """Checkpoint uniform layer stacks (:func:`run_remat_stack`) in groups
    of ``group`` layers instead of one region per layer. The recomputation
    is the same either way (every layer once); what changes is memory: one
    saved boundary stream per group instead of per layer, against a
    backward working set of ``group`` layers' intermediates."""
    global _remat_group
    if group < 1:
        raise ValueError(f"remat group must be >= 1, got {group}")
    _remat_group = group


def remat_group() -> int:
    return _remat_group


def run_remat_stack(apply_fn: Callable, layers, carry, enabled: bool):
    """Run a uniform layer stack ``carry = apply_fn(layer, carry)``,
    checkpointed (:func:`remat_layer`) in groups of :func:`remat_group`
    layers when ``enabled``. With group 1 it is one region per layer. The
    JAX package's ``params_list`` argument has no counterpart: a layer
    holds its parameters."""
    layers = list(layers)
    if not enabled:
        for layer in layers:
            carry = apply_fn(layer, carry)
        return carry
    g = _remat_group
    for i in range(0, len(layers), g):

        def chunk(c, _sub=tuple(layers[i:i + g])):
            for layer in _sub:
                c = apply_fn(layer, c)
            return c

        carry = remat_layer(chunk)(carry)
    return carry


# -- quantized weights --------------------------------------------------------

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
NF4_ROUTES = ("fused", "stream", "dequant")
_nf4_route = "fused"


def set_nf4_route(route: str) -> None:
    """How a ``Linear`` multiplies by a packed 4-bit (NF4 / FP4) weight:

    - "fused" (default): the hand-written kernels of ``ops/nf4_matmul.py``;
      the weight stays packed in device memory, forward and backward.
    - "stream": ``ops/nf4_stream.py``, plain dequantization one panel of
      output rows at a time (split-layout weights only); its backward is
      the fused dx kernel where that takes the shape.
    - "dequant": plain dequantization of the whole weight into a matmul;
      the weight is dequantized again in the backward, not kept.

    A route takes a layer only where its shape contract holds (and, for
    the kernels on the card, only bf16 inputs); every other case takes
    "dequant", except a bf16 input on the card to a layer outside the
    "fused" kernels' shapes, which raises naming the layer. Results agree
    within rounding; time and memory differ."""
    global _nf4_route
    if route not in NF4_ROUTES:
        raise ValueError(f"unknown nf4 route: {route!r}")
    _nf4_route = route


def nf4_route() -> str:
    return _nf4_route


class QuantizedWeight(nn.Module):
    """Holder of the leaves of one quantized weight, as buffers: the
    ``weight`` child of a quantized ``Linear``. Every leaf keeps its own
    dtype (uint8 codes, fp32 scales and codebook, int8 data) whatever
    dtype the model around it is cast to; device moves apply as usual."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, leaf in leaves.items():
            self.register_buffer(name, leaf)

    def _apply(self, fn, recurse=True):
        for name, leaf in self._buffers.items():
            moved = fn(leaf)
            self._buffers[name] = moved if moved.dtype == leaf.dtype else leaf.to(moved.device)
        return self

    @property
    def device(self) -> torch.device:
        return next(iter(self._buffers.values())).device


def weight_device(layer: nn.Module) -> torch.device:
    """The device of a layer's weight, dense or quantized (the meta device
    for a weight that is not materialized yet)."""
    return layer.weight.device


class _DequantLinear(torch.autograd.Function):
    """x @ W^T for a weight that ``dequantize()`` rebuilds: the backward
    calls it again, so no dense copy of the weight lives from the forward
    to the backward. Differentiable in x only (the base is frozen)."""

    @staticmethod
    def forward(ctx, x, dequantize):
        ctx.dequantize = dequantize
        return F.linear(x, dequantize(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        return torch.matmul(dy, ctx.dequantize(dy.dtype)), None


def _w8a8_linear(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8_w8a8: dynamic per-token symmetric int8 activations, an exact
    s8 x s8 -> s32 product, fp32 rescale (weight scale per output channel,
    (O, 1)). On the CPU the product is an int32 matmul; on the card
    ``torch._int_mm`` where it takes the shape (more than 16 rows, k and n
    multiples of 8), else an fp64 matmul, which is exact for these sums."""
    xf = x.float()
    x_scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    x_q = torch.round(xf / x_scale).clamp(-127, 127).to(torch.int8)
    rows = x_q.reshape(-1, x_q.shape[-1])
    n, k = data.shape
    if not x.is_cuda:
        y = torch.matmul(rows.int(), data.int().t())
    elif rows.shape[0] > 16 and k % 8 == 0 and n % 8 == 0:
        y = torch._int_mm(rows.contiguous(), data.t())
    else:
        y = torch.matmul(rows.double(), data.double().t())
    y = y.reshape(*x.shape[:-1], n)
    return (y.float() * (x_scale * scale[:, 0])).to(x.dtype)


# -- adapters -----------------------------------------------------------------

_peft_enabled = True


def set_peft_enabled(enabled: bool) -> None:
    """Global toggle for adapter application: with it off, a layer that
    carries an adapter computes its base output only."""
    global _peft_enabled
    _peft_enabled = enabled


def peft_enabled() -> bool:
    return _peft_enabled


class AdapterWeights(nn.Module):
    """Holder of one adapter matrix (keys ``weight`` and, optionally,
    ``bias``): the ``lora_down`` / ``lora_up`` children of an adapted layer.
    It is not a layer: the adapted layer applies it."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None


def is_adapter_key(key: str) -> bool:
    return any(part in ADAPTER_LEAF_NAMES for part in key.split("."))


def attach_adapter(layer: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Put adapter tensors, keyed relative to the layer (``lora_down.weight``,
    ``lora_up.weight``, ``lora_up.bias``, ``alpha``, ``hada_*``), on a
    ``Linear`` or ``Conv2d``, replacing any adapter it had. ``alpha``
    becomes a buffer, the rest parameters."""
    if not isinstance(layer, (Linear, Conv2d)):
        raise TypeError(f"adapters go on Linear or Conv2d, not {type(layer).__name__}")
    known = {"lora_down.weight", "lora_up.weight", "lora_up.bias", "alpha", *_HADA_NAMES}
    unknown = sorted(set(tensors) - known)
    if unknown:
        raise KeyError(f"not adapter tensors: {unknown}")
    lora = "lora_down.weight" in tensors and "lora_up.weight" in tensors
    loha = all(name in tensors for name in _HADA_NAMES)
    if lora == loha or "alpha" not in tensors:
        raise KeyError(f"need alpha and either lora_down/lora_up or hada_* tensors, got {sorted(tensors)}")
    if loha and not isinstance(layer, Linear):
        raise TypeError("LoHa adapters go on Linear layers only")
    for name in ("lora_down", "lora_up", "alpha", *_HADA_NAMES):
        layer._modules.pop(name, None)
        layer._parameters.pop(name, None)
        layer._buffers.pop(name, None)
    if lora:
        layer.lora_down = AdapterWeights(tensors["lora_down.weight"])
        layer.lora_up = AdapterWeights(tensors["lora_up.weight"], tensors.get("lora_up.bias"))
    else:
        for name in _HADA_NAMES:
            layer.register_parameter(name, nn.Parameter(tensors[name]))
    layer.register_buffer("alpha", tensors["alpha"])


def attach_adapters_from_state(module: nn.Module, flat: Mapping[str, torch.Tensor]) -> None:
    """Attach the adapters found in a flat state dict (full keys) to the
    layers of ``module`` they name, each on its layer's device unless that
    is the meta device. Raises ``KeyError`` where an adapter key has no
    Linear/Conv2d under it."""
    layers = dict(module.named_modules())
    grouped: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        if not is_adapter_key(key):
            continue
        parts = key.split(".")
        cut = next(i for i, part in enumerate(parts) if part in ADAPTER_LEAF_NAMES)
        root, leaf = ".".join(parts[:cut]), ".".join(parts[cut:])
        if not isinstance(layers.get(root), (Linear, Conv2d)):
            raise KeyError(f"adapter weight {key!r} has no base layer {root!r}")
        device = weight_device(layers[root])
        value = torch.as_tensor(value)
        grouped.setdefault(root, {})[leaf] = value if device.type == "meta" else value.to(device)
    for root, tensors in grouped.items():
        attach_adapter(layers[root], tensors)


def _adapter_scale(layer: nn.Module, rank: int, dtype: torch.dtype) -> float | torch.Tensor:
    """alpha / rank rounded to ``dtype``, as a host number: a 0-dim tensor
    as the factor sends every adapted layer's delta through PyTorch's
    unvectorized broadcasting kernel. The buffer is read once, and again
    when it has been replaced or written to. An ``alpha`` that trains (a
    workload's extra-trainable filter reaches it, as the JAX package's
    does) gives the 0-dim tensor, so that its gradient flows."""
    alpha = layer.alpha
    if alpha.requires_grad:
        return (alpha.float() / rank).to(dtype)
    version = 0 if alpha.is_inference() else alpha._version
    cached = layer.__dict__.get("_adapter_scale_cache")
    if cached is None or cached[0] is not alpha or cached[1:3] != (version, dtype):
        value = (alpha.detach().float() / rank).to(dtype).item()
        cached = layer.__dict__["_adapter_scale_cache"] = (alpha, version, dtype, value)
    return cached[3]


def _linear_adapter_delta(layer: "Linear", x: torch.Tensor) -> Optional[torch.Tensor]:
    """LoRA / LoHa delta of an adapted Linear, or None."""
    if not _peft_enabled:
        return None
    if "lora_down" in layer._modules:
        down_w, up = layer.lora_down.weight, layer.lora_up
        h = F.linear(F.linear(x, down_w.to(x.dtype)), up.weight.to(x.dtype))
        if up.bias is not None:
            h = h + up.bias.to(x.dtype)
        return h * _adapter_scale(layer, down_w.shape[0], x.dtype)
    if "hada_w1_a" in layer._parameters:
        w1 = layer.hada_w1_a.float() @ layer.hada_w1_b.float()
        w2 = layer.hada_w2_a.float() @ layer.hada_w2_b.float()
        weight = (w1 * w2).to(x.dtype)  # (in, out)
        return (x @ weight) * _adapter_scale(layer, layer.hada_w1_a.shape[1], x.dtype)
    return None


class _LoRAConcatDot(torch.autograd.Function):
    """``x2 @ w^T + ((x2 @ down^T) * scale) @ up^T`` as one matmul (the JAX
    ``_lora_concat_dot``): the rank-r hidden is concatenated onto x and
    ``up`` onto ``w``, so one (M, K+r) @ (K+r, N) product writes the output
    once. The backward forms no (N, K+r) weight gradient: the base weight
    is frozen (a caller whose base trains takes the separate route). A
    ``scale`` that is a tensor (a trainable alpha) gets its gradient, where
    the JAX custom VJP returns a zero."""

    @staticmethod
    def forward(ctx, x2, w, down_w, up_w, scale):
        hs = x2 @ down_w.t()  # (M, r), unscaled
        h = hs * scale
        y = torch.cat([x2, h], dim=1) @ torch.cat([w, up_w], dim=1).t()
        ctx.save_for_backward(x2, w, down_w, up_w, hs, scale if torch.is_tensor(scale) else None)
        ctx.scale = scale if not torch.is_tensor(scale) else None
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w, down_w, up_w, hs, scale_t = ctx.saved_tensors
        scale = scale_t if scale_t is not None else ctx.scale
        dy = dy.to(x2.dtype)
        dh = dy @ up_w  # (M, r)
        dhs = dh * scale
        dx = dy @ w + dhs @ down_w
        d_down = dhs.t() @ x2  # (r, K)
        d_up = dy.t() @ (hs * scale)  # (N, r)
        d_scale = None
        if scale_t is not None and ctx.needs_input_grad[4]:
            d_scale = (dh.float() * hs.float()).sum().to(scale_t.dtype).reshape(scale_t.shape)
        return dx, None, d_down, d_up, d_scale


def _lora_concat_applies(layer: "Linear") -> bool:
    """``VFT_LORA_CONCAT=1`` folds a dense Linear's LoRA into its base
    matmul, where the JAX package does (LoRA without an up bias), and
    where the base weight is frozen."""
    return (
        _peft_enabled
        and "lora_down" in layer._modules
        and layer.lora_up.bias is None
        and not layer.is_quantized
        and not layer.weight.requires_grad
        and os.environ.get("VFT_LORA_CONCAT", "0") == "1"
    )


def _lora_concat_linear(layer: "Linear", x: torch.Tensor) -> torch.Tensor:
    down_w = layer.lora_down.weight
    scale = _adapter_scale(layer, down_w.shape[0], x.dtype)
    x2 = x.reshape(-1, layer.in_features)
    y = _LoRAConcatDot.apply(
        x2, layer.weight.to(x.dtype), down_w.to(x.dtype), layer.lora_up.weight.to(x.dtype), scale
    ).reshape(*x.shape[:-1], layer.out_features)
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    return y


def _conv_adapter_delta(layer: "Conv2d", x_nchw: torch.Tensor) -> Optional[torch.Tensor]:
    """LoRA delta of an adapted Conv2d (kohya conv-LoRA: down = a conv of
    the layer's own geometry to rank channels, up = a 1x1 conv), or None.
    Takes and returns the NCHW view the layer hands to PyTorch."""
    if not _peft_enabled or "lora_down" not in layer._modules:
        return None
    down_w, up = layer.lora_down.weight.to(x_nchw.dtype), layer.lora_up
    h = F.conv2d(x_nchw, down_w, None, stride=layer.stride, padding=layer.padding)
    h = F.conv2d(h, up.weight.to(x_nchw.dtype), None if up.bias is None else up.bias.to(x_nchw.dtype))
    return h * _adapter_scale(layer, down_w.shape[0], x_nchw.dtype)



class Linear(nn.Module):
    quantized_name = ""  # the layer's path, given with a quantized weight

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)), as the JAX init;
        # a quantized weight is left as it is
        bound = 1.0 / math.sqrt(self.in_features)
        if not self.is_quantized:
            self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    @property
    def is_quantized(self) -> bool:
        weight = self.weight
        return isinstance(weight, QuantizedWeight) or weight.dtype in FP8_DTYPES

    def set_quantized_weight(self, quantized, name: str = "") -> None:
        """Replace the weight by quantized leaves (a mapping of tensors, as
        ``modules.quant.quantize_weight`` returns it) or an fp8 tensor.
        ``name``, the layer's path in its model, names it in errors."""
        self.quantized_name = name
        if isinstance(quantized, Mapping):
            self._parameters.pop("weight", None)
            self._modules.pop("weight", None)
            self.weight = QuantizedWeight(quantized)
        elif quantized.dtype in FP8_DTYPES:
            self._modules.pop("weight", None)
            self.weight = nn.Parameter(quantized, requires_grad=False)
        else:
            raise TypeError(f"not a quantized weight: {quantized.dtype}")

    def _apply(self, fn, recurse=True):
        # an fp8 weight keeps its dtype when the model around it is cast
        weight = self._parameters.get("weight")
        kept = weight.data if weight is not None and weight.dtype in FP8_DTYPES else None
        super()._apply(fn, recurse)
        if kept is not None and self.weight.dtype != kept.dtype:
            self.weight = nn.Parameter(kept.to(self.weight.device), requires_grad=False)
        return self

    def _quantized_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x @ W^T for a quantized weight, without bias or adapter, in the
        JAX ``Linear``'s order of branches: w8a8, then for a packed 4-bit
        weight the route of :func:`set_nf4_route` where its contract holds,
        then plain dequantization into a matmul."""
        from ..modules.quant.functional import dequantize_weight

        w = self.weight

        shape = (self.out_features, self.in_features)
        leaves = w._buffers if isinstance(w, QuantizedWeight) else {}
        if "w8a8" in leaves:
            return _w8a8_linear(x, leaves["data"], leaves["scale"])
        if "packed" in leaves and _nf4_route != "dequant":
            from ..modules.quant.nf4 import infer_blocksize
            from ..ops import nf4_matmul, nf4_stream

            n, k = shape
            blocksize = infer_blocksize(n * k, leaves["absmax"].shape[0])
            args = (x, leaves["packed"], leaves["code"], leaves["absmax"], shape, blocksize)
            # the kernels take bf16 on the card; on the CPU the wrappers
            # take their plain versions for any dtype
            kernel_input = not x.is_cuda or x.dtype == torch.bfloat16
            if _nf4_route == "stream" and "split" in leaves and nf4_stream.supports(n, k, blocksize):
                return nf4_stream.nf4_stream_matmul(*args)
            if _nf4_route == "fused" and kernel_input:
                if nf4_matmul.supports(x.numel() // k, k, n, blocksize):
                    return nf4_matmul.nf4_matmul(*args, split="split" in leaves)
                if x.is_cuda:
                    raise ValueError(
                        f"the 4-bit matmul kernel does not take the Linear "
                        f"{self.quantized_name!r} ({k} -> {n}, blocksize "
                        f"{blocksize}): leave it unquantized or set_nf4_route('dequant')"
                    )

        def dequantize(dtype):
            return dequantize_weight(w, dtype=dtype, shape=shape)

        if torch.is_grad_enabled() and x.requires_grad:
            return _DequantLinear.apply(x, dequantize)
        return F.linear(x, dequantize(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _lora_concat_applies(self):
            return _base_product(lambda: _lora_concat_linear(self, x))
        if self.is_quantized:
            # kernel D keeps its own output (ops.flash_attention.saved_output)
            y = self._quantized_matmul(x)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)
        else:
            y = _base_product(lambda: F.linear(x, self.weight, self.bias))
        delta = _linear_adapter_delta(self, x)
        return y if delta is None else y + delta


class Conv2d(nn.Module):
    """2-D convolution over NHWC activations with OIHW-stored kernels."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_channels * self.kernel_size**2)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, H, W, C) -> NCHW view with channels-last strides -> NHWC
        x = x.permute(0, 3, 1, 2)
        y = _base_product(
            lambda: F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)
        )
        delta = _conv_adapter_delta(self, x)
        if delta is not None:
            y = y + delta
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics.

    bf16 inputs on the card with an affine and C % 128 == 0 go through
    the fused LayerNorm kernel (``ops/layer_norm.py``), the rule of the
    JAX ``LayerNorm`` with ``is_cuda`` in place of the TPU check; every
    other input takes the plain formula.
    """

    def __init__(
        self, dim: int, eps: float = 1e-5, elementwise_affine: bool = True, bias: bool = True
    ):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim)) if elementwise_affine else None
        self.bias = (
            nn.Parameter(torch.empty(dim)) if bias and elementwise_affine else None
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (
            x.is_cuda
            and x.dtype == torch.bfloat16
            and self.weight is not None
            and self.dim % 128 == 0
            and x.ndim >= 2
        ):
            return layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm_reference(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis, computed in fp32, with an optional
    scale (key ``weight``)."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = True):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim)) if elementwise_affine else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            h = h * self.weight.float()
        return h.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC activations (statistics in fp32)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_channels)) if affine else None
        self.bias = nn.Parameter(torch.empty(num_channels)) if affine else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(
            x.permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias, self.eps
        )
        return y.permute(0, 2, 3, 1)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


_LEAVES = (Linear, Conv2d, LayerNorm, RMSNorm, GroupNorm, Embedding)


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in place, on the device and in the dtype the module's
    parameters already have. Every parameter of the port belongs to one
    of the leaf layers above, or is held by a module that draws its own
    (a ``reset_parameters(generator)`` method for the parameters it holds
    itself, such as a learned positional table); a parameter that does not
    is an error. Adapters on a layer and quantized weights are left as they
    are."""
    covered = set()
    for m in module.modules():
        if isinstance(m, _LEAVES):
            m.reset_parameters(generator)
            covered.update(id(p) for p in m.parameters(recurse=True))
        elif callable(getattr(m, "reset_parameters", None)):
            m.reset_parameters(generator)
            covered.update(id(p) for p in m.parameters(recurse=False))
    stray = [n for n, p in module.named_parameters() if id(p) not in covered]
    if stray:
        raise TypeError(f"parameters outside the port's leaf layers: {stray[:5]}")
    return module
