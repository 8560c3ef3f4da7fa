"""Quantization as module transformations
(``vision_ft_tpu/modules/quant/functional.py`` counterpart).

A quantized ``Linear`` keeps its weight as a child module named ``weight``
(``nn.core.QuantizedWeight``) whose buffers are the leaves of the JAX
package's quantized subtree, so ``state_dict()`` keys stay
``X.weight.packed``, ``X.weight.absmax``, ...; an fp8 weight stays a tensor
of an fp8 dtype. ``nn.core.Linear`` applies them (QLoRA = this + LoRA
adapters side by side). Quantization runs in torch on the device of the
weight, so a whole model is quantized on the card, layer by layer.

Supported types:
  bnb_nf4 / bnb_fp4  bnb-packed 4-bit (bit-compatible load & save)
  ao_nf4             same math as bnb_nf4
  bnb_int8           per-row absmax int8 (LLM.int8 weight format)
  quanto_int8        quanto qint8 (weight._data x weight._scale)
  quanto_int4        quanto QBitsTensor affine uint4 (row-pair nibble
                     packing, dq = q*scale - shift)
  fp8_e4m3fn / ao_fp8  fp8 dtype cast
  int8_w8a8          W8A8 compute-in-int8: per-output-channel symmetric
                     int8 weights + dynamic per-token int8 activations,
                     s8 x s8 -> s32 product, fp32 rescale. Inference-path
                     quantization (round has no gradient).
"""

from __future__ import annotations

import logging
from typing import Any, Literal, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ...nn.core import FP8_DTYPES, Linear, QuantizedWeight
from ...utils.state_dict import RegexMatch, get_target_keys
from .nf4 import (
    dequantize_4bit,
    infer_blocksize,
    json_to_tensor,
    parse_quant_state,
    quantize_4bit,
    tensor_to_json,
)

QUANT_TYPE = Literal[
    "fp8_e4m3fn",
    "bnb_int8",
    "bnb_fp4",
    "bnb_nf4",
    "quanto_int4",
    "quanto_int8",
    "ao_nf4",
    "ao_fp8",
    "int8_w8a8",
]

logger = logging.getLogger(__name__)

_ALL_TYPES = (
    "fp8_e4m3fn", "bnb_int8", "bnb_fp4", "bnb_nf4",
    "quanto_int4", "quanto_int8", "ao_nf4", "ao_fp8",
    "int8_w8a8",
)


def validate_quant_type(quant_type: str) -> None:
    if quant_type not in _ALL_TYPES:
        raise ValueError(f"Unknown quant_type: {quant_type}")


# ---------------------------------------------------------------------------
# quantized-weight leaves: construction / application


def _per_row_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (data, scale (out, 1))."""
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    data = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return data, scale


@torch.no_grad()
def quantize_weight(weight: torch.Tensor, quant_type: QUANT_TYPE) -> Any:
    """fp tensor -> quantized leaves (a dict of tensors, or an fp8 tensor),
    on the weight's device."""
    validate_quant_type(quant_type)
    w = torch.as_tensor(weight).detach().float()
    if quant_type in ("bnb_nf4", "bnb_fp4", "ao_nf4"):
        qt = "nf4" if quant_type.endswith("nf4") else "fp4"
        packed, state = quantize_4bit(w, quant_type=qt)
        parsed = parse_quant_state(state)
        sub = {
            "code": parsed["code"],
            "absmax": parsed["absmax"],
            "_meta": _encode_meta(qt, w.shape, parsed["blocksize"], w.device),
        }
        sub.update(_device_packed_layout(packed, tuple(w.shape)))
        return sub
    if quant_type == "bnb_int8":
        absmax = w.abs().amax(dim=1).clamp_min(1e-12)
        data = torch.round(w / absmax[:, None] * 127.0).clamp(-127, 127).to(torch.int8)
        return {"data": data, "SCB": absmax}
    if quant_type == "quanto_int8":
        data, scale = _per_row_int8(w)
        return {"data": data, "scale": scale}
    if quant_type == "int8_w8a8":
        # same per-output-channel symmetric storage as quanto_int8; the
        # "w8a8" marker routes nn.core.Linear onto the compute-in-int8
        # path instead of dequantize-into-a-matmul
        data, scale = _per_row_int8(w)
        return {
            "data": data,
            "scale": scale,
            "w8a8": torch.ones((), dtype=torch.int8, device=w.device),
        }
    if quant_type == "quanto_int4":
        # affine per-output-channel uint4 in optimum-quanto's QBitsTensor
        # layout: shift = -rmin in weight units, q = round((w+shift)/scale)
        # in [0,15], dq = q*scale - shift. PackedTensor packs CONTIGUOUS
        # row halves: rows [0, R/2) in the low nibble, rows [R/2, R) in the
        # high nibble.
        if w.ndim != 2 or w.shape[0] % 2:
            raise ValueError("int4 needs a 2-D weight with even out_features")
        rmin = w.amin(dim=1, keepdim=True)
        rmax = w.amax(dim=1, keepdim=True)
        scale = ((rmax - rmin) / 15.0).clamp_min(1e-12)
        shift = -rmin
        q = torch.round((w + shift) / scale).clamp(0, 15).to(torch.uint8)
        half = w.shape[0] // 2
        return {"data": q[:half] | (q[half:] << 4), "scale": scale, "shift": shift}
    if quant_type in ("fp8_e4m3fn", "ao_fp8"):
        return w.to(torch.float8_e4m3fn)
    raise NotImplementedError(f"{quant_type} quantization is not implemented")


def _device_packed_layout(packed: torch.Tensor, shape) -> dict[str, torch.Tensor]:
    """bnb disk bytes -> the device packed layout.

    2-D even-k weights repack to the SPLIT layout (hi nibbles = columns
    [0, k/2), lo = [k/2, k)), marked by a ``split`` leaf, as the JAX
    package's device trees carry them; the on-disk format stays bnb
    (``quantize_state_dict`` is unaffected).
    """
    if len(shape) == 2 and shape[1] % 2 == 0:
        from ...ops.nf4_matmul import to_split_layout

        return {
            "packed": to_split_layout(packed, tuple(shape)),
            "split": torch.ones((), dtype=torch.uint8, device=packed.device),
        }
    return {"packed": packed}


def _encode_meta(quant_type: str, shape, blocksize: int, device=None) -> torch.Tensor:
    return json_to_tensor(
        {"quant_type": quant_type, "shape": list(shape), "blocksize": blocksize}, device
    )


def _decode_meta(meta: torch.Tensor) -> dict:
    return tensor_to_json(meta)


def _leaves(weight: Any) -> Mapping[str, torch.Tensor] | None:
    """The named leaves of a quantized weight, or None for a plain tensor."""
    if isinstance(weight, QuantizedWeight):
        return weight._buffers
    return weight if isinstance(weight, Mapping) else None


def is_quantized_weight(weight: Any) -> bool:
    if _leaves(weight) is not None:
        return True
    return getattr(weight, "dtype", None) in FP8_DTYPES


def dequantize_weight(weight: Any, dtype: torch.dtype = torch.float32, shape=None) -> torch.Tensor:
    """Quantized weight (a ``QuantizedWeight``, a dict of leaves or an fp8
    tensor) -> fp tensor. ``shape`` spares the 4-bit layouts the decoding
    of their host-side ``_meta`` leaf; ``Linear`` passes its own
    (out_features, in_features)."""
    leaves = _leaves(weight)
    if leaves is None:
        return weight.to(dtype)  # fp8 tensor
    if "packed" in leaves:
        if shape is None:
            shape = tuple(_decode_meta(leaves["_meta"])["shape"])
        numel = int(np.prod(shape))
        blocksize = infer_blocksize(numel, int(leaves["absmax"].shape[0]))
        return dequantize_4bit(
            leaves["packed"], leaves["code"], leaves["absmax"],
            tuple(shape), blocksize, dtype, split="split" in leaves,
        )
    if "SCB" in leaves:
        return (leaves["data"].float() * leaves["SCB"][:, None] / 127.0).to(dtype)
    if "shift" in leaves:
        # quanto qint4: contiguous-half nibbles (rows [0,R/2) low, [R/2,R)
        # high), dq = q*scale - shift. Two QBitsTensor layouts exist:
        #   ungrouped: rows are output channels, scale/shift (out, 1)
        #   grouped (the qint4 default, group_size<=128): the weight was
        #     reshaped row-major to (numel/gs, gs) before quantization, so
        #     scale/shift are per-group rows and dq is reshaped back to the
        #     logical (out, in).
        packed = leaves["data"]
        q = torch.cat([(packed & 0xF).float(), (packed >> 4).float()], dim=0)
        dq = q * leaves["scale"].float() - leaves["shift"].float()
        if shape is not None and tuple(dq.shape) != tuple(shape):
            if dq.numel() != int(np.prod(shape)):
                raise ValueError(
                    f"quanto int4 subtree of {tuple(dq.shape)} cannot reshape to "
                    f"weight shape {tuple(shape)} — unsupported QBitsTensor layout"
                )
            dq = dq.reshape(tuple(shape))
        return dq.to(dtype)
    if "scale" in leaves:
        return (leaves["data"].float() * leaves["scale"]).to(dtype)
    raise ValueError(f"Unknown quantized weight layout: {list(leaves)}")


# ---------------------------------------------------------------------------
# module transformation (replace / inplace are one operation here)


@torch.no_grad()
def quantize_params(
    module: nn.Module,
    quant_type: QUANT_TYPE,
    include_keys: Sequence[str | RegexMatch],
    exclude_keys: Sequence[str | RegexMatch] = (),
) -> nn.Module:
    """Quantize the targeted ``Linear`` weights of ``module`` in place, each
    on its own device, one layer at a time (the dense weight of a layer is
    released before the next is quantized). A layer that is quantized
    already is left as it is. Returns the module."""
    validate_quant_type(quant_type)
    layers = {
        name: m for name, m in module.named_modules()
        if isinstance(m, Linear) and not is_quantized_weight(m.weight)
    }
    for name in sorted(get_target_keys(include_keys, exclude_keys, list(layers))):
        layer = layers[name]
        if layer.weight.is_meta:
            raise ValueError(f"{name}: cannot quantize a weight on the meta device")
        layer.set_quantized_weight(quantize_weight(layer.weight, quant_type), name)
    return module


# keep the reference API names
replace_to_quant_linear = quantize_params
quantize_inplace = quantize_params


# ---------------------------------------------------------------------------
# prequantized checkpoints


def collect_children_dict(
    prefix: str, state_dict: Mapping[str, Any], remove_prefix: bool = True
) -> dict[str, Any]:
    return {
        (k[len(prefix):] if remove_prefix else k): v
        for k, v in state_dict.items()
        if k.startswith(prefix)
    }


def get_quant_type_from_children_dict(children: Mapping[str, Any]) -> QUANT_TYPE:
    for key, tensor in children.items():
        if "quant_state" in key:
            qt = key[len("quant_state.bitsandbytes__"):]
            if qt == "nf4":
                return "bnb_nf4"
            if qt == "fp4":
                return "bnb_fp4"
        elif "weight_format" in key:
            return "bnb_int8"
        elif "w8a8" in key:
            return "int8_w8a8"
        elif "_data" in key:
            if tensor.dtype == torch.int8:
                return "quanto_int8"
            return "quanto_int4"
    raise ValueError("quant_type not found")


def convert_prequantized_state_dict(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Group bnb/quanto quant-state keys (``X.weight.absmax`` etc.) into the
    ``X.weight.<leaf>`` keys a quantized ``Linear`` holds."""
    roots = set()
    for key in state_dict:
        for marker in (".weight.quant_state.bitsandbytes__", ".weight.absmax",
                       ".weight._data", ".weight._shift", ".weight.SCB",
                       ".weight.w8a8"):
            idx = key.find(marker)
            if idx >= 0:
                roots.add(key[: idx + len(".weight")])
    if not roots:
        return dict(state_dict)

    out: dict[str, Any] = {}
    consumed: set[str] = set()
    for root in sorted(roots):
        children = collect_children_dict(f"{root}.", state_dict)
        consumed.update(f"{root}.{k}" for k in children)
        consumed.add(root)
        quant_type = get_quant_type_from_children_dict(children)
        if quant_type in ("bnb_nf4", "bnb_fp4"):
            parsed = parse_quant_state(children)
            packed = torch.as_tensor(state_dict[root])
            for name, leaf in _device_packed_layout(packed, parsed["shape"]).items():
                out[f"{root}.{name}"] = leaf
            out[f"{root}.code"] = parsed["code"]
            out[f"{root}.absmax"] = parsed["absmax"]
            out[f"{root}._meta"] = _encode_meta(
                parsed["quant_type"], parsed["shape"], parsed["blocksize"], packed.device
            )
        elif quant_type == "bnb_int8":
            out[f"{root}.data"] = state_dict[root]
            out[f"{root}.SCB"] = children["SCB"]
        elif quant_type == "int8_w8a8":
            out[f"{root}.data"] = children["data"]
            out[f"{root}.scale"] = children["scale"]
            out[f"{root}.w8a8"] = children["w8a8"]
        elif quant_type == "quanto_int8":
            out[f"{root}.data"] = children["_data"]
            out[f"{root}.scale"] = children["_scale"]
        elif quant_type == "quanto_int4":
            out[f"{root}.data"] = torch.as_tensor(children["_data"]).to(torch.uint8)
            out[f"{root}.scale"] = children["_scale"]
            out[f"{root}.shift"] = children["_shift"]
        else:
            raise NotImplementedError(f"{quant_type} checkpoints are not supported yet")
    for key, value in state_dict.items():
        if key not in consumed:
            out[key] = value
    return out


@torch.no_grad()
def quantize_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    quant_type: QUANT_TYPE,
    include_keys: Sequence[str | RegexMatch],
    exclude_keys: Sequence[str | RegexMatch] = (),
) -> dict[str, torch.Tensor]:
    """Offline checkpoint quantizer in bnb's on-disk format."""
    if quant_type not in ("bnb_nf4", "bnb_fp4", "fp8_e4m3fn", "quanto_int4",
                          "int8_w8a8"):
        raise NotImplementedError(
            "Only bnb 4bit / fp8 / quanto int4 / int8_w8a8 offline "
            "quantization is supported"
        )
    targets = set(get_target_keys(include_keys, exclude_keys, list(state_dict.keys())))
    out = dict(state_dict)
    for key in list(out.keys()):
        if key not in targets:
            continue
        w = torch.as_tensor(out[key])
        if quant_type == "fp8_e4m3fn":
            out[key] = w.to(torch.float8_e4m3fn)
            continue
        if w.ndim != 2 or (quant_type == "quanto_int4" and w.shape[0] % 2):
            logger.warning(
                "quantize_state_dict: skipping %s (shape %s: %s needs a 2-D weight%s); "
                "it stays full precision", key, tuple(w.shape), quant_type,
                " with even out_features" if quant_type == "quanto_int4" else "",
            )
            continue
        if quant_type in ("bnb_nf4", "bnb_fp4"):
            packed, state = quantize_4bit(
                w, quant_type=quant_type[len("bnb_"):], compress_statistics=True
            )
            out[key] = packed
            for state_key, state_value in state.items():
                out[f"{key}.{state_key}"] = state_value
        elif quant_type == "int8_w8a8":
            del out[key]
            for name, leaf in quantize_weight(w, "int8_w8a8").items():
                out[f"{key}.{name}"] = leaf
        else:  # quanto_int4
            sub = quantize_weight(w, "quanto_int4")
            del out[key]
            out[f"{key}._data"] = sub["data"]
            out[f"{key}._scale"] = sub["scale"]
            out[f"{key}._shift"] = sub["shift"]
    return out
