"""NF4 / FP4 blockwise quantization, bit-compatible with bitsandbytes
(``vision_ft_tpu/modules/quant/nf4.py`` counterpart).

The format:

- values are mapped to a 16-entry codebook (NF4: quantiles of N(0,1);
  FP4: a tiny e2m1 float grid), per 64-element block scaled by absmax
- two codes per byte, first element in the HIGH nibble
- optional double quantization of absmax (dynamic 8-bit blockwise with a
  256-entry dynamic map, blocksize 256, mean offset)
- the non-tensor state (shape/blocksize/dtype) rides a JSON-in-uint8
  tensor under ``quant_state.bitsandbytes__nf4`` exactly like bnb

Tensors in, tensors out, on the device of the input: a whole model is
quantized on the card, layer by layer. The packed bytes equal the JAX
package's bit for bit on the same fp32 weight: the same fp32 division by
``max(absmax, 1e-12)``, the midpoints of the sorted codebook, a left-sided
``searchsorted``, the codebook's sort order taken from numpy (``FP4_CODE``
holds 0.0 twice, so the order of ties is part of the format).
"""

from __future__ import annotations

import functools
import json
from typing import Any, Mapping

import numpy as np
import torch

# NF4 codebook: 16 quantiles of N(0, 1) normalized to [-1, 1]
# (QLoRA paper / bitsandbytes functional.py `create_normal_map`)
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# FP4 codebook (bnb create_fp4_map): sign x {0, .0625, 8/12, .25, .333, .5, .667, 1}
FP4_CODE = np.array(
    [0.0, 0.0052083333, 0.6666666667, 1.0, 0.3333333333, 0.5, 0.1666666667, 0.25,
     0.0, -0.0052083333, -0.6666666667, -1.0, -0.3333333333, -0.5, -0.1666666667, -0.25],
    dtype=np.float32,
)


def create_dynamic_map(signed: bool = True, max_exponent_bits: int = 7, total_bits: int = 8) -> np.ndarray:
    """bitsandbytes' dynamic 8-bit map (sign + dynamic exponent + linear
    fraction), used for double-quantized absmax."""
    data = []
    non_sign_bits = total_bits - (1 if signed else 1)
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1
            if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1
        )
        boundaries = np.linspace(0.1, 1, fraction_items)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
    if additional_items > 0:
        boundaries = np.linspace(0.1, 1, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)) * means).tolist()
    data.append(0)
    data.append(1.0)
    if len(data) != 2**total_bits:
        raise ValueError(f"dynamic map has {len(data)} entries, not {2**total_bits}")
    data.sort()
    return np.array(data, dtype=np.float32)


DYNAMIC_MAP = create_dynamic_map()

_CODEBOOKS = {"nf4": NF4_CODE, "fp4": FP4_CODE, "dynamic": DYNAMIC_MAP}


@functools.cache
def _search_tables(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(midpoints of the sorted codebook, sort order), both from numpy."""
    code = _CODEBOOKS[name]
    order = np.argsort(code)
    sorted_code = code[order]
    return (sorted_code[1:] + sorted_code[:-1]) / 2, order


def _nearest_code(values: torch.Tensor, name: str) -> torch.Tensor:
    """Index of the nearest entry of codebook ``name`` (midpoint rule, like
    bnb), for flat fp32 ``values``; int64 on the values' device."""
    mids, order = _search_tables(name)
    mids_t = torch.from_numpy(mids).to(values.device)
    order_t = torch.from_numpy(order).to(values.device)
    return order_t[torch.searchsorted(mids_t, values.contiguous(), right=False)]


def _blocks(flat: torch.Tensor, blocksize: int) -> torch.Tensor:
    pad = (-flat.numel()) % blocksize
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, blocksize)


def quantize_blockwise_nested(absmax: torch.Tensor, blocksize: int = 256):
    """Double-quantize absmax like bnb (dynamic map + mean offset): (uint8
    codes, fp32 nested absmax, the offset as a numpy fp32 scalar). The
    offset is a host number of the format's JSON meta, and its fp32 mean
    is taken as numpy takes it (pairwise), so that it has the JAX
    package's bits."""
    offset = absmax.detach().cpu().numpy().mean(dtype=np.float32)
    centered = absmax - float(offset)
    blocks = _blocks(centered, blocksize)
    nested_absmax = blocks.abs().amax(dim=1).clamp_min(1e-12)
    normalized = blocks / nested_absmax[:, None]
    codes = _nearest_code(normalized.reshape(-1), "dynamic").to(torch.uint8)
    return codes[: centered.numel()], nested_absmax.float(), np.float32(offset)


def dequantize_blockwise_nested(
    absmax_q: torch.Tensor, nested_absmax: torch.Tensor, nested_code: torch.Tensor,
    offset: float, blocksize: int = 256,
) -> torch.Tensor:
    values = nested_code.float()[absmax_q.to(torch.int32)]
    scales = nested_absmax.float().repeat_interleave(blocksize)[: values.shape[0]]
    return values * scales + torch.tensor(offset, dtype=torch.float32, device=values.device)


@torch.no_grad()
def quantize_4bit(
    weight: torch.Tensor,
    quant_type: str = "nf4",
    blocksize: int = 64,
    compress_statistics: bool = False,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Quantize to the bnb packed layout.

    Returns (packed uint8 of shape (ceil(numel/2), 1), flat quant-state
    tensors dict in bnb ``as_dict(packed=True)`` form), on the weight's
    device.
    """
    if quant_type not in ("nf4", "fp4"):
        raise ValueError(f"Unknown 4-bit quant_type: {quant_type}")
    device = weight.device
    shape = list(weight.shape)
    blocks = _blocks(weight.detach().float().reshape(-1), blocksize)
    absmax = blocks.abs().amax(dim=1)
    normalized = (blocks / absmax.clamp_min(1e-12)[:, None]).reshape(-1)
    codes = _nearest_code(normalized, quant_type).to(torch.uint8)
    # pack: even index -> high nibble
    if codes.numel() % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    packed = ((codes[0::2] << 4) | codes[1::2]).reshape(-1, 1)

    state: dict[str, Any] = {"quant_map": torch.from_numpy(_CODEBOOKS[quant_type].copy()).to(device)}
    meta = {
        "quant_type": quant_type,
        "blocksize": blocksize,
        "shape": shape,
        "dtype": "float32",
    }
    if compress_statistics:
        absmax_q, nested_absmax, offset = quantize_blockwise_nested(absmax)
        state["absmax"] = absmax_q
        state["nested_absmax"] = nested_absmax
        state["nested_quant_map"] = torch.from_numpy(DYNAMIC_MAP.copy()).to(device)
        meta["nested_blocksize"] = 256
        meta["nested_offset"] = float(offset)
        meta["nested_dtype"] = "float32"
    else:
        state["absmax"] = absmax
    state[f"quant_state.bitsandbytes__{quant_type}"] = json_to_tensor(meta, device)
    return packed, state


def json_to_tensor(payload: dict, device=None) -> torch.Tensor:
    """A JSON object as the uint8 tensor of its UTF-8 bytes."""
    raw = np.frombuffer(json.dumps(payload).encode("utf-8"), dtype=np.uint8).copy()
    return torch.from_numpy(raw).to(device)


def tensor_to_json(tensor) -> dict:
    raw = tensor.detach().cpu().numpy() if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
    return json.loads(bytes(raw.astype(np.uint8)).decode("utf-8"))


def parse_quant_state(children: Mapping[str, Any]) -> dict[str, Any]:
    """Parse the bnb packed quant-state tensors into {code, absmax(fp32),
    blocksize, shape, quant_type}."""
    meta_key = next(k for k in children if k.startswith("quant_state.bitsandbytes__"))
    quant_type = meta_key[len("quant_state.bitsandbytes__"):]
    meta = tensor_to_json(children[meta_key])
    code = torch.as_tensor(children["quant_map"]).float()
    absmax = torch.as_tensor(children["absmax"])
    if "nested_absmax" in children:
        absmax = dequantize_blockwise_nested(
            absmax,
            torch.as_tensor(children["nested_absmax"]),
            torch.as_tensor(children["nested_quant_map"]),
            float(meta["nested_offset"]),
            int(meta.get("nested_blocksize", 256)),
        )
    else:
        absmax = absmax.float()
    return {
        "quant_type": quant_type,
        "code": code,
        "absmax": absmax,
        "blocksize": int(meta["blocksize"]),
        "shape": tuple(meta["shape"]),
    }


def infer_blocksize(numel: int, nblocks: int) -> int:
    """bnb blocksize from (numel, len(absmax)).

    ``numel // nblocks`` under-reads whenever bnb padded the flat element
    array (numel not a multiple of the blocksize): e.g. a (10, 7) weight
    quantizes to absmax blocks of 64 but 70 // 2 = 35. The blocksize is
    the smallest power of two >= 64 whose nblocks cover numel.
    """
    blocksize = 64
    while blocksize * nblocks < numel:
        blocksize *= 2
    return blocksize


def dequantize_4bit(
    packed: torch.Tensor,
    code: torch.Tensor,
    absmax: torch.Tensor,
    shape: tuple[int, ...],
    blocksize: int = 64,
    dtype: torch.dtype = torch.float32,
    split: bool = False,
) -> torch.Tensor:
    """Unpack + codebook lookup + per-block scale: fp32 value x fp32 scale,
    rounded once to ``dtype``.

    Each byte is looked up in a 256-entry table of (high, low) codebook
    pairs. ``split=True`` reads the split device layout
    (``ops/nf4_matmul.to_split_layout``): for a 2-D (n, k) weight, byte j
    of a row holds columns j (hi nibble) and k/2+j (lo nibble): the nibble
    planes concatenate along k instead of interleaving."""
    flat = packed.reshape(-1)
    code32 = code.float()
    byte = torch.arange(256, device=flat.device)
    pairs = torch.stack([code32[byte >> 4], code32[byte & 0xF]], dim=-1)  # (256, 2)
    values = pairs[flat.to(torch.int32)]  # (bytes, 2): high, low
    numel = int(np.prod(shape))
    if split:
        if len(shape) != 2 or shape[1] % 2:
            raise ValueError(f"split layout needs a 2-D even-k shape, got {shape}")
        n, k = shape
        values = values.reshape(n, k // 2, 2).transpose(1, 2).reshape(-1)
    else:
        values = values.reshape(-1)
    values = values[:numel]
    scales = absmax.float()[:, None].expand(absmax.shape[0], blocksize).reshape(-1)[:numel]
    return (values * scales).reshape(shape).to(dtype)
