"""IP-Adapter image projectors (``vision_ft_tpu/modules/adapter/
ip_adapter/projectors.py`` counterpart).

State-dict keys are the JAX package's (``proj.weight``, ``mlp.0.weight``,
``latents``, ``proj_in.weight``, ``layers.N.0...``, ``ip_tokens``,
``blocks.N...``), so projector safetensors load in both; the type and
configuration are detected from a state dict's keys and shapes.
``init_weights(generator)`` draws the JAX package's initial
distributions (on the projector's device, in its dtype).
"""

from __future__ import annotations

from typing import Literal, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import LayerNorm, Linear, RMSNorm, init_parameters_
from ....ops.attention import scaled_dot_product_attention

NORMALIZATION_TYPES = Literal["layernorm", "layer", "rmsnorm", "rms"]


def get_norm_layer(normalization: str, dim: int):
    if normalization.lower() in ("layernorm", "layer"):
        return LayerNorm(dim)
    if normalization.lower() in ("rmsnorm", "rms"):
        return RMSNorm(dim)
    raise ValueError(f"Unsupported normalization type: {normalization}")


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, inner = t.shape
    return t.reshape(b, s, num_heads, inner // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _pooled(features: torch.Tensor, name: str) -> torch.Tensor:
    """The linear and mlp projectors map one pooled feature vector a
    sample; a (B, S, F) sequence would fold its S tokens into the batch
    (as the JAX package's reshape does, whose loss then fails to
    broadcast), so it raises here."""
    if features.ndim != 2:
        raise ValueError(
            f"the {name} projector takes pooled (B, F) features, got {tuple(features.shape)}: "
            'use the image encoder\'s feature_type "pooler_output", or a resampler / '
            "image_text projector for a token sequence"
        )
    return features


class LinearImageProjector(nn.ModuleDict):
    def __init__(self, in_features: int, cross_attention_dim: int = 2048,
                 num_ip_tokens: int = 4, normalization: str = "layernorm"):
        super().__init__(
            {
                "proj": Linear(in_features, cross_attention_dim * num_ip_tokens),
                "norm": get_norm_layer(normalization, cross_attention_dim),
            }
        )
        self.in_features = in_features
        self.cross_attention_dim = cross_attention_dim
        self.num_ip_tokens = num_ip_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        self["proj"].weight.uniform_(0.0, 0.02, generator=generator)
        self["proj"].bias.zero_()

    @classmethod
    def config_from_pretrained(cls, state_dict) -> dict:
        cross_attention_dim = state_dict["norm.weight"].shape[0]
        return dict(
            in_features=state_dict["proj.weight"].shape[1],
            cross_attention_dim=cross_attention_dim,
            num_ip_tokens=state_dict["proj.weight"].shape[0] // cross_attention_dim,
            normalization="layer" if "norm.bias" in state_dict else "rms",
        )

    def forward(self, features, *args, **kwargs):
        tokens = self["proj"](_pooled(features, "linear")).reshape(-1, self.num_ip_tokens, self.cross_attention_dim)
        return self["norm"](tokens)


class MLPImageProjector(nn.ModuleDict):
    def __init__(self, in_features: int, mlp_ratio: float = 1.0,
                 cross_attention_dim: int = 768, num_style_tokens: int = 4,
                 normalization: str = "layernorm"):
        hidden = int(in_features * mlp_ratio)
        super().__init__(
            {
                "mlp": nn.ModuleDict(
                    {
                        "0": Linear(in_features, hidden),
                        "2": Linear(hidden, cross_attention_dim * num_style_tokens),
                    }
                ),
                "norm": get_norm_layer(normalization, cross_attention_dim),
            }
        )
        self.cross_attention_dim = cross_attention_dim
        self.num_style_tokens = num_style_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        for layer in self["mlp"].values():
            layer.weight.normal_(0.0, 0.02, generator=generator)
            layer.bias.zero_()

    @classmethod
    def config_from_pretrained(cls, state_dict) -> dict:
        in_features = state_dict["mlp.0.weight"].shape[1]
        cross_attention_dim = state_dict["norm.weight"].shape[0]
        return dict(
            in_features=in_features,
            mlp_ratio=state_dict["mlp.0.weight"].shape[0] / in_features,
            cross_attention_dim=cross_attention_dim,
            num_style_tokens=state_dict["mlp.2.weight"].shape[0] // cross_attention_dim,
            normalization="layer" if "norm.bias" in state_dict else "rms",
        )

    def forward(self, features, *args, **kwargs):
        h = F.gelu(self["mlp"]["0"](_pooled(features, "mlp")), approximate="none")
        tokens = self["mlp"]["2"](h).reshape(-1, self.num_style_tokens, self.cross_attention_dim)
        return self["norm"](tokens)


class PerceiverAttention(nn.ModuleDict):
    def __init__(self, in_features: int, num_heads: int,
                 normalization: str = "layernorm", qk_norm: bool = False):
        head_dim = in_features // num_heads
        children = {
            "norm1": get_norm_layer(normalization, in_features),
            "norm2": get_norm_layer(normalization, in_features),
            "to_q": Linear(in_features, in_features, bias=False),
            "to_kv": Linear(in_features, in_features * 2, bias=False),
            "to_out": Linear(in_features, in_features, bias=False),
        }
        if qk_norm:
            children["norm_q"] = get_norm_layer(normalization, head_dim)
            children["norm_k"] = get_norm_layer(normalization, head_dim)
        super().__init__(children)
        self.in_features = in_features
        self.num_heads = num_heads
        self.qk_norm = qk_norm

    def forward(self, image_features, latents):
        image_features = self["norm1"](image_features)
        latents = self["norm2"](latents)
        query = self["to_q"](latents)
        key, value = self["to_kv"](torch.cat([image_features, latents], dim=1)).chunk(2, dim=-1)
        q, k, v = (_heads(t, self.num_heads) for t in (query, key, value))
        if self.qk_norm:
            q, k = self["norm_q"](q), self["norm_k"](k)
        return self["to_out"](_merge(scaled_dot_product_attention(q, k, v)))


class _FeedForward(nn.ModuleDict):
    """norm -> linear -> gelu -> linear (keys 0, 1, 3)."""

    def __init__(self, in_features: int, mlp_ratio: float, normalization: str):
        super().__init__(
            {
                "0": get_norm_layer(normalization, in_features),
                "1": Linear(in_features, int(in_features * mlp_ratio), bias=False),
                "3": Linear(int(in_features * mlp_ratio), in_features, bias=False),
            }
        )

    def forward(self, x):
        return self["3"](F.gelu(self["1"](self["0"](x)), approximate="none"))


class ResamplerProjector(nn.Module):
    """Perceiver resampler: learned latents cross-attend to the projected
    image features through ``depth`` attention + feed-forward layers."""

    def __init__(self, in_features: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 cross_attention_dim: int = 768, num_ip_tokens: int = 4, depth: int = 4,
                 normalization: str = "layernorm", qk_norm: bool = False):
        super().__init__()
        dim = cross_attention_dim
        self.num_ip_tokens = num_ip_tokens
        self.cross_attention_dim = dim
        self.latents = nn.Parameter(torch.empty(1, num_ip_tokens, dim))
        self.proj_in = Linear(in_features, dim)
        self.proj_out = Linear(dim, dim)
        self.norm_out = get_norm_layer(normalization, dim)
        self.layers = nn.ModuleDict(
            {
                str(i): nn.ModuleDict(
                    {
                        "0": PerceiverAttention(dim, num_heads, normalization, qk_norm),
                        "1": _FeedForward(dim, mlp_ratio, normalization),
                    }
                )
                for i in range(depth)
            }
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.latents.normal_(0.0, 1.0, generator=generator).div_(self.cross_attention_dim**0.5)

    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)

    @classmethod
    def config_from_pretrained(cls, state_dict, num_heads: int = 8) -> dict:
        cross_attention_dim = state_dict["proj_out.weight"].shape[0]
        depth = len({k.split(".")[1] for k in state_dict if k.startswith("layers.")})
        return dict(
            in_features=state_dict["proj_in.weight"].shape[1],
            num_heads=num_heads,
            mlp_ratio=state_dict["layers.0.1.1.weight"].shape[0] / cross_attention_dim,
            cross_attention_dim=cross_attention_dim,
            num_ip_tokens=state_dict["latents"].shape[1],
            depth=depth,
            normalization="layer" if "norm_out.bias" in state_dict else "rms",
            qk_norm="layers.0.0.norm_q.weight" in state_dict,
        )

    def forward(self, image_features, *args, **kwargs):
        b = image_features.shape[0]
        latents = self.latents.to(image_features.dtype).expand(b, -1, -1)
        image_features = self.proj_in(image_features)
        for layer in self.layers.values():
            latents = layer["0"](image_features, latents) + latents
            latents = layer["1"](latents) + latents
        return self.norm_out(self.proj_out(latents))


class _IPContextAttention(nn.ModuleDict):
    """Perceiver attention: Q = ip tokens, KV = cat(ip, context), RMSNorm
    pre-norms on both streams and QK-norm over the head dim, bias-free
    projections. ``context_norm_name`` is the context pre-norm's key
    ("norm_image" or "norm_text")."""

    def __init__(self, dim: int, num_heads: int, context_norm_name: str):
        head_dim = dim // num_heads
        super().__init__(
            {
                context_norm_name: RMSNorm(dim),
                "norm_ip": RMSNorm(dim),
                "norm_q": RMSNorm(head_dim),
                "norm_k": RMSNorm(head_dim),
                "to_q": Linear(dim, dim, bias=False),
                "to_k": Linear(dim, dim, bias=False),
                "to_v": Linear(dim, dim, bias=False),
                "to_out": Linear(dim, dim, bias=False),
            }
        )
        self.num_heads = num_heads
        self.context_norm_name = context_norm_name

    def forward(self, context, ip_features):
        context = self[self.context_norm_name](context)
        ip_features = self["norm_ip"](ip_features)
        query = self["to_q"](ip_features)
        kv_input = torch.cat([ip_features, context], dim=1)
        q = self["norm_q"](_heads(query, self.num_heads))
        k = self["norm_k"](_heads(self["to_k"](kv_input), self.num_heads))
        v = _heads(self["to_v"](kv_input), self.num_heads)
        return self["to_out"](_merge(scaled_dot_product_attention(q, k, v)))


class ImageTextTransformerBlock(nn.ModuleDict):
    """One image_text block. As in the JAX package, ``attn2`` (its
    context pre-norm ``norm_text``) runs first, against the image
    features, then ``attn1`` (``norm_image``) against the text features:
    the keys and the order are the JAX package's."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_ratio: float = 4.0):
        mlp_hidden = int(hidden_dim * mlp_ratio)
        super().__init__(
            {
                "attn1": _IPContextAttention(hidden_dim, num_heads, "norm_image"),
                "norm1": RMSNorm(hidden_dim),
                "attn2": _IPContextAttention(hidden_dim, num_heads, "norm_text"),
                "norm2": RMSNorm(hidden_dim),
                "mlp": nn.ModuleDict(
                    {"0": Linear(hidden_dim, mlp_hidden), "2": Linear(mlp_hidden, hidden_dim)}
                ),
                "norm_out": RMSNorm(hidden_dim),
            }
        )

    def forward(self, image_features, text_features, ip_features):
        ip_features = self["norm2"](self["attn2"](image_features, ip_features) + ip_features)
        ip_features = self["norm1"](self["attn1"](text_features, ip_features) + ip_features)
        h = self["mlp"]["2"](F.silu(self["mlp"]["0"](ip_features)))
        return self["norm_out"](ip_features + h)


class ImageTextProjector(nn.Module):
    """Joint image + text -> ip-token projector: learned ip tokens attend
    to the projected image, then text, features through ``num_blocks``
    blocks. It takes the prompt embeddings as well:
    ``forward(image_features, text_features)``."""

    def __init__(self, image_dim: int, text_dim: int, hidden_dim: int,
                 num_heads: int, num_blocks: int = 6, mlp_ratio: float = 4.0,
                 num_ip_tokens: int = 64):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_ip_tokens = num_ip_tokens
        self.ip_tokens = nn.Parameter(torch.empty(1, num_ip_tokens, hidden_dim))
        self.image_proj_in = Linear(image_dim, hidden_dim)
        self.text_proj_in = Linear(text_dim, hidden_dim)
        self.blocks = nn.ModuleDict(
            {str(i): ImageTextTransformerBlock(hidden_dim, num_heads, mlp_ratio)
             for i in range(num_blocks)}
        )
        self.proj_out = Linear(hidden_dim, hidden_dim)
        self.norm_out = RMSNorm(hidden_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ip_tokens.normal_(0.0, 1.0, generator=generator).div_(self.hidden_dim**0.5)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.02) matrices, zero biases, unit RMSNorm scales, ip tokens
        N(0, 1) / sqrt(hidden_dim)."""
        init_parameters_(self, generator)
        for name, value in self.named_parameters():
            if name == "ip_tokens":
                continue
            if name.endswith("weight") and value.ndim == 2:
                value.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("bias"):
                value.zero_()
            else:
                value.fill_(1.0)

    @classmethod
    def config_from_pretrained(cls, state_dict, num_heads: int = 8) -> dict:
        hidden_dim = state_dict["norm_out.weight"].shape[0]
        num_blocks = 0
        while f"blocks.{num_blocks}.attn1.to_q.weight" in state_dict:
            num_blocks += 1
        return dict(
            image_dim=state_dict["image_proj_in.weight"].shape[1],
            text_dim=state_dict["text_proj_in.weight"].shape[1],
            hidden_dim=hidden_dim,
            num_heads=num_heads,
            num_blocks=num_blocks,
            mlp_ratio=state_dict["blocks.0.mlp.0.weight"].shape[0] / hidden_dim,
            num_ip_tokens=state_dict["ip_tokens"].shape[1],
        )

    def forward(self, image_features, text_features: Optional[torch.Tensor] = None, *args, **kwargs):
        if text_features is None:
            raise ValueError("the image_text projector needs the prompt embeddings")
        b = image_features.shape[0]
        ip = self.ip_tokens.to(image_features.dtype).expand(b, -1, -1)
        if text_features.shape[0] != b:
            # generate() encodes [positive image; negative image] against
            # CFG-doubled prompt embeddings: rows tiled or cut to b, as
            # jnp.resize does
            reps = -(-b // text_features.shape[0])
            text_features = text_features.repeat(reps, *([1] * (text_features.ndim - 1)))[:b]
        image_features = self.image_proj_in(image_features)
        text_features = self.text_proj_in(text_features.to(image_features.dtype))
        for block in self.blocks.values():
            ip = block(image_features, text_features, ip)
        return self.norm_out(self.proj_out(ip))


def detect_projector_type(state_dict) -> str:
    if "proj.weight" in state_dict:
        return "linear"
    if "mlp.0.weight" in state_dict:
        return "mlp"
    if "latents" in state_dict and "proj_in.weight" in state_dict:
        return "resampler"
    if "ip_tokens" in state_dict and "blocks.0.norm_out.weight" in state_dict:
        return "image_text"
    raise ValueError("Unknown projector type in state_dict")


def load_projector_from_state_dict(state_dict, device=None, **kwargs):
    """The projector a flat state dict describes, with its weights (in
    their dtype, on ``device``: the CPU unless named)."""
    from ....nn import load_flat_params

    projector_type = detect_projector_type(state_dict)
    cls = {
        "linear": LinearImageProjector,
        "mlp": MLPImageProjector,
        "resampler": ResamplerProjector,
        "image_text": ImageTextProjector,
    }[projector_type]
    # the head count is not in the keys: the caller may name it
    if projector_type in ("resampler", "image_text"):
        config = cls.config_from_pretrained(state_dict, **kwargs)
    else:
        config = cls.config_from_pretrained(state_dict)
    with torch.device("meta"):
        module = cls(**config)
    return load_flat_params(module, dict(state_dict), meta_device=device or "cpu")
