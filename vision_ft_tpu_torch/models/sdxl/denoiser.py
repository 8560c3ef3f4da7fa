"""SDXL UNet denoiser, forward only (``vision_ft_tpu/models/sdxl/denoiser.py``
counterpart).

Activations are NHWC end to end, as in the JAX package: latents
(B, H, W, C) in, noise prediction (B, H, W, C) out. Conv kernels are
stored OIHW, and the module tree reproduces the JAX package's flattened
keys, including the ``.blocks.`` segment of the UNet stacks, e.g.
``input_blocks.blocks.4.1.transformer_blocks.0.attn1.to_q.weight``.

Kernels on this path: the 70 self-attentions of an SDXL UNet go through
the BSHD flash kernel and its 210 transformer LayerNorms through the
fused LayerNorm kernel, for bf16 CUDA tensors (``ops/attention.py``,
``nn/core.py``). Not ported yet: DeepCache (``deepcache_forward``),
gradient checkpointing and the adapter hooks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...modules.timestep.embedding import get_timestep_embedding
from ...nn import Conv2d, GroupNorm, LayerNorm, Linear
from ...ops.attention import AttentionImplementation, attention_heads_packed
from .config import DenoiserConfig


class MLPEmbedder(nn.ModuleDict):
    """Linear -> SiLU -> Linear (torch Sequential keys "0", "2")."""

    def __init__(self, hidden_dim: int, time_embed_dim: int):
        super().__init__(
            {"0": Linear(hidden_dim, time_embed_dim), "2": Linear(time_embed_dim, time_embed_dim)}
        )

    def forward(self, x):
        return self["2"](F.silu(self["0"](x)))


class CrossAttention(nn.ModuleDict):
    """to_q / to_k / to_v (no bias) + to_out.0 over heads-packed tensors."""

    def __init__(
        self,
        query_dim: int,
        context_dim: int,
        num_heads: int,
        head_dim: int,
        backend: AttentionImplementation,
    ):
        inner = num_heads * head_dim
        super().__init__(
            {
                "to_q": Linear(query_dim, inner, bias=False),
                "to_k": Linear(context_dim, inner, bias=False),
                "to_v": Linear(context_dim, inner, bias=False),
                "to_out": nn.ModuleDict({"0": Linear(inner, query_dim)}),
            }
        )
        self.num_heads = num_heads
        self.backend = backend

    def forward(self, x, context):
        q = self["to_q"](x)
        k = self["to_k"](context)
        v = self["to_v"](context)
        attn = attention_heads_packed(q, k, v, self.num_heads, backend=self.backend)
        return self["to_out"]["0"](attn)


class SelfAttention(CrossAttention):
    def __init__(self, num_heads: int, head_dim: int, backend: AttentionImplementation):
        inner = num_heads * head_dim
        super().__init__(inner, inner, num_heads, head_dim, backend)

    def forward(self, x):
        return super().forward(x, x)


class FeedForward(nn.ModuleDict):
    """GeGLU feed-forward: net.0.proj (2x fused gate) -> gelu-gate -> net.2."""

    def __init__(self, hidden_dim: int, multiplier: float = 4.0):
        inner = int(hidden_dim * multiplier)
        super().__init__(
            {
                "net": nn.ModuleDict(
                    {
                        "0": nn.ModuleDict({"proj": Linear(hidden_dim, inner * 2)}),
                        "2": Linear(inner, hidden_dim),
                    }
                )
            }
        )

    def forward(self, x):
        h, gate = self["net"]["0"]["proj"](x).chunk(2, dim=-1)
        # the JAX rule: tanh-approximate GELU on bf16, exact (erf) on fp32
        approximate = "tanh" if gate.dtype == torch.bfloat16 else "none"
        return self["net"]["2"](h * F.gelu(gate, approximate=approximate))


class TransformerBlock(nn.ModuleDict):
    """pre-LN self-attn -> cross-attn -> GeGLU FF, each with a residual."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        head_dim: int,
        context_dim: int,
        backend: AttentionImplementation,
    ):
        super().__init__(
            {
                "attn1": SelfAttention(num_heads, head_dim, backend),
                "attn2": CrossAttention(hidden_dim, context_dim, num_heads, head_dim, backend),
                "ff": FeedForward(hidden_dim),
                "norm1": LayerNorm(hidden_dim),
                "norm2": LayerNorm(hidden_dim),
                "norm3": LayerNorm(hidden_dim),
            }
        )

    def forward(self, x, context):
        x = x + self["attn1"](self["norm1"](x))
        x = x + self["attn2"](self["norm2"](x), context)
        return x + self["ff"](self["norm3"](x))


class SpatialTransformer(nn.ModuleDict):
    """GroupNorm -> proj_in -> transformer blocks -> proj_out + residual.
    NHWC: the (B, H, W, C) -> (B, HW, C) flatten is a reshape."""

    def __init__(
        self,
        in_channels: int,
        num_heads: int,
        head_dim: int,
        num_blocks: int,
        context_dim: int,
        backend: AttentionImplementation,
    ):
        inner = num_heads * head_dim
        super().__init__(
            {
                "norm": GroupNorm(32, in_channels, eps=1e-6),
                "proj_in": Linear(in_channels, inner),
                "transformer_blocks": nn.ModuleDict(
                    {
                        str(i): TransformerBlock(inner, num_heads, head_dim, context_dim, backend)
                        for i in range(num_blocks)
                    }
                ),
                "proj_out": Linear(inner, in_channels),
            }
        )

    def forward(self, x, context):
        b, hh, ww, c = x.shape
        h = self["proj_in"](self["norm"](x).reshape(b, hh * ww, c))
        for block in self["transformer_blocks"].values():
            h = block(h, context)
        return self["proj_out"](h).reshape(b, hh, ww, c) + x


class ResidualBlock(nn.ModuleDict):
    """GN/SiLU/Conv + time-embedding add + GN/SiLU/Conv, with skip."""

    def __init__(self, in_channels: int, embedding_dim: int, out_channels: int):
        children = {
            "in_layers": nn.ModuleDict(
                {
                    "0": GroupNorm(32, in_channels, eps=1e-5),
                    "2": Conv2d(in_channels, out_channels, 3, padding=1),
                }
            ),
            "emb_layers": nn.ModuleDict({"1": Linear(embedding_dim, out_channels)}),
            "out_layers": nn.ModuleDict(
                {
                    "0": GroupNorm(32, out_channels, eps=1e-5),
                    "3": Conv2d(out_channels, out_channels, 3, padding=1),
                }
            ),
        }
        if in_channels != out_channels:
            children["skip_connection"] = Conv2d(in_channels, out_channels, 1)
        super().__init__(children)

    def forward(self, x, emb):
        h = self["in_layers"]["2"](F.silu(self["in_layers"]["0"](x)))
        h = h + self["emb_layers"]["1"](F.silu(emb))[:, None, None, :]
        h = self["out_layers"]["3"](F.silu(self["out_layers"]["0"](h)))
        if "skip_connection" in self:
            x = self["skip_connection"](x)
        return h + x


class Downsample(nn.ModuleDict):
    """Strided conv (SDXL never uses avg-pool)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__({"op": Conv2d(channels, out_channels, 3, stride=2, padding=1)})

    def forward(self, x):
        return self["op"](x)


class Upsample(nn.ModuleDict):
    """Nearest 2x upsample + conv, on NHWC."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__({"conv": Conv2d(channels, out_channels, 3, padding=1)})

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self["conv"](x.permute(0, 2, 3, 1))


def _spatial_transformer(config: DenoiserConfig, channels: int, num_blocks: int):
    return SpatialTransformer(
        channels,
        channels // config.num_head_channels,
        config.num_head_channels,
        num_blocks,
        config.context_dim,
        config.attention_backend,
    )


def _build_down_blocks(config: DenoiserConfig, time_embed_dim: int):
    """Layer-lists of the down path: conv stem, resblocks (+ transformers),
    downsamples between stages."""
    lists: list[list[tuple[str, nn.Module]]] = []
    current = config.in_channels
    n_stages = len(config.down_blocks)
    for i, (block, out_ch, n_tf) in enumerate(
        zip(config.down_blocks, config.block_out_channels, config.num_transformers_per_block)
    ):
        if block == "DownBlock2D":
            lists.append([("conv", Conv2d(current, config.block_out_channels[0], 3, padding=1))])
            current = out_ch
            for _ in range(config.layers_per_block):
                lists.append([("res", ResidualBlock(current, time_embed_dim, out_ch))])
        elif block == "TransformerDownBlock2D":
            for _ in range(config.layers_per_block):
                layer = [("res", ResidualBlock(current, time_embed_dim, out_ch))]
                current = out_ch
                layer.append(("st", _spatial_transformer(config, out_ch, n_tf)))
                lists.append(layer)
        else:
            raise ValueError(f"Invalid down block: {block}")
        if i != n_stages - 1:
            lists.append([("down", Downsample(out_ch, out_ch))])
    return lists


def _build_up_blocks(config: DenoiserConfig, time_embed_dim: int):
    """Layer-lists of the up path: reversed channels, layers_per_block + 1
    resblocks per stage, skip-channel pops, a trailing Upsample on the
    stage's last layer-list."""
    skips: list[int] = []
    for i, (block, ch) in enumerate(zip(config.down_blocks, config.block_out_channels)):
        skips.extend([ch] * (config.layers_per_block + (block == "DownBlock2D")))
        if i != len(config.down_blocks) - 1:
            skips.append(ch)

    up_channels = config.block_out_channels[::-1]
    up_n_tf = config.num_transformers_per_block[::-1]
    lists: list[list[tuple[str, nn.Module]]] = []
    current = config.block_out_channels[-1]
    for i, (block, out_ch, n_tf) in enumerate(zip(config.up_blocks, up_channels, up_n_tf)):
        for _ in range(config.layers_per_block + 1):
            layer = [("res", ResidualBlock(current + skips.pop(), time_embed_dim, out_ch))]
            current = out_ch
            if block == "TransformerUpBlock2D":
                layer.append(("st", _spatial_transformer(config, out_ch, n_tf)))
            lists.append(layer)
        if i != len(config.up_blocks) - 1:
            lists[-1].append(("up", Upsample(out_ch, out_ch)))
    return lists


def _run_layer_list(kinds, modules, x, context, global_cond):
    for kind, module in zip(kinds, modules):
        if kind == "res":
            x = module(x, global_cond)
        elif kind == "st":
            x = module(x, context)
        else:  # conv / down / up
            x = module(x)
    return x


class _BlockStack(nn.Module):
    """Layer-lists under a ``blocks`` list (keys ``blocks.<i>.<j>``)."""

    def __init__(self, lists: list[list[tuple[str, nn.Module]]]):
        super().__init__()
        self.kinds = [[kind for kind, _ in layer_list] for layer_list in lists]
        self.blocks = nn.ModuleList(
            nn.ModuleList(module for _, module in layer_list) for layer_list in lists
        )


class _LayerList(nn.Module):
    """One layer-list under ``blocks`` (keys ``blocks.<j>``): the middle block."""

    def __init__(self, layer_list: list[tuple[str, nn.Module]]):
        super().__init__()
        self.kinds = [kind for kind, _ in layer_list]
        self.blocks = nn.ModuleList(module for _, module in layer_list)


class UNet(nn.Module):
    """The SDXL UNet. ``forward(latents, timestep, encoder_hidden_states,
    encoder_pooler_output, original_size, target_size,
    crop_coords_top_left)`` with NHWC latents (B, H, W, C)."""

    def __init__(self, config: DenoiserConfig):
        super().__init__()
        self.config = config
        self.hidden_dim = config.hidden_dim
        self.time_embed_dim = config.hidden_dim * 4
        self.additional_cond_dim = config.additional_condition_dim

        self.time_embed = MLPEmbedder(config.hidden_dim, self.time_embed_dim)
        self.label_emb = nn.ModuleDict(
            {"0": MLPEmbedder(config.global_cond_dim, self.time_embed_dim)}
        )
        self.input_blocks = _BlockStack(_build_down_blocks(config, self.time_embed_dim))
        mid_ch = config.block_out_channels[-1]
        self.middle_block = _LayerList(
            [
                ("res", ResidualBlock(mid_ch, self.time_embed_dim, mid_ch)),
                ("st", _spatial_transformer(config, mid_ch, config.num_transformers_per_block[-1])),
                ("res", ResidualBlock(mid_ch, self.time_embed_dim, mid_ch)),
            ]
        )
        self.output_blocks = _BlockStack(_build_up_blocks(config, self.time_embed_dim))
        self.out = nn.ModuleDict(
            {
                "0": GroupNorm(32, config.hidden_dim, eps=1e-5),
                "2": Conv2d(config.hidden_dim, config.out_channels, 3, padding=1),
            }
        )

    def prepare_global_condition(
        self,
        timestep: torch.Tensor,
        text_pooler_output: torch.Tensor,
        original_size: torch.Tensor,
        target_size: torch.Tensor,
        crop_coords: torch.Tensor,
        dtype: torch.dtype,
    ):
        """Timestep sinusoid + 6 x 256-d size Fourier + pooled text -> MLPs."""
        time_sin = get_timestep_embedding(
            timestep, self.hidden_dim, flip_sin_to_cos=True, downscale_freq_shift=0.0
        ).to(dtype)
        time_embed = self.time_embed(time_sin)

        batch = text_pooler_output.shape[0]
        additional = torch.cat([original_size, crop_coords, target_size], dim=1).reshape(-1)
        additional = get_timestep_embedding(
            additional, self.additional_cond_dim, flip_sin_to_cos=True, downscale_freq_shift=0.0
        ).reshape(batch, -1)
        global_cond = torch.cat(
            [text_pooler_output, additional.to(text_pooler_output.dtype)], dim=1
        ).to(dtype)
        global_cond = self.label_emb["0"](global_cond)
        return time_embed, global_cond + time_embed

    def forward(
        self,
        latents: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        encoder_pooler_output: torch.Tensor,
        original_size: torch.Tensor,
        target_size: torch.Tensor,
        crop_coords_top_left: torch.Tensor,
    ) -> torch.Tensor:
        _, global_cond = self.prepare_global_condition(
            timestep, encoder_pooler_output, original_size, target_size,
            crop_coords_top_left, latents.dtype,
        )
        context = encoder_hidden_states
        h = latents
        skips = []
        for kinds, modules in zip(self.input_blocks.kinds, self.input_blocks.blocks):
            h = _run_layer_list(kinds, modules, h, context, global_cond)
            skips.append(h)
        h = _run_layer_list(
            self.middle_block.kinds, self.middle_block.blocks, h, context, global_cond
        )
        for kinds, modules in zip(self.output_blocks.kinds, self.output_blocks.blocks):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _run_layer_list(kinds, modules, h, context, global_cond)
        h = F.silu(self.out["0"](h))
        return self.out["2"](h)


class Denoiser(UNet):
    """Config-constructed UNet."""
