"""CogView4 DiT denoiser (``vision_ft_tpu/models/cogview4/denoiser.py``
counterpart), NHWC latents.

- The text is projected (``patch_embed.text_proj``), the latent is
  patchified ((c, ph, pw) feature order, ``modules/patch``) and projected
  (``patch_embed.proj``); each block attends over the joint sequence
  [text | image], at 1024 px 16 caption tokens or more and 4096 patches.
- Attention runs on heads-packed (B, S, H*D) tensors through
  ``ops.attention.attention_heads_packed``: q and k get a per-head fp32
  LayerNorm (no affine) on a (B, S, H, D) view, the image part of each a
  2-axis rotary embedding (halves rotation with full-width cos / sin), and
  no head transpose is made. With the "flash" backend (the default) a
  CUDA call goes to the BSHD flash kernel B (32 heads of 128 in the
  default config) and its gradient to kernel C.
- Each block has a 12-way modulation (shift, scale and gate for the
  attention and the feed-forward, each for the image and the text), an
  affine-free LayerNorm (the plain formula: only affine bf16 LayerNorms
  take kernel A, as the JAX gate has it) and a GELU-tanh feed-forward
  shared by both streams.
- The global condition is the timestep sinusoid and the size conditioning
  (original size, crop, target size), each through an MLP, summed, SiLU.

``deepcache_forward`` caches the deep blocks' residual across steps.
``set_gradient_checkpointing(True)`` checkpoints each block
(``nn.core.run_remat_stack``) in a forward that runs with gradients.
``set_pipeline`` (GPipe over a mesh) is not ported and raises by name.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...modules.patch import patchify, unpatchify_cmajor
from ...modules.timestep.embedding import TimestepEmbedding, get_timestep_embedding
from ...nn import LayerNorm, Linear, run_remat_stack, save_name, saved_products
from ...ops.attention import attention_heads_packed
from ..auraflow.denoiser import _qk_norm  # the per-head fp32 LayerNorm without affine
from .config import DenoiserConfig

DENOISER_TENSOR_PREFIX = "diffusion_model."


class GlobalConditionEmbedding(nn.ModuleDict):
    """Timestep sinusoid and the 3 x 2 size sinusoids, each through an MLP,
    summed, SiLU."""

    def __init__(self, embedding_dim: int, condition_dim: int, pooled_projection_dim: int,
                 timesteps_dim: int = 256):
        super().__init__(
            {
                "timestep_embedder": TimestepEmbedding(timesteps_dim, embedding_dim),
                "condition_embedder": TimestepEmbedding(pooled_projection_dim, embedding_dim),
            }
        )
        self.condition_dim = condition_dim
        self.timesteps_dim = timesteps_dim

    def forward(self, timestep, original_size, target_size, crop_coords, dtype):
        t_proj = get_timestep_embedding(
            timestep, self.timesteps_dim, flip_sin_to_cos=True, downscale_freq_shift=0.0
        )

        def cond(v):
            return get_timestep_embedding(
                v.reshape(-1), self.condition_dim, flip_sin_to_cos=True, downscale_freq_shift=0.0
            ).reshape(v.shape[0], -1)

        condition = torch.cat([cond(original_size), cond(crop_coords), cond(target_size)], dim=1)
        t_emb = self["timestep_embedder"](t_proj.to(dtype))
        c_emb = self["condition_embedder"](condition.to(dtype))
        return F.silu(t_emb + c_emb)


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Halves rotation of heads-packed (B, S, H, D) with full-width fp32
    ``cos`` / ``sin`` (S, D): x * cos + [-x2, x1] * sin, in fp32."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[None, :, None] + rotated.float() * sin[None, :, None]).to(x.dtype)


class SelfAttention(nn.ModuleDict):
    def __init__(self, hidden_dim: int, num_heads: int, bias: bool = True,
                 attention_backend: str = "xla"):
        super().__init__(
            {
                "to_q": Linear(hidden_dim, hidden_dim, bias=bias),
                "to_k": Linear(hidden_dim, hidden_dim, bias=bias),
                "to_v": Linear(hidden_dim, hidden_dim, bias=bias),
                "to_out": nn.ModuleDict({"0": Linear(hidden_dim, hidden_dim, bias=bias)}),
            }
        )
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.backend = attention_backend

    @saved_products()
    def forward(self, hidden_states, encoder_hidden_states, rope_freqs):
        text_len = encoder_hidden_states.shape[1]
        x = torch.cat([encoder_hidden_states, hidden_states], dim=1)
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q = _qk_norm(self["to_q"](x).reshape(b, s, h, d))
        k = _qk_norm(self["to_k"](x).reshape(b, s, h, d))
        v = self["to_v"](x)
        if rope_freqs is not None:
            cos, sin = rope_freqs
            q = torch.cat([q[:, :text_len], _apply_rotary(q[:, text_len:], cos, sin)], dim=1)
            k = torch.cat([k[:, :text_len], _apply_rotary(k[:, text_len:], cos, sin)], dim=1)
        attn = attention_heads_packed(
            q.reshape(b, s, h * d), k.reshape(b, s, h * d), v, h, backend=self.backend
        )
        attn = self["to_out"]["0"](attn)
        return attn[:, text_len:], attn[:, :text_len]


class FeedForward(nn.ModuleDict):
    def __init__(self, hidden_dim: int, mlp_scale: float = 4.0, bias: bool = True):
        inner = int(hidden_dim * mlp_scale)
        super().__init__(
            {
                "net": nn.ModuleDict(
                    {
                        "0": nn.ModuleDict({"proj": Linear(hidden_dim, inner, bias=bias)}),
                        "2": Linear(inner, hidden_dim, bias=bias),
                    }
                )
            }
        )

    def forward(self, x):
        h = F.gelu(self["net"]["0"]["proj"](x), approximate="tanh")
        return self["net"]["2"](save_name(h, "ff_inner"))


class TransformerBlock(nn.ModuleDict):
    def __init__(self, hidden_dim: int, num_attention_heads: int, time_embed_dim: int,
                 attention_backend: str = "xla"):
        super().__init__(
            {
                "norm1": nn.ModuleDict({"linear": Linear(time_embed_dim, 12 * hidden_dim)}),
                "attn1": SelfAttention(hidden_dim, num_attention_heads, True, attention_backend),
                "ff": FeedForward(hidden_dim),
            }
        )
        self.norm = LayerNorm(hidden_dim, eps=1e-5, elementwise_affine=False)  # no parameters

    def forward(self, hidden_states, encoder_hidden_states, time_embed, rope_freqs):
        (shift_msa, c_shift_msa, scale_msa, c_scale_msa, gate_msa, c_gate_msa,
         shift_mlp, c_shift_mlp, scale_mlp, c_scale_mlp, gate_mlp, c_gate_mlp) = (
            self["norm1"]["linear"](time_embed).chunk(12, dim=1)
        )
        norm_h = self.norm(hidden_states) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        norm_c = self.norm(encoder_hidden_states) * (1 + c_scale_msa[:, None]) + c_shift_msa[:, None]

        attn_h, attn_c = self["attn1"](norm_h, norm_c, rope_freqs)
        hidden_states = save_name(hidden_states + attn_h * gate_msa[:, None], "res_stream")
        encoder_hidden_states = save_name(
            encoder_hidden_states + attn_c * c_gate_msa[:, None], "res_stream"
        )

        norm_h = self.norm(hidden_states) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        norm_c = self.norm(encoder_hidden_states) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        hidden_states = hidden_states + self["ff"](norm_h) * gate_mlp[:, None]
        encoder_hidden_states = encoder_hidden_states + self["ff"](norm_c) * c_gate_mlp[:, None]
        return hidden_states, encoder_hidden_states


@functools.lru_cache(maxsize=16)
def _rope_tables(height: int, width: int, patch_size: int, head_dim: int,
                 rope_axes_dim: tuple[int, int], theta: float = 10000.0):
    """fp32 numpy (cos, sin) of the image tokens, (h*w, head_dim): the
    2-axis table resampled onto the patch grid, as the JAX package builds
    it."""
    hp, wp = height // patch_size, width // patch_size
    dim_h = dim_w = head_dim // 2
    h_inv = 1.0 / (theta ** (np.arange(0, dim_h, 2, dtype=np.float32)[: dim_h // 2] / dim_h))
    w_inv = 1.0 / (theta ** (np.arange(0, dim_w, 2, dtype=np.float32)[: dim_w // 2] / dim_w))
    freqs_h_table = np.outer(np.arange(rope_axes_dim[0]), h_inv).astype(np.float32)
    freqs_w_table = np.outer(np.arange(rope_axes_dim[1]), w_inv).astype(np.float32)
    inner_h = np.arange(hp) * rope_axes_dim[0] // hp
    inner_w = np.arange(wp) * rope_axes_dim[1] // wp
    fh = freqs_h_table[inner_h][:, None].repeat(wp, axis=1)
    fw = freqs_w_table[inner_w][None, :].repeat(hp, axis=0)
    freqs = np.concatenate([fh, fw], axis=-1)
    freqs = np.concatenate([freqs, freqs], axis=-1).reshape(hp * wp, -1)
    return np.cos(freqs), np.sin(freqs)


class FinalAdaLayerNorm(nn.ModuleDict):
    def __init__(self, hidden_dim: int, condition_dim: int):
        super().__init__({"linear": Linear(condition_dim, 2 * hidden_dim)})
        self.norm = LayerNorm(hidden_dim, eps=1e-5, elementwise_affine=False)  # no parameters

    def forward(self, hidden_states, condition):
        scale, shift = self["linear"](F.silu(condition).to(hidden_states.dtype)).chunk(2, dim=-1)
        return self.norm(hidden_states) * (1 + scale)[:, None] + shift[:, None]


class CogView4DiT(nn.Module):
    def __init__(self, config: DenoiserConfig):
        super().__init__()
        self.config = config
        self.inner_dim = config.num_attention_heads * config.attention_head_dim
        self.patch_size = config.patch_size
        self.out_channels = config.out_channels
        self.pooled_projection_dim = 3 * 2 * config.condition_dim
        self.gradient_checkpointing = False

        self.patch_embed = nn.ModuleDict(
            {
                "proj": Linear(config.in_channels * config.patch_size**2, self.inner_dim),
                "text_proj": Linear(config.text_embed_dim, self.inner_dim),
            }
        )
        self.time_condition_embed = GlobalConditionEmbedding(
            embedding_dim=config.time_embed_dim,
            condition_dim=config.condition_dim,
            pooled_projection_dim=self.pooled_projection_dim,
            timesteps_dim=self.inner_dim,
        )
        self.transformer_blocks = nn.ModuleDict(
            {
                str(i): TransformerBlock(self.inner_dim, config.num_attention_heads,
                                         config.time_embed_dim, config.attention_backend)
                for i in range(config.num_layers)
            }
        )
        self.norm_out = FinalAdaLayerNorm(self.inner_dim, config.time_embed_dim)
        self.proj_out = Linear(self.inner_dim, config.patch_size**2 * config.out_channels)

    def set_gradient_checkpointing(self, enabled: bool):
        """Checkpoint each block whenever a forward runs with gradients
        enabled."""
        self.gradient_checkpointing = enabled

    def _remat(self) -> bool:
        return self.gradient_checkpointing and torch.is_grad_enabled()

    def set_pipeline(self, mesh, num_microbatches: int, axis: str = "pipe"):
        if mesh is not None:
            raise NotImplementedError(
                "set_pipeline (GPipe pipelining of the transformer blocks over a mesh) "
                "is not ported yet (ROADMAP.md queue 1, item 8)"
            )

    # -- forward ------------------------------------------------------------------

    def _prepare_tokens(self, latent, encoder_hidden_states, timestep, original_size,
                        target_size, crop_coords):
        """Embeddings, RoPE tables and the global condition: the steps
        shared by ``forward`` and ``deepcache_forward``."""
        _, height, width, _ = latent.shape
        hidden_states = self.patch_embed["proj"](patchify(latent, self.patch_size))
        encoder_hidden_states = self.patch_embed["text_proj"](encoder_hidden_states)
        cos, sin = _rope_tables(height, width, self.patch_size, self.config.attention_head_dim,
                                tuple(self.config.rope_axes_dim))
        rope_freqs = (torch.from_numpy(cos).to(latent.device),
                      torch.from_numpy(sin).to(latent.device))
        global_cond = self.time_condition_embed(
            timestep, original_size, target_size, crop_coords, hidden_states.dtype
        )
        return hidden_states, encoder_hidden_states, rope_freqs, global_cond, height, width

    def _run_blocks_range(self, hidden_states, encoder_hidden_states, global_cond, rope_freqs,
                          start: int = 0, end: Optional[int] = None):
        """Blocks [start, end) as a plain stack, checkpointed in groups of
        ``nn.remat_group()`` blocks."""
        end = len(self.transformer_blocks) if end is None else end
        return run_remat_stack(
            lambda block, hc: block(hc[0], hc[1], global_cond, rope_freqs),
            [self.transformer_blocks[str(i)] for i in range(start, end)],
            (hidden_states, encoder_hidden_states),
            self._remat(),
        )

    def _finish(self, hidden_states, global_cond, height: int, width: int):
        p = self.patch_size
        hidden_states = self.proj_out(self.norm_out(hidden_states, global_cond))
        return unpatchify_cmajor(hidden_states, height // p, width // p, p, self.out_channels)

    def forward(
        self,
        latent: torch.Tensor,  # (B, H, W, C)
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        original_size: torch.Tensor,
        target_size: torch.Tensor,
        crop_coords: torch.Tensor,
    ) -> torch.Tensor:
        hidden_states, encoder_hidden_states, rope_freqs, global_cond, height, width = (
            self._prepare_tokens(latent, encoder_hidden_states, timestep, original_size,
                                 target_size, crop_coords)
        )
        hidden_states, _ = self._run_blocks_range(
            hidden_states, encoder_hidden_states, global_cond, rope_freqs
        )
        return self._finish(hidden_states, global_cond, height, width)

    def deepcache_forward(
        self,
        latent: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        original_size: torch.Tensor,
        target_size: torch.Tensor,
        crop_coords: torch.Tensor,
        cached_delta: Optional[torch.Tensor] = None,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """Step caching for the block stack (delta caching, as the other
        DiTs' ``deepcache_forward``). The stack is residual, so it is split
        at ``cache_depth`` k (default N // 4): a full (``refresh``) step
        records ``delta = h_N - h_k`` of the image stream, the summed
        contribution of the deep blocks [k, N); a cached step runs the
        shallow blocks [0, k) fresh and takes ``h_N = h_k + delta``. Only
        the image stream's delta is kept: the final layer never reads the
        text stream. Returns (velocity, delta)."""
        n = len(self.transformer_blocks)
        k = cache_depth if cache_depth is not None else max(1, n // 4)
        if not 0 < k < n:
            raise ValueError(f"cache_depth {k} outside (0, {n})")
        hidden_states, encoder_hidden_states, rope_freqs, global_cond, height, width = (
            self._prepare_tokens(latent, encoder_hidden_states, timestep, original_size,
                                 target_size, crop_coords)
        )
        hidden_states, encoder_hidden_states = self._run_blocks_range(
            hidden_states, encoder_hidden_states, global_cond, rope_freqs, 0, k
        )
        if refresh:
            shallow = hidden_states
            hidden_states, _ = self._run_blocks_range(
                hidden_states, encoder_hidden_states, global_cond, rope_freqs, k, n
            )
            delta = hidden_states - shallow
        else:
            if cached_delta is None:
                raise ValueError("a cached step needs cached_delta")
            hidden_states = hidden_states + cached_delta.to(hidden_states.dtype)
            delta = cached_delta
        return self._finish(hidden_states, global_cond, height, width), delta


class Denoiser(CogView4DiT):
    @classmethod
    def from_config(cls, config: DenoiserConfig) -> "Denoiser":
        return cls(config)
