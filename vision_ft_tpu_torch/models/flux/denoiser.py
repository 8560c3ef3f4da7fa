"""Flux transformer denoiser (``vision_ft_tpu/models/flux/denoiser.py``
counterpart), NHWC latents.

- Double-stream blocks (separate image / text qkv and MLPs, one joint
  attention over [text; image]), then single-stream blocks over the joint
  sequence (fused ``linear1`` / ``linear2``), then the final adaLN layer.
- q and k get Flux's RMS norm (fp32 normalize, cast, times ``scale``) per
  head on (B, S, H, D) views of the heads-packed projections; 3-axis RoPE
  over [text (zeros), image (y, x)] positions; attention runs on
  heads-packed (B, S, H*D) tensors through
  ``ops.attention.attention_heads_packed``, so no head transpose is made.
  With ``use_flash_attention`` a CUDA call goes to the BSHD flash kernel B
  (24 heads of 128 in the published configs: 512 + 4096 keys at 1024 px);
  without it, the default as in the JAX package, the plain formula.
- The affine-free LayerNorms take the plain formula, as the JAX gate has it.
- The distilled guidance embedding (flux1-dev, flex1-alpha) is added where
  a row's guidance is > 0. The gate is per row: the JAX package gates on
  the batch's maximum, which equals this wherever a batch's guidance is
  uniform (``generate()``), but lets a row of guidance 0 in a serving pool
  take its neighbours' embedding.

``deepcache_forward`` caches the deep single blocks' residual across steps.
``set_gradient_checkpointing(True)`` checkpoints each block of both stacks
(``nn.core.run_remat_stack``) in a forward that runs with gradients.
``set_pipeline`` (GPipe over a mesh) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...modules.patch import patchify, unpatchify_cmajor
from ...modules.positional_encoding.rope import RoPEFrequency, apply_rope_qk
from ...nn import LayerNorm, Linear, run_remat_stack, save_name
from ...ops.attention import attention_heads_packed
from .config import DenoiserConfig

DENOISER_TENSOR_PREFIX = "model.diffusion_model."


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Cos-first sinusoid of ``time_factor * t``, in fp32."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class MLPEmbedder(nn.ModuleDict):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__({"in_layer": Linear(in_dim, hidden_dim),
                          "out_layer": Linear(hidden_dim, hidden_dim)})

    def forward(self, x):
        return self["out_layer"](F.silu(self["in_layer"](x)))


class _FluxRMSNorm(nn.Module):
    """Flux's RMSNorm: the weight is ``scale``; normalized in fp32, cast to
    the input's dtype, then scaled."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + 1e-6)
        return h.to(x.dtype) * self.scale.to(x.dtype)


class QKNorm(nn.ModuleDict):
    def __init__(self, dim: int):
        super().__init__({"query_norm": _FluxRMSNorm(dim), "key_norm": _FluxRMSNorm(dim)})

    def forward(self, q, k):
        return self["query_norm"](q), self["key_norm"](k)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, L, 3*H*D) -> three (B, L, H, D) views, K-major ((K H D) feature
    order) but heads-packed: the per-head norm and RoPE run on these views
    and attention takes (B, L, H*D), so no (B, H, L, D) transpose exists."""
    b, s, _ = qkv.shape
    qkv = qkv.reshape(b, s, 3, num_heads, -1)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attention(q, k, v, num_heads: int, pe: torch.Tensor, backend: str) -> torch.Tensor:
    """RoPE on q and k, then attention over the heads-packed sequence."""
    q, k = apply_rope_qk(q, k, pe[:, None])
    b, s, h, d = q.shape
    return attention_heads_packed(
        q.reshape(b, s, h * d), k.reshape(b, s, h * d), v.reshape(b, s, h * d), h,
        backend=backend,
    )


class SelfAttention(nn.ModuleDict):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False):
        super().__init__({
            "qkv": Linear(dim, dim * 3, bias=qkv_bias),
            "norm": QKNorm(dim // num_heads),
            "proj": Linear(dim, dim),
        })
        self.num_heads = num_heads

    def qkv_heads(self, x):
        q, k, v = _split_heads(self["qkv"](x), self.num_heads)
        q, k = self["norm"](q, k)
        return q, k, v


class Modulation(nn.ModuleDict):
    def __init__(self, dim: int, double: bool):
        super().__init__({"lin": Linear(dim, (6 if double else 3) * dim)})
        self.multiplier = 6 if double else 3

    def forward(self, vec):
        return self["lin"](F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)


def _mlp(module: nn.ModuleDict, x):
    return module["2"](save_name(_gelu_tanh(module["0"](x)), "ff_inner"))


class DoubleStreamBlock(nn.ModuleDict):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool = False, use_flash_attention: bool = False):
        mlp_hidden = int(hidden_size * mlp_ratio)

        def mlp():
            return nn.ModuleDict({"0": Linear(hidden_size, mlp_hidden),
                                  "2": Linear(mlp_hidden, hidden_size)})

        super().__init__({
            "img_mod": Modulation(hidden_size, double=True),
            "img_attn": SelfAttention(hidden_size, num_heads, qkv_bias),
            "img_mlp": mlp(),
            "txt_mod": Modulation(hidden_size, double=True),
            "txt_attn": SelfAttention(hidden_size, num_heads, qkv_bias),
            "txt_mlp": mlp(),
        })
        self.num_heads = num_heads
        self.backend = "flash" if use_flash_attention else "xla"
        self.norm = LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False)

    def forward(self, img, txt, vec, pe):
        i_shift, i_scale, i_gate, i_shift2, i_scale2, i_gate2 = self["img_mod"](vec)
        t_shift, t_scale, t_gate, t_shift2, t_scale2, t_gate2 = self["txt_mod"](vec)

        iq, ik, iv = self["img_attn"].qkv_heads((1 + i_scale) * self.norm(img) + i_shift)
        tq, tk, tv = self["txt_attn"].qkv_heads((1 + t_scale) * self.norm(txt) + t_shift)
        attn = _attention(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                          torch.cat([tv, iv], dim=1), self.num_heads, pe, self.backend)
        txt_len = txt.shape[1]
        txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

        img = save_name(img + i_gate * self["img_attn"]["proj"](img_attn), "res_stream")
        img = img + i_gate2 * _mlp(self["img_mlp"], (1 + i_scale2) * self.norm(img) + i_shift2)
        txt = save_name(txt + t_gate * self["txt_attn"]["proj"](txt_attn), "res_stream")
        txt = txt + t_gate2 * _mlp(self["txt_mlp"], (1 + t_scale2) * self.norm(txt) + t_shift2)
        return img, txt


class SingleStreamBlock(nn.ModuleDict):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_flash_attention: bool = False):
        mlp_hidden = int(hidden_size * mlp_ratio)
        super().__init__({
            "linear1": Linear(hidden_size, hidden_size * 3 + mlp_hidden),
            "linear2": Linear(hidden_size + mlp_hidden, hidden_size),
            "norm": QKNorm(hidden_size // num_heads),
            "modulation": Modulation(hidden_size, double=False),
        })
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.mlp_hidden_dim = mlp_hidden
        self.backend = "flash" if use_flash_attention else "xla"
        self.pre_norm = LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False)

    def forward(self, x, vec, pe):
        shift, scale, gate = self["modulation"](vec)
        h = self["linear1"]((1 + scale) * self.pre_norm(x) + shift)
        qkv, mlp = h.split([3 * self.hidden_size, self.mlp_hidden_dim], dim=-1)
        q, k, v = _split_heads(qkv, self.num_heads)
        q, k = self["norm"](q, k)
        attn = _attention(q, k, v, self.num_heads, pe, self.backend)
        output = self["linear2"](save_name(torch.cat([attn, _gelu_tanh(mlp)], dim=2), "ff_inner"))
        return x + gate * output


class LastLayer(nn.ModuleDict):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__({
            "linear": Linear(hidden_size, patch_size * patch_size * out_channels),
            "adaLN_modulation": nn.ModuleDict({"1": Linear(hidden_size, 2 * hidden_size)}),
        })
        self.norm_final = LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False)

    def forward(self, x, vec):
        shift, scale = self["adaLN_modulation"]["1"](F.silu(vec)).chunk(2, dim=1)
        x = (1 + scale[:, None, :]) * self.norm_final(x) + shift[:, None, :]
        return self["linear"](x)


class Flux(nn.Module):
    def __init__(self, config: DenoiserConfig):
        super().__init__()
        if config.hidden_size % config.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        pe_dim = config.hidden_size // config.num_heads
        if sum(config.axes_dim) != pe_dim:
            raise ValueError(f"Got {config.axes_dim} but expected positional dim {pe_dim}")
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_heads
        self.patch_size = config.patch_size
        self.vae_channels = config.vae_channels
        self.gradient_checkpointing = False
        self._pe_cache: Optional[tuple] = None

        self.rope_frequency = RoPEFrequency(config.axes_dim, config.theta)
        hidden, heads, flash = config.hidden_size, config.num_heads, config.use_flash_attention
        self.img_in = Linear(config.in_channels, hidden)
        self.time_in = MLPEmbedder(256, hidden)
        self.vector_in = MLPEmbedder(config.vec_in_dim, hidden)
        self.guidance_in = MLPEmbedder(256, hidden) if config.guidance_embed else None
        self.txt_in = Linear(config.context_in_dim, hidden)
        self.double_blocks = nn.ModuleDict({
            str(i): DoubleStreamBlock(hidden, heads, config.mlp_ratio, config.qkv_bias, flash)
            for i in range(config.depth)
        })
        self.single_blocks = nn.ModuleDict({
            str(i): SingleStreamBlock(hidden, heads, config.mlp_ratio, flash)
            for i in range(config.depth_single_blocks)
        })
        self.final_layer = LastLayer(hidden, 1, config.out_channels)

    def set_gradient_checkpointing(self, enabled: bool):
        """Checkpoint each block of both stacks whenever a forward runs with
        gradients enabled."""
        self.gradient_checkpointing = enabled

    def _remat(self) -> bool:
        return self.gradient_checkpointing and torch.is_grad_enabled()

    def set_pipeline(self, mesh, num_microbatches: int, axis: str = "pipe"):
        if mesh is not None:
            raise NotImplementedError(
                "set_pipeline (GPipe pipelining of the double and single stacks over a mesh) "
                "is not ported yet (ROADMAP.md queue 1, item 6)"
            )

    # -- forward ------------------------------------------------------------------

    def _rope_table(self, txt_len: int, height: int, width: int, device) -> torch.Tensor:
        """The RoPE cos/sin table of [text; image] positions, kept for the
        last shape asked (a denoise loop asks one shape every step); a table
        made under ``inference_mode`` is not reused by a forward with
        gradients."""
        key = (txt_len, height, width, torch.device(device), torch.is_inference_mode_enabled())
        if self._pe_cache is None or self._pe_cache[0] != key:
            txt_ids = self.rope_frequency.get_text_position_indices(txt_len)
            img_ids = self.rope_frequency.get_image_position_indices(height, width)
            table = self.rope_frequency(np.concatenate([txt_ids, img_ids], axis=0), device)
            self._pe_cache = (key, table)
        return self._pe_cache[1]

    def _prepare_tokens(self, latent, t5_hidden_states, timesteps, clip_hidden_states,
                        guidance):
        """Input projections, the modulation vector and the RoPE table:
        the steps shared by ``forward`` and ``deepcache_forward``."""
        _, height, width, _ = latent.shape
        img = self.img_in(patchify(latent, self.patch_size))  # (c, ph, pw) feature order
        txt = self.txt_in(t5_hidden_states)

        vec = self.time_in(timestep_embedding(timesteps, 256).to(img.dtype))
        if self.guidance_in is not None and guidance is not None:
            gate = (guidance > 0).to(img.dtype)[:, None]  # per row (module docstring)
            vec = vec + gate * self.guidance_in(timestep_embedding(guidance, 256).to(img.dtype))
        vec = vec + self.vector_in(clip_hidden_states)
        pe = self._rope_table(txt.shape[1], height, width, img.device)
        return img, txt, vec, pe, height, width

    def _run_double_blocks(self, img, txt, vec, pe):
        return run_remat_stack(
            lambda block, it: block(it[0], it[1], vec, pe),
            self.double_blocks.values(), (img, txt), self._remat(),
        )

    def _run_single_range(self, x, vec, pe, start: int = 0, end: Optional[int] = None):
        """Single (joint-sequence) blocks [start, end)."""
        end = len(self.single_blocks) if end is None else end
        return run_remat_stack(
            lambda block, xx: block(xx, vec, pe),
            [self.single_blocks[str(i)] for i in range(start, end)], x, self._remat(),
        )

    def _finish(self, img, vec, height: int, width: int):
        p = self.patch_size
        img = self.final_layer(img, vec)
        return unpatchify_cmajor(img, height // p, width // p, p, self.vae_channels)

    def forward(
        self,
        latent: torch.Tensor,  # (B, H, W, C), C = vae_channels
        t5_hidden_states: torch.Tensor,
        timesteps: torch.Tensor,
        clip_hidden_states: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        img, txt, vec, pe, height, width = self._prepare_tokens(
            latent, t5_hidden_states, timesteps, clip_hidden_states, guidance
        )
        img, txt = self._run_double_blocks(img, txt, vec, pe)
        x = self._run_single_range(torch.cat([txt, img], dim=1), vec, pe)
        return self._finish(x[:, txt.shape[1]:], vec, height, width)

    def deepcache_forward(
        self,
        latent: torch.Tensor,
        t5_hidden_states: torch.Tensor,
        timesteps: torch.Tensor,
        clip_hidden_states: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,
        cached_delta: Optional[torch.Tensor] = None,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """Step caching for the single-block stack (delta caching, as the
        port's Lumina2 and AuraFlow). The double blocks always run; the
        single stack is residual, so it is split at ``cache_depth`` k
        (default N // 4): a full (``refresh``) step records ``delta = x_N -
        x_k``, the deep blocks' summed contribution, and a cached step runs
        the shallow blocks [0, k) fresh and takes ``x_N = x_k + delta``.
        Returns (velocity, delta)."""
        n = len(self.single_blocks)
        k = cache_depth if cache_depth is not None else max(1, n // 4)
        if not 0 < k < n:
            raise ValueError(f"cache_depth {k} outside (0, {n})")
        img, txt, vec, pe, height, width = self._prepare_tokens(
            latent, t5_hidden_states, timesteps, clip_hidden_states, guidance
        )
        for block in self.double_blocks.values():
            img, txt = block(img, txt, vec, pe)
        x = self._run_single_range(torch.cat([txt, img], dim=1), vec, pe, 0, k)
        if refresh:
            shallow = x
            x = self._run_single_range(x, vec, pe, k, n)
            delta = x - shallow
        else:
            if cached_delta is None:
                raise ValueError("a cached step needs cached_delta")
            x = x + cached_delta.to(x.dtype)
            delta = cached_delta
        return self._finish(x[:, txt.shape[1]:], vec, height, width), delta


class Denoiser(Flux):
    @classmethod
    def from_config(cls, config: DenoiserConfig) -> "Denoiser":
        return cls(config)
