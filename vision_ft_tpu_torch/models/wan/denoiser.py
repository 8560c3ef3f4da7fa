"""Wan 2.2 video DiT denoiser (``vision_ft_tpu/models/wan/denoiser.py``
counterpart), dense NFHWC latents ``(B, F, H, W, C)`` on one grid a batch.

- The Conv3d patch embedding (kernel = stride = (1, 2, 2)) is a reshape
  and one matmul on the OIDHW weight, whose layout the checkpoint keeps.
- RoPE on three axes (frames, height, width) from float64 tables, cast to
  fp32: head dim 128 splits 44 / 42 / 42, and the rotation acts on
  interleaved (even, odd) pairs of the bf16 projection in fp32, then casts
  back.
- ``WanAttention`` applies an RMSNorm over the full width to q and k before
  the head split, and runs ``ops.attention.attention_heads_packed`` with
  the "flash" backend: on the card kernel B at head dim 128 (24 heads in
  the published config), self-attention over the video tokens (Sq = Sk)
  and cross-attention from them to the 512 text positions (Sk = 512).
- The residual stream and the modulation stay in fp32, as do the time
  MLP and the head; a timestep is one a sample ``(B,)`` (embedded once and
  broadcast over the tokens) or one a token ``(B, L)``.
- The context is zero-padded to ``text_len`` and embedded; cross-attention
  sees all ``text_len`` keys with no mask.

``deepcache_forward`` caches the deep blocks' residual across steps;
``set_gradient_checkpointing(True)`` checkpoints the blocks
(``nn.run_remat_stack``) in a forward that runs with gradients.
``set_pipeline`` (GPipe over a mesh) is not ported and raises by name.

Seeded init (``nn.init_parameters_``): every Linear takes the leaf rule,
the modulation tables N(0, 1) / sqrt(dim), the patch embedding
Xavier-uniform with a zero bias. The JAX package also zeros the head and
draws the text and time MLPs from N(0, 0.02), the init of a training run
from scratch, which the port has no path for; its checks want every layer
to act.

A quantized Linear of the fp32 parts (the time MLP and projection)
multiplies a bf16 copy of its input, the input kernel D takes, and its
result rejoins the fp32 stream.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import LayerNorm, Linear, RMSNorm, run_remat_stack, save_name
from ...ops.attention import attention_heads_packed
from .config import DenoiserConfig


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoid table of ``position`` (any shape), fp32."""
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=pos.device) / half)
    sinusoid = pos[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


def _rope_tables(max_seq_len: int, dim: int, theta: float = 10000.0):
    """float64 numpy (cos, sin) of one RoPE axis, (max_seq_len, dim // 2)."""
    freqs = np.outer(
        np.arange(max_seq_len, dtype=np.float64),
        1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim),
    )
    return np.cos(freqs), np.sin(freqs)


@functools.lru_cache(maxsize=16)
def rope_for_grid(grid: tuple[int, int, int], head_dim: int):
    """fp32 numpy (cos, sin) of a (frames, height, width) token grid,
    (f * h * w, head_dim // 2): the three axis tables (widths d - 4 (d // 6),
    2 (d // 6), 2 (d // 6)) expanded over the grid and concatenated."""
    f, h, w = grid
    d = head_dim
    parts_cos, parts_sin = [], []
    for dim, axis_len, before, after in ((d - 4 * (d // 6), f, 1, h * w),
                                         (2 * (d // 6), h, f, w),
                                         (2 * (d // 6), w, f * h, 1)):
        cos, sin = (t[:axis_len] for t in _rope_tables(1024, dim))
        for table, parts in ((cos, parts_cos), (sin, parts_sin)):
            parts.append(np.tile(np.repeat(table, after, axis=0), (before, 1)))
    cos = np.concatenate(parts_cos, axis=1).astype(np.float32)
    sin = np.concatenate(parts_sin, axis=1).astype(np.float32)
    return cos, sin


def apply_rope(x: torch.Tensor, num_heads: int, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotation of interleaved (even, odd) pairs of heads-packed (B, S, H*d)
    ``x`` in fp32 by fp32 ``cos`` / ``sin`` (S, d // 2); fp32 out."""
    b, s, hd = x.shape
    xf = x.float().reshape(b, s, num_heads, hd // num_heads // 2, 2)
    even, odd = xf[..., 0], xf[..., 1]
    cos, sin = cos[:, None], sin[:, None]  # (S, 1, c) over (B, S, H, c)
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return out.reshape(b, s, hd)


def _linear_fp32(layer: Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear of the fp32 parts: fp32 weights and input, fp32 out. A
    quantized weight multiplies a copy of the input in the model's dtype
    (bf16 on the card: kernel D's input)."""
    if layer.is_quantized:
        return layer(x.to(layer.bias.dtype)).float()
    bias = None if layer.bias is None else layer.bias.float()
    return F.linear(x.float(), layer.weight.float(), bias)


class WanAttention(nn.Module):
    """q / k / v / o with an fp32 RMSNorm over the full width on q and k
    before the head split."""

    def __init__(self, dim: int, num_heads: int, eps: float = 1e-6):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.o = Linear(dim, dim)
        self.norm_q = RMSNorm(dim, eps=eps)
        self.norm_k = RMSNorm(dim, eps=eps)

    def forward(self, x, context=None, rope=None):
        context = x if context is None else context
        wdtype = self.q.bias.dtype
        x, context = x.to(wdtype), context.to(wdtype)
        q = self.norm_q(self.q(x))
        k = self.norm_k(self.k(context))
        v = self.v(context)
        if rope is not None:
            cos, sin = rope
            q = apply_rope(q, self.num_heads, cos, sin).to(wdtype)
            k = apply_rope(k, self.num_heads, cos, sin).to(wdtype)
        out = attention_heads_packed(q, k, v, self.num_heads,
                                     scale=1.0 / math.sqrt(self.head_dim), backend="flash")
        return self.o(out)


class WanBlock(nn.Module):
    """adaLN-zero DiT block: a learned (1, 6, dim) modulation table added to
    the timestep embedding, fp32 modulation and residual arithmetic."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, eps: float = 1e-6):
        super().__init__()
        self.dim = dim
        self.norm1 = LayerNorm(dim, eps=eps, elementwise_affine=False)
        self.self_attn = WanAttention(dim, num_heads, eps)
        self.norm3 = LayerNorm(dim, eps=eps, elementwise_affine=True)
        self.cross_attn = WanAttention(dim, num_heads, eps)
        self.norm2 = LayerNorm(dim, eps=eps, elementwise_affine=False)
        self.ffn = nn.ModuleDict({"0": Linear(dim, ffn_dim), "2": Linear(ffn_dim, dim)})
        self.modulation = nn.Parameter(torch.empty(1, 6, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.modulation.normal_(0.0, 1.0, generator=generator)
        self.modulation.div_(self.dim**0.5)

    def forward(self, x, timestep_embed, rope, context):
        # x: the fp32 residual stream (B, L, D); timestep_embed (B, L|1, 6, D) fp32
        mod = self.modulation.float() + timestep_embed
        shift_sa, scale_sa, gate_sa, shift_mlp, scale_mlp, gate_mlp = mod.unbind(dim=2)

        h = self.norm1(x) * (1 + scale_sa) + shift_sa
        attn = self.self_attn(h, rope=rope)
        x = save_name(x + attn.float() * gate_sa, "res_stream")

        h = self.norm3(x)
        x = save_name(x + self.cross_attn(h, context=context).float(), "res_stream")

        h = self.norm2(x) * (1 + scale_mlp) + shift_mlp
        h = self.ffn["0"](h.to(self.ffn["0"].bias.dtype))
        h = F.gelu(h, approximate="tanh")
        h = self.ffn["2"](save_name(h, "ff_inner"))
        return x + h.float() * gate_mlp


class FinalLayer(nn.Module):
    """Final adaLN (a (1, 2, dim) modulation table) and the fp32 head."""

    def __init__(self, dim: int, out_dim: int, patch_size, eps: float = 1e-6):
        super().__init__()
        self.dim = dim
        self.norm = LayerNorm(dim, eps=eps, elementwise_affine=False)
        self.head = Linear(dim, math.prod(patch_size) * out_dim)
        self.modulation = nn.Parameter(torch.empty(1, 2, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.modulation.normal_(0.0, 1.0, generator=generator)
        self.modulation.div_(self.dim**0.5)

    def forward(self, x, timestep_element):
        # timestep_element: (B, L|1, D) fp32
        mod = self.modulation.float() + timestep_element[:, :, None]
        shift, scale = mod[:, :, 0], mod[:, :, 1]
        h = self.norm(x) * (1 + scale) + shift
        return _linear_fp32(self.head, h)


class PatchEmbedding(nn.Module):
    """The Conv3d patch embedding's parameters: weight (dim, C, pf, ph, pw)
    (OIDHW) and bias (dim,)."""

    def __init__(self, in_dim: int, dim: int, patch_size):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, in_dim, *patch_size))
        self.bias = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.weight.shape[1:])
        bound = math.sqrt(6.0 / (fan_in + self.weight.shape[0]))
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.zero_()

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """NFHWC latents -> (B, f*h*w, dim) in the latents' dtype."""
        b, frames, height, width, c = latents.shape
        pf, ph, pw = self.weight.shape[2:]
        f, h, w = frames // pf, height // ph, width // pw
        x = latents.reshape(b, f, pf, h, ph, w, pw, c)
        # patch features in the Conv3d order (C, pf, ph, pw)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, f * h * w, c * pf * ph * pw)
        wmat = self.weight.reshape(self.weight.shape[0], -1).to(x.dtype)
        return F.linear(x, wmat, self.bias.to(x.dtype))


class DiT(nn.Module):
    """The Wan 2.2 DiT."""

    def __init__(
        self,
        model_type: str = "t2v",
        patch_size: tuple[int, int, int] = (1, 2, 2),
        text_len: int = 512,
        in_dim: int = 16,
        dim: int = 2048,
        ffn_dim: int = 8192,
        freq_dim: int = 256,
        text_dim: int = 4096,
        out_dim: int = 16,
        num_heads: int = 16,
        num_layers: int = 32,
        eps: float = 1e-6,
    ):
        super().__init__()
        if model_type not in ("t2v", "i2v", "ti2v"):
            raise ValueError(f"unknown model type {model_type!r}")
        if dim % num_heads or (dim // num_heads) % 2:
            raise ValueError(f"width {dim} over {num_heads} heads gives no even head dim")
        self.model_type = model_type
        self.patch_size = tuple(patch_size)
        self.text_len = text_len
        self.in_dim = in_dim
        self.dim = dim
        self.freq_dim = freq_dim
        self.out_dim = out_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.gradient_checkpointing = False

        self.patch_embedding = PatchEmbedding(in_dim, dim, self.patch_size)
        self.text_embedding = nn.ModuleDict({"0": Linear(text_dim, dim), "2": Linear(dim, dim)})
        self.time_embedding = nn.ModuleDict({"0": Linear(freq_dim, dim), "2": Linear(dim, dim)})
        self.time_projection = nn.ModuleDict({"1": Linear(dim, dim * 6)})
        self.blocks = nn.ModuleList(
            [WanBlock(dim, ffn_dim, num_heads, eps) for _ in range(num_layers)])
        self.head = FinalLayer(dim, out_dim, self.patch_size, eps)

    def set_gradient_checkpointing(self, value: bool) -> None:
        """Checkpoint the blocks whenever a forward runs with gradients."""
        self.gradient_checkpointing = value

    def set_pipeline(self, mesh, num_microbatches: int, axis: str = "pipe"):
        if mesh is not None:
            raise NotImplementedError(
                "set_pipeline (GPipe pipelining of the blocks over a mesh) is not ported yet "
                "(ROADMAP.md queue 1, item 8)"
            )

    # -- patching ---------------------------------------------------------------------

    def _unpatchify(self, patches: torch.Tensor, grid) -> torch.Tensor:
        """(B, L, prod(patch) * C_out) -> NFHWC."""
        b = patches.shape[0]
        f, h, w = grid
        pf, ph, pw = self.patch_size
        x = patches.reshape(b, f, h, w, pf, ph, pw, self.out_dim)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(b, f * pf, h * ph, w * pw, self.out_dim)

    # -- forward ----------------------------------------------------------------------

    def _prepare_tokens(self, latents, timesteps, context):
        """Patches, RoPE, the fp32 time embeddings and the embedded
        context: the steps ``forward`` and ``deepcache_forward`` share."""
        _, frames, height, width, _ = latents.shape
        pf, ph, pw = self.patch_size
        grid = (frames // pf, height // ph, width // pw)
        device = latents.device

        x = self.patch_embedding(latents)
        cos, sin = rope_for_grid(grid, self.dim // self.num_heads)
        rope = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))

        # the time embeddings in fp32; a timestep a sample embeds once
        t = timesteps.float()
        if t.ndim == 1:
            t = t[:, None]  # (B, 1)
        ts_sin = sinusoidal_embedding_1d(self.freq_dim, t)
        h0 = _linear_fp32(self.time_embedding["0"], ts_sin)
        timestep_element = _linear_fp32(self.time_embedding["2"], F.silu(h0))  # (B, L|1, dim)
        timestep_embed = _linear_fp32(self.time_projection["1"], F.silu(timestep_element))
        timestep_embed = timestep_embed.reshape(*timestep_element.shape[:2], 6, self.dim)

        # the context zero-padded to text_len, then embedded: padding rows are
        # keys too (cross-attention has no mask)
        if context.shape[1] < self.text_len:
            context = F.pad(context, (0, 0, 0, self.text_len - context.shape[1]))
        cdtype = self.text_embedding["0"].bias.dtype
        ctx = self.text_embedding["0"](context.to(cdtype))
        ctx = self.text_embedding["2"](F.gelu(ctx, approximate="tanh"))
        return x.float(), timestep_embed, timestep_element, ctx, rope, grid

    def _run_blocks_range(self, x, timestep_embed, rope, ctx, start: int = 0,
                          end: Optional[int] = None):
        """Blocks [start, end) as a plain stack, checkpointed in groups of
        ``nn.remat_group()`` blocks when checkpointing is on and gradients
        are enabled."""
        end = len(self.blocks) if end is None else end
        return run_remat_stack(
            lambda block, xx: block(xx, timestep_embed, rope, ctx),
            list(self.blocks)[start:end],
            x,
            self.gradient_checkpointing and torch.is_grad_enabled(),
        )

    def forward(
        self,
        latents: torch.Tensor,    # (B, F, H, W, C_in) NFHWC
        timesteps: torch.Tensor,  # (B,) or (B, L)
        context: torch.Tensor,    # (B, Lc, text_dim), Lc <= text_len
    ) -> torch.Tensor:
        x, timestep_embed, timestep_element, ctx, rope, grid = self._prepare_tokens(
            latents, timesteps, context)
        x = self._run_blocks_range(x, timestep_embed, rope, ctx)
        return self._unpatchify(self.head(x, timestep_element), grid)

    def deepcache_forward(
        self,
        latents: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor,
        cached_delta: Optional[torch.Tensor] = None,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """Step caching for the block stack (delta caching, as the other
        DiTs' ``deepcache_forward``). The stack is residual, so it is split
        at ``cache_depth`` k (default N // 4): a full (``refresh``) step
        records ``delta = x_N - x_k``, the summed contribution of the deep
        blocks [k, N); a cached step runs the shallow blocks [0, k) fresh
        and takes ``x_N = x_k + delta``. Returns (velocity, delta)."""
        n = len(self.blocks)
        k = cache_depth if cache_depth is not None else max(1, n // 4)
        if not 0 < k < n:
            raise ValueError(f"cache_depth {k} outside (0, {n})")
        x, timestep_embed, timestep_element, ctx, rope, grid = self._prepare_tokens(
            latents, timesteps, context)
        x = self._run_blocks_range(x, timestep_embed, rope, ctx, 0, k)
        if refresh:
            shallow = x
            x = self._run_blocks_range(x, timestep_embed, rope, ctx, k, n)
            delta = x - shallow
        else:
            if cached_delta is None:
                raise ValueError("a cached step needs cached_delta")
            x = x + cached_delta.to(x.dtype)
            delta = cached_delta
        return self._unpatchify(self.head(x, timestep_element), grid), delta


class Denoiser(DiT):
    """Config-driven DiT."""

    def __init__(self, config: DenoiserConfig):
        super().__init__(
            model_type=config.type,
            patch_size=tuple(config.patch_size),
            text_len=config.text_length,
            in_dim=config.in_channels,
            dim=config.hidden_dim,
            ffn_dim=config.ffn_dim,
            freq_dim=config.freq_dim,
            text_dim=config.text_dim,
            out_dim=config.out_channels,
            num_heads=config.num_heads,
            num_layers=config.num_layers,
            eps=config.norm_eps,
        )
        self.config = config
