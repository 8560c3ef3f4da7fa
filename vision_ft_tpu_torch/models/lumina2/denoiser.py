"""Lumina2 NextDiT denoiser (``vision_ft_tpu/models/lumina2/denoiser.py``
counterpart).

- Fixed-capacity padded layout: the joint sequence is [caption (L,
  right-padded and masked), image patches (P)]. Masked keys are excluded
  from attention and per-token ops do not mix positions, so every valid
  position equals the packed layout's. Image tokens take RoPE axis-0 id =
  the sample's caption length (a gather on the device, no host sync).
- Complex RoPE as the cos/sin pair formulation (even = real, odd = imag),
  fp32, from per-axis precomputed tables.
- Grouped-query attention: fused qkv Linear, QK-RMSNorm (eps 1e-6). q, k
  and v stay in the (B, S, heads, D) memory the projection writes and are
  handed to the attention dispatch as (B, H, S, D) views; k and v keep
  their 8 heads (the key-masked flash kernel maps query heads to kv heads
  itself, the plain formula repeats them), where the JAX package repeats
  them in device memory.
- 4-way tanh-gated adaLN (scale / gate x2), sandwich RMSNorms (eps 1e-5);
  the context refiner runs without adaLN.
- SwiGLU feed-forward through the fused gated-MLP kernel
  (``ops/fused_mlp.py``) under its gate, else three Linears.
- ``norm_final`` exists in the parameter tree and is never applied, as in
  the JAX package.

Returns (velocity NHWC, caption_mask, refined_caption_features), so that
the pipeline can cache the refined captions across steps. With
``set_gradient_checkpointing(True)`` a forward that runs with gradients
checkpoints each refiner block (``nn.core.remat_layer``) and the main stack
in groups of ``nn.core.remat_group()`` blocks (``run_remat_stack``), as the
JAX package does. ``set_pipeline`` (GPipe over a mesh) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...modules.patch import unpatchify
from ...modules.timestep.embedding import get_timestep_embedding
from ...nn import LayerNorm, Linear, RMSNorm, remat_layer, run_remat_stack, save_name, saved_products
from ...ops.attention import scaled_dot_product_attention
from ...ops.fused_mlp import fused_ff_enabled, gated_mlp, supported
from .config import DenoiserConfig


def _patchify_nhwc(latent: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, p*p*C), (ph, pw, c) feature order."""
    b, height, width, c = latent.shape
    h, w = height // p, width // p
    x = latent.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, p * p * c)


class TimestepEmbedder(nn.Module):
    """Sinusoid(256) -> MLP(1024)."""

    def __init__(self, hidden_dim: int, time_embed_dim: int):
        super().__init__()
        self.time_embed_dim = time_embed_dim
        self.mlp = nn.ModuleDict(
            {"0": Linear(time_embed_dim, hidden_dim), "2": Linear(hidden_dim, hidden_dim)}
        )

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = get_timestep_embedding(
            timesteps, self.time_embed_dim, flip_sin_to_cos=True, downscale_freq_shift=0.0
        )
        h = self.mlp["0"](emb.to(self.mlp["0"].weight.dtype))
        return self.mlp["2"](F.silu(h))


def _apply_rope_complex(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); freqs: (B, S, D/2, 2) cos/sin. Complex multiply on
    (even, odd) pairs in fp32. The result keeps x's memory layout."""
    xf = x.float()
    cos = freqs[..., 0][:, None]  # (B, 1, S, D/2)
    sin = freqs[..., 1][:, None]
    even, odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = even * cos - odd * sin
    out[..., 1::2] = even * sin + odd * cos
    return out


class SelfAttention(nn.ModuleDict):
    """Grouped-query attention with a fused qkv projection and QK-RMSNorm."""

    def __init__(self, hidden_dim: int, num_heads: int, num_kv_heads: int):
        head_dim = hidden_dim // num_heads
        total = (num_heads + 2 * num_kv_heads) * head_dim
        super().__init__(
            {
                "qkv": Linear(hidden_dim, total, bias=False),
                "out": Linear(num_heads * head_dim, hidden_dim, bias=False),
                "q_norm": RMSNorm(head_dim, eps=1e-6),
                "k_norm": RMSNorm(head_dim, eps=1e-6),
            }
        )
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim

    @saved_products()
    def forward(self, x, freqs, mask=None):
        b, s, _ = x.shape
        h, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        qkv = self["qkv"](x)
        q, k, v = qkv.split([h * d, kv * d, kv * d], dim=-1)
        q = self["q_norm"](q.reshape(b, s, h, d))
        k = self["k_norm"](k.reshape(b, s, kv, d))
        # (B, H, S, D) views of (B, S, heads, D) memory, then rope
        q = save_name(_apply_rope_complex(q.transpose(1, 2), freqs), "flash_qkv")
        k = save_name(_apply_rope_complex(k.transpose(1, 2), freqs), "flash_qkv")
        v = save_name(v.reshape(b, s, kv, d).transpose(1, 2), "flash_qkv")
        attn_mask = None if mask is None else mask.bool()[:, None, None, :]
        attn = scaled_dot_product_attention(
            q, k, v, mask=attn_mask, scale=math.sqrt(1 / d), backend="flash"
        )
        return self["out"](attn.transpose(1, 2).reshape(b, s, h * d))


class FeedForward(nn.ModuleDict):
    """SwiGLU with the inner width rounded up to ``multiple_of``."""

    def __init__(self, hidden_dim: int, intermediate_dim: int, multiple_of: int = 256):
        inter = multiple_of * ((intermediate_dim + multiple_of - 1) // multiple_of)
        super().__init__(
            {
                "w1": Linear(hidden_dim, inter, bias=False),
                "w2": Linear(inter, hidden_dim, bias=False),
                "w3": Linear(hidden_dim, inter, bias=False),
            }
        )

    def forward(self, x):
        w1, w2, w3 = self["w1"], self["w2"], self["w3"]
        c, inner = w2.out_features, w2.in_features
        if (
            fused_ff_enabled(x, w1, w2, w3, inner=inner)
            and x.shape[-1] == c
            and supported(c, inner)
        ):
            # both up-projections, the silu gate and the down-projection in one kernel
            return gated_mlp(
                x, w_act=w1.weight, w_gate=w3.weight, w_down=w2.weight,
                b_act=w1.bias, b_gate=w3.bias, b_down=w2.bias, act="silu",
            )
        h = save_name(F.silu(w1(x)) * w3(x), "ff_inner")
        return w2(h)


class TransformerBlock(nn.ModuleDict):
    """Sandwich-norm block with an optional 4-way tanh-gated adaLN."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        num_kv_heads: int,
        multiple_of: int = 256,
        norm_eps: float = 1e-5,
        use_adaln: bool = True,
    ):
        children = {
            "attention": SelfAttention(hidden_dim, num_heads, num_kv_heads),
            "feed_forward": FeedForward(hidden_dim, hidden_dim * 4, multiple_of),
            "attention_norm1": RMSNorm(hidden_dim, eps=norm_eps),
            "ffn_norm1": RMSNorm(hidden_dim, eps=norm_eps),
            "attention_norm2": RMSNorm(hidden_dim, eps=norm_eps),
            "ffn_norm2": RMSNorm(hidden_dim, eps=norm_eps),
        }
        if use_adaln:
            children["adaLN_modulation"] = nn.ModuleDict({"1": Linear(1024, 4 * hidden_dim)})
        super().__init__(children)
        self.use_adaln = use_adaln

    @staticmethod
    def modulate(x, scale):
        return x * (1 + scale[:, None, :])

    def forward(self, x, freqs, adaln_input=None, mask=None):
        if self.use_adaln:
            if adaln_input is None:
                raise ValueError("a block with adaLN needs adaln_input")
            mod = self["adaLN_modulation"]["1"](F.silu(adaln_input))
            scale_attn, gate_attn, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)

            attn = self.modulate(self["attention_norm1"](x), scale_attn)
            attn = self["attention_norm2"](self["attention"](attn, freqs, mask))
            x = save_name(x + torch.tanh(gate_attn)[:, None, :] * attn, "res_stream")

            mlp = self.modulate(self["ffn_norm1"](x), scale_mlp)
            mlp = self["ffn_norm2"](self["feed_forward"](mlp))
            return x + torch.tanh(gate_mlp)[:, None, :] * mlp

        h = self["attention"](self["attention_norm1"](x), freqs, mask)
        x = save_name(x + self["attention_norm2"](h), "res_stream")
        h = self["feed_forward"](self["ffn_norm1"](x))
        return x + self["ffn_norm2"](h)


class FinalLayer(nn.ModuleDict):
    """fp32 LayerNorm (no affine) + adaLN scale + linear."""

    def __init__(self, hidden_dim: int, patch_size: int, out_channels: int):
        super().__init__(
            {
                "linear": Linear(hidden_dim, patch_size * patch_size * out_channels),
                "adaLN_modulation": nn.ModuleDict({"1": Linear(1024, hidden_dim)}),
            }
        )
        self.norm = LayerNorm(hidden_dim, eps=1e-6, elementwise_affine=False)  # no parameters

    def forward(self, x, adaln_input):
        scale = self["adaLN_modulation"]["1"](F.silu(adaln_input))
        x = self.norm(x) * (1 + scale[:, None, :])
        return self["linear"](x)


def _blocks(count: int, config: DenoiserConfig, use_adaln: bool = True) -> nn.ModuleDict:
    return nn.ModuleDict(
        {
            str(i): TransformerBlock(
                config.hidden_dim, config.num_heads, config.num_kv_heads,
                config.multiple_of, config.norm_eps, use_adaln=use_adaln,
            )
            for i in range(count)
        }
    )


class NextDiT(nn.Module):
    def __init__(self, config: DenoiserConfig):
        super().__init__()
        self.config = config
        hd = config.hidden_dim
        self.patch_size = config.patch_size
        self.out_channels = config.in_channels

        self.x_embedder = Linear(config.patch_size**2 * config.in_channels, hd)
        self.noise_refiner = _blocks(config.refiner_depth, config)
        self.context_refiner = _blocks(config.refiner_depth, config, use_adaln=False)
        self.t_embedder = TimestepEmbedder(1024, config.timestep_embed_dim)
        self.cap_embedder = nn.ModuleDict(
            {
                "0": RMSNorm(config.caption_dim, eps=config.norm_eps),
                "1": Linear(config.caption_dim, hd),
            }
        )
        self.layers = _blocks(config.depth, config)
        self.norm_final = RMSNorm(hd, eps=config.norm_eps)  # never applied
        self.final_layer = FinalLayer(hd, config.patch_size, self.out_channels)
        self.gradient_checkpointing = False

        # per-axis RoPE tables (axes_len, d/2, 2) cos/sin, fp32, on the host;
        # copied to each device they are asked for once
        self._rope_tables = [
            self._precompute_axis(d, e, config.theta)
            for d, e in zip(config.axes_dims, config.axes_lens)
        ]
        self._rope_on_device: dict = {}

    @staticmethod
    def _precompute_axis(dim: int, end: int, theta: float) -> np.ndarray:
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        angles = np.outer(np.arange(end, dtype=np.float64), freqs)
        return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)

    def set_gradient_checkpointing(self, value: bool):
        """Checkpoint the refiner blocks one by one and the main stack in
        groups whenever a forward runs with gradients enabled."""
        self.gradient_checkpointing = value

    def _remat(self) -> bool:
        return self.gradient_checkpointing and torch.is_grad_enabled()

    def set_pipeline(self, mesh, num_microbatches: int, axis: str = "pipe"):
        if mesh is not None:
            raise NotImplementedError(
                "set_pipeline (GPipe pipelining of the main stack over a mesh) is not ported yet"
            )

    # -- RoPE frequency assembly -------------------------------------------------

    def _tables(self, device: torch.device):
        key = str(device)
        if key not in self._rope_on_device:
            self._rope_on_device[key] = [torch.from_numpy(t).to(device) for t in self._rope_tables]
        return self._rope_on_device[key]

    def _caption_freqs(self, cap_len: int, device: torch.device) -> torch.Tensor:
        """(L, D/2, 2): axis-0 ids = arange(L), axes 1 and 2 = 0."""
        t0, t1, t2 = self._tables(device)
        ids = torch.arange(cap_len, device=device) % t0.shape[0]
        return torch.cat(
            [t0[ids], t1[0].expand(cap_len, *t1.shape[1:]), t2[0].expand(cap_len, *t2.shape[1:])],
            dim=1,
        )

    def _image_freqs(self, caption_lens: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(B, P, D/2, 2): axis-0 id = the sample's caption length (a
        gather), y / x grids on axes 1 and 2."""
        t0, t1, t2 = self._tables(caption_lens.device)
        b, p = caption_lens.shape[0], h * w
        f0 = t0[caption_lens][:, None].expand(b, p, *t0.shape[1:])
        y = torch.arange(h, device=t1.device).repeat_interleave(w)
        x = torch.arange(w, device=t2.device).repeat(h)
        f1 = t1[y][None].expand(b, p, *t1.shape[1:])
        f2 = t2[x][None].expand(b, p, *t2.shape[1:])
        return torch.cat([f0, f1, f2], dim=2)

    # -- forward -------------------------------------------------------------------

    def _prepare_tokens(self, latents, caption_features, timestep, caption_mask,
                        cached_caption_features):
        """Steps 1-5 of the forward: embeddings, RoPE, refiners, the joint
        sequence. Shared by ``forward`` and ``deepcache_forward``."""
        b, height, width, _ = latents.shape
        p = self.patch_size
        hp, wp = height // p, width // p
        num_patches = hp * wp
        cap_len = caption_features.shape[1]
        caption_mask = caption_mask.bool()
        caption_lens = caption_mask.sum(dim=1)  # (B,)

        # 1. timestep embedding (adaLN input, 1024-d)
        t_emb = self.t_embedder(timestep)

        # 2. RoPE freqs
        cap_freqs = self._caption_freqs(cap_len, latents.device)[None].expand(b, -1, -1, -1)
        img_freqs = self._image_freqs(caption_lens, hp, wp)
        joint_freqs = torch.cat([cap_freqs, img_freqs], dim=1)

        # 3. refine caption features (skipped when cached)
        if cached_caption_features is not None:
            caption_tokens = cached_caption_features
        else:
            caption_tokens = self.cap_embedder["1"](self.cap_embedder["0"](caption_features))
            for layer in self.context_refiner.values():
                fn = lambda c, layer=layer: layer(c, cap_freqs, mask=caption_mask)  # noqa: E731
                caption_tokens = (remat_layer(fn) if self._remat() else fn)(caption_tokens)

        # 4. refine image features
        image_tokens = self.x_embedder(_patchify_nhwc(latents, p))
        image_mask = torch.ones(b, num_patches, dtype=torch.bool, device=latents.device)
        for layer in self.noise_refiner.values():
            fn = lambda x, layer=layer: layer(x, img_freqs, t_emb, image_mask)  # noqa: E731
            image_tokens = (remat_layer(fn) if self._remat() else fn)(image_tokens)

        # 5. joint sequence [caption | image], the padding holes masked
        context = torch.cat([caption_tokens, image_tokens], dim=1)
        joint_mask = torch.cat([caption_mask, image_mask], dim=1)
        return (context, joint_freqs, joint_mask, t_emb, caption_tokens, caption_mask,
                cap_len, hp, wp)

    def _run_main_layers(self, context, joint_freqs, t_emb, joint_mask, start=0, end=None):
        """Main layers [start, end), checkpointed in groups of
        ``nn.core.remat_group()`` layers."""
        end = len(self.layers) if end is None else end
        return run_remat_stack(
            lambda layer, c: layer(c, joint_freqs, t_emb, joint_mask),
            [self.layers[str(i)] for i in range(start, end)],
            context,
            self._remat(),
        )

    def _finish(self, context, t_emb, cap_len, hp, wp):
        """Final layer + unpatchify (steps 7-8)."""
        context = self.final_layer(context, t_emb)
        return unpatchify(context[:, cap_len:], hp, wp, self.patch_size, self.out_channels)

    def forward(
        self,
        latents: torch.Tensor,  # (B, H, W, C) NHWC
        caption_features: torch.Tensor,  # (B, L, caption_dim)
        timestep: torch.Tensor,  # (B,)
        caption_mask: torch.Tensor,  # (B, L) bool/int, right-padded
        cached_caption_features: Optional[torch.Tensor] = None,
    ):
        (context, joint_freqs, joint_mask, t_emb, caption_tokens, caption_mask,
         cap_len, hp, wp) = self._prepare_tokens(
            latents, caption_features, timestep, caption_mask, cached_caption_features
        )
        context = self._run_main_layers(context, joint_freqs, t_emb, joint_mask)
        velocity = self._finish(context, t_emb, cap_len, hp, wp)
        return velocity, caption_mask, caption_tokens

    def deepcache_forward(
        self,
        latents: torch.Tensor,
        caption_features: torch.Tensor,
        timestep: torch.Tensor,
        caption_mask: torch.Tensor,
        cached_caption_features: Optional[torch.Tensor] = None,
        cached_delta: Optional[torch.Tensor] = None,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """Step caching for the uniform NextDiT stack (delta caching, as
        Delta-DiT, arXiv:2401.05252). The main stack is residual, so it is
        split at ``cache_depth``: a full (``refresh``) step records
        ``delta = x_N - x_k``, the summed contribution of the deep layers
        [k, N); a cached step runs only the shallow layers [0, k) and takes
        ``x_N = x_k + delta``. Refiners, the final layer and the fresh
        ``t_emb`` adaLN always run. Returns (velocity, caption_mask,
        caption_tokens, delta)."""
        n = len(self.layers)
        k = cache_depth if cache_depth is not None else max(1, n // 4)
        if not 0 < k < n:
            raise ValueError(f"cache_depth {k} outside (0, {n})")

        (context, joint_freqs, joint_mask, t_emb, caption_tokens, caption_mask,
         cap_len, hp, wp) = self._prepare_tokens(
            latents, caption_features, timestep, caption_mask, cached_caption_features
        )
        x_k = self._run_main_layers(context, joint_freqs, t_emb, joint_mask, end=k)
        if refresh:
            x_n = self._run_main_layers(x_k, joint_freqs, t_emb, joint_mask, start=k)
            delta = x_n - x_k
        else:
            if cached_delta is None:
                raise ValueError("a cached step needs cached_delta")
            delta = cached_delta
            x_n = x_k + delta.to(x_k.dtype)
        velocity = self._finish(x_n, t_emb, cap_len, hp, wp)
        return velocity, caption_mask, caption_tokens, delta


class Denoiser(NextDiT):
    pass
