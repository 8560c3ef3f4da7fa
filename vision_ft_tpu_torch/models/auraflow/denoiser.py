"""AuraFlow MMDiT denoiser (``vision_ft_tpu/models/auraflow/denoiser.py``
counterpart), NHWC latents.

- The condition tokens are the register tokens and the projected text;
  the latent is patchified ((c, ph, pw) feature order, ``modules/patch``)
  and projected.
- Double (two-stream) blocks with 6-way adaLN per stream, then single
  blocks over the joint sequence [condition | patches]; at 1024 px that is
  8 + 256 + 4096 = 4360 tokens.
- Attention runs on heads-packed (B, S, H*D) tensors through
  ``ops.attention.attention_heads_packed``: q and k get a per-head fp32
  LayerNorm (no affine) on a (B, S, H, D) view, and no head transpose is
  made. With ``use_flash_attn`` (the default) a CUDA call goes to the BSHD
  flash kernel B (12 heads of 256 in the default config).
- The gated MLP (``AuraMLP``) goes through the fused gated-MLP kernel F
  (``ops/fused_mlp.py``) under its gate, as in the JAX package, else three
  Linears.
- The adaLN projections (``mod*.1``), ``final_linear`` and
  ``cond_seq_linear`` start at zero, as in the JAX package's init.
- Learned positional encoding with the centre-crop index selection, or
  (``use_rope``) 3-axis RoPE; the optional shortcut and guidance embedders
  (the guidance embedder is fed the timestep, as in the JAX package).

``deepcache_forward`` caches the deep single layers' residual across steps.
``set_gradient_checkpointing(True)`` checkpoints each layer of both stacks
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

from ...modules.patch import patchify, unpatchify
from ...modules.positional_encoding.rope import RoPEFrequency, apply_rope_qk
from ...nn import LayerNorm, Linear, run_remat_stack, save_name, saved_products
from ...ops.attention import attention_heads_packed
from ...ops.fused_mlp import fused_ff_enabled, gated_mlp, supported
from .config import DenoiserConfig


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


_ACTS = {
    "silu": F.silu,
    "swish": F.silu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "mish": F.mish,
}
# the fused kernel's name of each activation it takes
_FUSED_ACTS = {"silu": "silu", "swish": "silu", "gelu": "gelu", "gelu_new": "gelu_tanh"}


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class ZeroInitLinear(Linear):
    """A ``Linear`` whose random init is zeros (the JAX package's init of
    the adaLN projections, ``final_linear`` and ``cond_seq_linear``)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        if not self.is_quantized:
            nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class AuraMLP(nn.ModuleDict):
    """Gated MLP with the inner width 2/3 of ``hidden_dim`` rounded up to 256."""

    def __init__(self, input_dim: int, hidden_dim: Optional[int] = None, hidden_act: str = "silu"):
        hidden_dim = 4 * input_dim if hidden_dim is None else hidden_dim
        n_hidden = find_multiple(int(2 * hidden_dim / 3), 256)
        super().__init__(
            {
                "c_fc1": Linear(input_dim, n_hidden, bias=False),
                "c_fc2": Linear(input_dim, n_hidden, bias=False),
                "c_proj": Linear(n_hidden, input_dim, bias=False),
            }
        )
        self.act = _ACTS[hidden_act]
        self.act_name = _FUSED_ACTS.get(hidden_act)  # None: the kernel has no such gate

    def forward(self, x):
        fc1, fc2, proj = self["c_fc1"], self["c_fc2"], self["c_proj"]
        c, inner = proj.out_features, proj.in_features
        if (
            self.act_name is not None
            and fused_ff_enabled(x, fc1, fc2, proj, inner=inner)
            and x.shape[-1] == c
            and supported(c, inner)
        ):
            # both up-projections, the gate and the down-projection in one kernel
            return gated_mlp(
                x, w_act=fc1.weight, w_gate=fc2.weight, w_down=proj.weight,
                b_act=fc1.bias, b_gate=fc2.bias, b_down=proj.bias, act=self.act_name,
            )
        return proj(save_name(self.act(fc1(x)) * fc2(x), "ff_inner"))


class Modulation(nn.ModuleDict):
    """act -> Linear(dim, n * dim, bias=False) (key "1"), split in n."""

    def __init__(self, dim: int, n: int, hidden_act: str = "silu"):
        super().__init__({"1": ZeroInitLinear(dim, n * dim, bias=False)})
        self.n = n
        self.act = _ACTS[hidden_act]

    def forward(self, cond):
        return self["1"](self.act(cond)).chunk(self.n, dim=-1)


def _qk_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm without affine over the head dim, in fp32."""
    h = x.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    return ((h - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class SingleAttention(nn.ModuleDict):
    def __init__(self, dim: int, n_heads: int, use_flash_attn: bool = False,
                 use_rope: bool = False):
        super().__init__({name: Linear(dim, dim, bias=False) for name in ("w1q", "w1k", "w1v", "w1o")})
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.backend = "flash" if use_flash_attn else "xla"
        self.use_rope = use_rope

    @saved_products()
    def forward(self, condition, rope_freqs=None):
        b, s, _ = condition.shape
        h, d = self.n_heads, self.head_dim
        q = _qk_norm(self["w1q"](condition).reshape(b, s, h, d))
        k = _qk_norm(self["w1k"](condition).reshape(b, s, h, d))
        v = self["w1v"](condition)
        if self.use_rope and rope_freqs is not None:
            q, k = apply_rope_qk(q, k, rope_freqs[:, None])
        attn = attention_heads_packed(
            q.reshape(b, s, h * d), k.reshape(b, s, h * d), v, h,
            scale=1 / d**0.5, backend=self.backend,
        )
        return self["w1o"](attn)


class DoubleAttention(nn.ModuleDict):
    """Separate condition / latent projections, one joint attention, split back."""

    def __init__(self, dim: int, n_heads: int, use_flash_attn: bool = False,
                 use_rope: bool = False):
        super().__init__(
            {
                name: Linear(dim, dim, bias=False)
                for name in ("w1q", "w1k", "w1v", "w1o", "w2q", "w2k", "w2v", "w2o")
            }
        )
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.backend = "flash" if use_flash_attn else "xla"
        self.use_rope = use_rope

    @saved_products()
    def forward(self, condition, latent, rope_freqs=None):
        b, cs, _ = condition.shape
        ls = latent.shape[1]
        h, d = self.n_heads, self.head_dim
        cq = _qk_norm(self["w1q"](condition).reshape(b, cs, h, d))
        ck = _qk_norm(self["w1k"](condition).reshape(b, cs, h, d))
        lq = _qk_norm(self["w2q"](latent).reshape(b, ls, h, d))
        lk = _qk_norm(self["w2k"](latent).reshape(b, ls, h, d))
        q = torch.cat([cq, lq], dim=1)
        k = torch.cat([ck, lk], dim=1)
        v = torch.cat([self["w1v"](condition), self["w2v"](latent)], dim=1)
        if self.use_rope and rope_freqs is not None:
            q, k = apply_rope_qk(q, k, rope_freqs[:, None])
        s = cs + ls
        attn = attention_heads_packed(
            q.reshape(b, s, h * d), k.reshape(b, s, h * d), v, h, backend=self.backend
        )
        return self["w1o"](attn[:, :cs]), self["w2o"](attn[:, cs:])


class MMDiTBlock(nn.ModuleDict):
    """Two-stream block with 6-way adaLN per stream."""

    def __init__(self, dim: int, heads: int, hidden_act: str = "silu",
                 use_flash_attn: bool = False, use_rope: bool = False):
        super().__init__(
            {
                "mlpC": AuraMLP(dim, dim * 4, hidden_act),
                "modC": Modulation(dim, 6, hidden_act),
                "mlpX": AuraMLP(dim, dim * 4, hidden_act),
                "modX": Modulation(dim, 6, hidden_act),
                "attn": DoubleAttention(dim, heads, use_flash_attn, use_rope),
            }
        )
        # no parameters
        self.normC1, self.normC2, self.normX1, self.normX2 = (
            LayerNorm(dim, elementwise_affine=False) for _ in range(4)
        )

    def forward(self, condition, patches, global_cond, rope_freqs=None):
        condition_res, patches_res = condition, patches
        c_shift_msa, c_scale_msa, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = (
            self["modC"](global_cond)
        )
        condition = modulate(self.normC1(condition), c_shift_msa, c_scale_msa)
        x_shift_msa, x_scale_msa, x_gate_msa, x_shift_mlp, x_scale_mlp, x_gate_mlp = (
            self["modX"](global_cond)
        )
        patches = modulate(self.normX1(patches), x_shift_msa, x_scale_msa)

        condition, patches = self["attn"](condition, patches, rope_freqs)

        condition = self.normC2(
            save_name(condition_res + c_gate_msa[:, None, :] * condition, "res_stream")
        )
        condition = c_gate_mlp[:, None, :] * self["mlpC"](
            modulate(condition, c_shift_mlp, c_scale_mlp)
        )
        condition = condition_res + condition

        patches = self.normX2(
            save_name(patches_res + x_gate_msa[:, None, :] * patches, "res_stream")
        )
        patches = x_gate_mlp[:, None, :] * self["mlpX"](modulate(patches, x_shift_mlp, x_scale_mlp))
        return condition, patches_res + patches


class DiTBlock(nn.ModuleDict):
    """Single-stream block over the joint sequence."""

    def __init__(self, dim: int, heads: int, hidden_act: str = "silu",
                 use_flash_attn: bool = False, use_rope: bool = False):
        super().__init__(
            {
                "modCX": Modulation(dim, 6, hidden_act),
                "attn": SingleAttention(dim, heads, use_flash_attn, use_rope),
                "mlp": AuraMLP(dim, dim * 4, hidden_act),
            }
        )
        self.norm1 = LayerNorm(dim, elementwise_affine=False)  # no parameters
        self.norm2 = LayerNorm(dim, elementwise_affine=False)

    def forward(self, context, global_cond, rope_freqs=None):
        context_res = context
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self["modCX"](global_cond)
        context = modulate(self.norm1(context), shift_msa, scale_msa)
        context = self["attn"](context, rope_freqs)
        context = self.norm2(save_name(context_res + gate_msa[:, None, :] * context, "res_stream"))
        mlp_out = self["mlp"](modulate(context, shift_mlp, scale_mlp))
        return context_res + gate_mlp[:, None, :] * mlp_out


class TimestepEmbedder(nn.Module):
    """Sinusoid (frequencies scaled by 1000, cos first) -> MLP."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 hidden_act: str = "silu"):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.act = _ACTS[hidden_act]
        self.mlp = nn.ModuleDict(
            {"0": Linear(frequency_embedding_size, hidden_size), "2": Linear(hidden_size, hidden_size)}
        )

    @staticmethod
    def timestep_embedding(timestep: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
        half = dim // 2
        steps = torch.arange(half, dtype=torch.float32, device=timestep.device)
        frequencies = 1000 * torch.exp(-math.log(max_period) * steps / half)
        args = timestep.float()[:, None] * frequencies[None]
        embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
        return embedding

    def forward(self, timestep):
        freq = self.timestep_embedding(timestep, self.frequency_embedding_size)
        h = self.mlp["0"](freq.to(self.mlp["0"].weight.dtype))
        return self.mlp["2"](self.act(h))


class MMDiT(nn.Module):
    def __init__(self, config: DenoiserConfig):
        super().__init__()
        self.config = config
        self.inner_dim = config.attention_head_dim * config.num_attention_heads
        self.patch_size = config.patch_size
        self.out_channels = config.out_channels
        self.max_pos_embed_size = config.pos_embed_max_size
        self.h_max = int(config.pos_embed_max_size**0.5)
        self.w_max = int(config.pos_embed_max_size**0.5)
        self.n_register_tokens = config.num_register_tokens
        self.gradient_checkpointing = False

        act, flash, rope = config.hidden_act, config.use_flash_attn, config.use_rope
        dim, heads = self.inner_dim, config.num_attention_heads
        self.t_embedder = TimestepEmbedder(dim, hidden_act=act)
        self.cond_seq_linear = ZeroInitLinear(
            config.joint_attention_dim, config.caption_projection_dim, bias=False
        )
        self.init_x_linear = Linear(config.patch_size**2 * config.in_channels, dim)
        self.positional_encoding = nn.Parameter(torch.empty(1, self.max_pos_embed_size, dim))
        self.register_tokens = nn.Parameter(torch.empty(1, self.n_register_tokens, dim))
        self.rope_frequency = (
            RoPEFrequency(config.rope_dim_sizes, config.rope_theta) if rope else None
        )
        if config.use_shortcut:
            self.shortcut_embedder = TimestepEmbedder(dim, hidden_act=act)
        if config.use_guidance:
            self.guidance_embedder = TimestepEmbedder(dim, hidden_act=act)
        self.double_layers = nn.ModuleDict(
            {str(i): MMDiTBlock(dim, heads, act, flash, rope) for i in range(config.num_double_layers)}
        )
        self.single_layers = nn.ModuleDict(
            {str(i): DiTBlock(dim, heads, act, flash, rope) for i in range(config.num_single_layers)}
        )
        self.final_linear = ZeroInitLinear(
            dim, config.patch_size**2 * config.out_channels, bias=False
        )
        self.modF = Modulation(dim, 2, act)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The parameters held by this module itself (``nn.init_parameters_``
        draws the layers'): the learned positional encoding N(0, 0.1) and
        the register tokens N(0, 0.02), as the JAX package draws them."""
        self.positional_encoding.normal_(0.0, 0.1, generator=generator)
        self.register_tokens.normal_(0.0, 0.02, generator=generator)

    def set_gradient_checkpointing(self, enabled: bool):
        """Checkpoint each layer of both stacks whenever a forward runs
        with gradients enabled."""
        self.gradient_checkpointing = enabled

    def _remat(self) -> bool:
        return self.gradient_checkpointing and torch.is_grad_enabled()

    def set_pipeline(self, mesh, num_microbatches: int, axis: str = "pipe"):
        if mesh is not None:
            raise NotImplementedError(
                "set_pipeline (GPipe pipelining of the double and single stacks over a mesh) "
                "is not ported yet (ROADMAP.md queue 1, item 6)"
            )

    # -- positional encoding ------------------------------------------------------

    def pe_selection_index_based_on_dim(self, h: int, w: int) -> np.ndarray:
        """The centre crop of the learned PE grid for an h x w latent."""
        h_p, w_p = h // self.patch_size, w // self.patch_size
        original = np.arange(self.max_pos_embed_size).reshape(self.h_max, self.w_max)
        start_h = self.h_max // 2 - h_p // 2
        start_w = self.w_max // 2 - w_p // 2
        return original[start_h: start_h + h_p, start_w: start_w + w_p].flatten()

    def get_pos_encoding(self, h: int, w: int) -> torch.Tensor:
        idx = torch.from_numpy(self.pe_selection_index_based_on_dim(h, w))
        return self.positional_encoding[:, idx.to(self.positional_encoding.device)]

    def _rope_freqs(self, cond_len: int, height: int, width: int, device) -> torch.Tensor:
        text_idx = self.rope_frequency.get_text_position_indices(cond_len)
        image_idx = self.rope_frequency.get_image_position_indices(height, width)
        return self.rope_frequency(np.concatenate([text_idx, image_idx], axis=0), device)

    def _position_encoding(self, patches, cond_len: int, height: int, width: int):
        """(patches, rope_freqs) for this resolution."""
        if self.rope_frequency is not None:
            return patches, self._rope_freqs(cond_len, height, width, patches.device)
        return patches + self.get_pos_encoding(height, width).to(patches.dtype), None

    # -- forward ------------------------------------------------------------------

    def _prepare_tokens(self, latent, encoder_hidden_states, timestep, shortcut_duration,
                        guidance_scale):
        """Condition tokens, global condition, patches and positions: the
        steps shared by ``forward`` and ``deepcache_forward``."""
        batch_size, height, width, _ = latent.shape

        # 1. condition tokens: register tokens + projected text
        cond_tokens = self.cond_seq_linear(encoder_hidden_states[:batch_size])
        register = self.register_tokens.expand(batch_size, -1, -1).to(cond_tokens.dtype)
        cond_tokens = torch.cat([register, cond_tokens], dim=1)

        # 2. timestep embedding (+ shortcut / guidance)
        global_cond = self.t_embedder(timestep)
        if shortcut_duration is not None:
            global_cond = global_cond + self.shortcut_embedder(shortcut_duration)
        if guidance_scale is not None:
            # as in the JAX package: the guidance embedder embeds the timestep
            global_cond = global_cond + self.guidance_embedder(timestep)

        # 3. patchify + project, 3.5 positions
        patches = self.init_x_linear(patchify(latent, self.patch_size))
        patches, rope_freqs = self._position_encoding(patches, cond_tokens.shape[1], height, width)
        return cond_tokens, patches, global_cond, rope_freqs, height, width

    def _run_double_layers(self, cond_tokens, patches, global_cond, rope_freqs):
        return run_remat_stack(
            lambda layer, cx: layer(cx[0], cx[1], global_cond, rope_freqs),
            self.double_layers.values(),
            (cond_tokens, patches),
            self._remat(),
        )

    def _run_single_range(self, context, global_cond, rope_freqs, start: int = 0,
                          end: Optional[int] = None):
        """Single (joint-sequence) layers [start, end)."""
        end = len(self.single_layers) if end is None else end
        return run_remat_stack(
            lambda layer, c: layer(c, global_cond, rope_freqs),
            [self.single_layers[str(i)] for i in range(start, end)],
            context,
            self._remat(),
        )

    def _finish(self, patches, global_cond, height: int, width: int):
        """Final modulation, projection and unpatchify."""
        f_shift, f_scale = self.modF(global_cond)
        patches = self.final_linear(modulate(patches, f_shift, f_scale))
        return unpatchify(
            patches, height // self.patch_size, width // self.patch_size, self.patch_size,
            self.out_channels,
        )

    def forward(
        self,
        latent: torch.Tensor,  # (B, H, W, C)
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        shortcut_duration: Optional[torch.Tensor] = None,
        guidance_scale: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cond_tokens, patches, global_cond, rope_freqs, height, width = self._prepare_tokens(
            latent, encoder_hidden_states, timestep, shortcut_duration, guidance_scale
        )
        cond_tokens, patches = self._run_double_layers(cond_tokens, patches, global_cond, rope_freqs)
        if len(self.single_layers):
            cond_len = cond_tokens.shape[1]
            context = torch.cat([cond_tokens, patches], dim=1)
            context = self._run_single_range(context, global_cond, rope_freqs)
            patches = context[:, cond_len:]
        return self._finish(patches, global_cond, height, width)

    def deepcache_forward(
        self,
        latent: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        shortcut_duration: Optional[torch.Tensor] = None,
        guidance_scale: Optional[torch.Tensor] = None,
        cached_delta: Optional[torch.Tensor] = None,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """Step caching for the single-layer stack (delta caching, as
        Lumina2's ``NextDiT.deepcache_forward``). The stack is residual, so
        it is split at ``cache_depth`` k (default N // 4): a full
        (``refresh``) step records ``delta = x_N - x_k``, the summed
        contribution of the deep layers [k, N); a cached step runs the
        double layers and the shallow single layers [0, k) fresh and takes
        ``x_N = x_k + delta``. Returns (velocity, delta)."""
        n = len(self.single_layers)
        k = cache_depth if cache_depth is not None else max(1, n // 4)
        if not 0 < k < n:
            raise ValueError(f"cache_depth {k} outside (0, {n})")
        cond_tokens, patches, global_cond, rope_freqs, height, width = self._prepare_tokens(
            latent, encoder_hidden_states, timestep, shortcut_duration, guidance_scale
        )
        for layer in self.double_layers.values():
            cond_tokens, patches = layer(cond_tokens, patches, global_cond, rope_freqs)
        cond_len = cond_tokens.shape[1]
        context = torch.cat([cond_tokens, patches], dim=1)
        context = self._run_single_range(context, global_cond, rope_freqs, 0, k)
        if refresh:
            shallow = context
            context = self._run_single_range(context, global_cond, rope_freqs, k, n)
            delta = context - shallow
        else:
            if cached_delta is None:
                raise ValueError("a cached step needs cached_delta")
            context = context + cached_delta.to(context.dtype)
            delta = cached_delta
        velocity = self._finish(context[:, cond_len:], global_cond, height, width)
        return velocity, delta


class Denoiser(MMDiT):
    @classmethod
    def from_config(cls, config: DenoiserConfig) -> "Denoiser":
        return cls(config)
