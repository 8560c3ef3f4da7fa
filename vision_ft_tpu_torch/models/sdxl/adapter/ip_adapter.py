"""IP-Adapter for SDXL (``vision_ft_tpu/models/sdxl/adapter/ip_adapter.py``
counterpart): image-prompt cross-attention and the model around it.

The adapter cross-attentions are ``CrossAttention`` subclasses the UNet
is built with (its ``cross_attention_class``); their weights live on the
attn2 modules (``...attn2.to_k_ip.weight``) and ``IPAdapterManager`` maps
them to the on-disk keys (``ip_adapter.{odd}.to_k_ip.weight``).

Variants:
  original   -- ip_tokens / ip_mask keyword arguments, base + ip_scale *
                ip attention, optional renorm; to_k_ip / to_v_ip start as
                copies of the base k / v.
  adaln_zero -- ip tokens ride the context's tail; SingleAdaLayerNormZero
                on them, a zero-initialized gate from the time embedding.
  tanh_gate  -- context-tail tokens, a zero-initialized per-channel tanh gate.
  gate       -- context-tail tokens, a zero-initialized linear gate.
  flamingo   -- tanh_gate with one scalar gate.
  time_gate  -- context-tail tokens, a zero-initialized Linear(time
                embedding -> gate).
  peft       -- original with LoRA on to_k_ip / to_v_ip (``adapter.peft``).

``skip_zero_tokens`` multiplies the ip branch by whether any ip token is
non-zero (the JAX package's form of the branch, no data-dependent
control flow). The ip attention has 4 to 16 keys, so it takes the plain
formula, as in the JAX package; a dropped image's all-False ip mask gives
rows of zeros there.

The image encoder is any callable from a (B, H, W, C) batch in [-1, 1] to
features; the default is the port's own SigLIP
(``models/vision_encoders/siglip.ImageEncoder``, seeded weights), which
keeps the features on the model's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from ....dataset.transform import ColorChannelSwap, PaddedResize, to_array
from ....modules.adapter.ip_adapter import IPAdapterConfig, IPAdapterManager
from ....modules.adapter.util import Adapter
from ....modules.norm import SingleAdaLayerNormZero
from ....nn import Linear, init_parameters_, saved_products
from ....ops.attention import scaled_dot_product_attention
from ....utils import tensor as tensor_utils
from ....utils.dtype import str_to_dtype
from ....utils.state_dict import RegexMatch
from ..config import SDXLConfig
from ..denoiser import CrossAttention, Denoiser
from ..pipeline import SDXLModel

SDXL_TIME_EMBED_DIM = 1280


class _GateWeight(nn.Module):
    """A zero-initialized gate vector, held for its key (``<name>.weight``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.zero_()


class IPAdapterCrossAttentionSDXL(CrossAttention, Adapter):
    target_key = RegexMatch(regex=r".*?(denoiser|diffusion_model).*\.attn2$")
    adapter_param_names = ("to_k_ip", "to_v_ip")

    def __init__(self, query_dim, context_dim, num_heads, head_dim, backend,
                 config: IPAdapterConfig, time_embedding_dim: int = SDXL_TIME_EMBED_DIM):
        super().__init__(query_dim, context_dim, num_heads, head_dim, backend)
        self.adapter_config = config
        self.time_embedding_dim = time_embedding_dim
        self.ip_scale = config.ip_scale
        self.num_ip_tokens = config.num_ip_tokens
        self.skip_zero_tokens = config.skip_zero_tokens
        self.attn_renorm = config.attn_renorm
        inner = num_heads * head_dim
        self["to_k_ip"] = Linear(context_dim, inner, bias=False)
        self["to_v_ip"] = Linear(context_dim, inner, bias=False)
        self._register_extra_children()

    def _register_extra_children(self) -> None:
        pass

    # -- adapter init ------------------------------------------------------------

    @torch.no_grad()
    def init_adapter_(self, generator: torch.Generator) -> None:
        """to_k_ip / to_v_ip copy the base to_k / to_v (a quantized base:
        N(0, 1) * 0.01 - 0.01, as in the JAX package); the extra children
        of a variant start at zero."""
        for name in ("to_k", "to_v"):
            base, ip = self[name], self[f"{name}_ip"]
            if base.is_quantized:
                ip.weight.normal_(0.0, 1.0, generator=generator).mul_(0.01).sub_(0.01)
            else:
                ip.weight.copy_(base.weight)

    # -- attention pieces ----------------------------------------------------------

    def _attend(self, query, key, value, mask=None):
        b, s, _ = query.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], h, -1).transpose(1, 2)

        if mask is not None:
            mask = (mask[:, None, None, :] if mask.ndim == 2 else mask).bool()
        attn = scaled_dot_product_attention(
            heads(query), heads(key), heads(value), mask=mask, backend=self.backend
        )
        return attn.transpose(1, 2).reshape(b, s, -1)

    @staticmethod
    def _renorm(original, new):
        o_norm = torch.linalg.vector_norm(original.float(), dim=-1, keepdim=True)
        n_norm = torch.linalg.vector_norm(new.float(), dim=-1, keepdim=True)
        return (new.float() * (o_norm / n_norm.clamp_min(1e-12))).to(new.dtype)

    def _maybe_skip_zero(self, ip_tokens, ip_hidden):
        if not self.skip_zero_tokens:
            return ip_hidden
        return ip_hidden * (ip_tokens != 0).any().to(ip_hidden.dtype)

    # -- forward ---------------------------------------------------------------------

    @saved_products()
    def forward(self, x, context, ip_tokens=None, ip_mask=None, **kwargs):
        query = self["to_q"](x)
        hidden = self._attend(query, self["to_k"](context), self["to_v"](context))
        if ip_tokens is not None:
            ip_hidden = self._attend(
                query, self["to_k_ip"](ip_tokens), self["to_v_ip"](ip_tokens), mask=ip_mask
            )
            ip_hidden = self._maybe_skip_zero(ip_tokens, ip_hidden)
            new_hidden = hidden + self.ip_scale * ip_hidden
            hidden = self._renorm(hidden, new_hidden) if self.attn_renorm else new_hidden
        return self["to_out"]["0"](hidden)


class _ContextTailVariant(IPAdapterCrossAttentionSDXL):
    """The variants that take their ip tokens from the context's tail."""

    def _split_context(self, context):
        return context[:, : -self.num_ip_tokens, :], context[:, -self.num_ip_tokens:, :]

    def _transform_ip_tokens(self, ip_tokens, time_embedding):
        """(the tokens the ip projections read, the gate's extra input)."""
        return ip_tokens, None

    def _gate(self, ip_hidden, extra, time_embedding):
        raise NotImplementedError

    @saved_products()
    def forward(self, x, context, time_embedding=None, **kwargs):
        text_context, ip_tokens = self._split_context(context)
        query = self["to_q"](x)
        hidden = self._attend(query, self["to_k"](text_context), self["to_v"](text_context))
        ip_in, extra = self._transform_ip_tokens(ip_tokens, time_embedding)
        ip_hidden = self._attend(query, self["to_k_ip"](ip_in), self["to_v_ip"](ip_in))
        ip_hidden = self._gate(ip_hidden, extra, time_embedding)
        ip_hidden = self._maybe_skip_zero(ip_tokens, ip_hidden)
        return self["to_out"]["0"](hidden + self.ip_scale * ip_hidden)


class IPAdapterCrossAttentionAdaLNZeroSDXL(_ContextTailVariant):
    adapter_param_names = ("to_k_ip", "to_v_ip", "norm")

    def _register_extra_children(self) -> None:
        self["norm"] = SingleAdaLayerNormZero(
            hidden_dim=self["to_k"].in_features,
            gate_dim=self["to_q"].out_features,
            embedding_dim=self.time_embedding_dim,
        )

    def init_adapter_(self, generator: torch.Generator) -> None:
        super().init_adapter_(generator)
        self["norm"].zero_()

    def _transform_ip_tokens(self, ip_tokens, time_embedding):
        out = self["norm"](ip_tokens, time_embedding)
        return out.hidden_states, out.gate

    def _gate(self, ip_hidden, gate, time_embedding):
        return ip_hidden * gate[:, None, :]


class IPAdapterCrossAttentionTanhGateSDXL(_ContextTailVariant):
    adapter_param_names = ("to_k_ip", "to_v_ip", "tanh_gate")
    _gate_dim_is_scalar = False

    def _register_extra_children(self) -> None:
        self["tanh_gate"] = _GateWeight(1 if self._gate_dim_is_scalar else self["to_q"].out_features)

    def init_adapter_(self, generator: torch.Generator) -> None:
        super().init_adapter_(generator)
        self["tanh_gate"].reset_parameters()

    def _gate(self, ip_hidden, extra, time_embedding):
        return ip_hidden * torch.tanh(self["tanh_gate"].weight.to(ip_hidden.dtype))


class IPAdapterCrossAttentionFlamingoGateSDXL(IPAdapterCrossAttentionTanhGateSDXL):
    _gate_dim_is_scalar = True  # one scalar gate


class IPAdapterCrossAttentionGateSDXL(_ContextTailVariant):
    adapter_param_names = ("to_k_ip", "to_v_ip", "gate")

    def _register_extra_children(self) -> None:
        self["gate"] = _GateWeight(self["to_q"].out_features)

    def init_adapter_(self, generator: torch.Generator) -> None:
        super().init_adapter_(generator)
        self["gate"].reset_parameters()

    def _gate(self, ip_hidden, extra, time_embedding):
        return ip_hidden * self["gate"].weight.to(ip_hidden.dtype)


class IPAdapterCrossAttentionTimeGateSDXL(_ContextTailVariant):
    adapter_param_names = ("to_k_ip", "to_v_ip", "time_gate")

    def _register_extra_children(self) -> None:
        self["time_gate"] = Linear(self.time_embedding_dim, self["to_q"].out_features)

    @torch.no_grad()
    def init_adapter_(self, generator: torch.Generator) -> None:
        super().init_adapter_(generator)
        self["time_gate"].weight.zero_()
        self["time_gate"].bias.zero_()

    def _gate(self, ip_hidden, extra, time_embedding):
        return ip_hidden * self["time_gate"](time_embedding)[:, None, :].to(ip_hidden.dtype)


class IPAdapterCrossAttentionPeftSDXL(IPAdapterCrossAttentionSDXL):
    """The original variant with LoRA on the ip projections: the model
    attaches it from ``config.peft``, and ``nn.core.Linear`` applies it."""


VARIANT_CLASSES = {
    "original": IPAdapterCrossAttentionSDXL,
    "adaln_zero": IPAdapterCrossAttentionAdaLNZeroSDXL,
    "tanh_gate": IPAdapterCrossAttentionTanhGateSDXL,
    "gate": IPAdapterCrossAttentionGateSDXL,
    "flamingo": IPAdapterCrossAttentionFlamingoGateSDXL,
    "time_gate": IPAdapterCrossAttentionTimeGateSDXL,
    "peft": IPAdapterCrossAttentionPeftSDXL,
}


class SDXLModelWithIPAdapterConfig(SDXLConfig):
    adapter: IPAdapterConfig = IPAdapterConfig()


def default_image_encoder(config: SDXLModelWithIPAdapterConfig, device=None):
    """The port's SigLIP encoder for an adapter config that names a timm
    SigLIP (seeded weights, the model's dtype), else None."""
    enc_cfg = config.adapter.image_encoder
    if enc_cfg.type != "timm" or "siglip" not in enc_cfg.model_name:
        return None
    from ...vision_encoders.siglip import ImageEncoder, SigLIPVisionConfig

    return ImageEncoder(
        SigLIPVisionConfig(image_size=config.adapter.image_size),
        feature_type=enc_cfg.feature_type,
        hidden_state_index=enc_cfg.hidden_state_index,
        dtype=config.dtype,
        mean=config.adapter.image_mean,
        std=config.adapter.image_std,
        device=device,
    )


class SDXLModelWithIPAdapter(SDXLModel):
    """SDXL + an image encoder + the IP-Adapter's attn2 + a projector.

    ``image_encoder``: a callable from a (B, H, W, C) batch in [-1, 1] to
    (B, S, feature_dim) or (B, feature_dim) features; by default the
    port's SigLIP is built on the first materialization (``init_params`` /
    ``load_state_dict``), on that device. The projector is the module
    ``image_proj`` (``as_module()`` holds it beside the three parts)."""

    config: SDXLModelWithIPAdapterConfig

    def __init__(self, config: SDXLModelWithIPAdapterConfig,
                 image_encoder: Optional[Callable] = None, **kwargs):
        adapter_cls = VARIANT_CLASSES[config.adapter.variant]
        if config.adapter.variant == "peft" and config.adapter.peft is None:
            raise ValueError('the "peft" variant needs adapter.peft')
        adapter_dtype = str_to_dtype(config.adapter.dtype)
        if adapter_dtype != str_to_dtype(config.dtype):
            raise ValueError(
                f"adapter.dtype {config.adapter.dtype} differs from the model's {config.dtype}: "
                "the port keeps the adapter in the model's dtype"
            )

        class _Denoiser(Denoiser):
            cross_attention_class = adapter_cls
            cross_attention_extra = {
                "config": config.adapter,
                "time_embedding_dim": config.denoiser.hidden_dim * 4,
            }

        self.denoiser_class = _Denoiser
        super().__init__(config, **kwargs)
        self.encoder = image_encoder
        self.manager = IPAdapterManager(adapter_cls, config.adapter)
        self.manager.set_target_paths(self._attn2_paths())
        with torch.device("meta"):
            self.image_proj = self.manager.get_projector(attention_dim=config.denoiser.context_dim)
        self.preprocessor_resize = PaddedResize(
            max_size=config.adapter.image_size, fill=config.adapter.background_color
        )
        self.color_swap = ColorChannelSwap(
            swap=(2, 1, 0) if config.adapter.color_channel == "bgr" else (0, 1, 2),
            skip=config.adapter.color_channel == "rgb",
        )

    # -- structure -----------------------------------------------------------------

    def _attn2_paths(self) -> list[str]:
        """The adapter attn2 paths in the denoiser, in replacement order
        (input blocks, middle block, output blocks)."""
        cls = self.manager.adapter_class
        return [name for name, m in self.denoiser.named_modules()
                if isinstance(m, cls) and name.endswith(".attn2")]

    def as_module(self) -> nn.ModuleDict:
        return nn.ModuleDict({**self._parts(), "image_proj": self.image_proj})

    def _materialize_adapters(self, device) -> None:
        """The projector (and the default encoder) on ``device`` in the
        model's dtype, where they are not materialized yet."""
        if any(t.is_meta for t in self.image_proj.parameters()):
            self.image_proj.to(dtype=self.dtype).to_empty(device=device)
            init_parameters_(self.image_proj, torch.Generator(device=device).manual_seed(0))
        if self.encoder is None:
            self.encoder = default_image_encoder(self.config, device=device)

    # -- parameters ----------------------------------------------------------------

    def init_params(self, generator, dtype=None, device=None) -> None:
        super().init_params(generator, dtype, device)
        self._materialize_adapters(generator.device if device is None else torch.device(device))

    def load_state_dict(self, flat, device=None) -> None:
        """The base model's flat state dict (``denoiser.*``, ``vae.*``,
        ``text_encoder.*``) with or without the adapters' tensors; absent
        adapter tensors load as zeros until :meth:`init_adapter_params`."""
        flat = dict(flat)
        for key, value in self.denoiser.state_dict(keep_vars=True).items():
            if f"denoiser.{key}" not in flat and self._is_adapter_path(key):
                flat[f"denoiser.{key}"] = np.zeros(tuple(value.shape), np.float32)
        super().load_state_dict(flat, device)
        self._materialize_adapters(torch.device("cuda" if device is None else device))

    def _is_adapter_path(self, key: str) -> bool:
        parts = key.split(".")
        names = self.manager.adapter_class.adapter_param_names
        return any(
            i > 0 and parts[i - 1] == "attn2" and part in names for i, part in enumerate(parts)
        )

    def init_adapter_params(self, generator: torch.Generator) -> None:
        """The adapters' initial values (the base k / v copied, the gates
        at zero) and the projector's initial distributions; with the
        "peft" variant, LoRA on the ip projections from ``adapter.peft``."""
        denoiser = self.denoiser
        for path in self.manager.target_paths:
            denoiser.get_submodule(path).init_adapter_(generator)
        self.image_proj.init_weights(generator)
        if self.config.adapter.variant == "peft":
            from ....modules.peft import replace_to_peft_layer

            replace_to_peft_layer(
                denoiser, ["to_k_ip", "to_v_ip"], [], self.config.adapter.peft, generator
            )

    def load_adapter_params(self, state_dict: dict) -> None:
        """A saved adapter checkpoint (``ip_adapter.*`` + ``image_proj.*``)."""
        from ....nn import load_flat_params

        self.manager.load_state_dict(
            self.denoiser, {k: v for k, v in state_dict.items() if k.startswith("ip_adapter.")}
        )
        proj = {k[len("image_proj."):]: v for k, v in state_dict.items() if k.startswith("image_proj.")}
        if proj:
            load_flat_params(self.image_proj, proj)

    def get_adapter_state_dict(self) -> dict[str, torch.Tensor]:
        out = self.manager.get_state_dict(self.denoiser)
        out.update({f"image_proj.{k}": v for k, v in self.image_proj.state_dict().items()})
        return out

    # -- reference image -----------------------------------------------------------------

    def preprocess_reference_image(self, reference_image, normalize: bool = True) -> np.ndarray:
        if isinstance(reference_image, Image.Image):
            reference_image = [reference_image]
        arrays = []
        for img in reference_image:
            arr = to_array(self.preprocessor_resize(img))  # HWC in [-1, 1]
            if not normalize:
                arr = (arr + 1.0) / 2.0
            arrays.append(self.color_swap(arr))
        return np.stack(arrays)

    def encode_reference_image(self, pixel_values, prompt_embeddings=None) -> torch.Tensor:
        if self.encoder is None:
            raise RuntimeError("no image encoder configured")
        features = torch.as_tensor(self.encoder(pixel_values)).to(self.device, self.dtype)
        return self.image_proj(features, prompt_embeddings)

    # -- generate --------------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        reference_image=None,
        width: int = 768,
        height: int = 768,
        original_size=None,
        target_size=None,
        crop_coords_top_left=(0, 0),
        num_inference_steps: int = 20,
        cfg_scale: float = 3.5,
        max_token_length: int = 75,
        seed: Optional[int] = None,
        do_offloading: bool = False,
    ) -> list[Image.Image]:
        del do_offloading  # accepted and ignored, as in the JAX package
        do_cfg = cfg_scale > 1.0
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        sigmas = self.scheduler.get_sigmas(timesteps)
        prompts = list(prompt) if isinstance(prompt, (list, tuple)) else [prompt]
        num_prompts = len(prompts)
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        encoder_output = self.text_encoder.encode_prompts(
            prompts, negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length,
        )
        embeddings, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        embeddings = embeddings.to(self.dtype)
        pooled = pooled.to(self.dtype)
        batch_size = embeddings.shape[0]
        device = embeddings.device

        if reference_image is not None:
            pixel_values = self.preprocess_reference_image(reference_image)
            rng = np.random.default_rng(seed if seed is not None else 0)
            negative_image = np.clip(rng.standard_normal(pixel_values.shape, np.float32), -1.0, 1.0)
            both = np.concatenate([pixel_values, negative_image], axis=0)
            reference_embeddings = self.encode_reference_image(both, embeddings)
            ip_tokens = reference_embeddings.repeat_interleave(num_prompts, dim=0)
            ip_mask = torch.ones(ip_tokens.shape[:2], dtype=torch.bool, device=device)
        else:
            n_tok = self.manager.adapter_config.num_ip_tokens
            ip_tokens = torch.zeros((batch_size, n_tok, embeddings.shape[-1]), dtype=self.dtype,
                                    device=device)
            ip_mask = torch.zeros((batch_size, n_tok), dtype=torch.bool, device=device)
        ip_tokens = ip_tokens.to(self.dtype)

        latents = self.prepare_latents(
            num_prompts, height, width, self.scheduler.get_max_noise_sigma(sigmas), seed
        )
        noise_seed = seed if seed is not None else int(np.random.randint(0, 2**31 - 1))
        step_noises = [
            tensor_utils.incremental_seed_randn(
                latents.shape, (noise_seed + 7919 * (i + 1)) & 0x7FFFFFFF, torch.float32,
                latents.device,
            )
            for i in range(len(timesteps))
        ]

        def sizes(value):
            return torch.tensor(value, dtype=torch.float32, device=device).expand(batch_size, 2)

        latents = self._denoise_loop(
            latents, step_noises, timesteps, sigmas, embeddings, pooled,
            sizes(original_size), sizes(target_size), sizes(crop_coords_top_left),
            cfg_scale, 0.0, do_cfg,
            cross_attention_kwargs={"ip_tokens": ip_tokens, "ip_mask": ip_mask},
        )
        return self.decode_image(latents, use_tiling=max(height, width) >= 1536)
