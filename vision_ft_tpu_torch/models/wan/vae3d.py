"""Wan 2.2 causal 3-D video VAE (``vision_ft_tpu/models/wan/vae3d.py``
counterpart), NFHWC activations.

- ``CausalConv3d``: one ``F.conv3d`` over the NCDHW view of the NFHWC
  tensor (channels-last strides, no copy around the conv), causal in time:
  a stride-1 conv pads kt - 1 frames at both ends and keeps the first F
  outputs (the back padding reaches only the outputs it drops), so no
  padded copy of the input is made; a strided one pads in front. The JAX
  package evaluates the same sum as kt shifted 2-D convolutions.
- Encoder: patchify (p = 2) -> conv_in -> 4 residual down stages (2
  resnets each; spatial downsample after stages 0-2, temporal after 1-2;
  each stage adds an avg-pool shortcut, the Wan 2.2 ``is_residual`` form)
  -> mid (resnet, attention, resnet) -> RMS norm -> conv_out (2 z moments).
- Decoder: the mirror, with nearest-upsample resamples, channel-duplicating
  shortcuts and the causal first-frame rule (a temporal upsample emits
  2F - 1 frames: frame 0 is never duplicated).
- RMS norms are channel L2 norms * sqrt(C) * gamma; the mid block's
  attention is single-head spatial attention per frame, the plain formula
  (``ops.attention.scaled_dot_product_attention``, "xla" backend).

Compression: 4x in time (1 + 4k frames <-> 1 + k latents), 16x in space,
z 48. The model computes in its ``dtype`` (fp32 by default) whatever the
file's dtype: the pipeline reads the VAE file in the model's dtype (bf16)
and the parameters keep the VAE's. Intermediates are dropped as soon as
the next one exists: at 45 frames of 704 x 704 one activation of the
decoder's last stage is 45 x 352 x 352 x 256 fp32 values, 5.7 GB.

Keys follow the diffusers module tree (encoder.down_blocks.N...,
decoder.up_blocks.N..., quant_conv, post_quant_conv), as in the JAX
package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Conv2d, init_parameters_, load_flat_params
from ...ops.attention import scaled_dot_product_attention
from .vae import DEFAULT_VAE_CONFIG, LATENT_MEAN, VAE


@dataclass
class WanVAEConfig:
    base_dim: int = 160
    decoder_base_dim: int = 256
    z_dim: int = 48
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: tuple[float, ...] = ()
    temperal_downsample: tuple[bool, ...] = (False, True, True)  # sic
    in_channels: int = 12
    out_channels: int = 12
    patch_size: int = 2
    is_residual: bool = True

    @classmethod
    def from_default(cls) -> "WanVAEConfig":
        c = DEFAULT_VAE_CONFIG
        return cls(
            base_dim=c["base_dim"],
            decoder_base_dim=c["decoder_base_dim"],
            z_dim=c["z_dim"],
            dim_mult=tuple(c["dim_mult"]),
            num_res_blocks=c["num_res_blocks"],
            attn_scales=tuple(c["attn_scales"]),
            temperal_downsample=tuple(c["temperal_downsample"]),
            in_channels=c["in_channels"],
            out_channels=c["out_channels"],
            patch_size=c["patch_size"],
            is_residual=c["is_residual"],
        )


# -- primitive modules --------------------------------------------------------------------


class CausalConv3d(nn.Module):
    """3-D conv, causal in time: weight (O, I, kt, kh, kw) (the torch key
    layout), bias (O,)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, spatial_padding=None):
        super().__init__()
        kt, kh, kw = kernel if isinstance(kernel, tuple) else (kernel,) * 3
        st, ss = stride if isinstance(stride, tuple) else (stride, stride)
        if kh != kw:
            raise ValueError("square spatial kernels only")
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kt, self.kh = kt, kh
        self.st, self.ss = st, ss
        self.spatial_padding = kh // 2 if spatial_padding is None else spatial_padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kt, kh, kh))
        self.bias = nn.Parameter(torch.empty(out_ch))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_ch * self.kt * self.kh * self.kh)
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, F, H, W, C) -> (B, F', H', W', O), F' = (F - 1) // st + 1."""
        frames, time_pad = x.shape[1], self.kt - 1
        if self.st > 1 and time_pad:
            b, _, h, w, c = x.shape
            x = torch.cat([x.new_zeros(b, time_pad, h, w, c), x], dim=1)
            time_pad = 0
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=(self.st, self.ss, self.ss),
                     padding=(time_pad, self.spatial_padding, self.spatial_padding))
        if time_pad:
            y = y[:, :, :frames]
        return y.permute(0, 2, 3, 4, 1)


class WanRMSNorm(nn.Module):
    """Channel L2-normalize * sqrt(C) * gamma, in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        # the sum of squares by one reduction, no squared copy of x
        inv = torch.linalg.vector_norm(xf, dim=-1, keepdim=True).square_().add_(1e-12).rsqrt_()
        y = xf * inv.mul_(math.sqrt(self.dim))
        return y.mul_(self.gamma.float()).to(x.dtype)


def _norm_silu_conv(norm: WanRMSNorm, conv: CausalConv3d, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(norm(x), inplace=True)
    return conv(h)


class ResidualBlock3d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = WanRMSNorm(in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, 3)
        self.norm2 = WanRMSNorm(out_ch)
        self.conv2 = CausalConv3d(out_ch, out_ch, 3)
        self.conv_shortcut = CausalConv3d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        # each intermediate dropped as soon as the next one exists
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        h = F.silu(self.norm2(h), inplace=True)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h.add_(x)


class AttentionBlock3d(nn.Module):
    """Single-head spatial self-attention, applied per frame."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.norm = WanRMSNorm(dim)
        self.to_qkv = Conv2d(dim, dim * 3, 1)
        self.proj = Conv2d(dim, dim, 1)

    def forward(self, x):
        b, f, h, w, c = x.shape
        t = self.norm(x).reshape(b * f, h, w, c)
        qkv = self.to_qkv(t).reshape(b * f, h * w, 3 * c)
        q, k, v = qkv[:, None].chunk(3, dim=-1)  # (bf, 1 head, hw, c)
        attn = scaled_dot_product_attention(q, k, v)[:, 0]
        out = self.proj(attn.reshape(b * f, h, w, c))
        return out.reshape(b, f, h, w, c) + x


class Resample(nn.Module):
    """Spatial (and optionally temporal) resample.

    down: zero-pad (0, 1, 0, 1) + stride-2 conv [+ stride-2 causal time conv]
    up: [time conv emitting 2F - 1 frames +] nearest 2x + 3x3 conv to out_dim
    """

    def __init__(self, dim: int, mode: str, out_dim: Optional[int] = None):
        super().__init__()
        self.mode = mode
        if mode.startswith("downsample"):
            self.resample = nn.ModuleDict({"1": Conv2d(dim, dim, 3, stride=2, padding=0)})
            if mode == "downsample3d":
                self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1))
        elif mode.startswith("upsample"):
            out_dim = out_dim if out_dim is not None else dim // 2
            self.resample = nn.ModuleDict({"1": Conv2d(dim, out_dim, 3, padding=1)})
            if mode == "upsample3d":
                self.time_conv = CausalConv3d(dim, dim * 2, (3, 1, 1))
        else:
            raise ValueError(mode)

    def forward(self, x):
        b, f, h, w, c = x.shape
        if self.mode.startswith("downsample"):
            flat = F.pad(x.reshape(b * f, h, w, c), (0, 0, 0, 1, 0, 1))
            y = self.resample["1"](flat)
            y = y.reshape(b, f, *y.shape[1:])
            if self.mode == "downsample3d":
                y = self.time_conv(y)
            return y
        # temporal duplication first (causal: frame 0 stays single, F -> 2F - 1),
        # then nearest 2x in space and the conv
        if self.mode == "upsample3d":
            y = self.time_conv(x)  # (B, F, H, W, 2C)
            y = y.reshape(b, f, h, w, 2, c).permute(0, 1, 4, 2, 3, 5)
            x = y.reshape(b, 2 * f, h, w, c)[:, 1:]
            del y
            f = x.shape[1]
        up = F.interpolate(x.reshape(b * f, h, w, c).permute(0, 3, 1, 2), scale_factor=2.0,
                           mode="nearest")
        del x
        y = self.resample["1"](up.permute(0, 2, 3, 1))
        return y.reshape(b, f, *y.shape[1:])


def _avg_down(x, out_ch: int, ft: int, fs: int):
    """Parameter-free avg-pool shortcut: space / time factors fold into
    channels, then a grouped mean to out_ch. Time is padded in front by
    repeating frame 0 (causal)."""
    b, f, h, w, c = x.shape
    pad = (ft - f % ft) % ft
    if pad:
        x = torch.cat([x[:, :1].expand(b, pad, h, w, c), x], dim=1)
        f = f + pad
    x = x.reshape(b, f // ft, ft, h // fs, fs, w // fs, fs, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, f // ft, h // fs, w // fs, ft * fs * fs * c)
    group = (ft * fs * fs * c) // out_ch
    return x.reshape(*x.shape[:4], out_ch, group).mean(dim=-1)


def _dup_up(x, out_ch: int, ft: int, fs: int):
    """Inverse shortcut: channels repeated into space / time factors; the
    duplicated leading frames are dropped, so F -> ft F - (ft - 1) (frame 0
    single, causal)."""
    b, f, h, w, c = x.shape
    repeat = (out_ch * ft * fs * fs) // c
    if out_ch % repeat:
        x = x.repeat_interleave(repeat, dim=-1).reshape(b, f, h, w, ft, fs, fs, out_ch)
    else:  # the repeats as an expanded view: one copy, in the reshape below
        x = x.reshape(b, f, h, w, ft, fs, fs, out_ch // repeat, 1).expand(
            b, f, h, w, ft, fs, fs, out_ch // repeat, repeat)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7, *range(8, x.ndim)).reshape(
        b, f * ft, h * fs, w * fs, out_ch)
    return x[:, ft - 1:]


# -- encoder / decoder stages -------------------------------------------------------------


class DownStage(nn.Module):
    """num_res_blocks resnets and an optional resample, with an avg-pool
    shortcut across the whole stage."""

    def __init__(self, in_ch: int, out_ch: int, num_res: int, temporal_down: bool,
                 spatial_down: bool, is_residual: bool):
        super().__init__()
        self.ft = 2 if temporal_down else 1
        self.fs = 2 if spatial_down else 1
        self.out_ch = out_ch
        self.is_residual = is_residual
        self.resnets = nn.ModuleDict({
            str(i): ResidualBlock3d(in_ch if i == 0 else out_ch, out_ch) for i in range(num_res)})
        if spatial_down:
            self.downsampler = Resample(out_ch, "downsample3d" if temporal_down else "downsample2d")
        else:
            self.downsampler = None

    def forward(self, x):
        shortcut = x
        for resnet in self.resnets.values():
            x = resnet(x)
        if self.downsampler is not None:
            x = self.downsampler(x)
        if self.is_residual:
            x = x.add_(_avg_down(shortcut, self.out_ch, self.ft, self.fs))
        return x


class UpStage(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_res: int, temporal_up: bool,
                 spatial_up: bool, is_residual: bool):
        super().__init__()
        self.ft = 2 if temporal_up else 1
        self.fs = 2 if spatial_up else 1
        self.out_ch = out_ch
        self.is_residual = is_residual
        self.resnets = nn.ModuleDict({str(i): ResidualBlock3d(in_ch, in_ch) for i in range(num_res)})
        if spatial_up:
            self.upsampler = Resample(in_ch, "upsample3d" if temporal_up else "upsample2d",
                                      out_dim=out_ch)
        else:
            self.upsampler = None

    def forward(self, x):
        shortcut = x
        for resnet in self.resnets.values():
            x = resnet(x)
        if self.upsampler is not None:
            x = self.upsampler(x)
        if self.is_residual:
            x = x.add_(_dup_up(shortcut, self.out_ch, self.ft, self.fs))
        return x


class MidBlock3d(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.resnets = nn.ModuleDict({"0": ResidualBlock3d(dim, dim), "1": ResidualBlock3d(dim, dim)})
        self.attentions = nn.ModuleDict({"0": AttentionBlock3d(dim)})

    def forward(self, x):
        x = self.resnets["0"](x)
        x = self.attentions["0"](x)
        return self.resnets["1"](x)


class Encoder3d(nn.Module):
    def __init__(self, config: WanVAEConfig):
        super().__init__()
        dims = [config.base_dim * m for m in config.dim_mult]
        stages = {}
        in_ch = dims[0]
        for i, out_ch in enumerate(dims):
            spatial_down = i != len(dims) - 1
            temporal_down = spatial_down and config.temperal_downsample[i]
            stages[str(i)] = DownStage(in_ch, out_ch, config.num_res_blocks, temporal_down,
                                       spatial_down, config.is_residual)
            in_ch = out_ch
        self.conv_in = CausalConv3d(config.in_channels, dims[0], 3)
        self.down_blocks = nn.ModuleDict(stages)
        self.mid_block = MidBlock3d(dims[-1])
        self.norm_out = WanRMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], config.z_dim * 2, 3)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks.values():
            x = stage(x)
        x = self.mid_block(x)
        return _norm_silu_conv(self.norm_out, self.conv_out, x)


class Decoder3d(nn.Module):
    def __init__(self, config: WanVAEConfig):
        super().__init__()
        dims = [config.decoder_base_dim * m for m in reversed(config.dim_mult)]
        # the encoder's mirror: a spatial upsample after all but the last stage,
        # the temporal ones where temperal_downsample, reversed, has them
        temporal = list(reversed(config.temperal_downsample))
        stages = {}
        for i in range(len(dims)):
            out_ch = dims[i + 1] if i + 1 < len(dims) else dims[-1]
            spatial_up = i != len(dims) - 1
            stages[str(i)] = UpStage(dims[i], out_ch, config.num_res_blocks + 1,
                                     spatial_up and temporal[i], spatial_up, config.is_residual)
        self.conv_in = CausalConv3d(config.z_dim, dims[0], 3)
        self.mid_block = MidBlock3d(dims[0])
        self.up_blocks = nn.ModuleDict(stages)
        self.norm_out = WanRMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], config.out_channels, 3)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block(x)
        for stage in self.up_blocks.values():
            x = stage(x)
        return _norm_silu_conv(self.norm_out, self.conv_out, x)


# -- the whole model ----------------------------------------------------------------------


class CausalVAE(VAE, nn.Module):
    """The native AutoencoderKLWan: a frozen module (encode and decode run
    without gradients) that computes in ``dtype`` (fp32 by default). Build
    it on the meta device and materialize it with ``init_random`` or
    ``load_weights``."""

    def __init__(self, config: Optional[WanVAEConfig] = None, dtype: torch.dtype = torch.float32):
        nn.Module.__init__(self)
        self.config = config or WanVAEConfig.from_default()
        self.dtype = dtype
        cfg = self.config
        # the compression of this config (the protocol's class attributes
        # describe the default 48-channel one)
        self.latent_dim = cfg.z_dim
        self.spatial_compression_ratio = (2 ** (len(cfg.dim_mult) - 1)) * cfg.patch_size
        self.temporal_compression_ratio = 2 ** sum(bool(t) for t in cfg.temperal_downsample)
        self.encoder = Encoder3d(cfg)
        self.decoder = Decoder3d(cfg)
        self.quant_conv = CausalConv3d(cfg.z_dim * 2, cfg.z_dim * 2, 1)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, 1)

    @property
    def shift_factor(self) -> torch.Tensor:
        if self.config.z_dim != len(LATENT_MEAN):  # another latent width: identity stats
            return torch.zeros(1, 1, 1, 1, self.config.z_dim)
        return VAE.shift_factor.fget(self)

    @property
    def scaling_factor(self) -> torch.Tensor:
        if self.config.z_dim != len(LATENT_MEAN):
            return torch.ones(1, 1, 1, 1, self.config.z_dim)
        return VAE.scaling_factor.fget(self)

    @property
    def device(self) -> torch.device:
        return self.quant_conv.weight.device

    # -- parameters ---------------------------------------------------------------------

    def _materialize(self, device) -> None:
        self.to(dtype=self.dtype)
        if any(p.is_meta for p in self.parameters()):
            self.to_empty(device=device)
        else:
            self.to(device)

    def init_random(self, generator: torch.Generator, device=None) -> "CausalVAE":
        """Seeded random weights on ``device`` (default: the generator's)."""
        self._materialize(generator.device if device is None else torch.device(device))
        init_parameters_(self, generator)
        return self.eval()

    def load_weights(self, flat: Mapping[str, object], device=None) -> "CausalVAE":
        """Load a flat state dict (the JAX package's keys) in this model's
        dtype onto ``device``: the card unless the caller names another."""
        device = torch.device("cuda" if device is None else device)
        self.to(dtype=self.dtype)
        load_flat_params(self, dict(flat), meta_device=device)
        return self.to(device).eval()

    # -- patchify -----------------------------------------------------------------------

    def _patchify(self, video):
        p = self.config.patch_size
        b, f, h, w, c = video.shape
        x = video.reshape(b, f, h // p, p, w // p, p, c)
        return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, f, h // p, w // p, p * p * c)

    def _unpatchify(self, x):
        p = self.config.patch_size
        b, f, h, w, c = x.shape
        x = x.reshape(b, f, h, w, p, p, c // (p * p))
        return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, f, h * p, w * p, c // (p * p))

    # -- public API ---------------------------------------------------------------------

    def _require_params(self) -> None:
        if self.quant_conv.weight.is_meta:
            raise RuntimeError("Wan VAE has no params: call load_weights() or init_random()")

    @torch.no_grad()
    def encode_moments(self, video: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) -> (B, F', H', W', 2 z) mean / logvar moments."""
        self._require_params()
        x = self._patchify(video.to(self.device, self.dtype))
        return self.quant_conv(self.encoder(x))

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) in [-1, 1] -> the raw latent mean (B, F', H', W', z)."""
        return self.encode_moments(video)[..., : self.config.z_dim]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Raw latents (B, F', H', W', z) -> (B, F, H, W, 3) in [-1, 1]."""
        self._require_params()
        x = self.post_quant_conv(latents.to(self.device, self.dtype))
        return self._unpatchify(self.decoder(x)).clamp_(-1.0, 1.0)

    @classmethod
    def from_default(cls) -> "CausalVAE":
        return cls(WanVAEConfig.from_default())
