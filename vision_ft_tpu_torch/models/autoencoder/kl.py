"""KL autoencoder (SD/SDXL VAE and the 16-channel Flux VAE),
``vision_ft_tpu/models/autoencoder/kl.py`` counterpart, diffusers key layout.

The whole module tree is ported, so that the JAX package's parameters
load with strict keys, with ``encode`` (the Lumina2 train step's, into a
``DiagonalGaussian``) and ``decode`` (the generate paths). All tensors are
NHWC; latents (B, H/8, W/8, C). The mid-block attention is single-head over
HW tokens and runs the plain formula ("xla" backend, as in the JAX
package), and ``tiled_decode`` (overlapping tiles with blended seams, the
SDXL pipeline's decode at 1536 px and up).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Conv2d, GroupNorm, Linear
from ...ops.attention import scaled_dot_product_attention


@dataclass
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    # pipeline-level attributes
    compression_ratio: int = 8
    scaling_factor: float = 0.13025
    shift_factor: float = 0.0
    use_quant_conv: bool = True
    mid_block_add_attention: bool = True


# the 16-channel Flux VAE (Lumina2): a shift factor, no quant convs
FLUX_VAE_CONFIG = AutoencoderKLConfig(
    latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
    use_quant_conv=False,
)
SDXL_VAE_CONFIG = AutoencoderKLConfig()


class ResnetBlock(nn.ModuleDict):
    def __init__(self, in_ch: int, out_ch: int, groups: int = 32):
        children = {
            "norm1": GroupNorm(groups, in_ch, eps=1e-6),
            "conv1": Conv2d(in_ch, out_ch, 3, padding=1),
            "norm2": GroupNorm(groups, out_ch, eps=1e-6),
            "conv2": Conv2d(out_ch, out_ch, 3, padding=1),
        }
        if in_ch != out_ch:
            children["conv_shortcut"] = Conv2d(in_ch, out_ch, 1)
        super().__init__(children)

    def forward(self, x):
        h = self["conv1"](F.silu(self["norm1"](x)))
        h = self["conv2"](F.silu(self["norm2"](h)))
        if "conv_shortcut" in self:
            x = self["conv_shortcut"](x)
        return x + h


class VAEAttention(nn.ModuleDict):
    """Single-head full attention over HW tokens (diffusers Attention)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(
            {
                "group_norm": GroupNorm(groups, channels, eps=1e-6),
                "to_q": Linear(channels, channels),
                "to_k": Linear(channels, channels),
                "to_v": Linear(channels, channels),
                "to_out": nn.ModuleDict({"0": Linear(channels, channels)}),
            }
        )

    def forward(self, x):
        b, h, w, c = x.shape
        t = self["group_norm"](x).reshape(b, h * w, c)
        q = self["to_q"](t)[:, None]  # (b, 1 head, hw, c)
        k = self["to_k"](t)[:, None]
        v = self["to_v"](t)[:, None]
        attn = scaled_dot_product_attention(q, k, v)[:, 0]
        return self["to_out"]["0"](attn).reshape(b, h, w, c) + x


class MidBlock(nn.ModuleDict):
    def __init__(self, channels: int, groups: int = 32, add_attention: bool = True):
        children = {
            "resnets": nn.ModuleDict(
                {
                    "0": ResnetBlock(channels, channels, groups),
                    "1": ResnetBlock(channels, channels, groups),
                }
            ),
        }
        if add_attention:
            children["attentions"] = nn.ModuleDict({"0": VAEAttention(channels, groups)})
        super().__init__(children)

    def forward(self, x):
        x = self["resnets"]["0"](x)
        if "attentions" in self:
            x = self["attentions"]["0"](x)
        return self["resnets"]["1"](x)


class Downsampler(nn.ModuleDict):
    """Stride-2 conv with diffusers' asymmetric (0,1)x(0,1) padding."""

    def __init__(self, channels: int):
        super().__init__({"conv": Conv2d(channels, channels, 3, stride=2, padding=0)})

    def forward(self, x):
        # NHWC: one zero column on the right of W, one zero row below H
        return self["conv"](F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsampler(nn.ModuleDict):
    def __init__(self, channels: int):
        super().__init__({"conv": Conv2d(channels, channels, 3, padding=1)})

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self["conv"](x.permute(0, 2, 3, 1))


class Encoder(nn.Module):
    """Image (B, H, W, 3) -> moments (B, H/8, W/8, 2 * latent_channels)."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        chs = config.block_out_channels
        g = config.norm_num_groups
        self.conv_in = Conv2d(config.in_channels, chs[0], 3, padding=1)
        blocks = {}
        in_ch = chs[0]
        for i, out_ch in enumerate(chs):
            block = {
                "resnets": nn.ModuleDict(
                    {
                        str(j): ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g)
                        for j in range(config.layers_per_block)
                    }
                )
            }
            if i != len(chs) - 1:
                block["downsamplers"] = nn.ModuleDict({"0": Downsampler(out_ch)})
            blocks[str(i)] = nn.ModuleDict(block)
            in_ch = out_ch
        self.down_blocks = nn.ModuleDict(blocks)
        self.mid_block = MidBlock(chs[-1], g, config.mid_block_add_attention)
        self.conv_norm_out = GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * config.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks.values():
            for resnet in block["resnets"].values():
                h = resnet(h)
            if "downsamplers" in block:
                h = block["downsamplers"]["0"](h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        rev = list(reversed(config.block_out_channels))
        g = config.norm_num_groups
        self.conv_in = Conv2d(config.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g, config.mid_block_add_attention)
        blocks = {}
        in_ch = rev[0]
        for i, out_ch in enumerate(rev):
            block = {
                "resnets": nn.ModuleDict(
                    {
                        str(j): ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g)
                        for j in range(config.layers_per_block + 1)
                    }
                )
            }
            if i != len(rev) - 1:
                block["upsamplers"] = nn.ModuleDict({"0": Upsampler(out_ch)})
            blocks[str(i)] = nn.ModuleDict(block)
            in_ch = out_ch
        self.up_blocks = nn.ModuleDict(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], config.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks.values():
            for resnet in block["resnets"].values():
                h = resnet(h)
            if "upsamplers" in block:
                h = block["upsamplers"]["0"](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class DiagonalGaussian:
    """diffusers' DiagonalGaussianDistribution over NHWC moments."""

    def __init__(self, moments: torch.Tensor):
        mean, logvar = moments.chunk(2, dim=-1)
        self.mean = mean
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """mean + std * noise: unit normal noise drawn from ``generator`` in
        the mean's dtype (the JAX package's draw), or the ``noise`` given."""
        if noise is None:
            if generator is None:
                raise ValueError("sample needs a generator or the noise")
            noise = torch.randn(
                self.mean.shape, generator=generator, dtype=self.mean.dtype, device=generator.device
            )
        return self.mean + self.std * noise.to(self.mean.device, self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """Full VAE; keys ``encoder.*``, ``decoder.*`` (+ the quant convs)."""

    def __init__(self, config: AutoencoderKLConfig = SDXL_VAE_CONFIG):
        super().__init__()
        self.config = config
        self.compression_ratio = config.compression_ratio
        self.scaling_factor = config.scaling_factor
        self.shift_factor = config.shift_factor
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        c = config.latent_channels
        if config.use_quant_conv:
            self.quant_conv = Conv2d(2 * c, 2 * c, 1)
            self.post_quant_conv = Conv2d(c, c, 1)
        else:
            self.quant_conv = None
            self.post_quant_conv = None

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """Image (B, H, W, 3) in [-1, 1] -> the latent distribution."""
        moments = self.encoder(x)
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        return DiagonalGaussian(moments)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, h, w, C) -> image (B, 8h, 8w, 3), NHWC."""
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    def tiled_decode(
        self, z: torch.Tensor, tile_latent_size: int = 64, tile_overlap_factor: float = 0.25
    ) -> torch.Tensor:
        """Decode in overlapping tiles and blend the seams (diffusers'
        ``AutoencoderKL.tiled_decode``, as the JAX package computes it):
        each tile blends against its raw upper and left neighbours, then is
        cropped, so the output has the size of a whole decode. A blended
        tile is fp32, as the JAX package's (its fp32 ramp promotes it)."""
        sf = self.config.compression_ratio
        overlap = int(tile_latent_size * tile_overlap_factor)
        stride = tile_latent_size - overlap
        blend = int(tile_latent_size * sf * tile_overlap_factor)
        _, h, w, _ = z.shape
        rows = [
            [
                self.decode(z[:, i : i + tile_latent_size, j : j + tile_latent_size])
                for j in range(0, w, stride)
            ]
            for i in range(0, h, stride)
        ]

        def ramp(extent, dim, like):
            t = torch.arange(extent, dtype=torch.float32, device=like.device) / extent
            return t.view([-1 if d == dim else 1 for d in range(4)])

        def blend_v(a, b, extent):
            extent = min(a.shape[1], b.shape[1], extent)
            t = ramp(extent, 1, b)
            mixed = a[:, -extent:] * (1 - t) + b[:, :extent] * t
            return torch.cat([mixed, b[:, extent:]], dim=1)

        def blend_h(a, b, extent):
            extent = min(a.shape[2], b.shape[2], extent)
            t = ramp(extent, 2, b)
            mixed = a[:, :, -extent:] * (1 - t) + b[:, :, :extent] * t
            return torch.cat([mixed, b[:, :, extent:]], dim=2)

        row_limit = tile_latent_size * sf - blend
        out_rows = []
        for i, row in enumerate(rows):
            result_row = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = blend_v(rows[i - 1][j], tile, blend)
                if j > 0:
                    tile = blend_h(row[j - 1], tile, blend)
                result_row.append(tile[:, :row_limit, :row_limit])
            out_rows.append(torch.cat(result_row, dim=2))  # cat promotes a mix to fp32
        return torch.cat(out_rows, dim=1)
