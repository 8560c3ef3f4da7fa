"""The port's native Wan 2.2 causal 3-D VAE against the JAX package's, on
the CPU in fp32 at the tiny config tests/models/test_wan_vae.py uses (base
8, z 4, dim_mult (1, 2, 2, 2), one resnet a stage): encode and decode of
the same seeded weights, the compression arithmetic, temporal causality,
the normalization constants, the state-dict round trip and the keys and
shapes at the default config.

The JAX package's VAE jits its own programs; its weights are seeded numpy
draws at the shapes of its init, traced and not run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.models.wan.vae3d import CausalVAE as JaxCausalVAE
from vision_ft_tpu.models.wan.vae3d import WanVAEConfig as JaxVAEConfig
from vision_ft_tpu.nn import flatten_params

from vision_ft_tpu_torch.models.wan.vae import LATENT_MEAN, LATENT_STD
from vision_ft_tpu_torch.models.wan.vae3d import CausalConv3d, CausalVAE, WanVAEConfig
from vision_ft_tpu_torch.utils import safetensors as st
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_wan import TINY_VAE, _close, seeded

# fp32 on the CPU: a dozen 3-D convolutions summed in other orders by the two
# packages (XLA's shifted 2-D taps, PyTorch's conv3d); relative to each
# tensor's max
TOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    jax_vae = JaxCausalVAE(JaxVAEConfig(**TINY_VAE))
    flat = seeded(jax_vae.init, 20)
    jax_vae.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    with torch.device("meta"):
        vae = CausalVAE(WanVAEConfig(**TINY_VAE))
    vae.load_weights(flat, "cpu")
    return jax_vae, vae, flat


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_encode_decode_match_jax(vaes, frames):
    """An image (1 frame) and 1 + 4k frames at 32 x 48: the moments of the
    encoder and the decoded video of the same latents."""
    jax_vae, vae, _ = vaes
    rng = np.random.default_rng(frames)
    video = rng.uniform(-1, 1, (2, frames, 32, 48, 3)).astype(np.float32)
    want = jax_vae.encode_moments(jnp.asarray(video))
    got = vae.encode_moments(torch.from_numpy(video))
    assert got.shape == ((2, (frames - 1) // 4 + 1, 2, 3, 8))
    _close(got, want, TOL, "moments")
    _close(vae.encode(torch.from_numpy(video)), jax_vae.encode(jnp.asarray(video)), TOL, "mean")
    z = rng.standard_normal(tuple(got.shape[:-1]) + (4,)).astype(np.float32)
    decoded = vae.decode(torch.from_numpy(z))
    assert decoded.shape == (2, frames, 32, 48, 3)
    assert float(decoded.abs().max()) <= 1.0
    _close(decoded, jax_vae.decode(jnp.asarray(z)), TOL, "decode")


def test_compression_arithmetic_and_causality(vaes):
    """4x in time (1 + 4k frames <-> 1 + k latents), 16x in space; a latent
    frame does not depend on pixel frames after its window, nor a decoded
    frame on later latents."""
    _, vae, _ = vaes
    assert (vae.temporal_compression_ratio, vae.spatial_compression_ratio, vae.latent_dim) == (
        4, 16, 4)
    rng = np.random.default_rng(21)
    video = torch.from_numpy(rng.standard_normal((1, 9, 32, 32, 3)).astype(np.float32))
    lat = vae.encode(video)
    assert lat.shape == (1, 3, 2, 2, 4)
    cut = video.clone()
    cut[:, 5:] = 0.0
    lat_cut = vae.encode(cut)
    torch.testing.assert_close(lat[:, :2], lat_cut[:, :2], rtol=0, atol=0)
    assert float((lat[:, 2] - lat_cut[:, 2]).abs().max()) > 0
    z = torch.from_numpy(rng.standard_normal((1, 3, 2, 2, 4)).astype(np.float32))
    d1 = vae.decode(z)
    z_cut = z.clone()
    z_cut[:, 2:] = 0.0
    torch.testing.assert_close(d1[:, :1], vae.decode(z_cut)[:, :1], rtol=0, atol=0)


@pytest.mark.parametrize("kernel,stride", [(3, 1), ((3, 1, 1), (2, 1)), (1, 1)])
def test_causal_conv3d_matches_jax(kernel, stride):
    """One causal conv: 3 x 3 x 3, the stride-2 time conv of a downsample,
    and 1 x 1 x 1, over 5 frames."""
    from vision_ft_tpu.models.wan.vae3d import CausalConv3d as JaxConv

    jax_conv = JaxConv(6, 10, kernel, stride=stride)
    flat = seeded(jax_conv.init, 22)
    with torch.device("meta"):
        conv = CausalConv3d(6, 10, kernel, stride=stride)
    conv.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()}, assign=True)
    x = np.random.default_rng(23).standard_normal((2, 5, 8, 8, 6)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_conv(p, x))({k: jnp.asarray(v) for k, v in flat.items()},
                                                jnp.asarray(x))
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    _close(got, want, 1e-5, "conv")


def test_normalization_constants_round_trip():
    """The default 48-channel statistics are the published ones and
    normalize / denormalize invert; another latent width has identity
    statistics."""
    with torch.device("meta"):
        vae = CausalVAE.from_default()
        tiny = CausalVAE(WanVAEConfig(**TINY_VAE))
    assert vae.latent_dim == 48 and vae.dtype == torch.float32
    np.testing.assert_allclose(vae.shift_factor.reshape(-1).numpy(), np.float32(LATENT_MEAN))
    np.testing.assert_allclose(vae.scaling_factor.reshape(-1).numpy(), np.float32(LATENT_STD))
    raw = torch.randn(1, 1, 2, 2, 48, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(vae.denormalize_latents(vae.normalize_latents(raw)), raw,
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(tiny.shift_factor, torch.zeros(1, 1, 1, 1, 4))
    assert torch.equal(tiny.scaling_factor, torch.ones(1, 1, 1, 1, 4))


def test_state_dict_round_trip_and_default_keys(vaes, tmp_path):
    """The port's keys and shapes are the JAX init's, at the tiny and the
    default config; a file written from the state dict loads back into a
    meta-built VAE with the same encode."""
    jax_vae, vae, _ = vaes
    for jax_module, config in ((jax_vae, WanVAEConfig(**TINY_VAE)),
                               (JaxCausalVAE(JaxVAEConfig.from_default()),
                                WanVAEConfig.from_default())):
        shapes = flatten_params(jax.eval_shape(jax_module.init, jax.random.PRNGKey(0)))
        with torch.device("meta"):
            module = CausalVAE(config)
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == {
            k: tuple(v.shape) for k, v in shapes.items()}
    sd = vae.state_dict()
    assert "quant_conv.weight" in sd and "post_quant_conv.bias" in sd
    assert any(k.startswith("decoder.up_blocks.0.upsampler.time_conv") for k in sd)
    path = tmp_path / "wan_vae.safetensors"
    st.save_file(sd, path)
    with torch.device("meta"):
        loaded = CausalVAE(WanVAEConfig(**TINY_VAE))
    loaded.load_weights(st.load_file(path), "cpu")
    video = torch.from_numpy(np.random.default_rng(24).uniform(-1, 1, (1, 5, 32, 32, 3))
                             .astype(np.float32))
    torch.testing.assert_close(loaded.encode(video), vae.encode(video), rtol=0, atol=0)
    seeded_vae = CausalVAE(WanVAEConfig(**TINY_VAE)).init_random(torch.Generator().manual_seed(1))
    assert seeded_vae.encode(video).shape == (1, 2, 2, 2, 4)
