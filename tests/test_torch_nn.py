"""The port's layer set and weight converter against the JAX package (CPU).

Inputs come from numpy.random.default_rng(seed); parameters from the JAX
modules' own init, flattened with nn.core.flatten_params and loaded into
the port with load_flat_params. Both packages take NHWC activations.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.autoencoder import AutoencoderKL as JaxVAE
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.sdxl.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.models.sdxl.text_encoder import TextEncoder as JaxTextEncoder
from vision_ft_tpu.modules.timestep.embedding import (
    get_timestep_embedding as jax_timestep_embedding,
)

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKL
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_ft_tpu_torch.models.sdxl.denoiser import Denoiser
from vision_ft_tpu_torch.models.sdxl.text_encoder import TextEncoder
from vision_ft_tpu_torch.modules.timestep.embedding import get_timestep_embedding


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops while a test module runs
    (the other test_torch_* modules import this fixture): the suite runs
    in several worker processes at once, and PyTorch's default of a thread
    a core in each of them, and in each serving thread, oversubscribes the
    cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# fp32 on the CPU in both packages: the same products, summed in another
# order by XLA and by PyTorch's CPU kernels, so agreement to a few fp32
# ulps of the output magnitude (all O(1) here)
FP32_TOL = 1e-5

# (JAX module, port module) pairs built from the same arguments
LAYERS = {
    "linear": lambda m: m.Linear(16, 24),
    "linear_nobias": lambda m: m.Linear(16, 24, bias=False),
    "conv3x3": lambda m: m.Conv2d(8, 12, 3, padding=1),
    "conv3x3_stride2": lambda m: m.Conv2d(8, 12, 3, stride=2, padding=1),
    "conv1x1": lambda m: m.Conv2d(8, 12, 1),
    "layer_norm": lambda m: m.LayerNorm(32),
    "layer_norm_nobias": lambda m: m.LayerNorm(32, bias=False),
    "layer_norm_noaffine": lambda m: m.LayerNorm(32, elementwise_affine=False),
    "group_norm": lambda m: m.GroupNorm(4, 16, eps=1e-6),
    "embedding": lambda m: m.Embedding(50, 16),
}
LAYER_INPUTS = {
    "linear": (2, 5, 16),
    "linear_nobias": (2, 5, 16),
    "conv3x3": (2, 9, 9, 8),
    "conv3x3_stride2": (2, 9, 9, 8),
    "conv1x1": (2, 9, 9, 8),
    "layer_norm": (3, 7, 32),
    "layer_norm_nobias": (3, 7, 32),
    "layer_norm_noaffine": (3, 7, 32),
    "group_norm": (2, 6, 5, 16),
}


def _flat(params):
    return {k: np.asarray(v) for k, v in jnn.flatten_params(params).items()}


def _jax_and_port(name, seed=0, dtype=jnp.float32):
    jax_layer = LAYERS[name](jnn)
    params = jax_layer.init(jax.random.key(seed), dtype)
    # norms init to ones/zeros: perturb so the affine path is exercised
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(0, 0.1, p.shape), p.dtype), params
    )
    port_layer = tnn.load_flat_params(LAYERS[name](tnn), _flat(params))
    return jax_layer, params, port_layer


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    jax_layer, params, port_layer = _jax_and_port(name)
    rng = np.random.default_rng(1)
    if name == "embedding":
        x = rng.integers(0, 50, (3, 7)).astype(np.int32)
        got = port_layer(torch.from_numpy(x).long())
    else:
        x = rng.standard_normal(LAYER_INPUTS[name]).astype(np.float32)
        got = port_layer(torch.from_numpy(x))
    want = np.asarray(jax_layer(params, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_bf16_matches_jax(bias):
    """bf16 LayerNorm on the CPU takes the plain formula in both packages:
    fp32 statistics, one rounding to bf16 at the end. The fp32 values
    differ in the last bits (sum order), which can flip a rounding: at most
    one bf16 ulp, 2**-8 relative."""
    jax_layer = jnn.LayerNorm(256, bias=bias)
    rng = np.random.default_rng(2)
    params = {
        k: jnp.asarray(rng.normal(1.0, 0.2, (256,)), jnp.bfloat16)
        for k in (["weight", "bias"] if bias else ["weight"])
    }
    port_layer = tnn.load_flat_params(tnn.LayerNorm(256, bias=bias), _flat(params))
    port_layer.to(torch.bfloat16)
    x = rng.standard_normal((4, 33, 256)).astype(np.float32) * 3 + 0.5
    want = np.asarray(jax_layer(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = port_layer(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2**-8, atol=2**-8)


@pytest.mark.parametrize("shift,flip", [(0.0, True), (1.0, False)])
def test_timestep_embedding_matches_jax(shift, flip):
    t = np.random.default_rng(3).uniform(0, 1000, (6,)).astype(np.float32)
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), 257, flip, shift))
    got = get_timestep_embedding(torch.from_numpy(t), 257, flip, shift).numpy()
    # sin/cos of arguments up to 1000 rad: fp32 argument rounding dominates
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# load_flat_params


def _tiny_denoiser(pkg_config):
    return pkg_config(
        hidden_dim=32, num_head_channels=8, context_dim=112,
        block_out_channels=[32, 64, 64], num_transformers_per_block=[1, 1, 1],
    )


TINY_MODULES = {
    "unet": (
        lambda: JaxDenoiser(_tiny_denoiser(JaxDenoiserConfig)),
        lambda: Denoiser(_tiny_denoiser(DenoiserConfig)),
    ),
    "transformer_layer_norm": (lambda: jnn.LayerNorm(128), lambda: tnn.LayerNorm(128)),
}


@pytest.mark.parametrize("name", sorted(TINY_MODULES))
def test_load_flat_params_round_trip(name):
    jax_ctor, port_ctor = TINY_MODULES[name]
    # the JAX module's own key layout and shapes, filled from numpy (an
    # eager JAX init of the UNet takes seconds per thousand leaves)
    shapes = jnn.flatten_params(jax.eval_shape(jax_ctor().init, jax.random.key(4)))
    rng = np.random.default_rng(4)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in shapes.items()}
    port = tnn.load_flat_params(port_ctor(), flat)
    state = port.state_dict()
    assert set(state) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)


def test_load_flat_params_bf16_bit_exact():
    flat = {"weight": np.arange(-24, 24, dtype=np.float32).reshape(4, 12).astype(ml_dtypes.bfloat16)}
    flat["weight"][0, 0] = ml_dtypes.bfloat16(1.0 / 3.0)
    layer = tnn.Linear(12, 4, bias=False).to(torch.bfloat16)
    tnn.load_flat_params(layer, flat)
    assert layer.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        layer.weight.detach().view(torch.int16).numpy(), flat["weight"].view(np.int16)
    )


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_load_flat_params_is_strict(fault):
    flat = {"weight": np.zeros((4, 12), np.float32), "bias": np.zeros(4, np.float32)}
    if fault == "missing":
        del flat["bias"]
    elif fault == "unexpected":
        flat["lora_down.weight"] = np.zeros((2, 12), np.float32)
    else:
        flat["weight"] = np.zeros((12, 4), np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        tnn.load_flat_params(tnn.Linear(12, 4), flat)


def _shapes(params_shape_tree):
    return {k: tuple(v.shape) for k, v in jnn.flatten_params(params_shape_tree).items()}


@pytest.mark.parametrize("part", ["denoiser", "vae", "text_encoder"])
def test_full_sdxl_keys_and_shapes_match(part):
    """Full SDXL width: the port's module trees (built on the meta device)
    carry exactly the JAX package's flattened keys and shapes. The JAX
    side is shape-evaluated, never initialized."""
    jax_module, port_module = {
        "denoiser": (JaxDenoiser(JaxDenoiserConfig()), lambda: Denoiser(DenoiserConfig())),
        "vae": (JaxVAE(), AutoencoderKL),
        "text_encoder": (JaxTextEncoder(backend="flash"), lambda: TextEncoder(backend="flash")),
    }[part]
    want = _shapes(jax.eval_shape(jax_module.init, jax.random.key(0)))
    with torch.device("meta"):
        port = port_module()
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
