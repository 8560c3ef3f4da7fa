"""The port's SDXL generate slice against the JAX package (CPU, fp32).

Tiny configs (those of tests/models/test_sdxl_pipeline.py); inputs from
numpy.random.default_rng(seed); weights from the JAX modules' init,
loaded into the port with load_flat_params / SDXLModel.load_state_dict.
The two frameworks' random bits differ, so the whole-slice test hands the
port's ``_denoise_loop`` the JAX package's own initial latents and
per-step ancestral noise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.autoencoder import AutoencoderKL as JaxVAE
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.sdxl.config import SDXLConfig as JaxSDXLConfig
from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel
from vision_ft_tpu.models.text_encoders import CLIPTextConfig as JaxCLIPConfig
from vision_ft_tpu.models.text_encoders.clip import (
    CLIPTextModelWithProjection as JaxCLIPWithProjection,
)
from vision_ft_tpu.models.text_encoders.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from vision_ft_tpu.utils import tensor as jax_tensor_utils

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKL, AutoencoderKLConfig
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig, SDXLConfig
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTokenizer
from vision_ft_tpu_torch.models.text_encoders.clip import CLIPTextModelWithProjection
from vision_ft_tpu_torch.utils.tensor import incremental_seed_randn
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import assert_offloaded_generate_is_plain

# fp32 on the CPU in both packages: the same arithmetic, summed in other
# orders. Measured: <= 1e-5 abs on the modules' O(1) outputs, 9e-5 abs on
# the slice's latents after 4 CFG steps (values up to ~47: sigma_max
# ~14.6 times unit noise). The tolerance, 1e-4 abs + 1e-4 relative, sits
# above those with room for another CPU's summation order.
TOL = 1e-4


class WordTokenizer:
    """Deterministic stand-in for the CLIP tokenizer: vocab 1000, bos 0,
    eos/pad 999 (the tiny CLIP towers' vocab_size - 1)."""

    bos_token_id = 0
    eos_token_id = 999
    pad_token_id = 999

    def __call__(self, prompts, max_length=None, **kw):
        rows = []
        for p in prompts:
            ids = [3 + sum(map(ord, w)) % 900 for w in p.split()][: max_length - 2]
            rows.append([0, *ids, 999] + [999] * (max_length - len(ids) - 2))
        return np.asarray(rows, dtype=np.int32)


def _clip_config(pkg, hidden, act, projection_dim=768):
    return pkg(
        vocab_size=1000, hidden_size=hidden, intermediate_size=2 * hidden,
        num_hidden_layers=2, num_attention_heads=4, hidden_act=act,
        projection_dim=projection_dim,
    )


def _tiny_kwargs(pkg):
    """(config, constructor kwargs) of the tiny SDXL model in package ``pkg``
    ("jax" or "torch"), the tests/models/test_sdxl_pipeline.py sizes."""
    sdxl, den, vae, clip = {
        "jax": (JaxSDXLConfig, JaxDenoiserConfig, JaxVAEConfig, JaxCLIPConfig),
        "torch": (SDXLConfig, DenoiserConfig, AutoencoderKLConfig, CLIPTextConfig),
    }[pkg]
    config = sdxl(
        checkpoint_path="unused.safetensors",
        dtype="float32",
        denoiser=den(
            hidden_dim=32, num_head_channels=8, context_dim=64 + 48,
            block_out_channels=[32, 64, 64], num_transformers_per_block=[1, 1, 1],
        ),
    )
    return config, dict(
        tokenizer=WordTokenizer(),
        vae_config=vae(block_out_channels=(8, 8, 16, 16), latent_channels=4, norm_num_groups=4),
        text_encoder_config_1=_clip_config(clip, 64, "quick_gelu"),
        text_encoder_config_2=_clip_config(clip, 48, "gelu", projection_dim=1280),
    )


def _flat(params):
    return {k: np.asarray(v) for k, v in jnn.flatten_params(params).items()}


def _random_params(shape_tree, seed):
    """numpy weights for a JAX shape tree: U(+-1/sqrt(fan_in)) matrices and
    kernels, norm scales near 1, small biases (the JAX init, but drawn in
    one numpy pass instead of thousands of eager JAX calls)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in jnn.flatten_params(shape_tree).items():
        shape = tuple(leaf.shape)
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            value = rng.uniform(-bound, bound, shape)
        else:
            value = (1.0 if key.endswith("weight") else 0.0) + rng.normal(0, 0.1, shape)
        flat[key] = value.astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def models():
    config, kwargs = _tiny_kwargs("jax")
    jax_model = JaxSDXLModel(config, **kwargs)
    flat = _random_params(
        jax.eval_shape(
            lambda key: {
                "denoiser": jax_model.denoiser.init(key),
                "vae": jax_model.vae.init(key),
                "text_encoder": jax_model.text_encoder.init(key),
            },
            jax.random.key(0),
        ),
        seed=0,
    )
    jax_model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    config, kwargs = _tiny_kwargs("torch")
    port = SDXLModel(config, **kwargs)
    port.load_state_dict(flat, device="cpu")
    return jax_model, port


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def test_unet_forward_matches_jax(models):
    jax_model, port = models
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((2, 16, 24, 4)).astype(np.float32)
    timestep = np.array([999.0, 251.0], np.float32)
    context = rng.standard_normal((2, 10, 112)).astype(np.float32)
    pooled = rng.standard_normal((2, 1280)).astype(np.float32)
    sizes = np.array([[128, 192], [96, 160]], np.float32)
    crops = np.array([[0, 0], [16, 8]], np.float32)
    args = (latents, timestep, context, pooled, sizes, sizes, crops)
    want = jax.jit(jax_model.denoiser.__call__)(
        jax_model.params["denoiser"], *map(jnp.asarray, args)
    )
    got = port.denoiser(*map(torch.from_numpy, args))
    _close(got, want, TOL, "unet")


def test_clip_towers_match_jax(models):
    jax_model, port = models
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 998, (3, 77)).astype(np.int32)
    ids[:, 0], ids[0, 20:], ids[1, 5], ids[2, 76] = 0, 999, 999, 999
    for name in ("text_encoder_1", "text_encoder_2"):
        want = getattr(jax_model.text_encoder, name)(
            jax_model.params["text_encoder"][name], jnp.asarray(ids)
        )
        got = getattr(port.text_encoder, name)(torch.from_numpy(ids).long())
        for g, w, what in zip(got, want, ("last", "penultimate", "pooled")):
            _close(g, w, TOL, f"{name} {what}")


def test_clip_projection_tower_at_bigg_layout():
    """The projection tower with more heads than the pipeline's tiny one."""
    jax_tower = JaxCLIPWithProjection(_clip_config(JaxCLIPConfig, 128, "gelu", 64))
    flat = _random_params(jax.eval_shape(jax_tower.init, jax.random.key(2)), seed=2)
    params = jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    port = tnn.load_flat_params(
        CLIPTextModelWithProjection(_clip_config(CLIPTextConfig, 128, "gelu", 64)), flat
    )
    ids = np.random.default_rng(3).integers(1, 999, (2, 77)).astype(np.int32)
    ids[:, 40] = 999
    want = jax.jit(jax_tower.__call__)(params, jnp.asarray(ids))
    for g, w in zip(port(torch.from_numpy(ids).long()), want):
        _close(g, w, TOL, "bigG-like tower")


def test_vae_decode_matches_jax(models):
    jax_model, port = models
    z = np.random.default_rng(4).standard_normal((2, 8, 12, 4)).astype(np.float32)
    want = jax_model.vae.decode(jax_model.params["vae"], jnp.asarray(z))
    _close(port.vae.decode(torch.from_numpy(z)), want, TOL, "vae decode")


def test_vae_full_tree_loads_from_jax():
    cfg = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4, norm_num_groups=4)
    flat = _random_params(jax.eval_shape(JaxVAE(JaxVAEConfig(**cfg)).init, jax.random.key(5)), 5)
    port = tnn.load_flat_params(AutoencoderKL(AutoencoderKLConfig(**cfg)), flat)
    assert set(port.state_dict()) == set(flat)
    assert any(k.startswith("encoder.down_blocks.") for k in flat)


@pytest.mark.parametrize("max_token_length", [75, 150])
def test_encode_prompts_matches_jax(models, max_token_length):
    jax_model, port = models
    prompts = ["a photo of a cat", "two dogs on a sofa!"]
    want = jax_model.text_encoder.encode_prompts(
        jax_model.params["text_encoder"], prompts, "blurry", use_negative_prompts=True,
        max_token_length=max_token_length,
    )
    got = port.text_encoder.encode_prompts(
        prompts, "blurry", use_negative_prompts=True, max_token_length=max_token_length
    )
    for tower_got, tower_want in zip(got, want):
        for field, g, w in zip(tower_got._fields, tower_got, tower_want):
            _close(g, w, TOL, field)


def test_clip_bpe_tokenizer_matches_jax(tmp_path):
    vocab = {ch + suffix: 0 for ch in "abcdefghijklmnopqrstuvwxyz" for suffix in ("", "</w>")}
    vocab.update({t: 0 for t in ("hello</w>", "he", "llo</w>", "<|startoftext|>", "<|endoftext|>")})
    vocab = {t: i for i, t in enumerate(vocab)}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh e\nl l\nll o</w>\nhe llo</w>\n")
    prompts = ["Hello  world", "a cat said hello"]
    want = JaxCLIPTokenizer.from_pretrained_dir(str(tmp_path))(prompts, max_length=12)
    got = CLIPTokenizer.from_pretrained_dir(str(tmp_path))(prompts, max_length=12)
    np.testing.assert_array_equal(got, want)


def test_scheduler_tables_match_jax(models):
    jax_model, port = models
    for steps in (3, 20, 30):
        ts = port.scheduler.get_timesteps(steps)
        np.testing.assert_array_equal(ts, jax_model.scheduler.get_timesteps(steps))
        np.testing.assert_array_equal(
            port.scheduler.get_sigmas(ts), jax_model.scheduler.get_sigmas(ts)
        )


def test_incremental_seed_randn_is_per_sample():
    batch = incremental_seed_randn((3, 4, 5), seed=11)
    for i in range(3):
        torch.testing.assert_close(batch[i], incremental_seed_randn((1, 4, 5), seed=11 + i)[0])
    assert batch.dtype == torch.float32 and not torch.equal(batch[0], batch[1])


def test_denoise_loop_and_decode_match_jax_generate(models):
    """The whole slice: text encoding, 3 CFG Euler-ancestral steps with
    cfg_rescale > 0, VAE decode and the conversion to images, the port fed
    the JAX package's own initial latents and per-step noise."""
    jax_model, port = models
    prompt, negative, seed, steps, cfg, rescale = "a photo of a cat", "blurry", 42, 3, 3.0, 0.7
    height, width = 64, 96
    want_images = jax_model.generate(
        prompt, negative_prompt=negative, width=width, height=height,
        num_inference_steps=steps, cfg_scale=cfg, cfg_rescale=rescale, seed=seed,
    )

    # the JAX package's generate(), step by step, for its latents and noise
    timesteps = jax_model.scheduler.get_timesteps(steps)
    sigmas = jax_model.scheduler.get_sigmas(timesteps)
    enc = jax_model.text_encoder.encode_prompts(
        jax_model.params["text_encoder"], prompt, negative, use_negative_prompts=True
    )
    emb, pooled = jax_model.prepare_encoder_hidden_states(enc, True)
    latents0 = jax_model.prepare_latents(
        1, height, width, jax_model.scheduler.get_max_noise_sigma(sigmas), seed
    )
    n = len(timesteps)  # get_timesteps(3) gives 4 steps
    step_seeds = [(seed + 7919 * (i + 1)) & 0x7FFFFFFF for i in range(n)]
    sizes = jnp.broadcast_to(jnp.asarray((height, width), jnp.float32), (2, 2))
    crops = jnp.zeros((2, 2), jnp.float32)
    want_latents = jax_model._get_jit_loop(True)(
        jax_model.params["denoiser"], latents0, jnp.asarray(timesteps),
        jnp.asarray(sigmas[:n]), jnp.asarray(sigmas[1:]),
        jnp.asarray(step_seeds, jnp.int32), emb, pooled, sizes, sizes, crops,
        jnp.float32(cfg), jnp.float32(rescale),
    )
    want_image = jax_model.vae.decode(
        jax_model.params["vae"], want_latents / jax_model.vae.scaling_factor
    )
    noises = [
        jax_tensor_utils._incremental_seed_randn_jit(jnp.int32(s), latents0.shape, jnp.float32)
        for s in step_seeds
    ]

    with torch.inference_mode():
        enc = port.text_encoder.encode_prompts(prompt, negative, use_negative_prompts=True)
        emb, pooled = port.prepare_encoder_hidden_states(enc, True)
        t_sizes = torch.tensor((height, width), dtype=torch.float32).expand(2, 2)
        latents = port._denoise_loop(
            torch.from_numpy(np.array(latents0)),
            [torch.from_numpy(np.array(n)) for n in noises],
            timesteps, sigmas, emb, pooled, t_sizes, t_sizes, torch.zeros(2, 2),
            cfg, rescale, True,
        )
        image = port.vae.decode(latents / port.vae.scaling_factor)
        images = port.decode_image(latents)

    _close(latents, want_latents, TOL, "latents")
    _close(image, want_image, TOL, "decoded image")
    assert len(images) == 1 and images[0].size == (width, height)
    # uint8 conversion truncates: an fp32 difference may cross one step
    diff = np.abs(np.asarray(images[0], np.int16) - np.asarray(want_images[0], np.int16))
    assert diff.max() <= 1


def test_generate_runs_and_is_seeded(models):
    _, port = models
    kwargs = dict(negative_prompt="blurry", width=64, height=64, num_inference_steps=2,
                  cfg_scale=3.0, seed=7)
    images = port.generate(["a cat", "a dog"], **kwargs)
    assert len(images) == 2 and all(isinstance(im, Image.Image) for im in images)
    assert images[0].size == (64, 64)
    again = port.generate(["a cat", "a dog"], **kwargs)
    np.testing.assert_array_equal(np.asarray(images[1]), np.asarray(again[1]))


@pytest.mark.parametrize("option", [{"do_offloading": True}])
def test_generate_rejects_unported_options(models, option, monkeypatch):
    """Offloading, which raised before it was ported, now runs: an offloaded
    request (the first, then one from the host) is the plain one bit for
    bit."""
    model = models[1]
    common = dict(width=64, height=64, num_inference_steps=2, cfg_scale=3.0, seed=7)
    assert_offloaded_generate_is_plain(
        monkeypatch, model, lambda **kw: model.generate("a cat", **common, **kw), ("text_encoder", "denoiser", "vae"))
    assert option == {"do_offloading": True}


def test_init_params_on_a_generator():
    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config, **kwargs)
    model.init_params(torch.Generator().manual_seed(0))
    assert not any(p.is_meta for p in model.denoiser.parameters())
    images = model.generate("a cat", width=64, height=64, num_inference_steps=2, seed=1)
    assert np.isfinite(np.asarray(images[0], np.float32)).all()


def _feed_forward_pair(c=128, seed=0):
    """The SDXL FeedForward at (c, 4c) in both packages, the same numpy weights."""
    from vision_ft_tpu.models.sdxl.denoiser import FeedForward as JaxFeedForward

    from vision_ft_tpu_torch.models.sdxl.denoiser import FeedForward

    jax_ff = JaxFeedForward(c)
    flat = _random_params(jax.eval_shape(jax_ff.init, jax.random.key(0)), seed)
    with torch.device("meta"):
        ff = FeedForward(c)
    return jax_ff, jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), \
        tnn.load_flat_params(ff, flat)


@pytest.mark.parametrize("adapter", [False, True], ids=["dense", "lora"])
def test_feed_forward_takes_the_fused_route_under_its_gate(monkeypatch, adapter):
    """The JAX _fused_ff_applies route of the SDXL FeedForward: with the
    fused feed-forward gate open (on the card set_fused_ff("on") and bf16
    CUDA activations; here the gate is opened for CPU tensors), a dense
    GeGLU with biases goes to geglu_mlp (its plain version on the CPU) and
    matches the JAX package's geglu_mlp kernel (interpret mode) within fp32
    rounding (2e-5 on O(1) values); a LoRA on the layer keeps the plain
    route, as in the JAX package."""
    from vision_ft_tpu.ops.pallas import fused_mlp as jax_fused

    import vision_ft_tpu_torch.models.sdxl.denoiser as denoiser_module
    from vision_ft_tpu_torch.modules import peft
    from vision_ft_tpu_torch.ops import fused_mlp

    jax_ff, params, ff = _feed_forward_pair()
    if adapter:
        peft.replace_to_peft_layer(ff, ["net"], [], peft.LoRAConfig(rank=2, dtype="float32"),
                                   torch.Generator().manual_seed(0))
    calls = []
    geglu = denoiser_module.geglu_mlp
    monkeypatch.setattr(denoiser_module, "geglu_mlp", lambda *a: calls.append(1) or geglu(*a))
    # the gate as on the card, minus its device and dtype checks
    monkeypatch.setattr(
        denoiser_module, "fused_ff_enabled",
        lambda x, *layers, inner=None: fused_mlp.fused_ff() == "on" and all(
            not layer.is_quantized and "lora_down" not in layer._modules for layer in layers),
    )
    x = np.random.default_rng(1).standard_normal((2, 24, 128)).astype(np.float32)
    with torch.no_grad():
        plain = ff(torch.from_numpy(x))
        fused_mlp.set_fused_ff("on")
        try:
            routed = ff(torch.from_numpy(x))
        finally:
            fused_mlp.set_fused_ff("auto")
    assert len(calls) == (0 if adapter else 1)
    if adapter:
        assert torch.equal(routed, plain)
        return
    net = params["net"]
    want = jax_fused.geglu_mlp(
        jnp.asarray(x), net["0"]["proj"]["weight"], net["0"]["proj"]["bias"],
        net["2"]["weight"], net["2"]["bias"], interpret=True,
    )
    np.testing.assert_allclose(routed.numpy(), np.asarray(want), atol=2e-5)
    # the plain route is the JAX FeedForward's own (exact gelu in fp32)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jax_ff(params, jnp.asarray(x))), atol=2e-5)


def test_feed_forward_gate_stays_shut_on_the_cpu_and_in_auto():
    """Off the card, and at SDXL widths under "auto", the plain route."""
    from vision_ft_tpu_torch.ops import fused_mlp

    _, _, ff = _feed_forward_pair()
    layers = (ff["net"]["0"]["proj"], ff["net"]["2"])
    x = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
    assert not fused_mlp.fused_ff_enabled(x, *layers, inner=512)
    fused_mlp.set_fused_ff("on")
    try:
        assert not fused_mlp.fused_ff_enabled(x, *layers, inner=512)  # a CPU tensor
    finally:
        fused_mlp.set_fused_ff("auto")
