"""The port's Flux slice against the JAX package's, on the CPU in fp32 at
the tiny config tests/models/test_flux.py uses (hidden 48, 2 heads, RoPE
axes [8, 8, 8], 1 double + 2 single blocks): the denoiser of each variant
with and without guidance, its remat path and DeepCache path, the prompt
API, the schedules, the single-file checkpoint, the slot step and the whole
slice: ``generate()`` from the same weights and the same noise, a serving
pool against batch-1 ``generate()``, the server and the CLI.

The JAX package's programs are jitted once per module (its eager dispatch
compiles op by op and costs far more on the CPU). The one place the port
departs from the JAX package is the guidance gate: per row here, over the
batch's maximum there (``test_jax_slot_step_depends_on_its_neighbours``).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from safetensors.numpy import save_file

from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.flux import config as jax_config
from vision_ft_tpu.models.flux import text_encoder as jax_text_encoder
from vision_ft_tpu.models.flux import util as jax_util
from vision_ft_tpu.models.flux.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.models.flux.pipeline import FluxModel as JaxFluxModel
from vision_ft_tpu.models.text_encoders.clip import CLIPTextConfig as JaxCLIPConfig
from vision_ft_tpu.models.text_encoders.umt5 import UMT5Config as JaxT5Config
from vision_ft_tpu.modules import patch as jax_patch
from vision_ft_tpu.modules.timestep import scheduler as jax_scheduler
from vision_ft_tpu.nn import flatten_params, unflatten_params

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.autoencoder.kl import FLUX_VAE_CONFIG
from vision_ft_tpu_torch.models.flux import config as flux_config
from vision_ft_tpu_torch.models.flux import text_encoder, util
from vision_ft_tpu_torch.models.flux import vae as flux_vae
from vision_ft_tpu_torch.models.flux.denoiser import Denoiser
from vision_ft_tpu_torch.models.flux.pipeline import FluxModel
from vision_ft_tpu_torch.models.text_encoders import sentencepiece
from vision_ft_tpu_torch.models.text_encoders.clip import CLIPTextConfig
from vision_ft_tpu_torch.models.text_encoders.umt5 import UMT5Config
from vision_ft_tpu_torch.modules import patch
from vision_ft_tpu_torch.modules.timestep import scheduler
from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd
from vision_ft_tpu_torch.ops.layer_norm import layer_norm
from vision_ft_tpu_torch.serving import ContinuousBatcher, FluxSlotAdapter, SlotRequest
from vision_ft_tpu_torch.tools import inference_cli
from vision_ft_tpu_torch.tools import inference_server as srv
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import assert_offloaded_generate_is_plain

# fp32 on the CPU: a few transformer blocks of O(1) activations summed in
# other orders by the two packages; relative to each tensor's max
TOL = 5e-5

TINY = dict(
    in_channels=16, out_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=48,
    mlp_ratio=2.0, num_heads=2, depth=1, depth_single_blocks=2, axes_dim=[8, 8, 8],
    patch_size=2, vae_channels=4, use_flash_attention=False,
)
VARIANTS = {
    "flux1-dev": jax_config.Flux1DevDenoiserConfig,
    "flux1-schnell": jax_config.Flux1SchnellDenoiserConfig,
    "flex1-alpha": jax_config.Flex1AlphaDenoiserConfig,
}
PORT_VARIANTS = {
    "flux1-dev": flux_config.Flux1DevDenoiserConfig,
    "flux1-schnell": flux_config.Flux1SchnellDenoiserConfig,
    "flex1-alpha": flux_config.Flex1AlphaDenoiserConfig,
}
# the pipeline's tiny parts: T5 ids cover the test vocab's pieces, CLIP's
# eos is its last id (999), the VAE has Flux's factors
PIPE_DENOISER = dict(TINY, vec_in_dim=48)
CLIP = dict(vocab_size=1000, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, hidden_act="quick_gelu")
T5 = dict(vocab_size=300, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
          relative_attention_num_buckets=8, relative_attention_max_distance=16,
          per_layer_relative_bias=False)
VAE = dict(block_out_channels=(8, 8, 16, 16), latent_channels=4, norm_num_groups=4,
           use_quant_conv=False, scaling_factor=0.3611, shift_factor=0.1159)
PROMPTS = ["a cat sitting on the sofa", "a red car"]


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: max err {err:.3e} > {tol} x {scale:.3e}"


def _numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _jax_params(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _seeded(module, seed):
    """Seeded numpy weights at the shapes of ``module``'s JAX init (traced,
    not run: a jitted init costs seconds to compile on the CPU). Vectors
    named as norms are near one, other vectors small, weights of std
    1 / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    shapes = flatten_params(jax.eval_shape(module.init, jax.random.PRNGKey(0)))
    flat = {}
    for key, leaf in sorted(shapes.items()):
        shape = tuple(leaf.shape)
        draw = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 1:
            is_norm = "norm" in key or key.endswith(".scale")
            flat[key] = 1 + 0.1 * draw if is_norm and not key.endswith(".bias") else 0.05 * draw
        else:
            flat[key] = draw / np.sqrt(np.prod(shape[1:]))
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _port_denoiser(kind, flat, **overrides):
    with torch.device("meta"):
        model = Denoiser(PORT_VARIANTS[kind](**dict(TINY, **overrides)))
    return tnn.load_flat_params(model, flat).eval()


@pytest.fixture(scope="module")
def dev_init():
    """Seeded weights of the tiny flux1-dev denoiser (flex1-alpha's keys too;
    flux1-schnell's lack ``guidance_in``)."""
    return _seeded(JaxDenoiser(jax_config.Flux1DevDenoiserConfig(**TINY)), 0)


@pytest.fixture(scope="module")
def denoisers(dev_init):
    """Per variant: the JAX denoiser, its params, its jitted forward
    (guidance an argument) and the port's denoiser on the same weights."""
    out = {}
    for kind, cfg in VARIANTS.items():
        flat = dev_init if kind != "flux1-schnell" else {
            k: v for k, v in dev_init.items() if not k.startswith("guidance_in.")}
        jax_model = JaxDenoiser(cfg(**TINY))
        forward = jax.jit(lambda p, x, c, t, v, g, _m=jax_model: _m(p, x, c, t, v, guidance=g))
        out[kind] = (jax_model, _jax_params(flat), forward, _port_denoiser(kind, flat), flat)
    return out


def _inputs(seed, shape=(2, 8, 12, 4), txt_len=6):
    rng = np.random.default_rng(seed)
    b = shape[0]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((b, txt_len, 32)).astype(np.float32),
            rng.uniform(0.1, 0.9, b).astype(np.float32),
            rng.standard_normal((b, 24)).astype(np.float32))


# -- configs, keys, schedules -------------------------------------------------------


def test_configs_match_jax():
    for kind in VARIANTS:
        assert PORT_VARIANTS[kind]().model_dump() == VARIANTS[kind]().model_dump()
    assert (flux_config.FluxConfig(checkpoint_path="x").model_dump()
            == jax_config.FluxConfig(checkpoint_path="x").model_dump())
    assert flux_config.FluxConfig(checkpoint_path="x").denoiser.type == "flex1-alpha"
    parsed = flux_config.FluxConfig.model_validate(
        {"checkpoint_path": "x", "denoiser": {"type": "flux1-schnell"}})
    assert isinstance(parsed.denoiser, flux_config.Flux1SchnellDenoiserConfig)
    with pytest.raises(ValueError):
        flux_config.Flux1SchnellDenoiserConfig(guidance_embed=True)
    with pytest.raises(ValueError):
        flux_config.Flex1AlphaDenoiserConfig(do_timestep_shift=True)
    assert vars(text_encoder.FLUX_T5_CONFIG) == vars(jax_text_encoder.FLUX_T5_CONFIG)
    assert vars(text_encoder.FLUX_CLIP_CONFIG) == vars(jax_text_encoder.FLUX_CLIP_CONFIG)
    assert flux_vae.DEFAULT_VAE_CONFIG is FLUX_VAE_CONFIG
    assert (flux_vae.VAE.scaling_factor, flux_vae.VAE.shift_factor) == (0.3611, 0.1159)


@pytest.mark.parametrize("kind", list(VARIANTS))
def test_denoiser_keys_and_shapes_match_jax(kind):
    shapes = jax.eval_shape(JaxDenoiser(VARIANTS[kind](**TINY)).init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    with torch.device("meta"):
        model = Denoiser(PORT_VARIANTS[kind](**TINY))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert ("guidance_in.in_layer.weight" in want) == (kind != "flux1-schnell")


def test_schedules_and_unpatchify_match_jax():
    for steps, seq in ((4, 256), (20, 4096), (28, 1024)):
        for shift in (True, False):
            assert (scheduler.get_flux_schedule(steps, seq, shift=shift)
                    == jax_scheduler.get_flux_schedule(steps, seq, shift=shift))
        np.testing.assert_array_equal(scheduler.get_linear_schedule(steps),
                                      jax_scheduler.get_linear_schedule(steps))
    x = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    got = patch.unpatchify_cmajor(torch.from_numpy(x), 3, 4, 2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_patch.unpatchify_cmajor(
        jnp.asarray(x), 3, 4, 2, 4)))
    # patchify's (c, ph, pw) order read back
    latent = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 6, 8, 4))
                              .astype(np.float32))
    torch.testing.assert_close(patch.unpatchify_cmajor(patch.patchify(latent, 2), 3, 4, 2, 4),
                               latent, rtol=0, atol=0)


def test_key_converters_match_jax():
    for key in ("model.diffusion_model.double_blocks.0.img_attn.qkv.weight",
                "diffusion_model.final_layer.linear.bias", "vae.decoder.conv_in.weight",
                "text_encoders.clip_l.transformer.text_model.final_layer_norm.weight",
                "text_encoders.t5xxl.transformer.encoder.block.0.layer.0.SelfAttention.q.weight"):
        internal = util.convert_from_original_key(key)
        assert internal == jax_util.convert_from_original_key(key)
        assert util.convert_to_original_key(internal) == jax_util.convert_to_original_key(internal)
        assert util.convert_to_comfy_key(internal) == jax_util.convert_to_comfy_key(internal)


# -- the denoiser -----------------------------------------------------------------


@pytest.mark.parametrize(
    "kind,guidance",
    [("flux1-dev", None), ("flux1-dev", 0.0), ("flux1-dev", 3.5), ("flux1-schnell", None),
     ("flux1-schnell", 3.5), ("flex1-alpha", 3.5)],
)
def test_denoiser_forward_matches_jax(denoisers, kind, guidance):
    """A non-square latent (8 x 12: 24 patches), batch 2; the CPU path
    launches no kernel."""
    jax_model, params, forward, model, _ = denoisers[kind]
    latent, t5, t, clip = _inputs(0)
    g = None if guidance is None else np.full((2,), guidance, np.float32)
    want = forward(params, *(jnp.asarray(a) for a in (latent, t5, t, clip)),
                   None if g is None else jnp.asarray(g))
    before = flash_attention_bshd.launches, layer_norm.launches
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (latent, t5, t, clip)),
                    guidance=None if g is None else torch.from_numpy(g))
    assert (flash_attention_bshd.launches, layer_norm.launches) == before
    assert got.shape == latent.shape
    _close(got, want, msg=f"{kind} guidance {guidance}")


def test_remat_path_matches_jax(denoisers):
    """Gradient checkpointing: the forward with gradients is the JAX
    forward, and its gradients are the plain path's."""
    _, params, forward, model, _ = denoisers["flux1-dev"]
    latent, t5, t, clip = _inputs(1)
    g = np.full((2,), 3.5, np.float32)
    want = forward(params, *(jnp.asarray(a) for a in (latent, t5, t, clip, g)))
    grads = []
    for remat in (False, True):
        model.set_gradient_checkpointing(remat)
        x = torch.from_numpy(latent).requires_grad_(True)
        try:
            out = model(x, *(torch.from_numpy(a) for a in (t5, t, clip)),
                        guidance=torch.from_numpy(g))
        finally:
            model.set_gradient_checkpointing(False)
        _close(out, want, msg=f"remat {remat}")
        out.square().sum().backward()
        grads.append(x.grad)
    model.zero_grad(set_to_none=True)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="set_pipeline"):
        model.set_pipeline(object(), 2)
    model.set_pipeline(None, 1)


@pytest.mark.parametrize("cache_depth", [None, 2])
def test_deepcache_forward_matches_jax(dev_init, cache_depth):
    """Three single blocks, the cache split at the default (1) and at 2: a
    refresh step equals the plain forward and records the delta; a cached
    step at the next timestep reuses it, in both packages alike; the cached
    step really skips the deep blocks."""
    config = dict(TINY, depth_single_blocks=3)
    jax_model = JaxDenoiser(jax_config.Flux1DevDenoiserConfig(**config))
    flat = {k: dev_init.get(k, v) for k, v in _seeded(jax_model, 3).items()}
    model = _port_denoiser("flux1-dev", flat, depth_single_blocks=3)
    params = _jax_params(flat)
    latent, t5, t, clip = _inputs(4, shape=(2, 8, 8, 4))
    g = np.full((2,), 3.5, np.float32)
    jargs = [jnp.asarray(a) for a in (latent, t5, t, clip)]
    targs = [torch.from_numpy(a) for a in (latent, t5, t, clip)]
    refresh = jax.jit(lambda p, *a: jax_model.deepcache_forward(
        p, *a[:4], guidance=a[4], refresh=True, cache_depth=cache_depth))
    cached = jax.jit(lambda p, *a: jax_model.deepcache_forward(
        p, *a[:4], guidance=a[4], cached_delta=a[5], refresh=False, cache_depth=cache_depth))
    want, want_delta = refresh(params, *jargs, jnp.asarray(g))
    with torch.no_grad():
        plain = model(*targs, guidance=torch.from_numpy(g))
        full, delta = model.deepcache_forward(*targs, guidance=torch.from_numpy(g),
                                              cache_depth=cache_depth)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)
    _close(full, want, msg="refresh")
    _close(delta, want_delta, msg="delta")

    jargs[2], targs[2] = jargs[2] + 0.05, targs[2] + 0.05  # the next step's time
    want_next, _ = cached(params, *jargs, jnp.asarray(g), want_delta)
    with torch.no_grad():
        reused, delta_out = model.deepcache_forward(
            *targs, guidance=torch.from_numpy(g), cached_delta=delta, refresh=False,
            cache_depth=cache_depth)
    assert delta_out is delta
    _close(reused, want_next, msg="cached")

    poisoned = _port_denoiser("flux1-dev", {
        k: np.full_like(v, np.nan) if k.startswith("single_blocks.2.") else v
        for k, v in flat.items()}, depth_single_blocks=3)
    with torch.no_grad():
        bad, _ = poisoned.deepcache_forward(*targs, refresh=True, cache_depth=cache_depth)
        clean, _ = poisoned.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                              cache_depth=cache_depth)
        with pytest.raises(ValueError):
            model.deepcache_forward(*targs, cache_depth=3)
        with pytest.raises(ValueError):
            model.deepcache_forward(*targs, refresh=False)
    assert not torch.isfinite(bad).all() and torch.isfinite(clean).all()


# -- tokenizers, the pipeline ---------------------------------------------------------


class ClipTok:
    """Stub CLIP tokenizer: bos 0, words to ids 3..902, eos and pad 999."""

    def __call__(self, prompts, max_length=None, **kw):
        rows = []
        for p in prompts:
            ids = [3 + sum(map(ord, w)) % 900 for w in p.split()][: max_length - 2]
            row = [0, *ids, 999]
            rows.append(row + [999] * (max_length - len(row)))
        return np.asarray(rows, np.int32)


class T5Tok:
    """Stub T5 tokenizer: words to ids 3..122, padded with 0 and masked."""

    def __call__(self, prompts, max_length=None, **kw):
        ids, mask = [], []
        for p in prompts:
            t = [3 + sum(map(ord, w)) % 120 for w in p.split()][:max_length]
            pad = max_length - len(t)
            ids.append(t + [0] * pad)
            mask.append([1] * len(t) + [0] * pad)
        return {"input_ids": ids, "attention_mask": mask}


def _port_pipeline(flat=None, device="cpu", **tokenizers):
    tokenizers = tokenizers or dict(clip_tokenizer=ClipTok(), t5_tokenizer=T5Tok())
    model = FluxModel(
        flux_config.FluxConfig(checkpoint_path="", dtype="float32",
                               denoiser=flux_config.Flux1DevDenoiserConfig(**PIPE_DENOISER)),
        vae_config=AutoencoderKLConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
        t5_config=UMT5Config(**T5), **tokenizers,
    )
    if flat is not None:
        model.load_state_dict(flat, device=device)
    return model


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' FluxModel at the tiny config with the same seeded
    weights and the same stub tokenizers."""
    jax_model = JaxFluxModel(
        jax_config.FluxConfig(checkpoint_path="unused", dtype="float32",
                              denoiser=jax_config.Flux1DevDenoiserConfig(**PIPE_DENOISER)),
        clip_tokenizer=ClipTok(), t5_tokenizer=T5Tok(), vae_config=JaxVAEConfig(**VAE),
        clip_config=JaxCLIPConfig(**CLIP), t5_config=JaxT5Config(**T5),
    )
    flat = {f"{root}.{k}": v for i, root in enumerate(("denoiser", "vae", "text_encoder"))
            for k, v in _seeded(getattr(jax_model, root), 10 + i).items()}
    flat["text_encoder.t5.encoder.embed_tokens.weight"] = flat["text_encoder.t5.shared.weight"]
    jax_model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    return jax_model, _port_pipeline(flat), flat


@pytest.mark.parametrize("negative", [None, "blurry photo"])
def test_encode_prompts_matches_jax(pipelines, negative):
    jax_model, model, _ = pipelines
    want = jax_model.text_encoder.encode_prompts(
        jax_model.params["text_encoder"], PROMPTS, negative, use_negative_prompts=True,
        t5_max_token_length=8,
    )
    before = layer_norm.launches
    with torch.no_grad():
        got = model.text_encoder.encode_prompts(PROMPTS, negative, use_negative_prompts=True,
                                                t5_max_token_length=8)
    assert layer_norm.launches == before
    for part in ("clip", "t5"):
        for ours, theirs in zip(getattr(got, part), getattr(want, part)):
            _close(ours, theirs, msg=part)
    t5 = got.t5
    assert t5.positive_embeddings.shape == (2, 8, 32) and t5.negative_embeddings.shape == (2, 8, 32)
    for hidden, mask in ((t5.positive_embeddings, t5.positive_attention_mask),
                         (t5.negative_embeddings, t5.negative_attention_mask)):
        assert not (hidden * (mask == 0)).any()  # padding zeroed
    assert t5.positive_attention_mask.any()
    single = model.text_encoder.encode_prompts("a cat", t5_max_token_length=8)
    assert single.clip.positive_embeddings.shape == (1, 48)
    assert single.t5.negative_embeddings.shape[0] == 0
    with pytest.raises(RuntimeError, match="tokenizers"):
        _port_pipeline(clip_tokenizer=None, t5_tokenizer=None).text_encoder.encode_prompts("a")


def _generate_both(pipelines, monkeypatch, **kwargs):
    """generate() of both packages on the same injected noise; each one's
    final latents and images."""
    jax_model, model, _ = pipelines
    noise = np.random.default_rng(7).standard_normal((2, 4, 6, 4)).astype(np.float32)
    latents = {}
    monkeypatch.setattr(jax_model, "prepare_latents", lambda *a, **kw: jnp.asarray(noise))
    monkeypatch.setattr(model, "prepare_latents", lambda *a, **kw: torch.from_numpy(noise))
    jax_decode, decode = jax_model.decode_image, model.decode_image
    monkeypatch.setattr(jax_model, "decode_image",
                        lambda z: latents.setdefault("jax", np.asarray(z)) is None or jax_decode(z))
    monkeypatch.setattr(model, "decode_image",
                        lambda z: latents.setdefault("port", z.numpy().copy()) is None or decode(z))
    common = dict(width=48, height=32, max_token_length=8, seed=1, **kwargs)
    want = jax_model.generate(PROMPTS, **common)
    got = model.generate(PROMPTS, **common)
    return latents["jax"], want, latents["port"], got


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("cfg1", dict(num_inference_steps=3, distilled_guidance_scale=3.5)),
        ("cfg2", dict(num_inference_steps=3, cfg_scale=2.0, distilled_guidance_scale=3.5,
                      negative_prompt="blurry photo")),
        ("deepcache1", dict(num_inference_steps=3, cfg_scale=2.0, deep_cache_interval=1)),
        ("deepcache2", dict(num_inference_steps=4, cfg_scale=2.0, deep_cache_interval=2)),
    ],
)
def test_generate_matches_jax(pipelines, monkeypatch, name, kwargs):
    want_latents, want, got_latents, got = _generate_both(pipelines, monkeypatch, **kwargs)
    assert got_latents.shape == (2, 4, 6, 4) and np.isfinite(got_latents).all()
    _close(got_latents, want_latents, msg=name)
    for ours, theirs in zip(got, want):
        assert ours.size == theirs.size == (48, 32)
        diff = np.abs(np.asarray(ours, np.int32) - np.asarray(theirs, np.int32))
        assert diff.max() <= 1  # 8-bit rounding of nearly equal floats


def test_generate_options_and_images(pipelines, monkeypatch):
    """A request repeats bit for bit; DeepCache refreshing every step is the
    plain loop; an offloaded request (the first, then one from the host) is
    the plain one bit for bit; encode_image is the JAX one (the
    VAE's mode times the scaling factor, no shift)."""
    jax_model, model, _ = pipelines
    common = dict(width=32, height=32, num_inference_steps=2, cfg_scale=2.0, seed=3,
                  max_token_length=8)
    base = np.asarray(model.generate("a cat", **common)[0])
    np.testing.assert_array_equal(base, np.asarray(model.generate("a cat", **common)[0]))
    np.testing.assert_array_equal(
        base, np.asarray(model.generate("a cat", deep_cache_interval=1, **common)[0]))
    assert_offloaded_generate_is_plain(
        monkeypatch, model, lambda **kw: model.generate("a cat", **common, **kw), ("text_encoder", "denoiser", "vae"))
    image = np.random.default_rng(9).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(image))
    _close(got, jax_model.encode_image(jnp.asarray(image)), msg="encode_image")
    latents = model.prepare_latents(2, 32, 48, seed=5)
    assert latents.shape == (2, 4, 6, 4)
    torch.testing.assert_close(latents[1:], model.prepare_latents(1, 32, 48, seed=6),
                               rtol=0, atol=0)


# -- the single-file checkpoint -----------------------------------------------------


@pytest.mark.parametrize("layout", ["original", "comfy"])
@pytest.mark.parametrize("dropped", ["shared", "encoder.embed_tokens"])
def test_single_file_checkpoint_loads_as_in_jax(pipelines, tmp_path, layout, dropped):
    """The JAX model's state_dict() written with one of T5's tied embeddings
    left out and a CLIP text_projection added: both packages load it to the
    same parameters, and the port's state_dict() writes the JAX layout back."""
    jax_model, _, flat = pipelines
    written = {}
    for key, value in jax_model.state_dict().items():
        if key == f"text_encoders.t5xxl.transformer.{dropped}.weight":
            continue
        if layout == "comfy":
            key = key.replace("model.diffusion_model.", "diffusion_model.", 1)
        written[key] = np.asarray(value)
    written["text_encoders.clip_l.transformer.text_projection.weight"] = np.ones((48, 48),
                                                                                 np.float32)
    path = tmp_path / "flux.safetensors"
    save_file(written, str(path))

    denoiser = flux_config.Flux1DevDenoiserConfig(**PIPE_DENOISER)
    ours = FluxModel.from_checkpoint(
        flux_config.FluxConfig(checkpoint_path=str(path), dtype="float32", denoiser=denoiser),
        device="cpu", vae_config=AutoencoderKLConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
        t5_config=UMT5Config(**T5),
    )
    jax_model.config = jax_config.FluxConfig(
        checkpoint_path=str(path), dtype="float32",
        denoiser=jax_config.Flux1DevDenoiserConfig(**PIPE_DENOISER))
    jax_model.load_checkpoint_weights()
    want = {f"{root}.{k}": v for root in ("denoiser", "vae", "text_encoder")
            for k, v in _numpy(jax_model.params[root]).items()}
    got = {f"{name}.{k}": v.numpy() for name, part in ours._parts().items()
           for k, v in part.state_dict().items()}
    assert set(got) == set(want) == set(flat)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
        np.testing.assert_array_equal(value, flat[key], err_msg=key)
    theirs = jax_model.state_dict()
    assert {k: v.numpy().tobytes() for k, v in ours.state_dict().items()} == {
        k: np.asarray(v).tobytes() for k, v in theirs.items()}
    assert ours.device.type == "cpu" and ours.text_encoder.clip_tokenizer is None


def test_init_params_on_a_generator():
    model = _port_pipeline()
    assert model.device.type == "meta"
    model.init_params(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert model.device.type == "cpu" and model.denoiser.img_in.weight.dtype == torch.bfloat16
    t5 = model.text_encoder.t5
    torch.testing.assert_close(t5.encoder["embed_tokens"].weight, t5.shared.weight, rtol=0, atol=0)
    scale = model.denoiser.double_blocks["0"]["img_attn"]["norm"]["query_norm"].scale
    assert bool((scale == 1).all())
    first = {k: v.clone() for k, v in model.state_dict().items()}
    model.init_params(torch.Generator().manual_seed(0))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, first[key], rtol=0, atol=0, msg=key)


# -- serving: the slot step, the pool, the server, the CLI ------------------------------


def _slot_inputs(pipelines, guidance):
    """A 3-slot pool: totals 4 / 8 / 4, CFG 1 / 2 / 1, the last slot
    inactive (blank: the engine's default guidance 1.0)."""
    jax_model, _, _ = pipelines
    rng = np.random.default_rng(11)
    enc = jax_model.text_encoder.encode_prompts(
        jax_model.params["text_encoder"], ["a cat", "a red car", "x"], ["", "blurry", ""],
        use_negative_prompts=True, t5_max_token_length=8)
    return dict(
        latents=rng.standard_normal((3, 4, 4, 4)).astype(np.float32),
        timestep=np.array([1.0, 0.875, 0.5], np.float32),
        total_steps=np.array([4, 8, 4], np.int32),
        t5_emb=np.concatenate([np.asarray(enc.t5.positive_embeddings),
                               np.asarray(enc.t5.negative_embeddings)]),
        clip_emb=np.concatenate([np.asarray(enc.clip.positive_embeddings),
                                 np.asarray(enc.clip.negative_embeddings)]),
        guidance=np.asarray(guidance, np.float32),
        cfg_scale=np.array([1.0, 2.0, 1.0], np.float32),
        active=np.array([True, True, False]),
    )


@pytest.fixture(scope="module")
def jax_slot_step(pipelines):
    jax_model = pipelines[0]
    step = jax.jit(jax_model._slot_step)
    return lambda a: np.asarray(step(jax_model.params["denoiser"],
                                     *(jnp.asarray(v) for v in a.values())))


def _port_slot_step(model, a):
    with torch.no_grad():
        return model._slot_step(*(torch.from_numpy(np.asarray(v)) for v in a.values())).numpy()


def test_slot_step_matches_jax(pipelines, jax_slot_step):
    """Mixed totals, guidance and CFG; the inactive row keeps its latents."""
    a = _slot_inputs(pipelines, [2.5, 3.5, 1.0])
    got = _port_slot_step(pipelines[1], a)
    _close(got, jax_slot_step(a))
    np.testing.assert_array_equal(got[2], a["latents"][2])


def test_jax_slot_step_depends_on_its_neighbours(pipelines, jax_slot_step):
    """The JAX guidance gate is the pool's maximum: a row of guidance 0 takes
    the guidance embedding when a neighbour (here a blank slot, guidance
    1.0) has guidance > 0, and its result changes with its neighbours. The
    port's per-row gate leaves it as it is alone."""
    beside = _slot_inputs(pipelines, [0.0, 3.5, 1.0])
    alone = _slot_inputs(pipelines, [0.0, 0.0, 0.0])
    jax_beside, jax_alone = jax_slot_step(beside), jax_slot_step(alone)
    assert np.abs(jax_beside[0] - jax_alone[0]).max() > 1e-3
    port_beside = _port_slot_step(pipelines[1], beside)
    port_alone = _port_slot_step(pipelines[1], alone)
    _close(port_beside[0], port_alone[0], tol=1e-6)
    _close(port_alone[0], jax_alone[0], msg="guidance 0 alone")
    _close(port_beside[1], jax_beside[1], msg="guidance 3.5")


def test_pool_matches_batch1_generate(pipelines, monkeypatch):
    """A pool of 3 slots over 4 staggered requests (steps 2 and 3, guidance
    0 beside 3.5 and 2.5, one with CFG 2 and a negative prompt): each
    result is its own batch-1 generate()'s."""
    model = pipelines[1]
    seen = []
    decode = model.decode_image
    monkeypatch.setattr(model, "decode_image", lambda z: seen.append(z.clone()) or decode(z))
    requests = [
        SlotRequest(prompt="a cat", num_inference_steps=3, cfg_scale=1.0, distilled_guidance=0.0,
                    seed=1),
        SlotRequest(prompt="a red car", num_inference_steps=2, cfg_scale=1.0,
                    distilled_guidance=3.5, seed=2),
        SlotRequest(prompt="the sofa", negative_prompt="blurry", num_inference_steps=3,
                    cfg_scale=2.0, distilled_guidance=2.5, seed=3),
        SlotRequest(prompt="a cat on the sofa", num_inference_steps=2, cfg_scale=1.0,
                    distilled_guidance=3.5, seed=4),
    ]
    want = []
    for r in requests:
        model.generate(r.prompt, negative_prompt=r.negative_prompt or None, width=32, height=32,
                       num_inference_steps=r.num_inference_steps, cfg_scale=r.cfg_scale,
                       distilled_guidance_scale=r.distilled_guidance, seed=r.seed,
                       max_token_length=8)
        want.append(seen.pop())
    engine = ContinuousBatcher(FluxSlotAdapter(model, 32, 32, max_token_length=8), num_slots=3,
                               max_steps=4)
    images = [None] * len(requests)
    try:
        def run(i):
            images[i] = engine.submit(requests[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        engine.close()
    assert all(isinstance(im, Image.Image) and im.size == (32, 32) for im in images)
    assert len(seen) == len(requests)
    for i, r in enumerate(requests):
        row = [z for z in seen if z.shape == want[i].shape]
        assert any(float((z - want[i]).abs().max()) <= TOL * float(want[i].abs().max())
                   for z in row), f"request {i} has no pool result equal to its generate()"
    assert engine.ticks >= 3


def _vocab_dir(path):
    """A T5 SentencePiece vocab (pad 0, eos 1, unk 2) inside the tiny T5's
    300 ids and a CLIP BPE vocab in clip/ inside the tiny CLIP's 1000."""
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces += [("▁" + w, -1.0 - 0.1 * i, 1) for i, w in enumerate(["a", "cat", "photo", "of"])]
    pieces += [(ch, -5.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz▁"]
    (path / "tokenizer.model").write_bytes(
        sentencepiece.serialize_model(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0))
    clip = path / "clip"
    clip.mkdir()
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789,":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 998, 999
    (clip / "vocab.json").write_text(json.dumps(vocab))
    (clip / "merges.txt").write_text("#version: 0.2\n")


@pytest.fixture
def tiny_flux(pipelines, tmp_path, monkeypatch):
    """A tiny seeded Flux checkpoint, a YAML naming it, a tokenizer dir, and
    FluxModel built at the checkpoint's widths in fp32 whatever config it is
    given (the CLI names only the checkpoint)."""
    model = pipelines[1]
    st = {k: v.contiguous().numpy() for k, v in model.state_dict().items()}
    save_file(st, str(tmp_path / "flux.safetensors"))
    _vocab_dir(tmp_path)
    (tmp_path / "serve.yml").write_text(yaml.safe_dump({
        "model": {"checkpoint_path": str(tmp_path / "flux.safetensors"),
                  "denoiser": {"type": "flux1-dev"}},
        "dataset": {}, "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1.0e-4}},
        "seed": 0, "num_train_epochs": 1,
    }))
    build = FluxModel.__init__

    def tiny_init(self, config, clip_tokenizer=None, t5_tokenizer=None):
        config = config.model_copy(update={
            "dtype": "float32", "denoiser": flux_config.Flux1DevDenoiserConfig(**PIPE_DENOISER)})
        build(self, config, clip_tokenizer=clip_tokenizer, t5_tokenizer=t5_tokenizer,
              vae_config=AutoencoderKLConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
              t5_config=UMT5Config(**T5))

    monkeypatch.setattr(FluxModel, "__init__", tiny_init)
    return tmp_path


def test_server_serves_flux(tiny_flux):
    """The server takes flux and its distilled guidance: T2IModel loads the
    checkpoint with both tokenizers; a window batch reaches generate() with
    the guidance; the continuous scheduler takes a Flux pool."""
    assert "flux" in srv.SERVED_FAMILIES
    assert srv.FAMILY_KERNELS["flux"] == ("flash_attention_bshd", "layer_norm")
    served = srv.T2IModel(str(tiny_flux / "serve.yml"), None, str(tiny_flux), family="flux",
                          device="cpu")
    model = served.model
    assert model.device.type == "cpu" and model.text_encoder.clip_tokenizer is not None
    params = srv.GenerationParams(prompt="a cat", negative_prompt="", width=64, height=64,
                                  inference_steps=2, cfg_scale=1.0, distilled_guidance=3.5,
                                  seed=5)
    got = served.generate_batch([params])
    want = model.generate(["a cat"], negative_prompt=[""], width=64, height=64,
                          num_inference_steps=2, cfg_scale=1.0, distilled_guidance_scale=3.5,
                          seed=5)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    other = served.generate_batch([params.model_copy(update={"distilled_guidance": 0.0})])
    assert (np.asarray(other[0]) != np.asarray(got[0])).any()
    sched = srv.ContinuousScheduler(served, height=64, width=64, num_slots=2, max_steps=4)
    try:
        image = sched.submit(params.model_copy(update={"distilled_guidance": 2.5}))
    finally:
        sched.close()
    assert image.size == (64, 64)


def test_cli_on_flux(tiny_flux, tmp_path, capsys):
    out = tmp_path / "out.webp"
    saved = inference_cli.main([
        "--family", "flux", "--checkpoint-path", str(tiny_flux / "flux.safetensors"),
        "--tokenizer-path", str(tiny_flux), "--width", "32", "--height", "32",
        "--num-inference-steps", "2", "--cfg-scale", "2.0", "--save-path", str(out),
        "--device", "cpu",
    ])
    assert saved == [str(out)] and Image.open(out).format == "WEBP"
    assert Image.open(out).size == (32, 32)
