"""The port's AuraFlow slice against the JAX package's, on the CPU in fp32
at the tiny config tests/models/test_auraflow.py uses: UMT5 with a padded
mask, the MMDiT forward (learned PE; RoPE + shortcut + guidance), its
DeepCache path, the scheduler, the prompt API, the single-file checkpoint
read by both packages, and the whole slice: ``generate()``'s denoise loop
step by step and end to end from the same weights and the same noise.

The weights are the JAX modules' own init, carried over by
``nn.load_flat_params``; the leaves the JAX init sets to zero (the adaLN
projections, ``final_linear``, ``cond_seq_linear``) are drawn anew here so
that they matter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from vision_ft_tpu.models.auraflow import config as jax_config
from vision_ft_tpu.models.auraflow import util as jax_util
from vision_ft_tpu.models.auraflow.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.models.auraflow.pipeline import AuraFlowModel as JaxAuraFlowModel
from vision_ft_tpu.models.auraflow.scheduler import Scheduler as JaxScheduler
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.sdxl.util import vae_convert_to_original_key
from vision_ft_tpu.models.text_encoders import auto_tokenizer as jax_auto_tokenizer
from vision_ft_tpu.models.text_encoders import umt5 as jax_umt5
from vision_ft_tpu.modules.positional_encoding import rope as jax_rope
from vision_ft_tpu.nn import flatten_params, unflatten_params

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.auraflow import util
from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig, DenoiserConfig
from vision_ft_tpu_torch.models.auraflow.denoiser import Denoiser
from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel
from vision_ft_tpu_torch.models.auraflow.scheduler import Scheduler
from vision_ft_tpu_torch.models.auraflow.vae import DEFAULT_VAE_CONFIG, detect_vae_type
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.autoencoder.kl import SDXL_VAE_CONFIG
from vision_ft_tpu_torch.models.text_encoders import auto_tokenizer, sentencepiece, umt5
from vision_ft_tpu_torch.modules.positional_encoding import rope
from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd
from vision_ft_tpu_torch.ops.fused_mlp import gated_mlp
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import assert_offloaded_generate_is_plain

# fp32 on the CPU: a few transformer blocks of O(1) activations, summed in
# other orders by the two packages
TOL = 5e-5
# a whole request: 4 Euler steps, each with CFG (a difference of two
# forwards times the guidance scale), then the VAE
LATENT_TOL = 5e-4

TINY = dict(
    in_channels=4, out_channels=4, patch_size=2, caption_projection_dim=64,
    num_double_layers=1, num_single_layers=2, num_attention_heads=2, attention_head_dim=32,
    joint_attention_dim=48, pos_embed_max_size=16 * 16, num_register_tokens=2,
    use_flash_attn=False,
)
ROPE = dict(TINY, use_rope=True, rope_dim_sizes=[8, 12, 12], use_shortcut=True, use_guidance=True)
TEXT = dict(
    vocab_size=300, d_model=48, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
    relative_attention_num_buckets=8, relative_attention_max_distance=16,
)
VAE = dict(block_out_channels=(8, 8, 16, 16), latent_channels=4, norm_num_groups=4)


def _numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _jax_params(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _draw_zero_leaves(flat, seed):
    rng = np.random.default_rng(seed)
    return {
        k: (0.05 * rng.standard_normal(v.shape)).astype(v.dtype) if not v.any() else v
        for k, v in flat.items()
    }


def _denoisers(kwargs, seed, init=None):
    """The JAX denoiser, its parameters (``init``, or its own init of
    ``seed``, with the zero leaves drawn anew) and the port's loaded from
    them."""
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**kwargs))
    init = _numpy(jax.jit(jax_model.init)(jax.random.PRNGKey(seed))) if init is None else init
    flat = _draw_zero_leaves(init, seed)
    with torch.device("meta"):
        model = Denoiser(DenoiserConfig(**kwargs))
    tnn.load_flat_params(model, flat).eval()
    return jax_model, _jax_params(flat), model, flat


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init of the tiny denoiser, as it draws it (zeros included)."""
    return _numpy(jax.jit(JaxDenoiser(jax_config.DenoiserConfig(**TINY)).init)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def denoisers(jax_init):
    return _denoisers(TINY, 0, jax_init)


def test_configs_match_jax():
    assert DenoiserConfig().model_dump() == jax_config.DenoiserConfig().model_dump()
    assert (AuraFlowConig(checkpoint_path="x").model_dump()
            == jax_config.AuraFlowConig(checkpoint_path="x").model_dump())
    assert vars(umt5.UMT5Config()) == vars(jax_umt5.UMT5Config())
    assert DEFAULT_VAE_CONFIG is SDXL_VAE_CONFIG and DEFAULT_VAE_CONFIG.scaling_factor == 0.13025
    with pytest.raises(ValueError, match="rope_dim_sizes"):
        DenoiserConfig(use_rope=True, rope_dim_sizes=[32, 32, 32])


@pytest.mark.parametrize("kwargs", [TINY, ROPE], ids=["learned_pe", "rope_shortcut_guidance"])
def test_denoiser_keys_and_shapes_match_jax(kwargs):
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**kwargs))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    with torch.device("meta"):
        model = Denoiser(DenoiserConfig(**kwargs))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_denoiser_forward_learned_pe_matches_jax(denoisers):
    """A non-square latent (a centre crop of the PE grid), batch 2; the CPU
    path launches no kernel."""
    jax_model, params, model, _ = denoisers
    rng = np.random.default_rng(0)
    shape = (2, 8, 12, 4)
    latent = rng.standard_normal(shape).astype(np.float32)
    text = rng.standard_normal((2, 10, 48)).astype(np.float32)
    t = rng.uniform(0.1, 0.9, 2).astype(np.float32)
    want = jax.jit(jax_model.__call__)(params, *(jnp.asarray(a) for a in (latent, text, t)))
    before = flash_attention_bshd.launches, gated_mlp.launches
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (latent, text, t)))
    assert (flash_attention_bshd.launches, gated_mlp.launches) == before
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_denoiser_forward_rope_shortcut_guidance_matches_jax():
    jax_model, params, model, _ = _denoisers(ROPE, 1)
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    text = rng.standard_normal((1, 6, 48)).astype(np.float32)
    t, duration = np.array([0.7], np.float32), np.array([0.125], np.float32)
    forward = jax.jit(lambda p, x, c, s, d: jax_model(p, x, c, s, shortcut_duration=d,
                                                      guidance_scale=3.5))
    want = forward(params, *(jnp.asarray(a) for a in (latent, text, t, duration)))
    with torch.no_grad():
        got = model(torch.from_numpy(latent), torch.from_numpy(text), torch.from_numpy(t),
                    shortcut_duration=torch.from_numpy(duration), guidance_scale=3.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cache_depth", [None, 1])
def test_deepcache_forward_matches_jax(denoisers, cache_depth):
    """A refresh step equals the plain forward and records the delta; a
    cached step at the next timestep reuses it, in both packages alike; the
    cached step really skips the deep layers."""
    jax_model, params, model, flat = denoisers
    rng = np.random.default_rng(2)
    latent = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    text = rng.standard_normal((2, 6, 48)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    jargs = [jnp.asarray(a) for a in (latent, text, t)]
    targs = [torch.from_numpy(a) for a in (latent, text, t)]
    want, want_delta = jax.jit(functools.partial(
        jax_model.deepcache_forward, refresh=True, cache_depth=cache_depth))(params, *jargs)
    with torch.no_grad():
        plain = model(*targs)
        full, delta = model.deepcache_forward(*targs, refresh=True, cache_depth=cache_depth)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=TOL, rtol=TOL)

    jargs[2], targs[2] = jargs[2] + 0.05, targs[2] + 0.05  # the next step's time
    want_next, _ = jax.jit(functools.partial(
        jax_model.deepcache_forward, refresh=False, cache_depth=cache_depth))(
        params, *jargs, cached_delta=want_delta)
    with torch.no_grad():
        reused, delta_out = model.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                                    cache_depth=cache_depth)
    assert delta_out is delta
    np.testing.assert_allclose(reused.numpy(), np.asarray(want_next), atol=TOL, rtol=TOL)

    with torch.device("meta"):
        poisoned = Denoiser(DenoiserConfig(**TINY))
    bad = {k: np.full_like(v, np.nan) if k.startswith("single_layers.1.") else v
           for k, v in flat.items()}
    tnn.load_flat_params(poisoned, bad).eval()
    with torch.no_grad():
        refreshed, _ = poisoned.deepcache_forward(*targs, refresh=True, cache_depth=1)
        clean, _ = poisoned.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                              cache_depth=1)
    assert not torch.isfinite(refreshed).all() and torch.isfinite(clean).all()


def test_denoiser_options_and_bad_arguments(denoisers):
    """set_pipeline raises by name; gradient checkpointing leaves a forward
    without gradients as it was; bad DeepCache arguments raise."""
    model = denoisers[2]
    with pytest.raises(NotImplementedError, match="set_pipeline"):
        model.set_pipeline(object(), 2)
    model.set_pipeline(None, 1)
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in (rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
                                           rng.standard_normal((1, 5, 48)).astype(np.float32),
                                           np.array([0.4], np.float32))]
    with torch.no_grad():
        want = model(*args)
        model.set_gradient_checkpointing(True)
        try:
            got = model(*args)
        finally:
            model.set_gradient_checkpointing(False)
        with pytest.raises(ValueError):
            model.deepcache_forward(*args, cache_depth=2)  # two single layers: k must be 1
        with pytest.raises(ValueError):
            model.deepcache_forward(*args, refresh=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_init_draws_the_jax_distributions(jax_init):
    """Zeros where the JAX init puts zeros, the positional table N(0, 0.1)
    and the register tokens N(0, 0.02); one seed gives one set of weights."""
    with torch.device("meta"):
        model = Denoiser(DenoiserConfig(**dict(TINY, pos_embed_max_size=64 * 64)))
    model.to_empty(device="cpu")
    tnn.init_parameters_(model, torch.Generator().manual_seed(0))
    zeros = {k for k, v in jax_init.items() if not v.any()}
    assert zeros and {k for k, v in model.state_dict().items() if not v.any()} == zeros
    assert abs(model.positional_encoding.std().item() - 0.1) < 0.01
    assert abs(model.register_tokens.std().item() - 0.02) < 0.01
    first = {k: v.clone() for k, v in model.state_dict().items()}
    tnn.init_parameters_(model, torch.Generator().manual_seed(0))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, first[key], rtol=0, atol=0, msg=key)


# -- UMT5, RoPE, scheduler, key converters ---------------------------------------


@pytest.mark.parametrize("per_layer", [True, False], ids=["umt5", "t5_shared_bias"])
def test_umt5_matches_jax(per_layer):
    """Two layers with a padded mask: every position of the unpadded row,
    the valid positions of the padded one (both packages compute the padded
    positions too, from the same masked attention)."""
    config = dict(TEXT, per_layer_relative_bias=per_layer)
    jax_model = jax_umt5.UMT5EncoderModel(jax_umt5.UMT5Config(**config))
    flat = _numpy(jax.jit(jax_model.init)(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    flat = {k: (1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32) if "layer_norm" in k
            else v for k, v in flat.items()}
    with torch.device("meta"):
        model = umt5.UMT5EncoderModel(umt5.UMT5Config(**config))
    assert set(model.state_dict()) == set(flat)
    tnn.load_flat_params(model, flat).eval()
    ids = rng.integers(0, TEXT["vocab_size"], (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    want = np.asarray(jax.jit(jax_model.__call__)(_jax_params(flat), jnp.asarray(ids),
                                                  jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_relative_position_buckets_match_jax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    for buckets, distance in ((32, 128), (8, 16)):
        np.testing.assert_array_equal(
            umt5.relative_position_bucket(rel, buckets, distance),
            jax_umt5.relative_position_bucket(rel, buckets, distance),
        )


def test_rope_matches_jax():
    index = np.concatenate([np.zeros((5, 3), np.float32),
                            jax_rope.image_position_indices(8, 12)])
    np.testing.assert_array_equal(rope.image_position_indices(8, 12),
                                  jax_rope.image_position_indices(8, 12))
    freqs = rope.get_rope_frequencies(index, [8, 12, 12], 10000)
    np.testing.assert_array_equal(freqs, jax_rope.get_rope_frequencies(index, [8, 12, 12], 10000))
    x = np.random.default_rng(5).standard_normal((2, len(index), 3, 32)).astype(np.float32)
    want = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(freqs)[:, None])
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(freqs)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    provider = rope.RoPEFrequency([8, 12, 12], 10000)
    np.testing.assert_array_equal(provider(index).numpy(), freqs)


@pytest.mark.parametrize("steps", [4, 20, 25])
def test_scheduler_tables_match_jax(steps):
    ours, theirs = Scheduler(), JaxScheduler()
    assert (ours.sigma_max, ours.sigma_min) == (theirs.sigma_max, theirs.sigma_min)
    for got, want in zip(ours.schedule_tables(steps), theirs.schedule_tables(steps)):
        np.testing.assert_array_equal(got, want)
    ours.retrieve_timesteps(steps)
    theirs.retrieve_timesteps(steps)
    np.testing.assert_array_equal(ours.sigmas, theirs.sigmas)
    x, v = np.ones(2), np.full(2, 2.0)
    np.testing.assert_array_equal(ours.step(v, 1, x), theirs.step(v, 1, x))


def test_key_converters_match_jax():
    for key in ("model.double_layers.0.attn.w1q.weight", "diffusion_model.modF.1.weight",
                "vae.decoder.conv_in.weight",
                "text_encoders.pile_t5xl.transformer.encoder.block.0.layer.0.SelfAttention.q.weight"):
        internal = util.convert_from_original_key(key)
        assert internal == jax_util.convert_from_original_key(key)
        assert util.convert_to_original_key(internal) == jax_util.convert_to_original_key(internal)
        assert util.convert_to_comfy_key(internal) == jax_util.convert_to_comfy_key(internal)
    assert detect_vae_type({"vae.encoder.norm_out.weight": 0}) == "original"
    assert detect_vae_type({"vae.encoder.conv_norm_out.weight": 0}) == "autoencoder_kl"
    with pytest.raises(ValueError):
        detect_vae_type({})


# -- tokenizer, text encoder ---------------------------------------------------------

WORDS = ["a", "cat", "sitting", "on", "the", "sofa", "red", "car", "photo", "of", "blurry"]


def _vocab_bytes():
    """A small unigram vocab at T5's special ids (pad 0, eos 1, unk 2)."""
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces += [("▁" + w, -1.0 - 0.1 * i, 1) for i, w in enumerate(WORDS)]
    pieces += [(ch, -5.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz▁"]
    return sentencepiece.serialize_model(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("t5_vocab")
    (path / "tokenizer.model").write_bytes(_vocab_bytes())
    return path


@pytest.fixture(scope="module")
def pipelines(vocab_dir):
    """Both packages' AuraFlowModel at the tiny config with the same
    weights (the JAX init, its zero leaves drawn anew) and each its own copy
    of the same tokenizer (the "t5" template: text + </s>)."""
    denoiser = dict(TINY, joint_attention_dim=TEXT["d_model"])
    jax_model = JaxAuraFlowModel(
        jax_config.AuraFlowConig(checkpoint_path="unused", dtype="float32",
                                 denoiser=jax_config.DenoiserConfig(**denoiser)),
        tokenizer=jax_auto_tokenizer.load_tokenizer(str(vocab_dir), family="t5"),
        vae_config=JaxVAEConfig(**VAE), text_encoder_config=jax_umt5.UMT5Config(**TEXT),
    )
    jax_model.init_params(jax.random.PRNGKey(0))
    flat = {}
    for root in ("denoiser", "vae", "text_encoder"):
        flat.update({f"{root}.{k}": v for k, v in _numpy(jax_model.params[root]).items()})
    flat = _draw_zero_leaves(flat, 5)
    jax_model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    model = AuraFlowModel(
        AuraFlowConig(checkpoint_path="", dtype="float32", denoiser=DenoiserConfig(**denoiser)),
        tokenizer=auto_tokenizer.load_tokenizer(str(vocab_dir), family="t5"),
        vae_config=AutoencoderKLConfig(**VAE), text_encoder_config=umt5.UMT5Config(**TEXT),
    )
    model.load_state_dict(flat, device="cpu")
    return jax_model, model, flat


@pytest.mark.parametrize("negative", [None, "blurry photo"])
def test_encode_prompts_matches_jax(pipelines, negative):
    jax_model, model, _ = pipelines
    prompts = ["a cat sitting on the sofa", "a red car"]
    want = jax_model.text_encoder.encode_prompts(
        jax_model.params["text_encoder"], prompts, negative, use_negative_prompts=True,
        max_token_length=8,
    )
    with torch.no_grad():
        got = model.text_encoder.encode_prompts(prompts, negative, use_negative_prompts=True,
                                                max_token_length=8)
    for ours, theirs in zip(got, want):
        assert tuple(ours.shape) == theirs.shape
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs), atol=TOL, rtol=TOL)
    for hidden, mask in ((got.positive_embeddings, got.positive_attention_mask),
                         (got.negative_embeddings, got.negative_attention_mask)):
        assert mask.any() and not (hidden * (mask == 0)).any()  # padding zeroed
    single = model.text_encoder.encode_prompts("a cat", max_token_length=8)
    assert single.positive_embeddings.shape == (1, 8, TEXT["d_model"])
    assert single.negative_embeddings.shape[0] == 0


# -- the whole slice -------------------------------------------------------------


def test_denoise_steps_match_jax(pipelines):
    """The Euler loop step by step from the same latents: each package's
    own step (the JAX package's jitted one), with CFG and without."""
    jax_model, model, _ = pipelines
    noise = np.random.default_rng(6).standard_normal((2, 4, 4, 4)).astype(np.float32)
    embeddings = {}
    for do_cfg in (True, False):
        out = jax_model.text_encoder.encode_prompts(
            jax_model.params["text_encoder"], ["a cat", "a red car"], use_negative_prompts=do_cfg,
            max_token_length=8,
        )
        emb = jnp.concatenate([out.positive_embeddings, out.negative_embeddings])
        embeddings[do_cfg] = (emb, torch.from_numpy(np.array(emb)))
    _, sigmas = Scheduler().schedule_tables(4)
    for do_cfg in (True, False):
        jax_step = jax_model._get_jit_step(do_cfg)
        want, got = jnp.asarray(noise), torch.from_numpy(noise)
        for i in range(4):
            want = jax_step(jax_model.params["denoiser"], want, jnp.float32(sigmas[i]),
                            jnp.float32(sigmas[i + 1]), embeddings[do_cfg][0], jnp.float32(4.0))
            with torch.no_grad():
                got = model._denoise_step(got, sigmas[i], sigmas[i + 1], embeddings[do_cfg][1],
                                          4.0, do_cfg=do_cfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LATENT_TOL,
                                       rtol=LATENT_TOL, err_msg=f"step {i}, CFG {do_cfg}")


def _generate_both(pipelines, monkeypatch, prompts, **kwargs):
    """generate() of both packages on the same injected noise; returns each
    one's final latents and images."""
    jax_model, model, _ = pipelines
    noise = np.random.default_rng(7).standard_normal((len(prompts), 4, 4, 4)).astype(np.float32)
    latents = {}
    monkeypatch.setattr(jax_model, "prepare_latents", lambda *a, **kw: jnp.asarray(noise))
    monkeypatch.setattr(model, "prepare_latents", lambda *a, **kw: torch.from_numpy(noise))
    jax_decode, decode = jax_model.decode_image, model.decode_image
    monkeypatch.setattr(
        jax_model, "decode_image", lambda z: latents.setdefault("jax", np.asarray(z)) is None or jax_decode(z)
    )
    monkeypatch.setattr(
        model, "decode_image", lambda z: latents.setdefault("port", z.numpy().copy()) is None or decode(z)
    )
    common = dict(width=32, height=32, max_token_length=8, seed=1, **kwargs)
    want = jax_model.generate(prompts, **common)
    got = model.generate(prompts, **common)
    return latents["jax"], want, latents["port"], got


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("cfg", dict(num_inference_steps=4, cfg_scale=4.0)),
        ("no_cfg", dict(num_inference_steps=3, cfg_scale=1.0)),
        ("negative_prompt", dict(num_inference_steps=3, cfg_scale=4.0, negative_prompt="blurry photo")),
        ("deepcache", dict(num_inference_steps=4, cfg_scale=4.0, deep_cache_interval=2,
                           deep_cache_depth=1)),
    ],
)
def test_generate_matches_jax(pipelines, monkeypatch, name, kwargs):
    prompts = ["a cat sitting on the sofa", "a red car"]
    want_latents, want, got_latents, got = _generate_both(pipelines, monkeypatch, prompts, **kwargs)
    assert got_latents.shape == (2, 4, 4, 4) and np.isfinite(got_latents).all()
    np.testing.assert_allclose(got_latents, want_latents, atol=LATENT_TOL, rtol=LATENT_TOL)
    assert len(got) == len(want) == 2
    for ours, theirs in zip(got, want):
        assert ours.size == theirs.size == (32, 32)
        diff = np.abs(np.asarray(ours, np.int32) - np.asarray(theirs, np.int32))
        assert diff.max() <= 1  # 8-bit rounding of nearly equal floats


def test_generate_options(pipelines, monkeypatch):
    """A request repeats bit for bit; DeepCache refreshing every step is the
    plain loop and a cached one differs; an offloaded request (the first,
    then one from the host) is the plain one bit for bit."""
    _, model, _ = pipelines
    noise = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 4, 4, 4)).astype(np.float32))
    monkeypatch.setattr(model, "prepare_latents", lambda *a, **kw: noise.clone())
    common = dict(width=32, height=32, num_inference_steps=4, cfg_scale=4.0, max_token_length=8)
    base = np.asarray(model.generate("a cat", **common)[0])
    np.testing.assert_array_equal(base, np.asarray(model.generate("a cat", **common)[0]))
    np.testing.assert_array_equal(
        base, np.asarray(model.generate("a cat", deep_cache_interval=1, **common)[0]))
    cached = model.generate("a cat", deep_cache_interval=2, deep_cache_depth=1, **common)
    assert (np.asarray(cached[0]) != base).any()
    assert_offloaded_generate_is_plain(
        monkeypatch, model, lambda **kw: model.generate("a cat", **common, **kw), ("text_encoder", "denoiser", "vae"))


def test_encode_and_decode_image_match_jax(pipelines):
    """The VAE's mode, scaled, from an NHWC image in [-1, 1], and back to
    8-bit images."""
    jax_model, model, _ = pipelines
    image = np.random.default_rng(9).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_model.encode_image(jnp.asarray(image)))
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(image))
    assert got.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    theirs = jax_model.decode_image(jnp.asarray(want))
    with torch.no_grad():
        ours = model.decode_image(got)
    diff = np.abs(np.asarray(ours[0], np.int32) - np.asarray(theirs[0], np.int32))
    assert ours[0].size == (32, 32) and diff.max() <= 1


def test_pipeline_keys_match_jax_and_load_is_strict(pipelines):
    jax_model, model, flat = pipelines
    own = {f"{name}.{k}" for name, part in model._parts().items() for k in part.state_dict()}
    assert own == set(flat)
    assert set(model.state_dict()) == set(jax_model.state_dict())
    with pytest.raises(KeyError):
        model.load_state_dict({**flat, "unet.x": np.zeros(1)}, device="cpu")
    missing = {k: v for k, v in flat.items() if k != "denoiser.register_tokens"}
    with pytest.raises(KeyError):
        model.load_state_dict(missing, device="cpu")


def test_load_state_dict_lands_on_the_card_by_default(pipelines):
    """Without a device argument the weights go to the card; here, with no
    card, that raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default lands on it")
    _, model, flat = pipelines
    with pytest.raises((RuntimeError, AssertionError)):
        model.load_state_dict(flat)
    model.load_state_dict(flat, device="cpu")
    assert model.device.type == "cpu"


def test_init_params_on_a_generator(vocab_dir):
    model = AuraFlowModel(
        AuraFlowConig(checkpoint_path=str(vocab_dir), dtype="bfloat16",
                      denoiser=DenoiserConfig(**dict(TINY, joint_attention_dim=48))),
        vae_config=AutoencoderKLConfig(**VAE), text_encoder_config=umt5.UMT5Config(**TEXT),
    )
    assert model.device.type == "meta"
    assert model.text_encoder.tokenizer is not None  # found in the checkpoint directory
    model.init_params(torch.Generator().manual_seed(0))
    assert model.device.type == "cpu" and model.denoiser.init_x_linear.weight.dtype == torch.bfloat16
    encoder = model.text_encoder.model
    torch.testing.assert_close(encoder.encoder["embed_tokens"].weight, encoder.shared.weight,
                               rtol=0, atol=0)
    assert not model.denoiser.final_linear.weight.any()
    first = {k: v.clone() for k, v in model.state_dict().items()}
    model.init_params(torch.Generator().manual_seed(0))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, first[key], rtol=0, atol=0, msg=key)


# -- the single-file checkpoint ------------------------------------------------------


@pytest.mark.parametrize("dropped", ["shared", "encoder.embed_tokens"])
def test_single_file_checkpoint_loads_as_in_jax(pipelines, vocab_dir, tmp_path, dropped):
    """The JAX model's state_dict() written with the VAE in sgm names and one
    of UMT5's tied embeddings left out: both packages load it to the same
    parameters, and the port's state_dict() writes the JAX layout back."""
    jax_model, model, flat = pipelines
    written = {}
    for key, value in jax_model.state_dict().items():
        if key == f"text_encoders.pile_t5xl.transformer.{dropped}.weight":
            continue
        if key.startswith("vae."):
            key = vae_convert_to_original_key(key)
        written[key] = np.asarray(value)
    assert "vae.encoder.norm_out.weight" in written
    path = tmp_path / "auraflow.safetensors"
    save_file(written, str(path))

    denoiser = DenoiserConfig(**dict(TINY, joint_attention_dim=TEXT["d_model"]))
    theirs = JaxAuraFlowModel.from_original_checkpoint(
        jax_config.AuraFlowConig(checkpoint_path=str(path), dtype="float32",
                                 denoiser=jax_config.DenoiserConfig(**denoiser.model_dump())),
        tokenizer=jax_auto_tokenizer.load_tokenizer(str(vocab_dir), family="t5"),
    )
    ours = AuraFlowModel.from_original_checkpoint(
        AuraFlowConig(checkpoint_path=str(path), dtype="float32", denoiser=denoiser),
        tokenizer=auto_tokenizer.load_tokenizer(str(vocab_dir), family="t5"), device="cpu",
        vae_config=AutoencoderKLConfig(**VAE), text_encoder_config=umt5.UMT5Config(**TEXT),
    )
    want = {f"{root}.{k}": v for root in ("denoiser", "vae", "text_encoder")
            for k, v in _numpy(theirs.params[root]).items()}
    got = {f"{name}.{k}": v.numpy() for name, part in ours._parts().items()
           for k, v in part.state_dict().items()}
    assert set(got) == set(want) == set(flat)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
        np.testing.assert_array_equal(value, flat[key], err_msg=key)
    assert {k: v.numpy().tobytes() for k, v in ours.state_dict().items()} == {
        k: np.asarray(v).tobytes() for k, v in jax_model.state_dict().items()
    }
    assert AuraFlowModel.from_checkpoint == AuraFlowModel.from_original_checkpoint
