"""The port's Lumina2 slice against the JAX package's, on the CPU in fp32
at a tiny config (the one tests/models/test_lumina2.py uses): the NextDiT
forward at several caption lengths, the cached-caption and DeepCache paths,
the scheduler, the tokenizer copies, and the whole slice: ``generate()`` of
both packages from the same flattened weights and the same injected noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.lumina2 import config as jax_config
from vision_ft_tpu.models.lumina2 import util as jax_util
from vision_ft_tpu.models.lumina2.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.models.lumina2.pipeline import Lumina2 as JaxLumina2
from vision_ft_tpu.models.lumina2.scheduler import Scheduler as JaxScheduler
from vision_ft_tpu.models.text_encoders import auto_tokenizer as jax_auto_tokenizer
from vision_ft_tpu.models.text_encoders import sentencepiece as jax_sentencepiece
from vision_ft_tpu.models.text_encoders.gemma2 import Gemma2Config as JaxGemma2Config
from vision_ft_tpu.modules import patch as jax_patch
from vision_ft_tpu.nn import flatten_params, unflatten_params

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.autoencoder.kl import FLUX_VAE_CONFIG
from vision_ft_tpu_torch.models.lumina2 import util
from vision_ft_tpu_torch.models.lumina2.config import DenoiserConfig, Lumina2Config
from vision_ft_tpu_torch.models.lumina2.denoiser import Denoiser
from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
from vision_ft_tpu_torch.models.lumina2.scheduler import Scheduler
from vision_ft_tpu_torch.models.lumina2.vae import DEFAULT_VAE_CONFIG
from vision_ft_tpu_torch.models.text_encoders import auto_tokenizer, sentencepiece
from vision_ft_tpu_torch.models.text_encoders.gemma2 import Gemma2Config
from vision_ft_tpu_torch.modules import patch
from vision_ft_tpu_torch.ops.flash_attention import flash_attention_masked
from vision_ft_tpu_torch.ops.fused_mlp import gated_mlp
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import assert_offloaded_generate_is_plain

# fp32 on the CPU: a few transformer blocks of O(1) activations, summed in
# other orders by the two packages
TOL = 5e-5
# a whole request: 4 Euler steps, each with CFG (a difference of two
# forwards times the guidance scale) and the renorm, then the VAE
LATENT_TOL = 5e-4

TINY = dict(
    in_channels=4, out_channels=4, hidden_dim=48, caption_dim=40, timestep_embed_dim=32,
    depth=2, num_heads=4, num_kv_heads=2, refiner_depth=1, multiple_of=16,
    axes_dims=[4, 4, 4], axes_lens=[32, 16, 16], patch_size=2,
)
TEXT = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, query_pre_attn_scalar=16.0,
)
VAE = dict(
    block_out_channels=(8, 8, 16, 16), latent_channels=4, norm_num_groups=4,
    use_quant_conv=False, scaling_factor=0.3611, shift_factor=0.1159,
)


def _numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _jax_params(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


@pytest.fixture(scope="module")
def denoisers():
    """The JAX denoiser, its parameters (norm scales drawn anew, so that
    they matter) and the port's denoiser loaded from them."""
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**TINY))
    flat = _numpy(jax_model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for key, value in flat.items():
        if "norm" in key:
            flat[key] = (1 + 0.2 * rng.standard_normal(value.shape)).astype(np.float32)
    with torch.device("meta"):
        model = Denoiser(DenoiserConfig(**TINY))
    tnn.load_flat_params(model, flat).eval()
    return jax_model, _jax_params(flat), model, flat


def _inputs(cap_lens, seed=0, cap_len=6):
    rng = np.random.default_rng(seed)
    b = len(cap_lens)
    latents = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    captions = rng.standard_normal((b, cap_len, TINY["caption_dim"])).astype(np.float32)
    t = rng.uniform(0.1, 0.9, b).astype(np.float32)
    mask = np.zeros((b, cap_len), bool)
    for i, n in enumerate(cap_lens):
        mask[i, :n] = True
    return latents, captions, t, mask


def test_configs_match_jax():
    assert DenoiserConfig().model_dump() == jax_config.DenoiserConfig().model_dump()
    assert (Lumina2Config(checkpoint_path="x").model_dump()
            == jax_config.Lumina2Config(checkpoint_path="x").model_dump())
    assert DEFAULT_VAE_CONFIG is FLUX_VAE_CONFIG
    assert (FLUX_VAE_CONFIG.latent_channels, FLUX_VAE_CONFIG.use_quant_conv) == (16, False)
    assert (FLUX_VAE_CONFIG.scaling_factor, FLUX_VAE_CONFIG.shift_factor) == (0.3611, 0.1159)


def test_denoiser_keys_and_shapes_match_jax(denoisers):
    _, _, model, flat = denoisers
    own = model.state_dict()
    assert set(own) == set(flat)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in flat.items()}
    assert "norm_final.weight" in own  # in the tree, never applied


@pytest.mark.parametrize("cap_lens", [(6, 6), (6, 3), (1, 5), (4,)])
def test_denoiser_forward_matches_jax(denoisers, cap_lens):
    """Velocity everywhere (it covers image positions only) and the refined
    captions at the valid positions; then the cached-caption path."""
    jax_model, params, model, _ = denoisers
    latents, captions, t, mask = _inputs(cap_lens)
    want, _, want_refined = jax_model(
        params, jnp.asarray(latents), jnp.asarray(captions), jnp.asarray(t), jnp.asarray(mask)
    )
    args = [torch.from_numpy(a) for a in (latents, captions, t, mask)]
    attention, mlp = flash_attention_masked.launches, gated_mlp.launches
    with torch.no_grad():
        got, got_mask, refined = model(*args)
        cached, _, _ = model(*args, cached_caption_features=refined)
    assert (flash_attention_masked.launches, gated_mlp.launches) == (attention, mlp)
    assert got.shape == latents.shape and got_mask.dtype == torch.bool
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for i, n in enumerate(cap_lens):
        np.testing.assert_allclose(
            refined[i, :n].numpy(), np.asarray(want_refined)[i, :n], atol=TOL, rtol=TOL
        )
    want_cached, _, _ = jax_model(
        params, jnp.asarray(latents), jnp.asarray(captions), jnp.asarray(t), jnp.asarray(mask),
        cached_caption_features=want_refined,
    )
    np.testing.assert_allclose(cached.numpy(), np.asarray(want_cached), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cached.numpy(), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("cache_depth", [None, 1])
def test_deepcache_forward_matches_jax(denoisers, cache_depth):
    """A refresh step equals the plain forward and records the delta; a
    cached step at the next timestep reuses it, in both packages alike; the
    cached step really skips the deep layers."""
    jax_model, params, model, flat = denoisers
    latents, captions, t, mask = _inputs((6, 4), seed=1)
    jargs = [jnp.asarray(a) for a in (latents, captions, t, mask)]
    targs = [torch.from_numpy(a) for a in (latents, captions, t, mask)]
    want, _, _, want_delta = jax_model.deepcache_forward(
        params, *jargs, refresh=True, cache_depth=cache_depth
    )
    with torch.no_grad():
        plain, _, _ = model(*targs)
        full, _, _, delta = model.deepcache_forward(*targs, refresh=True, cache_depth=cache_depth)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=TOL, rtol=TOL)

    jargs[2], targs[2] = jargs[2] + 0.05, targs[2] + 0.05  # the next step's time
    want_next, _, _, _ = jax_model.deepcache_forward(
        params, *jargs, cached_delta=want_delta, refresh=False, cache_depth=cache_depth
    )
    with torch.no_grad():
        reused, _, _, delta_out = model.deepcache_forward(
            *targs, cached_delta=delta, refresh=False, cache_depth=cache_depth
        )
    assert delta_out is delta
    np.testing.assert_allclose(reused.numpy(), np.asarray(want_next), atol=TOL, rtol=TOL)

    with torch.device("meta"):
        poisoned = Denoiser(DenoiserConfig(**TINY))
    bad = {k: np.full_like(v, np.nan) if k.startswith("layers.1.") else v for k, v in flat.items()}
    tnn.load_flat_params(poisoned, bad).eval()
    with torch.no_grad():
        refreshed, *_ = poisoned.deepcache_forward(*targs, refresh=True, cache_depth=1)
        clean, *_ = poisoned.deepcache_forward(*targs, cached_delta=delta, refresh=False, cache_depth=1)
    assert not torch.isfinite(refreshed).all() and torch.isfinite(clean).all()


def test_deepcache_forward_rejects_bad_arguments(denoisers):
    model = denoisers[2]
    targs = [torch.from_numpy(a) for a in _inputs((6, 4))]
    with pytest.raises(ValueError):
        model.deepcache_forward(*targs, cache_depth=2)  # depth 2: k must be 1
    with pytest.raises(ValueError):
        model.deepcache_forward(*targs, refresh=False)


def test_unported_denoiser_options_raise_by_name(denoisers):
    """set_pipeline stays unported; gradient checkpointing is ported (held
    against the JAX package in tests/test_torch_lumina2_train.py) and leaves
    a forward without gradients as it was."""
    model = denoisers[2]
    with pytest.raises(NotImplementedError, match="set_pipeline"):
        model.set_pipeline(object(), 2)
    model.set_pipeline(None, 1)
    args = [torch.from_numpy(a) for a in _inputs((6, 3))]
    with torch.no_grad():
        want, _, _ = model(*args)
        model.set_gradient_checkpointing(True)
        try:
            assert model.gradient_checkpointing
            got, _, _ = model(*args)
        finally:
            model.set_gradient_checkpointing(False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("steps", [4, 8, 25])
def test_scheduler_tables_match_jax(steps):
    ours, theirs = Scheduler(), JaxScheduler()
    np.testing.assert_array_equal(ours.get_timesteps(steps), theirs.get_timesteps(steps))
    np.testing.assert_array_equal(ours.get_sigmas(steps), theirs.get_sigmas(steps))
    assert ours.get_sigmas(steps).dtype == np.float32 and ours.get_sigmas(steps)[-1] == 0
    x, v = torch.ones(2), torch.full((2,), 2.0)
    torch.testing.assert_close(ours.step(x, v, 0.5, 0.25), torch.full((2,), 1.5))


def test_patchify_and_unpatchify_match_jax():
    rng = np.random.default_rng(3)
    latent = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        patch.patchify(torch.from_numpy(latent), 2).numpy(),
        np.asarray(jax_patch.patchify(jnp.asarray(latent), 2)),
    )
    patches = rng.standard_normal((2, 4 * 6, 2 * 2 * 4)).astype(np.float32)
    np.testing.assert_array_equal(
        patch.unpatchify(torch.from_numpy(patches), 4, 6, 2, 4).numpy(),
        np.asarray(jax_patch.unpatchify(jnp.asarray(patches), 4, 6, 2, 4)),
    )


@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_matches_jax(affine):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 48)) * 2).astype(np.float32)
    weight = (1 + 0.2 * rng.standard_normal(48)).astype(np.float32)
    norm = tnn.RMSNorm(48, eps=1e-5, elementwise_affine=affine)
    assert set(norm.state_dict()) == ({"weight"} if affine else set())
    if affine:
        tnn.load_flat_params(norm, {"weight": weight})
    want = jnn.RMSNorm(48, eps=1e-5, elementwise_affine=affine)(
        {"weight": jnp.asarray(weight)} if affine else {}, jnp.asarray(x)
    )
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    half = norm(torch.from_numpy(x).bfloat16())
    assert half.dtype == torch.bfloat16


def test_key_converters_match_jax():
    for key in ("model.diffusion_model.layers.0.attention.qkv.weight", "vae.decoder.conv_in.weight",
                "text_encoders.gemma2_2b.transformer.model.norm.weight"):
        internal = util.convert_from_original_key(key)
        assert internal == jax_util.convert_from_original_key(key)
        assert util.convert_to_original_key(internal) == jax_util.convert_to_original_key(internal) == key
        assert util.convert_to_comfy_key(internal) == jax_util.convert_to_comfy_key(internal)


# -- tokenizer copies -----------------------------------------------------------

WORDS = ["a", "cat", "sitting", "on", "the", "sofa", "red", "car", "photo", "of", "blurry"]
PROMPTS = ["a cat sitting on the sofa", "", "a photo of a red car", "  a   zebra!  ", "the the the"]


def _pieces():
    """A small unigram vocab: specials, the byte pieces, words and letters."""
    pieces = [("<pad>", 0.0, 3), ("<eos>", 0.0, 3), ("<bos>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces += [("▁" + w, -1.0 - 0.1 * i, 1) for i, w in enumerate(WORDS)]
    pieces += [(ch, -5.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz▁"]
    return pieces


def _model_bytes(module, model_type=1):
    return module.serialize_model(_pieces(), model_type=model_type, unk_id=3, bos_id=2, eos_id=1, pad_id=0)


@pytest.mark.parametrize("model_type", [1, 2], ids=["unigram", "bpe"])
@pytest.mark.parametrize("template", ["bos", "eos", "bos_eos", "none"])
def test_sentencepiece_copy_gives_the_same_ids(model_type, template):
    data = _model_bytes(sentencepiece, model_type)
    assert data == _model_bytes(jax_sentencepiece, model_type)
    ours = sentencepiece.SentencePieceTokenizer(sentencepiece.SentencePieceModel.from_bytes(data), template)
    theirs = jax_sentencepiece.SentencePieceTokenizer(
        jax_sentencepiece.SentencePieceModel.from_bytes(data), template
    )
    assert len(ours) == len(theirs) == len(_pieces())
    for max_length in (8, 5, None):
        assert ours(PROMPTS, max_length=max_length) == theirs(PROMPTS, max_length=max_length)
    for prompt in PROMPTS:
        ids = ours.encode(prompt)
        assert ids == theirs.encode(prompt)
        assert ours.decode(ids) == theirs.decode(ids)


def test_empty_prompt_keeps_one_token_under_the_gemma_template(tmp_path):
    """The empty negative prompt of a CFG request is <bos> alone: one valid
    caption token, so no attention row of the NextDiT is fully masked."""
    (tmp_path / "tokenizer.model").write_bytes(_model_bytes(sentencepiece))
    ours = auto_tokenizer.load_tokenizer(str(tmp_path), family="gemma")
    theirs = jax_auto_tokenizer.load_tokenizer(str(tmp_path), family="gemma")
    out = ours(["", "a cat"], max_length=6)
    assert out == theirs(["", "a cat"], max_length=6)
    assert out["attention_mask"][0] == [1, 0, 0, 0, 0, 0] and out["input_ids"][0][0] == 2
    config = Lumina2Config(checkpoint_path="", tokenizer_path=str(tmp_path))
    found = auto_tokenizer.maybe_auto_tokenizer(config, family="gemma")
    assert found(["a cat"], max_length=6) == ours(["a cat"], max_length=6)
    assert auto_tokenizer.maybe_auto_tokenizer(Lumina2Config(checkpoint_path=""), "gemma") is None
    with pytest.raises(FileNotFoundError):
        auto_tokenizer.load_tokenizer(str(tmp_path / "nothing"))


# -- the whole slice ------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both packages' Lumina2 at the tiny config with the same weights (the
    JAX init, flattened) and each its own copy of the same tokenizer."""
    path = tmp_path_factory.mktemp("tokenizer") / "tokenizer.model"
    path.write_bytes(_model_bytes(sentencepiece))
    denoiser = dict(TINY, caption_dim=TEXT["hidden_size"])
    jax_model = JaxLumina2(
        jax_config.Lumina2Config(checkpoint_path="unused", dtype="float32",
                                 denoiser=jax_config.DenoiserConfig(**denoiser)),
        tokenizer=jax_auto_tokenizer.load_tokenizer(str(path), family="gemma"),
        vae_config=JaxVAEConfig(**VAE), text_encoder_config=JaxGemma2Config(**dict(TEXT, vocab_size=512)),
    )
    jax_model.init_params(jax.random.PRNGKey(0))
    flat = {}
    for root in ("denoiser", "vae", "text_encoder"):
        flat.update({f"{root}.{k}": v for k, v in _numpy(jax_model.params[root]).items()})
    model = Lumina2(
        Lumina2Config(checkpoint_path="", dtype="float32", denoiser=DenoiserConfig(**denoiser)),
        tokenizer=auto_tokenizer.load_tokenizer(str(path), family="gemma"),
        vae_config=AutoencoderKLConfig(**VAE), text_encoder_config=Gemma2Config(**dict(TEXT, vocab_size=512)),
    )
    model.load_state_dict(flat, device="cpu")
    return jax_model, model, flat


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
        ("no_renorm", dict(num_inference_steps=3, cfg_scale=3.0, renorm_cfg_scale=0.0)),
        ("negative_prompt", dict(num_inference_steps=3, cfg_scale=4.0, negative_prompt="blurry photo")),
        ("truncation", dict(num_inference_steps=4, cfg_scale=4.0, cfg_truncation_ratio=0.5)),
        ("deepcache", dict(num_inference_steps=4, cfg_scale=4.0, deep_cache_interval=2,
                           deep_cache_depth=1)),
        ("deepcache_truncation", dict(num_inference_steps=5, cfg_scale=4.0, cfg_truncation_ratio=0.4,
                                      deep_cache_interval=3)),
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


def test_generate_options_change_the_result(pipelines, monkeypatch):
    """Truncation and DeepCache are not inert at this size, and a request
    repeats bit for bit."""
    _, model, _ = pipelines
    noise = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 4, 4, 4)).astype(np.float32))
    monkeypatch.setattr(model, "prepare_latents", lambda *a, **kw: noise.clone())
    common = dict(width=32, height=32, num_inference_steps=4, cfg_scale=4.0, max_token_length=8)
    base = np.asarray(model.generate("a cat", **common)[0])
    np.testing.assert_array_equal(base, np.asarray(model.generate("a cat", **common)[0]))
    exact = np.asarray(model.generate("a cat", deep_cache_interval=1, **common)[0])
    np.testing.assert_array_equal(base, exact)  # a refresh at every step is the plain loop
    for extra in (dict(cfg_truncation_ratio=0.5), dict(deep_cache_interval=2, deep_cache_depth=1)):
        assert (np.asarray(model.generate("a cat", **common, **extra)[0]) != base).any()


def test_generate_rejects_offloading(pipelines, monkeypatch):
    """Offloading, which raised before it was ported, now runs: an offloaded
    request (the first, then one from the host) is the plain one bit for
    bit."""
    model = pipelines[1]
    common = dict(width=32, height=32, num_inference_steps=2, cfg_scale=4.0, seed=3)
    assert_offloaded_generate_is_plain(
        monkeypatch, model, lambda **kw: model.generate("a cat", **common, **kw), ("text_encoder", "denoiser", "vae"))


def test_pipeline_keys_match_jax_and_load_is_strict(pipelines):
    _, model, flat = pipelines
    own = {f"{name}.{k}" for name, part in model._parts().items() for k in part.state_dict()}
    assert own == set(flat)
    with pytest.raises(KeyError):
        model.load_state_dict({**flat, "unet.x": np.zeros(1)}, device="cpu")
    missing = {k: v for k, v in flat.items() if k != "denoiser.norm_final.weight"}
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


def test_init_params_on_a_generator():
    model = Lumina2(
        Lumina2Config(checkpoint_path="", dtype="bfloat16",
                      denoiser=DenoiserConfig(**dict(TINY, caption_dim=32))),
        tokenizer=None, vae_config=AutoencoderKLConfig(**VAE), text_encoder_config=Gemma2Config(**TEXT),
    )
    assert model.device.type == "meta"
    model.init_params(torch.Generator().manual_seed(0))
    first = {k: v.clone() for k, v in model.denoiser.state_dict().items()}
    assert model.device.type == "cpu" and model.denoiser.x_embedder.weight.dtype == torch.bfloat16
    assert (model.text_encoder.model.norm.weight == 0).all()  # Gemma's offset norm
    assert (model.denoiser.norm_final.weight == 1).all()
    model.init_params(torch.Generator().manual_seed(0))  # the same seed: the same weights
    for key, value in model.denoiser.state_dict().items():
        torch.testing.assert_close(value, first[key], rtol=0, atol=0, msg=key)
    model.init_params(torch.Generator().manual_seed(1), dtype=torch.float32)
    assert model.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in model.denoiser.state_dict().values())
    assert not torch.equal(model.denoiser.x_embedder.weight.bfloat16(), first["x_embedder.weight"])
    with pytest.raises(RuntimeError, match="tokenizer"):
        model.generate("a cat", width=32, height=32, num_inference_steps=1)
