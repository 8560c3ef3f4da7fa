"""The port's serving slice against the JAX package (CPU, fp32, tiny
configs): each family's ``_slot_step`` with 3 slots at mixed steps and
guidance and an inactive row (CogView4's also against its own
``_denoise_step``), SDXL's ``deepcache_forward`` and DeepCache
loop, the VAE's ``tiled_decode``; then ``serving.ContinuousBatcher``
against the port's own batch-1 ``generate()`` for four families
(staggered admission, more requests than slots, the step and schedule
checks, submit after close, a weight swap), and the scheduler's host logic
pinned exactly by a model-free adapter that records every tick.

Inputs come from numpy.random.default_rng(seed); the two frameworks' random
bits differ, so where the JAX step draws ancestral noise the port is given
the JAX draws.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.auraflow import config as jax_aura_config
from vision_ft_tpu.models.auraflow.pipeline import AuraFlowModel as JaxAuraFlowModel
from vision_ft_tpu.models.cogview4 import config as jax_cogview4_config
from vision_ft_tpu.models.cogview4.pipeline import CogView4Model as JaxCogView4Model
from vision_ft_tpu.models.lumina2 import config as jax_lumina_config
from vision_ft_tpu.models.lumina2.pipeline import Lumina2 as JaxLumina2
from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel

from tests import test_torch_auraflow as aura_tests
from tests import test_torch_cogview4 as cogview4_tests
from tests import test_torch_lumina2 as lumina_tests
from tests.test_torch_sdxl import _random_params, _tiny_kwargs
import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig
from vision_ft_tpu_torch.models.auraflow.config import DenoiserConfig as AuraDenoiserConfig
from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.cogview4.config import CogView4Config
from vision_ft_tpu_torch.models.cogview4.config import DenoiserConfig as CogView4DenoiserConfig
from vision_ft_tpu_torch.models.cogview4.pipeline import CogView4Model
from vision_ft_tpu_torch.models.lumina2.config import DenoiserConfig as LuminaDenoiserConfig
from vision_ft_tpu_torch.models.lumina2.config import Lumina2Config
from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.text_encoders import auto_tokenizer, glm, umt5
from vision_ft_tpu_torch.models.text_encoders.gemma2 import Gemma2Config
from vision_ft_tpu_torch.serving import (
    AuraFlowSlotAdapter,
    CogView4SlotAdapter,
    ContinuousBatcher,
    Lumina2SlotAdapter,
    SDXLSlotAdapter,
    SlotRequest,
)
from vision_ft_tpu_torch.utils.tensor import incremental_seed_randn
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU in both packages, the same arithmetic summed in other
# orders: one UNet / NextDiT / MMDiT forward and one Euler update agree to
# ~1e-5 of latents up to ~15 (SDXL's sigma_max); 1e-4 abs + rel leaves room
STEP_TOL = 1e-4
# the DeepCache loop: 4 ancestral steps, each guidance x 3 on a difference
# of two forwards (test_torch_sdxl's whole-loop limit)
LOOP_TOL = 1e-4
# the pool against batch-1 generate() in the port itself: the same
# arithmetic at another batch (CPU matmuls may block rows differently),
# carried over up to 6 steps
POOL_TOL = 1e-4


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


# -- models -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdxl():
    """Both packages' tiny SDXL with the same numpy weights."""
    config, kwargs = _tiny_kwargs("jax")
    jax_model = JaxSDXLModel(config, **kwargs)
    flat = _random_params(
        jax.eval_shape(lambda key: {"denoiser": jax_model.denoiser.init(key),
                                    "vae": jax_model.vae.init(key),
                                    "text_encoder": jax_model.text_encoder.init(key)},
                       jax.random.key(0)),
        seed=0,
    )
    jax_model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    config, kwargs = _tiny_kwargs("torch")
    port = SDXLModel(config, **kwargs)
    port.load_state_dict(flat, device="cpu")
    return jax_model, port, flat


def _pipelines(jax_class, jax_config, port_class, port_config, tokenizer, port_kwargs):
    """A JAX pipeline holding only its denoiser's parameters (numpy draws of
    the init's shapes: the slot step reads no other part) and the port's
    whole pipeline, seeded, its denoiser loaded with the same numbers."""
    jax_model = jax_class(jax_config)
    shapes = jax.eval_shape(jax_model.denoiser.init, jax.random.key(0))
    flat = _random_params(shapes, seed=1)
    jax_model.params = {"denoiser": jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})}
    model = port_class(port_config, tokenizer=tokenizer, **port_kwargs)
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    tnn.load_flat_params(model.denoiser, flat)
    return jax_model, model


@pytest.fixture(scope="module")
def lumina(tmp_path_factory):
    """The tiny Lumina2 of tests/test_torch_lumina2.py."""
    path = tmp_path_factory.mktemp("gemma") / "tokenizer.model"
    path.write_bytes(lumina_tests._model_bytes(lumina_tests.sentencepiece))
    denoiser = dict(lumina_tests.TINY, caption_dim=lumina_tests.TEXT["hidden_size"])
    return _pipelines(
        JaxLumina2,
        jax_lumina_config.Lumina2Config(checkpoint_path="unused", dtype="float32",
                                        denoiser=jax_lumina_config.DenoiserConfig(**denoiser)),
        Lumina2,
        Lumina2Config(checkpoint_path="", dtype="float32", denoiser=LuminaDenoiserConfig(**denoiser)),
        auto_tokenizer.load_tokenizer(str(path), family="gemma"),
        dict(vae_config=AutoencoderKLConfig(**lumina_tests.VAE),
             text_encoder_config=Gemma2Config(**dict(lumina_tests.TEXT, vocab_size=512))),
    )


@pytest.fixture(scope="module")
def aura(tmp_path_factory):
    """The tiny AuraFlow of tests/test_torch_auraflow.py."""
    vocab = tmp_path_factory.mktemp("t5")
    (vocab / "tokenizer.model").write_bytes(aura_tests._vocab_bytes())
    denoiser = dict(aura_tests.TINY, joint_attention_dim=aura_tests.TEXT["d_model"])
    return _pipelines(
        JaxAuraFlowModel,
        jax_aura_config.AuraFlowConig(checkpoint_path="unused", dtype="float32",
                                      denoiser=jax_aura_config.DenoiserConfig(**denoiser)),
        AuraFlowModel,
        AuraFlowConig(checkpoint_path="", dtype="float32", denoiser=AuraDenoiserConfig(**denoiser)),
        auto_tokenizer.load_tokenizer(str(vocab), family="t5"),
        dict(vae_config=AutoencoderKLConfig(**aura_tests.VAE),
             text_encoder_config=umt5.UMT5Config(**aura_tests.TEXT)),
    )


@pytest.fixture(scope="module")
def cogview4():
    """The tiny CogView4 of tests/test_torch_cogview4.py."""
    return _pipelines(
        JaxCogView4Model,
        jax_cogview4_config.CogView4Config(
            checkpoint_path="unused", dtype="float32",
            denoiser=jax_cogview4_config.DenoiserConfig(**cogview4_tests.TINY,
                                                        attention_backend="eager")),
        CogView4Model,
        CogView4Config(checkpoint_path="", dtype="float32",
                       denoiser=CogView4DenoiserConfig(**cogview4_tests.TINY)),
        cogview4_tests.GlmTok(),
        dict(vae_config=AutoencoderKLConfig(**cogview4_tests.VAE),
             text_encoder_config=glm.GlmConfig(**cogview4_tests.GLM)),
    )


# -- the slot steps against the JAX package's ---------------------------------------

# three slots: two active at other steps, guidance and rescale; slot 1 inactive
ACTIVE = np.array([True, False, True])


def _pool_rows(rng, s, length, width):
    """(2S, length, width) context rows, [positives; negatives]."""
    return rng.standard_normal((2 * s, length, width)).astype(np.float32)


def test_sdxl_slot_step_matches_jax(sdxl):
    jax_model, port, _ = sdxl
    rng = np.random.default_rng(0)
    s, h, w = 3, 8, 12
    latents = rng.standard_normal((s, h, w, 4)).astype(np.float32) * 5
    timestep = np.array([801.0, 1.0, 301.0], np.float32)
    sigma = np.array([9.5, 0.0, 1.3], np.float32)
    next_sigma = np.array([4.2, 0.0, 0.0], np.float32)  # slot 2 takes the last step
    emb = _pool_rows(rng, s, 77, 112)
    pooled = rng.standard_normal((2 * s, 1280)).astype(np.float32)
    sizes = np.tile(np.array([[64.0, 96.0]], np.float32), (2 * s, 1))
    crops = np.zeros((2 * s, 2), np.float32)
    cfg = np.array([3.0, 1.0, 5.5], np.float32)
    rescale = np.array([0.25, 0.0, 0.7], np.float32)
    seeds = np.array([1000, 7, 2**31 - 5], np.int32)  # the last wraps past 2**31
    step_idx = np.array([0, 3, 2], np.int32)
    args = (latents, timestep, sigma, next_sigma, emb, pooled, sizes, sizes, crops, cfg,
            rescale)
    want = jax_model._get_jit_slot_step()(
        jax_model.params["denoiser"], *map(jnp.asarray, args), jnp.asarray(seeds),
        jnp.asarray(step_idx), jnp.asarray(ACTIVE),
    )
    step_seeds = (seeds + np.int32(7919) * (step_idx + 1)) & np.int32(0x7FFFFFFF)
    noise = jax.vmap(lambda k: jax.random.normal(jax.random.PRNGKey(k), (h, w, 4)))(
        jnp.asarray(step_seeds))
    with torch.inference_mode():
        got = port._slot_step(*map(torch.from_numpy, args), seeds, step_idx,
                              torch.from_numpy(ACTIVE), noise=torch.from_numpy(np.array(noise)))
    _close(got, want, STEP_TOL, "sdxl slot step")
    np.testing.assert_array_equal(got[1].numpy(), latents[1])  # the inactive row is kept


def test_sdxl_slot_noise_is_the_generate_stream():
    """Slot j at step i draws what batch-1 generate() draws at step i."""
    seeds, idx = [5, 2**31 - 2], [0, 3]
    got = SDXLModel.slot_noise(seeds, idx, (4, 6, 4), torch.device("cpu"))
    for j in range(2):
        step_seed = (seeds[j] + 7919 * (idx[j] + 1)) & 0x7FFFFFFF
        want = incremental_seed_randn((1, 4, 6, 4), step_seed)[0]
        torch.testing.assert_close(got[j], want, rtol=0, atol=0)


def test_lumina2_slot_step_matches_jax(lumina):
    jax_model, model = lumina
    rng = np.random.default_rng(1)
    s, length = 3, 6
    latents = rng.standard_normal((s, 8, 8, 4)).astype(np.float32)
    timestep = np.array([0.1, 0.0, 0.6], np.float32)
    sigma = 1.0 - timestep
    next_sigma = np.array([0.7, 0.0, 0.0], np.float32)
    features = _pool_rows(rng, s, length, lumina_tests.TEXT["hidden_size"])
    mask = np.zeros((2 * s, length), bool)
    for row, n in enumerate([6, 1, 3, 4, 2, 5]):
        mask[row, :n] = True
    cfg = np.array([4.0, 1.0, 3.0], np.float32)
    renorm = np.array([1.0, 1.0, 0.0], np.float32)  # slot 2 without renorm
    trunc = np.array([0.5, 0.0, 0.0], np.float32)   # slot 0 truncated at step 0 of 4
    step_idx = np.array([0, 1, 3], np.int32)
    total = np.array([4, 3, 4], np.int32)
    args = (latents, timestep, sigma, next_sigma, features, mask, cfg, renorm, trunc,
            step_idx, total, ACTIVE)
    want = jax_model._get_jit_slot_step()(jax_model.params["denoiser"], *map(jnp.asarray, args))
    with torch.inference_mode():
        got = model._slot_step(*map(torch.from_numpy, args))
    _close(got, want, STEP_TOL, "lumina2 slot step")
    np.testing.assert_array_equal(got[1].numpy(), latents[1])


def test_auraflow_slot_step_matches_jax(aura):
    jax_model, model = aura
    rng = np.random.default_rng(2)
    s = 3
    latents = rng.standard_normal((s, 4, 4, 4)).astype(np.float32)
    sigma = np.array([0.9, 0.0, 0.3], np.float32)
    next_sigma = np.array([0.7, 0.0, 0.0], np.float32)
    emb = _pool_rows(rng, s, 8, aura_tests.TEXT["d_model"])
    cfg = np.array([4.0, 2.0, 1.0], np.float32)  # slot 2: the positive velocity alone
    args = (latents, sigma * 1000, sigma, next_sigma, emb, cfg, ACTIVE)
    want = jax_model._get_jit_slot_step()(jax_model.params["denoiser"], *map(jnp.asarray, args))
    with torch.inference_mode():
        got = model._slot_step(*map(torch.from_numpy, args))
    _close(got, want, STEP_TOL, "auraflow slot step")
    np.testing.assert_array_equal(got[1].numpy(), latents[1])


def _cogview4_slot_args(rng, s=3):
    latents = rng.standard_normal((s, 4, 6, 4)).astype(np.float32)
    sigma = np.array([0.95, 0.0, 0.4], np.float32)
    next_sigma = np.array([0.8, 0.0, 0.0], np.float32)  # slot 2 takes the last step
    emb = _pool_rows(rng, s, 16, cogview4_tests.GLM["hidden_size"])
    sizes = np.tile(np.array([[32.0, 48.0]], np.float32), (2 * s, 1))
    crops = np.tile(np.array([[0.0, 16.0]], np.float32), (2 * s, 1))
    cfg = np.array([3.5, 2.0, 1.0], np.float32)  # slot 2: the positive velocity alone
    return (latents, np.array([999.0, 1.0, 400.0], np.float32), sigma, next_sigma, emb, sizes,
            sizes, crops, cfg)


def test_cogview4_slot_step_matches_jax(cogview4):
    """Per-slot timesteps (each slot its own row of the time embedding),
    size rows, CFG 3.5 / 2 / 1; the inactive row keeps its latents."""
    jax_model, model = cogview4
    args = (*_cogview4_slot_args(np.random.default_rng(3)), ACTIVE)
    want = jax_model._get_jit_slot_step()(jax_model.params["denoiser"], *map(jnp.asarray, args))
    with torch.inference_mode():
        got = model._slot_step(*map(torch.from_numpy, args))
    _close(got, want, STEP_TOL, "cogview4 slot step")
    np.testing.assert_array_equal(got[1].numpy(), args[0][1])


def test_cogview4_slot_step_is_the_denoise_step(cogview4):
    """Two active slots at one timestep and one CFG scale are one CFG
    ``_denoise_step`` of batch 2, bit for bit; a slot with CFG <= 1 is the
    step without CFG on its own row."""
    _, model = cogview4
    latents, _, _, _, emb, sizes, _, crops, _ = _cogview4_slot_args(np.random.default_rng(4), 2)
    t, sigma, next_sigma = 700.0, np.float32(0.7), np.float32(0.55)
    x = torch.from_numpy(latents)
    with torch.inference_mode():
        pooled = model._slot_step(
            x, torch.full((2,), t), torch.full((2,), float(sigma)),
            torch.full((2,), float(next_sigma)), torch.from_numpy(emb), *map(
                torch.from_numpy, (sizes, sizes, crops)), torch.full((2,), 3.5),
            torch.ones(2, dtype=torch.bool))
        step = model._denoise_step(x, t, sigma, next_sigma, torch.from_numpy(emb),
                                   *map(torch.from_numpy, (sizes, sizes, crops)), 3.5, do_cfg=True)
        alone = model._denoise_step(x[:1], t, sigma, next_sigma, torch.from_numpy(emb[:1]),
                                    *(torch.from_numpy(a[:1]) for a in (sizes, sizes, crops)), 1.0)
        no_cfg = model._slot_step(
            x, torch.full((2,), t), torch.full((2,), float(sigma)),
            torch.full((2,), float(next_sigma)), torch.from_numpy(emb), *map(
                torch.from_numpy, (sizes, sizes, crops)), torch.tensor([1.0, 3.5]),
            torch.ones(2, dtype=torch.bool))
    torch.testing.assert_close(pooled, step, rtol=0, atol=0)
    _close(no_cfg[0], alone[0], STEP_TOL, "a slot without CFG")


# -- SDXL DeepCache and the tiled decode ----------------------------------------------


@pytest.mark.parametrize("cache_depth", [2, 3])
def test_sdxl_deepcache_forward_matches_jax(sdxl, cache_depth):
    """The full pass (no cache yet) and a cached pass from the same deep
    feature, against the JAX package's, at two cache depths."""
    jax_model, port, _ = sdxl
    rng = np.random.default_rng(3)
    args = [rng.standard_normal((2, 8, 8, 4)).astype(np.float32), np.array([901.0, 401.0], np.float32),
            rng.standard_normal((2, 77, 112)).astype(np.float32),
            rng.standard_normal((2, 1280)).astype(np.float32),
            np.full((2, 2), 64.0, np.float32), np.full((2, 2), 64.0, np.float32),
            np.zeros((2, 2), np.float32)]
    params = jax_model.params["denoiser"]
    deepcache = functools.partial(jax_model.denoiser.deepcache_forward, cache_depth=cache_depth)
    deep_shape = jax.eval_shape(
        lambda *a: deepcache(params, *a, cached_deep=None, refresh=jnp.array(True))[1],
        *map(jnp.asarray, args))
    # one program for both passes: lax.cond on refresh, from a zero cache
    jax_fn = jax.jit(lambda deep, refresh, *a: deepcache(params, *a, cached_deep=deep,
                                                          refresh=refresh))
    want_full, want_deep = jax_fn(jnp.zeros(deep_shape.shape), jnp.array(True),
                                  *map(jnp.asarray, args))
    with torch.inference_mode():
        got_full, got_deep = port.denoiser.deepcache_forward(
            *map(torch.from_numpy, args), cached_deep=None, refresh=True, cache_depth=cache_depth)
        plain = port.denoiser(*map(torch.from_numpy, args))
    _close(got_full, want_full, STEP_TOL, "full pass")
    _close(got_deep, want_deep, STEP_TOL, "deep feature")
    torch.testing.assert_close(got_full, plain, rtol=0, atol=0)  # the forward's blocks, in order

    # a cached pass on other latents, from the deep feature of the full one
    args[0] = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want_cached, _ = jax_fn(want_deep, jnp.array(False), *map(jnp.asarray, args))
    with torch.inference_mode():
        got_cached, kept = port.denoiser.deepcache_forward(
            *map(torch.from_numpy, args), cached_deep=torch.from_numpy(np.array(want_deep)),
            refresh=False, cache_depth=cache_depth)
    _close(got_cached, want_cached, STEP_TOL, "cached pass")
    assert not np.allclose(_np(got_cached), _np(got_full), atol=1e-3)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want_deep))
    with pytest.raises(ValueError, match="cache_depth"):
        port.denoiser.deepcache_forward(*map(torch.from_numpy, args), cached_deep=None,
                                        refresh=True, cache_depth=9)


def test_sdxl_deepcache_loop_matches_jax(sdxl):
    """The denoise loop with DeepCache every 2 steps (CFG, rescale) against
    the JAX package's scanned loop, fed its initial latents and per-step
    noise."""
    jax_model, port, _ = sdxl
    interval = 2
    steps, seed, cfg, rescale = 4, 5, 3.0, 0.5
    timesteps = jax_model.scheduler.get_timesteps(steps)
    sigmas = jax_model.scheduler.get_sigmas(timesteps)
    n = len(timesteps)
    rng = np.random.default_rng(4)
    latents0 = (rng.standard_normal((1, 8, 8, 4)) * 10).astype(np.float32)
    emb = rng.standard_normal((2, 77, 112)).astype(np.float32)
    pooled = rng.standard_normal((2, 1280)).astype(np.float32)
    sizes, crops = np.full((2, 2), 64.0, np.float32), np.zeros((2, 2), np.float32)
    step_seeds = [(seed + 7919 * (i + 1)) & 0x7FFFFFFF for i in range(n)]
    want = jax_model._get_jit_loop(True, interval)(
        jax_model.params["denoiser"], jnp.asarray(latents0), jnp.asarray(timesteps),
        jnp.asarray(sigmas[:n]), jnp.asarray(sigmas[1:]), jnp.asarray(step_seeds, jnp.int32),
        jnp.asarray(emb), jnp.asarray(pooled), jnp.asarray(sizes), jnp.asarray(sizes),
        jnp.asarray(crops), jnp.float32(cfg), jnp.float32(rescale),
    )
    from vision_ft_tpu.utils import tensor as jax_tensor_utils

    noises = [torch.from_numpy(np.array(jax_tensor_utils._incremental_seed_randn_jit(
        jnp.int32(s), latents0.shape, jnp.float32))) for s in step_seeds]
    t = lambda a: torch.from_numpy(a)
    with torch.inference_mode():
        got = port._denoise_loop(t(latents0), noises, timesteps, sigmas, t(emb), t(pooled),
                                 t(sizes), t(sizes), t(crops), cfg, rescale, True,
                                 deep_cache_interval=interval)
        plain = port._denoise_loop(t(latents0), noises, timesteps, sigmas, t(emb), t(pooled),
                                   t(sizes), t(sizes), t(crops), cfg, rescale, True)
    _close(got, want, LOOP_TOL, f"DeepCache loop, interval {interval}")
    assert not np.allclose(_np(got), _np(plain), atol=1e-3)  # the cache is not inert


def test_sdxl_generate_deep_cache_interval_one_is_the_plain_loop(sdxl):
    _, port, _ = sdxl
    kwargs = dict(width=64, height=64, num_inference_steps=3, cfg_scale=3.0, seed=9)
    plain = port.generate("a cat", **kwargs)[0]
    cached = port.generate("a cat", deep_cache_interval=1, **kwargs)[0]
    np.testing.assert_array_equal(np.asarray(cached), np.asarray(plain))
    other = port.generate("a cat", deep_cache_interval=2, **kwargs)[0]
    assert (np.asarray(other) != np.asarray(plain)).any()


def test_tiled_decode_matches_jax(sdxl):
    """Tiles of 8 latents (stride 6, a 16-pixel blend) over a 12 x 20 latent:
    both blends and the crop of the ragged last tiles run."""
    jax_model, port, _ = sdxl
    z = np.random.default_rng(5).standard_normal((1, 12, 20, 4)).astype(np.float32)
    want = jax_model.vae.tiled_decode(jax_model.params["vae"], jnp.asarray(z), tile_latent_size=8)
    with torch.inference_mode():
        got = port.vae.tiled_decode(torch.from_numpy(z), tile_latent_size=8)
        whole = port.vae.decode(torch.from_numpy(z))
    assert got.shape == whole.shape == (1, 96, 160, 3)
    _close(got, want, STEP_TOL, "tiled decode")
    # the first tile's rows and columns before any blend are the tile's own decode
    with torch.inference_mode():
        first = port.vae.decode(torch.from_numpy(z[:, :8, :8]))
    torch.testing.assert_close(got[:, :48, :48], first[:, :48, :48], rtol=0, atol=0)


def test_decode_image_tiles_at_1536_px(sdxl, monkeypatch):
    _, port, _ = sdxl
    calls = []
    tiled = port.vae.tiled_decode
    monkeypatch.setattr(port.vae, "tiled_decode", lambda z: calls.append(z.shape) or tiled(z, 8))
    with torch.inference_mode():
        images = port.decode_image(torch.zeros(1, 12, 10, 4), use_tiling=True)
    assert calls == [(1, 12, 10, 4)] and images[0].size == (80, 96)


# -- the pool against batch-1 generate() ------------------------------------------------


class _LatentsOut:
    """An adapter whose decode returns the finished latents (a copy)."""

    def decode(self, latent_row):
        return latent_row.clone()


class SDXLLatents(_LatentsOut, SDXLSlotAdapter):
    pass


class Lumina2Latents(_LatentsOut, Lumina2SlotAdapter):
    pass


class AuraFlowLatents(_LatentsOut, AuraFlowSlotAdapter):
    pass


class CogView4Latents(_LatentsOut, CogView4SlotAdapter):
    pass


def _generate_latents(model, request, size, **kwargs):
    """The final latents of the port's batch-1 generate() of ``request``."""
    captured = {}
    decode = model.decode_image

    def capture(latents, *args, **kw):
        captured["latents"] = latents.clone()
        return decode(latents, *args, **kw)

    model.decode_image = capture
    try:
        model.generate(request.prompt, negative_prompt=request.negative_prompt or None,
                       width=size, height=size, num_inference_steps=request.num_inference_steps,
                       cfg_scale=request.cfg_scale, seed=request.seed, **kwargs)
    finally:
        del model.decode_image
    return captured["latents"][0]


def _serve(engine, requests, start_after=None):
    """Submit each request from its own thread; ``start_after[i]`` (an
    event) holds request i back until it is set. Returns the results (an
    exception where one was raised)."""
    results = [None] * len(requests)

    def run(i):
        if start_after and start_after.get(i) is not None:
            assert start_after[i].wait(timeout=120)
        try:
            results[i] = engine.submit(requests[i])
        except Exception as exc:  # the test inspects it
            results[i] = exc

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    return results


FAMILY_REQUESTS = {
    "sdxl": [SlotRequest("a photo of a cat", "blurry", 3, cfg_scale=3.0, seed=42),
             SlotRequest("a painting of a dog", "", 5, cfg_scale=5.0, cfg_rescale=0.3, seed=7),
             SlotRequest("a city at night", "low quality", 4, cfg_scale=2.0, seed=1234)],
    "lumina2": [SlotRequest("a cat sitting on the sofa", "blurry", 3, cfg_scale=4.0, seed=1),
                SlotRequest("a red car", "", 5, cfg_scale=3.0, renorm_cfg=0.0, seed=9),
                SlotRequest("a photo of the sofa", "blurry", 4, cfg_scale=4.0,
                            cfg_trunc_ratio=0.5, seed=77)],
    "auraflow": [SlotRequest("a cat sitting", "blurry", 3, cfg_scale=4.0, seed=1),
                 SlotRequest("a red car", "", 5, cfg_scale=1.0, seed=9),
                 SlotRequest("a photo of the sofa", "blurry", 4, cfg_scale=2.5, seed=77)],
    "cogview4": [SlotRequest("a cat sitting on the sofa", "blurry", 3, cfg_scale=3.5, seed=1),
                 SlotRequest("a red car", "", 5, cfg_scale=1.0, seed=9),
                 SlotRequest("a photo of the sofa", "blurry photo", 4, cfg_scale=2.0, seed=77)],
}


@pytest.mark.parametrize("family", ["sdxl", "lumina2", "auraflow", "cogview4"])
def test_pool_matches_batch1_generate(request, family):
    """Three requests with other step counts, seeds and guidance through a
    pool of 2 slots (the third waits for a free slot) each give the latents
    of their own batch-1 generate()."""
    fixture = {"sdxl": "sdxl", "lumina2": "lumina", "auraflow": "aura",
               "cogview4": "cogview4"}[family]
    model = request.getfixturevalue(fixture)[1]
    size, adapter_kwargs = (64, {}) if family == "sdxl" else (32, {"max_token_length": 8})
    requests = FAMILY_REQUESTS[family]

    def generate_kwargs(r):
        if family == "sdxl":
            return {"cfg_rescale": r.cfg_rescale}
        if family == "lumina2":
            return {"renorm_cfg_scale": r.renorm_cfg, "cfg_truncation_ratio": r.cfg_trunc_ratio,
                    "max_token_length": 8}
        return {"max_token_length": 8}

    wants = [_generate_latents(model, r, size, **generate_kwargs(r)) for r in requests]
    adapter_class = {"sdxl": SDXLLatents, "lumina2": Lumina2Latents,
                     "auraflow": AuraFlowLatents, "cogview4": CogView4Latents}[family]
    engine = ContinuousBatcher(adapter_class(model, size, size, **adapter_kwargs), num_slots=2,
                               max_steps=8)
    try:
        results = _serve(engine, requests)
    finally:
        engine.close()
    for r, got, want in zip(requests, results, wants):
        assert isinstance(got, torch.Tensor), got
        _close(got, want, POOL_TOL, f"{family} {r.prompt!r}")
    assert engine.ticks >= 6  # 12 slot-steps on 2 slots


def test_staggered_admission_joins_mid_flight(sdxl):
    """A request that arrives during the pool's second tick joins at the next
    step boundary (the tick waits for it to be queued) and still gives its
    batch-1 generate()'s latents."""
    _, port, _ = sdxl
    first = SlotRequest("first request", num_inference_steps=6, cfg_scale=3.0, seed=11)
    second = SlotRequest("second request", num_inference_steps=3, cfg_scale=4.0, seed=22)
    ticked = threading.Event()

    class Staggered(SDXLLatents):
        ticks = 0

        def slot_step(self, *args):
            out = super().slot_step(*args)
            Staggered.ticks += 1
            if Staggered.ticks == 2:
                ticked.set()
                deadline = time.monotonic() + 60
                while not engine._queue and time.monotonic() < deadline:
                    time.sleep(0.001)
            return out

    engine = ContinuousBatcher(Staggered(port, 64, 64), num_slots=2, max_steps=8)
    try:
        results = _serve(engine, [first, second], start_after={1: ticked})
    finally:
        engine.close()
    for r, got in zip((first, second), results):
        _close(got, _generate_latents(port, r, 64), POOL_TOL, r.prompt)
    # the second ran from tick 3 on, beside the first (SDXL walks 7 timesteps for 6 steps)
    assert engine.ticks == len(port.scheduler.get_timesteps(6)) == 7


def test_more_requests_than_slots_and_random_seeds(sdxl):
    _, port, _ = sdxl
    engine = ContinuousBatcher(SDXLSlotAdapter(port, 64, 64), num_slots=1, max_steps=8)
    requests = [SlotRequest(f"prompt {i}", num_inference_steps=2, cfg_scale=2.0,
                            seed=None if i == 2 else i) for i in range(3)]
    try:
        results = _serve(engine, requests)
    finally:
        engine.close()
    assert all(im.size == (64, 64) for im in results)
    assert not np.array_equal(np.asarray(results[0]), np.asarray(results[1]))
    assert engine.ticks == 3 * len(port.scheduler.get_timesteps(2))  # one slot: one at a time


def test_step_and_schedule_length_checks(sdxl):
    """A request over max_steps is refused at submit; one whose schedule
    is longer than its step count (SDXL: 24 steps walk 25 timesteps) fails
    alone at admission while its neighbour completes; submit after close
    raises."""
    _, port, _ = sdxl
    adapter = SDXLSlotAdapter(port, 32, 32)
    assert len(adapter.schedule(SlotRequest("x", num_inference_steps=24))[0]) == 25
    engine = ContinuousBatcher(adapter, num_slots=2, max_steps=24)
    try:
        with pytest.raises(ValueError, match="exceeds engine max_steps"):
            engine.submit(SlotRequest("x", num_inference_steps=25))
        big, ok = _serve(engine, [SlotRequest("big", num_inference_steps=24, seed=1),
                                  SlotRequest("ok", num_inference_steps=2, cfg_scale=2.0,
                                              seed=1)])
    finally:
        engine.close()
    assert isinstance(big, ValueError) and "schedule length 25 exceeds" in str(big)
    assert ok.size == (32, 32)
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(SlotRequest("x", num_inference_steps=2))


def test_weight_swap_reaches_the_next_request(tmp_path):
    """The pool reads the denoiser's weights on every tick: weights loaded
    after the batcher is built shape the next request as they shape
    generate()."""
    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config, **kwargs)
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    request = SlotRequest("a cat", num_inference_steps=2, cfg_scale=3.0, seed=3)
    engine = ContinuousBatcher(SDXLLatents(model, 64, 64), num_slots=2, max_steps=4)
    try:
        before = engine.submit(request)
        torch.testing.assert_close(before, _generate_latents(model, request, 64), rtol=POOL_TOL,
                                   atol=POOL_TOL)
        swapped = {f"denoiser.{k}": v.numpy() * 1.5 for k, v in model.denoiser.state_dict().items()}
        with torch.no_grad():
            model.denoiser.load_state_dict({k[9:]: torch.from_numpy(v) for k, v in swapped.items()})
        after = engine.submit(request)
    finally:
        engine.close()
    want = _generate_latents(model, request, 64)
    assert not torch.allclose(after, before, atol=1e-3)
    torch.testing.assert_close(after, want, rtol=POOL_TOL, atol=POOL_TOL)


def test_a_failed_tick_fails_every_request_in_flight(sdxl):
    _, port, _ = sdxl

    class Exploding(SDXLSlotAdapter):
        def slot_step(self, *args):
            raise RuntimeError("boom")

    engine = ContinuousBatcher(Exploding(port, 32, 32), num_slots=2, max_steps=4)
    try:
        results = _serve(engine, [SlotRequest(f"p{i}", num_inference_steps=2, seed=i)
                                  for i in range(3)])
    finally:
        engine.close()
    assert all(isinstance(r, RuntimeError) and str(r) == "boom" for r in results)


# -- the scheduler's host logic, pinned exactly ------------------------------------------


class _TraceAdapter:
    """A model-free adapter of exact small-integer fp32 arithmetic.
    schedule(): timesteps 1..n, sigmas linspace(n, 0, n + 1), so a request's
    final value telescopes to seed % 97 + n * (len(prompt) + cfg): any mix-up
    of slots, tables or steps changes it. Every tick's vectors are recorded
    and replayed against each request's schedule."""

    latent_shape = (2, 2, 1)
    dtype = torch.float32
    device = torch.device("cpu")

    def __init__(self):
        self.ticks = []
        self.encode_groups = []

    def schedule(self, r):
        n = r.num_inference_steps
        return np.arange(1, n + 1, dtype=np.float32), np.linspace(n, 0.0, n + 1).astype(np.float32)

    def scalar_fields(self):
        return {"cfg_scale": (0.0, np.float32), "seed": (0, np.int64)}

    def request_scalars(self, r):
        return {"cfg_scale": r.cfg_scale}

    def encode(self, reqs):
        self.encode_groups.append([r.prompt for r in reqs])
        return [float(len(r.prompt)) for r in reqs]

    def blank_context(self, num_slots):
        return {"tok": torch.zeros(num_slots)}

    def write_slot(self, ctx, j, row):
        ctx["tok"][j] = row
        return ctx

    def init_latents(self, r, seed, sigmas):
        return torch.full(self.latent_shape, float(seed % 97))

    def slot_step(self, latents, ctx, t, sigma, next_sigma, idx, total, scalars, active, host):
        self.ticks.append({
            "t": t.numpy().copy(), "sigma": sigma.numpy().copy(),
            "next_sigma": next_sigma.numpy().copy(), "idx": idx.numpy().copy(),
            "host_idx": host["idx"].copy(), "seed": host["seed"].copy(),
            "total": total.numpy().copy(), "active": active.numpy().copy(),
            "tok": ctx["tok"].numpy().copy(), "cfg": scalars["cfg_scale"].numpy().copy(),
        })
        update = (sigma - next_sigma) * (ctx["tok"] + scalars["cfg_scale"])
        new = latents + update.view(-1, 1, 1, 1)
        return torch.where(active.view(-1, 1, 1, 1), new, latents)

    def decode(self, latent_row):
        return latent_row.numpy().copy()


def test_scheduler_tick_trace():
    """More requests than slots, mixed step counts and scalars: every final
    value is its telescoped schedule sum, and the recorded ticks show each
    request consuming its own (t, sigma, idx) rows in order, with the host's
    index and seed beside the card's."""
    adapter = _TraceAdapter()
    engine = ContinuousBatcher(adapter, num_slots=2, max_steps=8)
    requests = [SlotRequest("ab", num_inference_steps=3, cfg_scale=2.0, seed=5),
                SlotRequest("hello", num_inference_steps=5, cfg_scale=1.0, seed=11),
                SlotRequest("x", num_inference_steps=2, cfg_scale=4.0, seed=23)]
    try:
        results = _serve(engine, requests)
    finally:
        engine.close()
    for r, got in zip(requests, results):
        want = np.float32(r.seed % 97) + np.float32(r.num_inference_steps) * (
            np.float32(len(r.prompt)) + np.float32(r.cfg_scale))
        np.testing.assert_array_equal(got, np.full((2, 2, 1), want))

    by_tok = {}
    for tick in adapter.ticks:
        np.testing.assert_array_equal(tick["idx"][tick["active"]], tick["host_idx"][tick["active"]])
        for j in range(2):
            if tick["active"][j]:
                by_tok.setdefault(float(tick["tok"][j]), []).append(
                    (tick["idx"][j], tick["t"][j], tick["sigma"][j], tick["next_sigma"][j],
                     tick["cfg"][j], tick["total"][j], tick["seed"][j]))
    assert set(by_tok) == {float(len(r.prompt)) for r in requests}
    for r in requests:
        rows = by_tok[float(len(r.prompt))]
        n = r.num_inference_steps
        t_row, sig_row = adapter.schedule(r)
        assert [x[0] for x in rows] == list(range(n)), rows
        np.testing.assert_array_equal([x[1] for x in rows], t_row)
        np.testing.assert_array_equal([x[2] for x in rows], sig_row[:-1])
        np.testing.assert_array_equal([x[3] for x in rows], sig_row[1:])
        assert all(x[4] == np.float32(r.cfg_scale) and x[5] == n and x[6] == r.seed
                   for x in rows)
    seen = [p for group in adapter.encode_groups for p in group]
    assert sorted(seen) == sorted(r.prompt for r in requests)
