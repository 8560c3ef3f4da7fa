"""The port's Wan 2.2 slice against the JAX package's, on the CPU in fp32 at
the tiny configs tests/models/test_wan.py uses (a DiT of 2 blocks 64 wide,
4 heads of 16, text_len 16; a UMT5 of 2 layers 32 wide, 4 heads, 8
buckets): the configs, schedule and key converters, the RoPE tables, a
block, the denoiser with (B,) and (B, L) timesteps, its DeepCache and remat
paths, the masked text encoder and the prompt padding, ``generate()`` end
to end with a toy VAE and with the native one, the three-file checkpoint
and the video writer.

The JAX package's programs are jitted; its weights are seeded numpy draws
at the shapes of its init, traced and not run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vision_ft_tpu.models.wan import config as jax_config
from vision_ft_tpu.models.wan import scheduler as jax_scheduler
from vision_ft_tpu.models.wan import util as jax_util
from vision_ft_tpu.models.wan import vae as jax_vae
from vision_ft_tpu.models.wan.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.models.wan.denoiser import WanBlock as JaxBlock
from vision_ft_tpu.models.wan.pipeline import Wan22 as JaxWan22
from vision_ft_tpu.models.wan.text_encoder import TextEncoder as JaxTextEncoder
from vision_ft_tpu.models.wan.text_encoder import TextEncoderConfig as JaxT5Config
from vision_ft_tpu.models.wan.vae3d import CausalVAE as JaxCausalVAE
from vision_ft_tpu.models.wan.vae3d import WanVAEConfig as JaxVAEConfig
from vision_ft_tpu.nn import flatten_params, unflatten_params
from vision_ft_tpu.utils import tensor as jax_tensor

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.wan import config, scheduler, util, vae
from vision_ft_tpu_torch.models.wan.denoiser import Denoiser, WanBlock, rope_for_grid
from vision_ft_tpu_torch.models.wan.pipeline import Wan22
from vision_ft_tpu_torch.models.wan.text_encoder import (
    TextEncoder, TextEncoderConfig, tokenize_prompts,
)
from vision_ft_tpu_torch.models.wan.vae3d import CausalVAE, WanVAEConfig
from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd
from vision_ft_tpu_torch.ops.layer_norm import layer_norm
from vision_ft_tpu_torch.utils import safetensors as st
from vision_ft_tpu_torch.utils import tensor as tensor_utils
from vision_ft_tpu_torch.utils.video import write_images_as_temp_video, write_images_as_video
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import assert_offloaded_generate_is_plain

# fp32 on the CPU: a few blocks of O(1) activations summed in other orders by
# the two packages; relative to each tensor's max
TOL = 5e-5

TINY = dict(type="ti2v", in_channels=8, out_channels=8, hidden_dim=64, ffn_dim=128, freq_dim=32,
            text_dim=24, num_heads=4, num_layers=2, text_length=16, patch_size=(1, 2, 2))
TINY_T5 = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2,
               num_buckets=8, shared_pos=False, dropout=0.0)
TINY_VAE = dict(base_dim=8, decoder_base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                in_channels=12, out_channels=12, patch_size=2)


class Tok:
    """Stub T5 tokenizer: words to ids 3..62 and an end token 1, padded to
    the longest with 0 (pad_token_id), as the JAX package's tests inject one."""

    pad_token_id = 0

    def __call__(self, prompts, max_length=None, **kw):
        rows = [([3 + sum(map(ord, w)) % 60 for w in p.split()] + [1])[:max_length]
                for p in prompts]
        longest = max(len(r) for r in rows)
        return {"input_ids": [r + [0] * (longest - len(r)) for r in rows]}


class RaggedTok(Tok):
    """The same ids, each row as long as its prompt (no padding)."""

    def __call__(self, prompts, max_length=None, **kw):
        rows = super().__call__(prompts, max_length)["input_ids"]
        return {"input_ids": [[i for i in r if i] for r in rows]}


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: max err {err:.3e} > {tol} x {scale:.3e}"


def _jax_params(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def seeded(init, seed):
    """Seeded numpy weights at the shapes of a JAX ``init`` (traced, not
    run). Vectors named as norms are near one, other vectors small, weights
    of std 1 / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    shapes = flatten_params(jax.eval_shape(init, jax.random.PRNGKey(0)))
    flat = {}
    for key, leaf in sorted(shapes.items()):
        shape = tuple(leaf.shape)
        draw = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 1:
            is_norm = "norm" in key and not key.endswith(".bias")
            flat[key] = 1 + 0.1 * draw if is_norm else 0.05 * draw
        else:
            flat[key] = draw / np.sqrt(np.prod(shape[1:]))
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _port(cls, flat, *args):
    with torch.device("meta"):
        module = cls(*args)
    return tnn.load_flat_params(module, flat).eval()


@pytest.fixture(scope="module")
def denoisers():
    """The JAX denoiser, its params and jitted forward, and the port's
    denoiser on the same weights."""
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**TINY))
    flat = seeded(jax_model.init, 0)
    forward = jax.jit(lambda p, *a: jax_model(p, *a))
    model = _port(Denoiser, flat, config.DenoiserConfig(**TINY))
    return jax_model, _jax_params(flat), forward, model, flat


def _inputs(seed, per_token=False, grid=(2, 8, 12), ctx_len=5):
    """NFHWC latents, timesteps ((B,) or (B, L)) and a context shorter than
    text_len with zeroed rows past each sample's length."""
    rng = np.random.default_rng(seed)
    f, h, w = grid
    latents = rng.standard_normal((2, f, h, w, TINY["in_channels"])).astype(np.float32)
    seq = f * (h // 2) * (w // 2)
    t = (rng.uniform(0, 1000, (2, seq)) if per_token else np.array([500.0, 100.0]))
    context = rng.standard_normal((2, ctx_len, TINY["text_dim"])).astype(np.float32)
    context[1, 3:] = 0.0
    return latents, t.astype(np.float32), context


# -- configs, keys, schedules ------------------------------------------------------------


def test_configs_schedule_and_key_converters_match_jax():
    for port_cls, jax_cls in ((config.DenoiserConfig, jax_config.DenoiserConfig),
                              (config.Wan22TI2V5BDenoiserConfig,
                               jax_config.Wan22TI2V5BDenoiserConfig)):
        assert port_cls().model_dump() == jax_cls().model_dump()
    paths = dict(denoiser_path="d", text_encoder_path="t", vae_path="v")
    assert config.WanConfig(**paths).model_dump() == jax_config.WanConfig(**paths).model_dump()
    tiny = config.WanConfig(**paths, denoiser=TINY)  # the base class validates tiny ones
    assert tiny.denoiser.hidden_dim == 64 and type(tiny.denoiser) is config.DenoiserConfig
    assert TextEncoderConfig().model_dump() == JaxT5Config().model_dump()
    assert dataclasses.asdict(WanVAEConfig.from_default()) == dataclasses.asdict(
        JaxVAEConfig.from_default())
    assert vae.DEFAULT_VAE_CONFIG == jax_vae.DEFAULT_VAE_CONFIG
    assert (vae.LATENT_MEAN, vae.LATENT_STD) == (jax_vae.LATENT_MEAN, jax_vae.LATENT_STD)
    assert (vae.TEMPORAL_COMPRESSION_RATIO, vae.SPATIAL_COMPRESSION_RATIO, vae.LATENT_DIM) == (
        4, 16, 48)
    ours, theirs = scheduler.Scheduler(), jax_scheduler.Scheduler()
    for steps in (1, 8, 25, 50):
        np.testing.assert_array_equal(ours.get_timesteps(steps), theirs.get_timesteps(steps))
        np.testing.assert_array_equal(ours.get_sigmas(steps), theirs.get_sigmas(steps))
    for key in ("blocks.0.self_attn.q.weight", "model.blocks.0.self_attn.q.weight",
                "token_embedding.weight", "model.token_embedding.weight", "decoder.conv_in.bias"):
        for part in ("text_encoder", "denoiser", "vae"):
            assert util.convert_from_original_key(key, part) == \
                jax_util.convert_from_original_key(key, part)
            assert util.convert_to_original_key(key, part) == \
                jax_util.convert_to_original_key(key, part)


@pytest.mark.parametrize("which", ["denoiser", "denoiser_5b", "t5", "t5_published"])
def test_keys_and_shapes_match_jax(which):
    """The port's state_dict() keys and shapes are the JAX init's flattened
    params, at the tiny and the published widths."""
    jax_module, port_module = {
        "denoiser": (JaxDenoiser(jax_config.DenoiserConfig(**TINY)),
                     lambda: Denoiser(config.DenoiserConfig(**TINY))),
        "denoiser_5b": (JaxDenoiser(jax_config.Wan22TI2V5BDenoiserConfig()),
                        lambda: Denoiser(config.Wan22TI2V5BDenoiserConfig())),
        "t5": (JaxTextEncoder(JaxT5Config(**TINY_T5)),
               lambda: TextEncoder(TextEncoderConfig(**TINY_T5))),
        "t5_published": (JaxTextEncoder(JaxT5Config()), lambda: TextEncoder(TextEncoderConfig())),
    }[which]
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    with torch.device("meta"):
        model = port_module()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("grid", [(2, 4, 6), (12, 22, 22), (30, 22, 40)])
def test_rope_tables_match_jax(grid):
    """The three-axis tables at head dim 16 (tiny) and 128 (published): 49
    frames at 704 x 704 and 121 at 704 x 1280 among the grids."""
    for cfg in (TINY, {}):
        jax_model = JaxDenoiser(jax_config.DenoiserConfig(**cfg))
        cos, sin = rope_for_grid(grid, jax_model.dim // jax_model.num_heads)
        want_cos, want_sin = jax_model._rope_for_grid(grid)
        np.testing.assert_array_equal(cos, np.asarray(want_cos))
        np.testing.assert_array_equal(sin, np.asarray(want_sin))
    d = 128
    assert cos.shape == (grid[0] * grid[1] * grid[2], d // 2)  # 44 / 42 / 42 dims: 22, 21, 21 pairs


# -- the denoiser -----------------------------------------------------------------------


@pytest.mark.parametrize("per_token", [False, True])
def test_block_matches_jax(denoisers, per_token):
    """One block over the fp32 residual stream with RoPE, a timestep
    embedding a sample (B, 1, 6, D) or a token (B, L, 6, D), and an
    embedded context."""
    _, _, _, _, flat = denoisers
    jax_block = JaxBlock(64, 128, 4, 1e-6)
    block_flat = {k[len("blocks.0."):]: v for k, v in flat.items() if k.startswith("blocks.0.")}
    block = _port(WanBlock, block_flat, 64, 128, 4, 1e-6)
    rng = np.random.default_rng(3)
    grid = (2, 4, 6)
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    temb = rng.standard_normal((2, 48 if per_token else 1, 6, 64)).astype(np.float32) * 0.3
    ctx = rng.standard_normal((2, 16, 64)).astype(np.float32)
    cos, sin = rope_for_grid(grid, 16)
    want = jax.jit(lambda p, *a: jax_block(p, *a[:2], (a[2], a[3]), a[4]))(
        _jax_params(block_flat), *map(jnp.asarray, (x, temb, cos, sin, ctx)))
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(temb),
                    (torch.from_numpy(cos), torch.from_numpy(sin)), torch.from_numpy(ctx))
    _close(got, want, msg="block")


@pytest.mark.parametrize("per_token", [False, True])
def test_denoiser_forward_matches_jax(denoisers, per_token):
    """Batch 2 over a (2, 4, 6) token grid, a context shorter than text_len
    (zero-padded inside), timesteps (B,) or (B, L); the CPU path launches
    no kernel."""
    _, params, forward, model, _ = denoisers
    args = _inputs(0, per_token)
    want = forward(params, *map(jnp.asarray, args))
    before = flash_attention_bshd.launches, layer_norm.launches
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args))
    assert (flash_attention_bshd.launches, layer_norm.launches) == before
    assert got.dtype == torch.float32
    _close(got, want, msg="forward")


def test_remat_path_matches_jax(denoisers):
    """Gradient checkpointing: the forward with gradients is the JAX
    forward, its gradients are the plain path's and JAX's; set_pipeline
    raises by name."""
    jax_model, params, forward, model, _ = denoisers
    args = _inputs(1)
    want = forward(params, *map(jnp.asarray, args))

    def jax_loss(p, latents):
        return jnp.sum(jnp.square(jax_model(p, latents, *map(jnp.asarray, args[1:]))))

    jax_model.set_gradient_checkpointing(True)
    try:
        want_grad = jax.jit(jax.grad(jax_loss, argnums=1))(params, jnp.asarray(args[0]))
    finally:
        jax_model.set_gradient_checkpointing(False)
    grads = []
    for remat in (False, True):
        model.set_gradient_checkpointing(remat)
        x = torch.from_numpy(args[0]).requires_grad_(True)
        try:
            out = model(x, *map(torch.from_numpy, args[1:]))
        finally:
            model.set_gradient_checkpointing(False)
        _close(out, want, msg=f"remat {remat}")
        out.square().sum().backward()
        grads.append(x.grad)
    model.zero_grad(set_to_none=True)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)
    _close(grads[1], want_grad, tol=1e-4, msg="gradient")
    with pytest.raises(NotImplementedError, match="set_pipeline"):
        model.set_pipeline(object(), 2)
    model.set_pipeline(None, 1)


@pytest.mark.parametrize("cache_depth", [None, 2])
def test_deepcache_forward_matches_jax(cache_depth):
    """Three blocks, the cache split at the default (1) and at 2: a refresh
    step equals the plain forward and records the delta; a cached step at
    the next timestep reuses it, in both packages alike; the cached step
    really skips the deep blocks."""
    cfg = dict(TINY, num_layers=3)
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**cfg))
    flat = seeded(jax_model.init, 4)
    model = _port(Denoiser, flat, config.DenoiserConfig(**cfg))
    params = _jax_params(flat)
    args = list(_inputs(5, grid=(2, 8, 8), ctx_len=16))
    refresh = jax.jit(lambda p, *a: jax_model.deepcache_forward(
        p, *a, refresh=True, cache_depth=cache_depth))
    cached = jax.jit(lambda p, d, *a: jax_model.deepcache_forward(
        p, *a, cached_delta=d, refresh=False, cache_depth=cache_depth))
    want, want_delta = refresh(params, *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        plain = model(*targs)
        full, delta = model.deepcache_forward(*targs, cache_depth=cache_depth)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)
    _close(full, want, msg="refresh")
    _close(delta, want_delta, msg="delta")

    args[1] = args[1] - 50.0  # the next step's time
    want_next, _ = cached(params, want_delta, *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        reused, delta_out = model.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                                    cache_depth=cache_depth)
    assert delta_out is delta
    _close(reused, want_next, msg="cached")

    poisoned = _port(Denoiser, {k: np.full_like(v, np.nan) if k.startswith("blocks.2.") else v
                                for k, v in flat.items()}, config.DenoiserConfig(**cfg))
    with torch.no_grad():
        bad, _ = poisoned.deepcache_forward(*targs, cache_depth=cache_depth)
        clean, _ = poisoned.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                              cache_depth=cache_depth)
    assert not torch.isfinite(bad).all() and torch.isfinite(clean).all()
    with pytest.raises(ValueError, match="cache_depth"):
        model.deepcache_forward(*targs, cache_depth=3)


# -- the text encoder and the prompts ------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    jax_model = JaxTextEncoder(JaxT5Config(**TINY_T5), tokenizer=Tok())
    flat = seeded(jax_model.init, 6)
    model = _port(TextEncoder, flat, TextEncoderConfig(**TINY_T5))
    model.tokenizer = Tok()
    return jax_model, _jax_params(flat), model, flat


def test_text_encoder_matches_jax_masked(encoders):
    """Ids with padding masked at two lengths, per-block position bias,
    unscaled logits, the gated FFN; the CPU path launches no kernel."""
    jax_model, params, model, _ = encoders
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 64, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[0, 7:] = 0
    mask[1, 4:] = 0
    want = jax_model.encode_tokens(params, jnp.asarray(ids), jnp.asarray(mask))
    before = layer_norm.launches
    with torch.no_grad():
        got = model.encode_tokens(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert layer_norm.launches == before
    _close(got, want, msg="encoder")


def test_prompt_padding_repair_matches_jax(encoders):
    """A tokenizer that pads leaves equal rows, which both packages take
    alike; one that leaves the rows ragged (the JAX package's
    ``np.asarray`` raises) is padded on the right and masked, which gives
    the JAX result of the padded rows."""
    jax_model, params, model, _ = encoders
    prompts, negative = ["a cat running through the tall grass"], "blurry"
    want = jax_model.encode_prompts(params, prompts, negative, use_negative_prompts=True)
    with pytest.raises(ValueError):
        JaxTextEncoder(JaxT5Config(**TINY_T5), tokenizer=RaggedTok()).encode_prompts(
            params, prompts, negative, use_negative_prompts=True)
    for tokenizer in (Tok(), RaggedTok()):
        model.tokenizer = tokenizer
        with torch.no_grad():
            got = model.encode_prompts(prompts, negative, use_negative_prompts=True)
        for ours, theirs in zip(got, want):
            assert ours.shape == theirs.shape
        np.testing.assert_array_equal(got.positive_attention_mask.numpy(),
                                      np.asarray(want.positive_attention_mask))
        np.testing.assert_array_equal(got.negative_attention_mask.numpy(),
                                      np.asarray(want.negative_attention_mask))
        _close(got.positive_embeddings, want.positive_embeddings, msg="positive")
        _close(got.negative_embeddings, want.negative_embeddings, msg="negative")
    model.tokenizer = Tok()

    class Left(RaggedTok):
        padding_side = "left"
        pad_token_id = 5

    ids, mask = tokenize_prompts(Left(), ["a b c", "a"], 512)
    assert ids.shape == (2, 4) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids[1, :2], [5, 5])
    np.testing.assert_array_equal(mask, [[1, 1, 1, 1], [0, 0, 1, 1]])

    class WithMask(RaggedTok):
        def __call__(self, prompts, max_length=None, **kw):
            rows = super().__call__(prompts, max_length)["input_ids"]
            return {"input_ids": rows, "attention_mask": [[1] * len(r) for r in rows]}

    ids, mask = tokenize_prompts(WithMask(), ["a b c", "a"], 512)
    np.testing.assert_array_equal(mask, [[1, 1, 1, 1], [1, 1, 0, 0]])
    np.testing.assert_array_equal(ids[1, 2:], [0, 0])


# -- generate() and the checkpoint ---------------------------------------------------------


class PortToyVAE(vae.VAE):
    """Shape-correct stand-in VAE (the port's side); records what it decodes."""

    def encode(self, video):
        b, f, h, w, _ = video.shape
        return torch.zeros(b, (f - 1) // 4 + 1, h // 16, w // 16, 48, dtype=video.dtype)

    def decode(self, latents):
        self.latents = latents.clone()
        video = latents[..., :3].repeat_interleave(16, 2).repeat_interleave(16, 3)
        return torch.tanh(video.repeat_interleave(4, 1))


class JaxToyVAE(jax_vae.VAE):
    def decode(self, latents):
        self.latents = latents
        video = jnp.repeat(jnp.repeat(latents[..., :3], 16, axis=2), 16, axis=3)
        return jnp.tanh(jnp.repeat(video, 4, axis=1))


def _pipelines(tmp_path, in_channels=48, port_vae=None, jax_vae_model=None, seed=8):
    """Both packages' Wan22 on the same seeded weights (fp32, the tiny DiT
    on ``in_channels`` latents, the tiny UMT5), noise made from ``seed``
    handed to both."""
    den = dict(TINY, in_channels=in_channels, out_channels=in_channels, text_dim=32)
    paths = dict(denoiser_path=str(tmp_path / "denoiser.safetensors"),
                 text_encoder_path=str(tmp_path / "text_encoder.safetensors"),
                 vae_path=str(tmp_path / "vae.safetensors"), dtype="float32")
    jax_model = JaxWan22(jax_config.WanConfig(**paths, denoiser=jax_config.DenoiserConfig(**den)),
                         tokenizer=Tok(), text_encoder_config=JaxT5Config(**TINY_T5),
                         vae=jax_vae_model or JaxToyVAE())
    flat = {f"denoiser.{k}": v for k, v in seeded(jax_model.denoiser.init, seed).items()}
    flat.update({f"text_encoder.{k}": v
                 for k, v in seeded(jax_model.text_encoder.init, seed + 1).items()})
    jax_model.params = {part: _jax_params({k[len(part) + 1:]: v for k, v in flat.items()
                                           if k.startswith(part + ".")})
                        for part in ("denoiser", "text_encoder")}
    model = Wan22(config.WanConfig(**paths, denoiser=config.DenoiserConfig(**den)),
                  tokenizer=Tok(), text_encoder_config=TextEncoderConfig(**TINY_T5),
                  vae=port_vae or PortToyVAE())
    for part in ("denoiser", "text_encoder"):
        tnn.load_flat_params(getattr(model, part), {k[len(part) + 1:]: v for k, v in flat.items()
                                                    if k.startswith(part + ".")}).eval()

    jax_prepare = jax_model.prepare_latents

    def hand_noise(b, frames, height, width, seed=None):
        shape = jax_prepare(b, frames, height, width, seed=0).shape
        noise = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        return noise

    jax_model.prepare_latents = lambda *a, seed=None: jnp.asarray(hand_noise(*a, seed=seed))
    real_prepare = model.prepare_latents
    model.prepare_latents = lambda *a, seed=None: torch.from_numpy(hand_noise(*a, seed=seed))
    return jax_model, model, real_prepare


def test_generate_matches_jax_toy_vae(tmp_path, monkeypatch):
    """``generate()`` at 32 x 32, 4 frames (one latent frame), 2 steps,
    CFG 5, two prompts of unequal length against one negative: the final
    latents and the frames match; DeepCache with interval 1 is the plain
    result bit for bit and interval 2 matches JAX's; the frame arithmetic
    is kept (frames // 4 * 4, then (f - 1) // 4 + 1 latent frames); an
    offloaded request (the first, then one from the host) is the plain one
    bit for bit, the text encoder and the denoiser parked (the VAE is not
    staged, as in the JAX package)."""
    jax_model, model, real_prepare = _pipelines(tmp_path)
    kwargs = dict(prompt=["a cat running", "a red car on the road"], negative_prompt="blurry",
                  frames=4, width=32, height=32, num_inference_steps=2, cfg_scale=5.0, seed=3)
    want = jax_model.generate(**kwargs)
    videos = model.generate(**kwargs)
    _close(model.vae.latents, jax_model.vae.latents, msg="latents")
    assert len(videos) == 2 and all(len(v) == 4 for v in videos)
    assert videos[0][0].size == (32, 32)
    for ours, theirs in zip(videos, want):
        for a, b in zip(ours, theirs):
            assert np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max() <= 1
    plain = model.vae.latents
    model.generate(**kwargs, deep_cache_interval=1)
    torch.testing.assert_close(model.vae.latents, plain, rtol=0, atol=0)
    jax_model.generate(**dict(kwargs, num_inference_steps=3), deep_cache_interval=2)
    model.generate(**dict(kwargs, num_inference_steps=3), deep_cache_interval=2)
    _close(model.vae.latents, jax_model.vae.latents, msg="DeepCache latents")
    for frames, latent_frames in ((4, 1), (5, 1), (8, 2), (16, 4), (49, 12)):
        assert real_prepare(1, frames, 32, 32, seed=0).shape == (1, latent_frames, 2, 2, 48)
    with pytest.raises(ValueError, match="divisible"):
        Wan22(model.config.model_copy(update={"denoiser": config.DenoiserConfig(
            **dict(TINY, in_channels=48, patch_size=(2, 2, 2)))}), tokenizer=Tok(),
            text_encoder_config=TextEncoderConfig(**TINY_T5),
            vae=PortToyVAE()).prepare_latents(1, 4, 32, 32, seed=0)
    assert_offloaded_generate_is_plain(
        monkeypatch, model, lambda **kw: model.generate(**kwargs, **kw), ("text_encoder", "denoiser"))


def test_generate_matches_jax_native_vae(tmp_path):
    """The whole video path through the native causal VAE (tiny config, 4
    latent channels) in both packages on the same weights: 8 frames give 2
    latent frames, which decode to 5."""
    jax_vae_model = JaxCausalVAE(JaxVAEConfig(**TINY_VAE))
    vae_flat = seeded(jax_vae_model.init, 10)
    jax_vae_model.load_state_dict({k: jnp.asarray(v) for k, v in vae_flat.items()})
    with torch.device("meta"):
        port_vae = CausalVAE(WanVAEConfig(**TINY_VAE))
    port_vae.load_weights(vae_flat, "cpu")
    jax_model, model, _ = _pipelines(tmp_path, 4, port_vae, jax_vae_model, seed=11)
    kwargs = dict(prompt="a cat running", frames=8, width=32, height=32,
                  num_inference_steps=2, cfg_scale=5.0, seed=1)
    want = jax_model.generate(**kwargs)
    videos = model.generate(**kwargs)
    assert len(videos) == 1 and len(videos[0]) == 5 and videos[0][0].size == (32, 32)
    got = np.stack([np.asarray(im, np.int16) for im in videos[0]])
    ref = np.stack([np.asarray(im, np.int16) for im in want[0]])
    assert np.abs(got - ref).max() <= 1


def test_three_file_checkpoint_matches_jax(tmp_path):
    """The port writes the three files (the denoiser's keys under
    ``model.``, the text encoder's without, the VAE's own); the JAX
    package and the port's from_checkpoint read them back: every tensor
    and a denoise step are the same; a bf16 model reads every file in bf16
    and keeps the VAE in fp32."""
    jax_vae_model = JaxCausalVAE(JaxVAEConfig(**TINY_VAE))
    vae_flat = seeded(jax_vae_model.init, 12)
    with torch.device("meta"):
        port_vae = CausalVAE(WanVAEConfig(**TINY_VAE))
    port_vae.load_weights(vae_flat, "cpu")
    _, model, _ = _pipelines(tmp_path, 4, port_vae, seed=13)
    cfg = model.config
    st.save_file(model.denoiser_state_dict(), cfg.denoiser_path)
    st.save_file(model.text_encoder_state_dict(), cfg.text_encoder_path)
    st.save_file(model.vae.state_dict(), cfg.vae_path)
    assert all(k.startswith("model.") for k in st.read_keys(cfg.denoiser_path))
    assert not any(k.startswith("model.") for k in st.read_keys(cfg.text_encoder_path))

    def fresh_vae():
        with torch.device("meta"):
            return CausalVAE(WanVAEConfig(**TINY_VAE))

    loaded = Wan22.from_checkpoint(cfg, tokenizer=Tok(), device="cpu",
                                   text_encoder_config=TextEncoderConfig(**TINY_T5),
                                   vae=fresh_vae())
    for name in ("denoiser", "text_encoder", "vae"):
        want, got = getattr(model, name).state_dict(), getattr(loaded, name).state_dict()
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)

    jax_model = JaxWan22(jax_config.WanConfig(**cfg.model_dump(exclude={"denoiser"}),
                                              denoiser=jax_config.DenoiserConfig(
                                                  **cfg.denoiser.model_dump())),
                         tokenizer=Tok(), text_encoder_config=JaxT5Config(**TINY_T5),
                         vae=JaxCausalVAE(JaxVAEConfig(**TINY_VAE)))
    jax_model._from_checkpoint()
    rng = np.random.default_rng(14)
    latents = rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    context = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = jax_model._denoise_step(jax_model.params["denoiser"], jnp.asarray(latents),
                                   jnp.float32(800.0), jnp.float32(0.8), jnp.float32(0.7),
                                   jnp.asarray(context), jnp.float32(5.0), do_cfg=True)
    with torch.no_grad():
        got = loaded._denoise_step(torch.from_numpy(latents), 800.0, 0.8, 0.7,
                                   torch.from_numpy(context), 5.0, do_cfg=True)
    _close(got, want, msg="denoise step")
    video = np.random.default_rng(15).uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    _close(loaded.encode_video(torch.from_numpy(video)),
           jax_model.vae.normalize_latents(jax_model.vae.encode(jnp.asarray(video))),
           msg="encode_video")

    half = Wan22.from_checkpoint(cfg.model_copy(update={"dtype": "bfloat16"}), tokenizer=Tok(),
                                 device="cpu", text_encoder_config=TextEncoderConfig(**TINY_T5),
                                 vae=fresh_vae())
    assert half.denoiser.blocks[0].self_attn.q.weight.dtype == torch.bfloat16
    assert half.text_encoder.model.norm.weight.dtype == torch.bfloat16
    vae_weight = half.vae.decoder.conv_in.weight
    assert vae_weight.dtype == torch.float32
    torch.testing.assert_close(vae_weight, model.vae.decoder.conv_in.weight.bfloat16().float(),
                               rtol=0, atol=0)


def test_init_params_and_an_unloaded_vae(tmp_path):
    """Seeded init on a generator: every part materialized in the model's
    dtype, the modulation tables N(0, 1) / sqrt(dim), the same seed the
    same weights; a VAE left on the meta device raises by name."""
    models = []
    for _ in range(2):
        m = Wan22(config.WanConfig(denoiser_path="", text_encoder_path="", vae_path="",
                                   dtype="float32", denoiser=config.DenoiserConfig(**TINY)),
                  tokenizer=Tok(), text_encoder_config=TextEncoderConfig(**TINY_T5))
        m.init_params(torch.Generator().manual_seed(0))
        models.append(m)
    a, b = (m.denoiser.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(t.is_meta for t in models[0].denoiser.state_dict().values())
    mod = models[0].denoiser.blocks[0].modulation
    assert mod.shape == (1, 6, 64) and 0.05 < float(mod.detach().std()) < 0.25
    assert float(models[0].denoiser.patch_embedding.bias.detach().abs().max()) == 0.0
    with pytest.raises(RuntimeError, match="no params"):
        models[0].vae.decode(torch.zeros(1, 1, 2, 2, 48))


# -- video helpers -----------------------------------------------------------------------


def test_video_writer_and_tensor_helpers(tmp_path):
    """Four frames to an mp4 that OpenCV reads back as four 16 x 16
    frames; the temp-file writer; videos <-> tensors as in the JAX
    package."""
    import cv2

    frames = [Image.fromarray(np.full((16, 16, 3), i * 40, np.uint8)) for i in range(4)]
    path = str(tmp_path / "out.mp4")
    write_images_as_video(frames, path, fps=8)
    capture = cv2.VideoCapture(path)
    read = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        read.append(frame)
    capture.release()
    assert len(read) == 4 and read[0].shape == (16, 16, 3)
    temp = write_images_as_temp_video(frames, fps=8)
    try:
        with open(temp, "rb") as f:
            assert len(f.read()) > 0
    finally:
        import os

        os.unlink(temp)

    rng = np.random.default_rng(16)
    videos = [[Image.fromarray(rng.integers(0, 255, (8, 12, 3), dtype=np.uint8))
               for _ in range(3)] for _ in range(2)]
    got = tensor_utils.videos_to_tensor(videos)
    want = jax_tensor.videos_to_tensor(videos)
    assert got.shape == (2, 3, 8, 12, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tensor_utils.tensor_to_videos(got)
    assert [[np.asarray(im).tolist() for im in v] for v in back] == \
        [[np.asarray(im).tolist() for im in v] for v in jax_tensor.tensor_to_videos(want)]
