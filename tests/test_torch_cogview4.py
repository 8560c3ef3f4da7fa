"""The port's CogView4 slice against the JAX package's, on the CPU in fp32 at
the tiny config tests/models/test_cogview4.py uses (2 blocks 64 wide, 4
heads of 16, RoPE axes [16, 16]; a 2-layer GLM 40 wide): GLM, the prompt
API's padding, the denoiser with and without RoPE, its remat and DeepCache
paths, the schedule, the single-file checkpoint and ``generate()`` from the
same weights and the same noise.

The JAX package's programs are jitted (its eager dispatch compiles op by op
and costs far more on the CPU); its weights are seeded numpy draws at the
shapes of its init, traced and not run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.cogview4 import config as jax_config
from vision_ft_tpu.models.cogview4 import pipeline as jax_pipeline
from vision_ft_tpu.models.cogview4 import scheduler as jax_scheduler
from vision_ft_tpu.models.cogview4 import vae as jax_vae
from vision_ft_tpu.models.cogview4.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.models.cogview4.denoiser import TransformerBlock as JaxBlock
from vision_ft_tpu.models.cogview4.denoiser import _rope_freqs as jax_rope_freqs
from vision_ft_tpu.models.text_encoders import glm as jax_glm
from vision_ft_tpu.nn import flatten_params, unflatten_params

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.cogview4 import config as cv_config
from vision_ft_tpu_torch.models.cogview4 import pipeline, scheduler
from vision_ft_tpu_torch.models.cogview4 import vae as cv_vae
from vision_ft_tpu_torch.models.cogview4.denoiser import Denoiser, TransformerBlock, _rope_tables
from vision_ft_tpu_torch.models.cogview4.pipeline import CogView4Model
from vision_ft_tpu_torch.models.cogview4.text_encoder import pad_token_ids
from vision_ft_tpu_torch.models.text_encoders import glm
from vision_ft_tpu_torch.ops.flash_attention import flash_attention_bshd
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import assert_offloaded_generate_is_plain

# fp32 on the CPU: a few transformer blocks of O(1) activations summed in
# other orders by the two packages; relative to each tensor's max
TOL = 5e-5

TINY = dict(patch_size=2, in_channels=4, out_channels=4, num_layers=2, attention_head_dim=16,
            num_attention_heads=4, text_embed_dim=40, time_embed_dim=32, condition_dim=8,
            rope_axes_dim=[16, 16])
GLM = dict(vocab_size=256, hidden_size=40, intermediate_size=48, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16)
VAE = dict(block_out_channels=(8, 8, 16, 16), latent_channels=4, norm_num_groups=4,
           use_quant_conv=False, mid_block_add_attention=False, scaling_factor=1.0,
           shift_factor=0.0)
PROMPTS = ["a cat sitting on the sofa", "a red car"]


class GlmTok:
    """Stub GLM tokenizer: words to ids 3..252, padded to the longest with 0
    (pad_token_id), as the JAX package's tests inject one."""

    pad_token_id = 0

    def __call__(self, prompts, max_length=None, **kw):
        rows = [[3 + sum(map(ord, w)) % 250 for w in p.split()][:max_length] for p in prompts]
        longest = max(len(r) for r in rows)
        return {"input_ids": [r + [0] * (longest - len(r)) for r in rows]}


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: max err {err:.3e} > {tol} x {scale:.3e}"


def _jax_params(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def seeded(module, seed):
    """Seeded numpy weights at the shapes of ``module``'s JAX init (traced,
    not run). Vectors named as norms are near one, other vectors small,
    weights of std 1 / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    shapes = flatten_params(jax.eval_shape(module.init, jax.random.PRNGKey(0)))
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


def _port_denoiser(flat, **overrides):
    with torch.device("meta"):
        model = Denoiser(cv_config.DenoiserConfig(**dict(TINY, **overrides)))
    return tnn.load_flat_params(model, flat).eval()


@pytest.fixture(scope="module")
def denoisers():
    """The JAX denoiser, its params, its jitted forward and the port's
    denoiser on the same weights."""
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**TINY, attention_backend="eager"))
    flat = seeded(jax_model, 0)
    forward = jax.jit(lambda p, *a: jax_model(p, *a))
    return jax_model, _jax_params(flat), forward, _port_denoiser(flat), flat


def _inputs(seed, shape=(2, 8, 12, 4), txt_len=6):
    rng = np.random.default_rng(seed)
    b = shape[0]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((b, txt_len, TINY["text_embed_dim"])).astype(np.float32),
            rng.uniform(1.0, 1000.0, b).astype(np.float32),
            rng.uniform(32, 1024, (b, 2)).round().astype(np.float32),
            rng.uniform(32, 1024, (b, 2)).round().astype(np.float32),
            rng.uniform(0, 64, (b, 2)).round().astype(np.float32))


# -- configs, keys, schedules ------------------------------------------------------------


def test_configs_and_schedule_match_jax():
    assert cv_config.DenoiserConfig().model_dump() == jax_config.DenoiserConfig().model_dump()
    assert (cv_config.CogView4Config(checkpoint_path="x").model_dump()
            == jax_config.CogView4Config(checkpoint_path="x").model_dump())
    assert dataclasses.asdict(glm.COGVIEW4_GLM_CONFIG) == dataclasses.asdict(
        jax_glm.COGVIEW4_GLM_CONFIG)
    assert vars(cv_vae.DEFAULT_VAE_CONFIG) == vars(jax_vae.DEFAULT_VAE_CONFIG)
    assert (cv_vae.VAE.scaling_factor, cv_vae.VAE.shift_factor) == (1.0, 0.0)
    for seq in (16, 256, 2304, 4096, 4500):
        assert scheduler.calculate_time_shift(seq) == jax_scheduler.calculate_time_shift(seq)
    for key in ("diffusion_model.transformer_blocks.0.attn1.to_q.weight",
                "text_encoder.layers.1.mlp.gate_up_proj.weight", "vae.decoder.conv_in.bias"):
        internal = pipeline.convert_from_original_key(key)
        assert internal == jax_pipeline.convert_from_original_key(key)
        assert pipeline.convert_to_original_key(internal) == key
    assert pipeline.convert_to_comfy_key is pipeline.convert_to_original_key


def test_denoiser_and_glm_keys_and_shapes_match_jax():
    for jax_module, port_module in (
            (JaxDenoiser(jax_config.DenoiserConfig(**TINY)),
             lambda: Denoiser(cv_config.DenoiserConfig(**TINY))),
            (JaxDenoiser(jax_config.DenoiserConfig()), lambda: Denoiser(cv_config.DenoiserConfig())),
            (jax_glm.GlmModel(jax_glm.GlmConfig(**GLM)), lambda: glm.GlmModel(glm.GlmConfig(**GLM))),
            (jax_glm.GlmModel(jax_glm.COGVIEW4_GLM_CONFIG),
             lambda: glm.GlmModel(glm.COGVIEW4_GLM_CONFIG))):
        shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
        with torch.device("meta"):
            model = port_module()
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("height,width", [(8, 12), (128, 128), (96, 152)])
def test_rope_tables_match_jax(height, width):
    for head_dim, axes in ((16, [16, 16]), (128, [256, 256])):
        cos, sin = _rope_tables(height, width, 2, head_dim, tuple(axes))
        want_cos, want_sin = jax_rope_freqs(height, width, 2, head_dim, axes)
        np.testing.assert_array_equal(cos, np.asarray(want_cos))
        np.testing.assert_array_equal(sin, np.asarray(want_sin))


# -- GLM and the prompt API -----------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_glm_matches_jax(masked):
    """Both outputs (the final normed state and the penultimate one), with
    and without a padding mask."""
    jax_model = jax_glm.GlmModel(jax_glm.GlmConfig(**GLM))
    flat = seeded(jax_model, 1)
    with torch.device("meta"):
        model = glm.GlmModel(glm.GlmConfig(**GLM))
    tnn.load_flat_params(model, flat).eval()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (2, 13)).astype(np.int32)
    mask = np.ones((2, 13), np.int32)
    mask[1, :5] = 0
    forward = jax.jit(lambda p, i, m: jax_model(p, i, m))
    want = forward(_jax_params(flat), jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask) if masked else None)
    for ours, theirs, name in zip(got, want, ("final", "penultimate")):
        _close(ours, theirs, msg=name)


def test_pad_token_ids_match_jax_padding():
    """Longest, then left padding to a multiple of 16 with the pad id; rows
    a tokenizer leaves unequal are padded to the longest first, on its
    ``padding_side`` (right where it names none)."""
    ids = pad_token_ids(GlmTok(), PROMPTS, 1024)
    assert ids.shape == (2, 16) and ids.dtype == np.int32
    # 6 and 3 words: the stub pads the second row on the right, then 10 to the left
    assert (ids[:, :10] == 0).all() and (ids[0, 10:] != 0).all()
    assert (ids[1, 10:13] != 0).all() and (ids[1, 13:] == 0).all()

    class Ragged:
        pad_token_id = 7

        def __call__(self, prompts, **kw):
            return {"input_ids": [[1] * (3 + 14 * i) for i in range(len(prompts))]}

    ragged = pad_token_ids(Ragged(), ["a", "b"], 1024)
    assert ragged.shape == (2, 32)
    np.testing.assert_array_equal(ragged[0], [7] * 15 + [1] * 3 + [7] * 14)
    np.testing.assert_array_equal(ragged[1], [7] * 15 + [1] * 17)
    exact = pad_token_ids(Ragged(), ["a"] * 1, 1024)  # 3 tokens -> 16
    assert exact.shape == (1, 16)
    Ragged.padding_side = "left"
    left = pad_token_ids(Ragged(), ["a", "b"], 1024)
    np.testing.assert_array_equal(left[0], [7] * 29 + [1] * 3)
    np.testing.assert_array_equal(left[1], ragged[1])


# -- the denoiser -----------------------------------------------------------------------


def test_denoiser_forward_matches_jax(denoisers):
    """A non-square latent (8 x 12: 24 patches), batch 2, per-row times and
    sizes; the CPU path launches no kernel."""
    _, params, forward, model, _ = denoisers
    args = _inputs(0)
    want = forward(params, *map(jnp.asarray, args))
    before = flash_attention_bshd.launches
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args))
    assert flash_attention_bshd.launches == before
    _close(got, want, msg="forward")


@pytest.mark.parametrize("rope", [True, False])
def test_block_matches_jax_with_and_without_rope(denoisers, rope):
    """One transformer block over [text | image], the image tokens rotated
    by the 2-axis tables or left as they are (``rope_freqs`` None)."""
    _, _, _, _, flat = denoisers
    jax_block = JaxBlock(64, 4, 32, "eager")
    block_flat = {k[len("transformer_blocks.0."):]: v for k, v in flat.items()
                  if k.startswith("transformer_blocks.0.")}
    with torch.device("meta"):
        block = TransformerBlock(64, 4, 32, "flash")
    tnn.load_flat_params(block, block_flat).eval()
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 24, 64)).astype(np.float32)
    c = rng.standard_normal((2, 6, 64)).astype(np.float32)
    emb = rng.standard_normal((2, 32)).astype(np.float32)
    cos, sin = _rope_tables(8, 12, 2, 16, (16, 16))
    jax_rope = (jnp.asarray(cos), jnp.asarray(sin)) if rope else None
    want = jax.jit(lambda p, *a: jax_block(p, *a, jax_rope))(
        _jax_params(block_flat), *map(jnp.asarray, (h, c, emb)))
    with torch.no_grad():
        got = block(*map(torch.from_numpy, (h, c, emb)),
                    (torch.from_numpy(cos), torch.from_numpy(sin)) if rope else None)
    _close(got[0], want[0], msg="image stream")
    _close(got[1], want[1], msg="text stream")


def test_remat_path_matches_jax(denoisers):
    """Gradient checkpointing: the forward with gradients is the JAX
    forward, and its gradients are the plain path's; set_pipeline raises
    by name."""
    _, params, forward, model, _ = denoisers
    args = _inputs(1)
    want = forward(params, *map(jnp.asarray, args))
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
    with pytest.raises(NotImplementedError, match="set_pipeline"):
        model.set_pipeline(object(), 2)
    model.set_pipeline(None, 1)


@pytest.mark.parametrize("cache_depth", [None, 2])
def test_deepcache_forward_matches_jax(cache_depth):
    """Three blocks, the cache split at the default (1) and at 2: a refresh
    step equals the plain forward and records the delta; a cached step at
    the next timestep reuses it, in both packages alike; the cached step
    really skips the deep blocks."""
    config = dict(TINY, num_layers=3)
    jax_model = JaxDenoiser(jax_config.DenoiserConfig(**config, attention_backend="eager"))
    flat = seeded(jax_model, 4)
    model = _port_denoiser(flat, num_layers=3)
    params = _jax_params(flat)
    args = list(_inputs(5, shape=(2, 8, 8, 4)))
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

    args[2] = args[2] - 50.0  # the next step's time
    want_next, _ = cached(params, want_delta, *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        reused, delta_out = model.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                                    cache_depth=cache_depth)
    assert delta_out is delta
    _close(reused, want_next, msg="cached")

    poisoned = _port_denoiser({
        k: np.full_like(v, np.nan) if k.startswith("transformer_blocks.2.") else v
        for k, v in flat.items()}, num_layers=3)
    with torch.no_grad():
        bad, _ = poisoned.deepcache_forward(*targs, refresh=True, cache_depth=cache_depth)
        clean, _ = poisoned.deepcache_forward(*targs, cached_delta=delta, refresh=False,
                                              cache_depth=cache_depth)
        with pytest.raises(ValueError):
            model.deepcache_forward(*targs, cache_depth=3)
        with pytest.raises(ValueError):
            model.deepcache_forward(*targs, refresh=False)
    assert not torch.isfinite(bad).all() and torch.isfinite(clean).all()


# -- the pipeline -------------------------------------------------------------------


def port_pipeline(flat=None, tokenizer=None, device="cpu", dtype="float32"):
    model = CogView4Model(
        cv_config.CogView4Config(checkpoint_path="", dtype=dtype,
                                 denoiser=cv_config.DenoiserConfig(**TINY)),
        tokenizer=tokenizer or GlmTok(), vae_config=AutoencoderKLConfig(**VAE),
        text_encoder_config=glm.GlmConfig(**GLM),
    )
    if flat is not None:
        model.load_state_dict(flat, device=device)
    return model


def jax_pipeline_model(tokenizer=None):
    return jax_pipeline.CogView4Model(
        jax_config.CogView4Config(checkpoint_path="unused", dtype="float32",
                                  denoiser=jax_config.DenoiserConfig(**TINY,
                                                                     attention_backend="eager")),
        tokenizer=tokenizer or GlmTok(), vae_config=JaxVAEConfig(**VAE),
        text_encoder_config=jax_glm.GlmConfig(**GLM),
    )


def pipeline_weights(jax_model):
    """Seeded weights of the whole tiny pipeline, internal keys."""
    return {f"{root}.{k}": v for i, root in enumerate(("denoiser", "vae", "text_encoder"))
            for k, v in seeded(getattr(jax_model, root), 10 + i).items()}


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' CogView4Model at the tiny config with the same seeded
    weights and the same stub tokenizer."""
    jax_model = jax_pipeline_model()
    flat = pipeline_weights(jax_model)
    jax_model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    return jax_model, port_pipeline(flat), flat


@pytest.mark.parametrize("negative", [None, "blurry photo of a cat on the sofa in the house"])
def test_encode_prompts_matches_jax(pipelines, negative):
    """The penultimate GLM states of the prompts and negatives, left-padded
    together; all-ones masks."""
    jax_model, model, _ = pipelines
    want = jax_model.text_encoder.encode_prompts(
        jax_model.params["text_encoder"], PROMPTS, negative, use_negative_prompts=True)
    with torch.no_grad():
        got = model.text_encoder.encode_prompts(PROMPTS, negative, use_negative_prompts=True)
    for ours, theirs in zip(got, want):
        _close(ours, theirs)
    assert got.positive_embeddings.shape == (2, 16, GLM["hidden_size"])
    assert bool((got.positive_attention_mask == 1).all())
    single = model.text_encoder.encode_prompts("a cat")
    assert single.positive_embeddings.shape == (1, 16, 40)
    assert single.negative_embeddings.shape[0] == 0
    model.text_encoder.tokenizer = None
    try:
        with pytest.raises(RuntimeError, match="tokenizer"):
            model.text_encoder.encode_prompts("a")
    finally:
        model.text_encoder.tokenizer = GlmTok()


@pytest.mark.parametrize("steps,size", [(1, (32, 32)), (4, (32, 48)), (20, (768, 768)),
                                        (28, (1024, 1024))])
def test_prepare_timesteps_matches_jax(pipelines, steps, size):
    jax_model, model, _ = pipelines
    t, s = model.prepare_timesteps(steps, *size)
    want_t, want_s = jax_model.prepare_timesteps(steps, *size)
    assert t.dtype == s.dtype == np.float32 and s.shape == (steps + 1,) and s[-1] == 0
    np.testing.assert_array_equal(t, want_t)
    np.testing.assert_array_equal(s, want_s)


def generate_both(pipelines, monkeypatch, **kwargs):
    """generate() of both packages on the same injected noise; each one's
    final latents."""
    jax_model, model, _ = pipelines
    noise = np.random.default_rng(7).standard_normal((2, 4, 6, 4)).astype(np.float32)
    latents = {}
    monkeypatch.setattr(jax_model, "prepare_latents", lambda *a, **kw: jnp.asarray(noise))
    monkeypatch.setattr(model, "prepare_latents", lambda *a, **kw: torch.from_numpy(noise))
    monkeypatch.setattr(jax_model, "decode_image", lambda z: latents.setdefault("jax", np.asarray(z)))
    monkeypatch.setattr(model, "decode_image", lambda z: latents.setdefault("port", z.numpy()))
    common = dict(width=48, height=32, seed=1, **kwargs)
    jax_model.generate(PROMPTS, **common)
    model.generate(PROMPTS, **common)
    return latents["jax"], latents["port"]


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("cfg", dict(num_inference_steps=3, cfg_scale=3.5, negative_prompt="blurry photo")),
        ("no_cfg_sizes", dict(num_inference_steps=2, cfg_scale=1.0, original_size=(512, 640),
                              crop_coords_top_left=(16, 32))),
        ("deepcache2", dict(num_inference_steps=4, cfg_scale=3.5, deep_cache_interval=2)),
    ],
)
def test_generate_matches_jax(pipelines, monkeypatch, name, kwargs):
    want, got = generate_both(pipelines, monkeypatch, **kwargs)
    assert got.shape == (2, 4, 6, 4) and np.isfinite(got).all()
    _close(got, want, msg=name)


def test_generate_options_and_images(pipelines, monkeypatch):
    """A request repeats bit for bit and decodes to an image of its size;
    DeepCache refreshing every step is the plain loop; an offloaded request
    (the first, then one from the host) is the plain one bit for bit; encode_image is the JAX one (the VAE's mode times the scaling
    factor); a batch's noise rows are the batch-1 streams."""
    jax_model, model, _ = pipelines
    common = dict(width=32, height=32, num_inference_steps=2, cfg_scale=3.5, seed=3)
    base = np.asarray(model.generate("a cat", **common)[0])
    assert base.shape == (32, 32, 3)
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


def test_single_file_checkpoint_loads_as_in_jax(pipelines, tmp_path):
    """The JAX model's state_dict() (``diffusion_model.``, ``text_encoder.``,
    ``vae.``) written to a safetensors file: both packages load it to the
    same parameters, and the port's state_dict() writes the same file back."""
    jax_model, _, flat = pipelines
    written = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    assert any(k.startswith("text_encoder.layers.") for k in written)
    path = tmp_path / "cogview4.safetensors"
    save_file(written, str(path))
    config = cv_config.CogView4Config(checkpoint_path=str(path), dtype="float32",
                                      denoiser=cv_config.DenoiserConfig(**TINY))
    ours = CogView4Model.from_checkpoint(config, tokenizer=GlmTok(), device="cpu",
                                         vae_config=AutoencoderKLConfig(**VAE),
                                         text_encoder_config=glm.GlmConfig(**GLM))
    theirs = jax_pipeline_model()
    theirs.config = jax_config.CogView4Config(
        checkpoint_path=str(path), dtype="float32",
        denoiser=jax_config.DenoiserConfig(**TINY, attention_backend="eager"))
    theirs._from_checkpoint()
    want = {f"{root}.{k}": np.asarray(v) for root in ("denoiser", "vae", "text_encoder")
            for k, v in flatten_params(theirs.params[root]).items()}
    got = {f"{name}.{k}": v.numpy() for name, part in ours._parts().items()
           for k, v in part.state_dict().items()}
    assert set(got) == set(want) == set(flat)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
        np.testing.assert_array_equal(value, flat[key], err_msg=key)
    assert {k: v.numpy().tobytes() for k, v in ours.state_dict().items()} == {
        k: v.tobytes() for k, v in written.items()}
    assert ours.device.type == "cpu"


def test_init_params_on_a_generator():
    model = port_pipeline()
    assert model.device.type == "meta"
    model.init_params(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert model.device.type == "cpu" and model.denoiser.proj_out.weight.dtype == torch.bfloat16
    assert bool((model.text_encoder.model.norm.weight == 1).all())
    first = {k: v.clone() for k, v in model.state_dict().items()}
    model.init_params(torch.Generator().manual_seed(0))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, first[key], rtol=0, atol=0, msg=key)
    with torch.no_grad():
        out = model.denoiser(torch.zeros(1, 8, 8, 4, dtype=torch.bfloat16),
                             torch.zeros(1, 16, 40, dtype=torch.bfloat16),
                             torch.full((1,), 500.0, dtype=torch.bfloat16),
                             torch.full((1, 2), 64.0), torch.full((1, 2), 64.0), torch.zeros(1, 2))
    assert out.shape == (1, 8, 8, 4) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
