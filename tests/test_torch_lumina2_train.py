"""The port's Lumina2 LoRA train slice against the JAX package (CPU, fp32).

The tiny NextDiT, VAE and Gemma-2 configs of tests/test_torch_lumina2.py,
LoRA rank 4 on ``qkv``, ``.out``, ``w1``, ``w2`` and ``w3`` with non-zero lora_up,
gradient checkpointing in groups of 1 and 2 blocks, AdamW with clipping and
a warm-up schedule, three steps of the whole loss: Gemma-2 and VAE encode
every step, the high-res and low-res flow-match losses and, in one case,
the downsampled-velocity loss. Weights are made with numpy; the VAE,
timestep and noise draws are supplied to both sides (the frameworks' random
bits differ), to the JAX side through a loss_fn closure written here from
the JAX ``loss_fn``'s body, to the port through ``loss_with_draws``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vision_ft_tpu.nn.core as jax_core
from vision_ft_tpu.models.autoencoder import AutoencoderKL as JaxVAE
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.lumina2 import config as jax_config
from vision_ft_tpu.models.lumina2 import scheduler as jax_scheduler_module
from vision_ft_tpu.models.lumina2 import train_text_to_image as jax_train
from vision_ft_tpu.models.lumina2.pipeline import Lumina2 as JaxLumina2
from vision_ft_tpu.models.text_encoders.gemma2 import Gemma2Config as JaxGemma2Config
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.loss import flow_match as jax_flow
from vision_ft_tpu.nn import flatten_params, unflatten_params
from vision_ft_tpu.training import get_optimizer as jax_get_optimizer
from vision_ft_tpu.training import get_schedule as jax_get_schedule
from vision_ft_tpu.training import make_train_step as jax_make_train_step
from vision_ft_tpu.training.train_step import init_train_state as jax_init_train_state

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKL, AutoencoderKLConfig
from vision_ft_tpu_torch.models.lumina2 import scheduler as scheduler_module
from vision_ft_tpu_torch.models.lumina2 import train_text_to_image
from vision_ft_tpu_torch.models.lumina2.config import DenoiserConfig, Lumina2Config
from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
from vision_ft_tpu_torch.models.lumina2.scheduler import Scheduler
from vision_ft_tpu_torch.models.text_encoders.gemma2 import Gemma2Config
from vision_ft_tpu_torch.modules import peft
from vision_ft_tpu_torch.modules.loss import flow_match
from vision_ft_tpu_torch.modules.timestep import sampling
from vision_ft_tpu_torch.training import get_optimizer, get_schedule, init_train_state, make_train_step

from test_torch_lumina2 import TEXT, TINY, VAE
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

TrainConfig = train_text_to_image.Lumina2ForTextToImageTrainingConfig
DENOISER = dict(TINY, caption_dim=TEXT["hidden_size"])
TARGETS = ["qkv", ".out", "w1", "w2", "w3"]
STEPS = 3
OPTIMIZER = dict(name="torch.optim.AdamW", schedule=("linear", 2e-3, 10, 1), max_grad_norm=0.005)
# fp32 on the CPU through Gemma-2, the VAE encoder and a checkpointed NextDiT
# forward and backward, sums in other orders: the SDXL train slice's limits
# (tests/test_torch_sdxl_train.py)
METRIC_RTOL, WEIGHT_ATOL = 1e-4, 1e-5
# a VAE encoder forward (convolutions, GroupNorms, the mid-block attention)
VAE_TOL = 2e-5


def _numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _jax_model():
    return JaxLumina2(
        jax_config.Lumina2Config(checkpoint_path="unused", dtype="float32",
                                 denoiser=jax_config.DenoiserConfig(**DENOISER)),
        tokenizer=None, vae_config=JaxVAEConfig(**VAE), text_encoder_config=JaxGemma2Config(**TEXT),
    )


def _port_model(flat, **config):
    model = Lumina2(
        TrainConfig(checkpoint_path="", dtype="float32", denoiser=DenoiserConfig(**DENOISER), **config),
        tokenizer=None, vae_config=AutoencoderKLConfig(**VAE), text_encoder_config=Gemma2Config(**TEXT),
    )
    model.load_state_dict(flat, device="cpu")
    return model


def _random_tree(module, rng):
    """numpy weights on a JAX module's tree: matrices uniform in
    +-1/sqrt(fan-in), norm scales and biases near 1 and 0."""
    base = {}
    for key, leaf in flatten_params(jax.eval_shape(module.init, jax.random.PRNGKey(0))).items():
        shape = tuple(leaf.shape)
        if len(shape) >= 2:
            value = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[1:]))
        else:
            value = (1.0 if key.endswith("weight") else 0.0) + rng.normal(0, 0.1, shape)
        base[key] = jnp.asarray(value.astype(np.float32))
    return unflatten_params(base)


@pytest.fixture(scope="module")
def weights():
    """Weights of the tiny pipeline made with numpy on the JAX package's
    tree, LoRA rank 4 on the NextDiT by the JAX package with lora_up drawn
    non-zero, flattened under denoiser. / vae. / text_encoder."""
    jax_model = _jax_model()
    rng = np.random.default_rng(0)
    flat = {}
    for root in ("denoiser", "vae", "text_encoder"):
        tree = _random_tree(getattr(jax_model, root), rng)
        if root == "denoiser":
            tree = jax_peft.replace_to_peft_layer(
                tree, TARGETS, [], jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
                jax.random.PRNGKey(1),
            )
        for key, value in _numpy(tree).items():
            if key.endswith("lora_up.weight"):
                value = rng.normal(0, 0.05, value.shape).astype(np.float32)
            flat[f"{root}.{key}"] = value
    return flat


def _batches(lowres=True, steps=STEPS):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        b = 2
        mask = np.zeros((b, 8), np.int32)
        mask[0, :8], mask[1, :3] = 1, 1  # two caption lengths: a hole in the joint mask
        batch = {
            "pixel_values": rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32),
            "input_ids": rng.integers(1, TEXT["vocab_size"], (b, 8)).astype(np.int32) * mask,
            "attention_mask": mask,
            "vae_noise": rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
            "timesteps": rng.uniform(0.05, 0.95, (b,)).astype(np.float32),
            "noise": rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
        }
        if lowres:
            batch["lowres_noise"] = rng.standard_normal((b, 2, 2, 4)).astype(np.float32)
        out.append(batch)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_run(flat, batches, velocity_loss):
    """Three steps of the JAX package's train step over a loss_fn with the
    body of its Lumina2 ``loss_fn`` (:126-164), every draw taken from the
    batch."""
    jax_model = _jax_model()
    jax_model.denoiser.set_gradient_checkpointing(True)
    params = {
        root: unflatten_params({k[len(root) + 1:]: jnp.asarray(v) for k, v in flat.items()
                                if k.startswith(root + ".")})
        for root in ("denoiser", "vae", "text_encoder")
    }
    trainable, frozen = jax_peft.split_peft_params(params)
    vae = jax_model.vae

    def forward_and_loss(p, latents, timesteps, hidden, caption_mask, noise):
        t = (1 - timesteps).reshape(-1, 1, 1, 1)
        noisy = ((1.0 - t) * latents + t * noise).astype(latents.dtype)
        velocity, _, _ = jax_model.denoiser(p["denoiser"], noisy, hidden, timesteps, caption_mask)
        velocity = -velocity
        return jax_flow.loss_with_predicted_velocity(latents, noise, velocity), velocity, noise - latents

    def loss_fn(trainable, frozen, batch, key):
        p = jax_peft.merge_params(frozen, trainable)
        hidden = jax_model.text_encoder.encode_tokens(
            p["text_encoder"], batch["input_ids"], batch["attention_mask"])
        hidden = jax.lax.stop_gradient(hidden)
        caption_mask = batch["attention_mask"].astype(bool)
        dist = vae.encode(p["vae"], batch["pixel_values"])
        z = dist.mean + dist.std * batch["vae_noise"]
        latents = jax.lax.stop_gradient((z - vae.shift_factor) * vae.scaling_factor)
        t = batch["timesteps"]
        loss, velocity, target = forward_and_loss(p, latents, t, hidden, caption_mask, batch["noise"])
        lo_loss, _, _ = forward_and_loss(
            p, jax_train._avg_pool_4x(latents), t, hidden, caption_mask, batch["lowres_noise"])
        total = loss + lo_loss
        if velocity_loss:
            small_v, small_t = jax_train._avg_pool_4x(velocity), jax_train._avg_pool_4x(target)
            total = total + jnp.mean(jnp.square(small_v - small_t))
        return total, {}

    tx = jax_get_optimizer(
        OPTIMIZER["name"], jax_get_schedule(*OPTIMIZER["schedule"]),
        max_grad_norm=OPTIMIZER["max_grad_norm"],
    )
    state = jax_init_train_state(tx, trainable)
    step = jax_make_train_step(loss_fn, tx, donate=False)
    metrics = []
    for batch in batches:
        state, m = step(state, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        metrics.append((float(m["train/loss"]), float(m["train/grad_norm"])))
    return metrics, {f"denoiser.{k}": v for k, v in _numpy(state.trainable["denoiser"]).items()}


def _draws_loss(model):
    def loss_fn(batch, generator):
        return train_text_to_image.loss_with_draws(
            model, batch, batch["vae_noise"], batch["timesteps"], batch["noise"],
            batch.get("lowres_noise"),
        )

    return loss_fn


@pytest.mark.parametrize("group,velocity_loss", [(1, False), (2, True)], ids=["group1", "group2_velocity"])
def test_lora_train_steps_match_jax(weights, group, velocity_loss):
    """loss and grad_norm per step rtol 1e-4; adapter parameters after step 3
    atol 1e-5; the base, the VAE and Gemma-2 bit for bit as they were."""
    batches = _batches()
    jax_core.set_remat_group(group)
    try:
        want_metrics, want_trainable = _jax_run(weights, batches, velocity_loss)
    finally:
        jax_core.set_remat_group(1)

    model = _port_model(weights, use_downsampled_velocity_loss=velocity_loss)
    model.denoiser.set_gradient_checkpointing(True)
    trainable, frozen = peft.split_peft_params(model.denoiser)
    assert {f"denoiser.{k}" for k in trainable} == set(want_trainable)
    optimizer = get_optimizer(
        OPTIMIZER["name"], get_schedule(*OPTIMIZER["schedule"]),
        max_grad_norm=OPTIMIZER["max_grad_norm"],
    )
    state = init_train_state(optimizer, trainable)
    step = make_train_step(_draws_loss(model), optimizer)
    tnn.set_remat_group(group)
    try:
        for batch, (want_loss, want_norm) in zip(batches, want_metrics):
            state, metrics = step(state, _torch_batch(batch), None)
            np.testing.assert_allclose(metrics["train/loss"].item(), want_loss, rtol=METRIC_RTOL)
            np.testing.assert_allclose(metrics["train/grad_norm"].item(), want_norm, rtol=METRIC_RTOL)
            assert want_norm > OPTIMIZER["max_grad_norm"]  # the clip is active
            assert set(metrics) >= {"train/highres_loss", "train/lowres_loss"}
            assert ("train/downsampled_velocity_loss" in metrics) == velocity_loss
    finally:
        tnn.set_remat_group(1)
    moved = 0.0
    for key, value in state.trainable.items():
        key = f"denoiser.{key}"
        np.testing.assert_allclose(
            value.detach().numpy(), want_trainable[key], atol=WEIGHT_ATOL, rtol=0, err_msg=key
        )
        moved = max(moved, np.abs(value.detach().numpy() - weights[key]).max())
    assert moved > 1e-3
    for key, value in frozen.items():
        np.testing.assert_array_equal(value.detach().numpy(), weights[f"denoiser.{key}"], err_msg=key)
        assert value.grad is None and not value.requires_grad
    for root in ("vae", "text_encoder"):
        for key, value in getattr(model, root).state_dict().items():
            np.testing.assert_array_equal(value.numpy(), weights[f"{root}.{key}"], err_msg=key)
    assert all(p.grad is None for part in (model.vae, model.text_encoder) for p in part.parameters())


def test_gradients_do_not_depend_on_checkpointing(weights):
    """No checkpointing, groups of 1 and 2 blocks, either remat mode: the
    same gradients bit for bit."""
    model = _port_model(weights, use_downsampled_velocity_loss=True)
    trainable, _ = peft.split_peft_params(model.denoiser)
    batch = _torch_batch(_batches(steps=1)[0])
    loss_fn = _draws_loss(model)

    def grads():
        return torch.autograd.grad(loss_fn(batch, None)[0], list(trainable.values()))

    want = grads()
    model.denoiser.set_gradient_checkpointing(True)
    for group, mode in ((1, "kernel"), (2, "kernel"), (2, "none"), (3, "kernel")):
        tnn.set_remat_group(group)
        tnn.set_remat_saves(mode)
        try:
            got = grads()
        finally:
            tnn.set_remat_group(1)
            tnn.set_remat_saves("activations")
        for key, g, w in zip(trainable, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"group {group} {mode} {key}")


def test_loss_fn_draws_in_order_from_the_generator(weights):
    """loss_fn's draws, made by hand from the same seed in its order (the
    VAE sample, the timesteps, the noise, the low-res noise), through
    loss_with_draws give the same loss; another seed another."""
    model = _port_model(weights)
    batch = _torch_batch(_batches(steps=1)[0])
    loss, metrics = train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(3))
    again, _ = train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(3))
    other, _ = train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(4))
    assert set(metrics) == {"train/highres_loss", "train/lowres_loss"} and torch.isfinite(loss)
    assert loss.item() == again.item() != other.item()
    torch.testing.assert_close(loss, metrics["train/highres_loss"] + metrics["train/lowres_loss"])
    gen = torch.Generator().manual_seed(3)
    vae_noise = torch.randn((2, 8, 8, 4), generator=gen)
    timesteps = torch.rand((2,), generator=gen)
    noise = torch.randn((2, 8, 8, 4), generator=gen)
    lowres = torch.randn((2, 2, 2, 4), generator=gen)
    by_hand, _ = train_text_to_image.loss_with_draws(model, batch, vae_noise, timesteps, noise, lowres)
    assert by_hand.item() == loss.item()
    high_only = _port_model(weights, use_lowres_loss=False)
    alone, alone_metrics = train_text_to_image.loss_with_draws(high_only, batch, vae_noise, timesteps, noise)
    assert set(alone_metrics) == {"train/highres_loss"}
    assert alone.item() == metrics["train/highres_loss"].item()


@pytest.mark.parametrize("mode", ["uniform", "lognorm", "shift_fraction_uniform"])
def test_timestep_modes(weights, mode):
    """Each mode is its sampler of the JAX package's table, drawn from the
    generator; the lognorm mode takes the denoiser's patch size."""
    model = _port_model(weights, timestep_sampling=mode)
    config = train_text_to_image.training_config(model)
    shape = (4, 64, 64, 4)
    got = train_text_to_image._sample_timesteps(model, config, torch.Generator().manual_seed(5), shape)
    gen = torch.Generator().manual_seed(5)
    want = {
        "uniform": lambda: sampling.uniform_rand(gen, shape),
        "lognorm": lambda: Scheduler().sample_sigmoid_randn(gen, shape, patch_size=2),
        "shift_fraction_uniform": lambda: 1 - sampling.shift_fraction_uniform_rand(
            gen, shape, shift=6.0, divisible=[20, 25, 30, 32]),
    }[mode]()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.shape == (4,) and ((got >= 0) & (got <= 1)).all()
    bad = model.config.model_copy(update={"timestep_sampling": "cosine"})
    with pytest.raises(ValueError):
        train_text_to_image._sample_timesteps(model, bad, gen, shape)


@pytest.mark.parametrize("shape", [(2, 64, 64, 16), (3, 128, 96, 16)])
def test_sample_sigmoid_randn_matches_jax(monkeypatch, shape):
    """The resolution-aware shift of the lognorm sampler, on the same
    sigmoid draws handed to both packages."""
    draws = 1 / (1 + np.exp(-_rand_normal(shape[0])))
    monkeypatch.setattr(jax_scheduler_module, "sigmoid_randn", lambda key, s: jnp.asarray(draws))
    monkeypatch.setattr(scheduler_module, "sigmoid_randn", lambda gen, s: torch.from_numpy(draws))
    want = jax_scheduler_module.Scheduler().sample_sigmoid_randn(jax.random.PRNGKey(0), shape)
    got = Scheduler().sample_sigmoid_randn(torch.Generator(), shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _rand_normal(n, seed=9):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_flow_match_matches_jax():
    """Noising on the JAX package's own draw (handed to the port), the loss,
    the target and the x0 conversion in both conventions."""
    rng = np.random.default_rng(10)
    latents = rng.standard_normal((3, 8, 6, 4)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (3,)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, latents.shape, jnp.float32))
    tl, tt, tn = (torch.from_numpy(x) for x in (latents, t, noise))
    want = jax_flow.prepare_noised_latents(key, jnp.asarray(latents), jnp.asarray(t), max_sigma=0.7)
    got = flow_match.prepare_noised_latents(None, tl, tt, max_sigma=0.7, noise=tn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for clean_at_zero in (False, True):
        want = jax_flow.prepare_scaled_noised_latents(
            key, jnp.asarray(latents), jnp.asarray(t), 0.5, clean_at_zero)
        got = flow_match.prepare_scaled_noised_latents(None, tl, tt, 0.5, clean_at_zero, noise=tn)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        want_v = jax_flow.convert_x0_to_velocity(
            jnp.asarray(latents), jnp.asarray(noise), jnp.asarray(t), clean_at_zero=clean_at_zero)
        got_v = flow_match.convert_x0_to_velocity(tl, tn, tt, clean_at_zero=clean_at_zero)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-6)
    pred = rng.standard_normal(latents.shape).astype(np.float32)
    np.testing.assert_allclose(
        flow_match.loss_with_predicted_velocity(tl, tn, torch.from_numpy(pred)).item(),
        float(jax_flow.loss_with_predicted_velocity(jnp.asarray(latents), jnp.asarray(noise), jnp.asarray(pred))),
        rtol=1e-6,
    )
    torch.testing.assert_close(flow_match.get_flow_match_target_velocity(tl, tn), tn - tl)
    drawn = flow_match.prepare_noised_latents(torch.Generator().manual_seed(0), tl, tt)
    assert drawn.random_noise.shape == tl.shape and not torch.equal(drawn.random_noise, tn)
    with pytest.raises(ValueError):
        flow_match.prepare_noised_latents(None, tl, tt)


def test_avg_pool_4x_matches_jax():
    x = np.random.default_rng(11).standard_normal((2, 10, 13, 4)).astype(np.float32)  # ragged edges
    want = np.asarray(jax_train._avg_pool_4x(jnp.asarray(x)))
    got = train_text_to_image._avg_pool_4x(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2, 3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant_conv", [False, True], ids=["flux", "quant_conv"])
def test_vae_encode_matches_jax(quant_conv):
    """Encoder forward (with the asymmetric stride-2 pad), the quant conv,
    the distribution's mean / std / mode and a sample on given noise."""
    config = dict(VAE, use_quant_conv=quant_conv)
    jax_vae = JaxVAE(JaxVAEConfig(**config))
    flat = _numpy(_random_tree(jax_vae, np.random.default_rng(3)))
    vae = tnn.load_flat_params(AutoencoderKL(AutoencoderKLConfig(**config)), flat)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 40, 24, 3)).astype(np.float32)
    want = jax_vae.encode(unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), jnp.asarray(x))
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(x))
    assert got.mean.shape == (2, 5, 3, 4)
    for name in ("mean", "logvar", "std"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=VAE_TOL, atol=VAE_TOL,
            err_msg=name)
    torch.testing.assert_close(got.mode(), got.mean)
    noise = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        got.sample(noise=torch.from_numpy(noise)).numpy(),
        np.asarray(want.mean + want.std * jnp.asarray(noise)), rtol=VAE_TOL, atol=VAE_TOL)
    drawn = got.sample(torch.Generator().manual_seed(0))
    assert drawn.shape == got.mean.shape and not torch.equal(drawn, got.mean)
    with pytest.raises(ValueError):
        got.sample()


def test_encode_image_matches_jax(weights):
    """A PIL image, a list of them and a tensor: the scaled mode of the VAE,
    as the JAX pipeline's ``encode_image`` without a key."""
    jax_model = _jax_model()
    jax_model.params = {
        root: unflatten_params({k[len(root) + 1:]: jnp.asarray(v) for k, v in weights.items()
                                if k.startswith(root + ".")})
        for root in ("denoiser", "vae", "text_encoder")
    }
    model = _port_model(weights)
    pixels = np.random.default_rng(13).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    images = [Image.fromarray(p) for p in pixels]
    want = np.asarray(jax_model.encode_image(images))
    with torch.no_grad():
        got = model.encode_image(images)
        one = model.encode_image(images[1])
        from_tensor = model.encode_image(torch.from_numpy(pixels.astype(np.float32) / 127.5 - 1.0))
        sampled = model.encode_image(images, torch.Generator().manual_seed(0))
    assert got.shape == (2, 4, 6, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=VAE_TOL, atol=VAE_TOL)
    np.testing.assert_allclose(one.numpy(), want[1:], rtol=VAE_TOL, atol=VAE_TOL)
    torch.testing.assert_close(from_tensor, got, rtol=1e-6, atol=1e-6)
    assert not torch.equal(sampled, got)


def test_peft_finds_every_nextdit_projection(weights):
    """The JAX key rules on the port's NextDiT: qkv, out, w1, w2 and w3 of
    every block, the refiners' included, and nothing else."""
    model = _port_model({k: v for k, v in weights.items() if "lora_" not in k and ".alpha" not in k})
    assert not peft.split_peft_params(model.denoiser)[0]
    peft.replace_to_peft_layer(
        model.denoiser, TARGETS, [], peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
        torch.Generator().manual_seed(0),
    )
    trainable, _ = peft.split_peft_params(model.denoiser)
    want = {k[len("denoiser."):] for k in weights if k.startswith("denoiser.") and "lora_" in k}
    assert set(trainable) == want
    blocks = DENOISER["depth"] + 2 * DENOISER["refiner_depth"]
    assert len(trainable) == blocks * len(TARGETS) * 2
    assert {k.split(".")[0] for k in trainable} == {"layers", "noise_refiner", "context_refiner"}


def test_training_config_matches_jax():
    ours = TrainConfig(checkpoint_path="x").model_dump()
    assert ours == jax_train.Lumina2ForTextToImageTrainingConfig(checkpoint_path="x").model_dump()
    # a model built on the plain config trains with the training defaults
    model = Lumina2(Lumina2Config(checkpoint_path="", denoiser=DenoiserConfig(**DENOISER)), tokenizer=None)
    assert train_text_to_image.training_config(model) == TrainConfig(**model.config.model_dump())
