"""The port's SDXL LoRA train slice against the JAX package (CPU, fp32).

The tiny denoiser of tests/test_torch_sdxl.py, LoRA rank 4 on the
attention and feed-forward layers with non-zero lora_up, gradient
checkpointing on, AdamW with clipping and a warm-up schedule, three
steps. Weights are made with numpy and carried across; timesteps and
noise are supplied to both sides (the frameworks' random bits differ),
to the JAX side through a loss_fn closure written here, to the port
through ``loss_with_draws``, the body of its ``loss_fn``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.sdxl.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.loss import diffusion as jax_diffusion
from vision_ft_tpu.training import get_optimizer as jax_get_optimizer
from vision_ft_tpu.training import get_schedule as jax_get_schedule
from vision_ft_tpu.training import make_train_step as jax_make_train_step
from vision_ft_tpu.training.train_step import init_train_state as jax_init_train_state

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.sdxl import train_text_to_image
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_ft_tpu_torch.models.sdxl.denoiser import Denoiser
from vision_ft_tpu_torch.modules import peft
from vision_ft_tpu_torch.training import (
    get_optimizer,
    get_schedule,
    init_train_state,
    make_train_step,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(
    hidden_dim=32, num_head_channels=8, context_dim=64 + 48,
    block_out_channels=[32, 64, 64], num_transformers_per_block=[1, 1, 1],
)
TARGETS = ["attn1", "attn2", ".ff."]
STEPS = 3
OPTIMIZER = dict(name="torch.optim.AdamW", schedule=("linear", 2e-3, 10, 1), max_grad_norm=0.005)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jnn.flatten_params(tree).items()}


def _weights():
    """numpy weights of the tiny denoiser with LoRA rank 4: the base as in
    tests/test_torch_sdxl.py, lora_down and lora_up both non-zero."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(JaxDenoiser(JaxDenoiserConfig(**TINY)).init, jax.random.key(0))
    base = {}
    for key, leaf in jnn.flatten_params(shapes).items():
        shape = tuple(leaf.shape)
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            value = rng.uniform(-bound, bound, shape)
        else:
            value = (1.0 if key.endswith("weight") else 0.0) + rng.normal(0, 0.1, shape)
        base[key] = jnp.asarray(value.astype(np.float32))
    params = jax_peft.replace_to_peft_layer(
        jnn.unflatten_params(base), TARGETS, [],
        jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"), jax.random.key(1),
    )
    flat = _flat(params)
    for key in flat:
        if key.endswith("lora_up.weight"):
            flat[key] = rng.normal(0, 0.05, flat[key].shape).astype(np.float32)
    return flat


def _batches():
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        b = 2
        batches.append({
            "cached_latents": rng.standard_normal((b, 16, 24, 4)).astype(np.float32),
            "cached_context": rng.standard_normal((b, 10, 112)).astype(np.float32),
            "cached_pooled": rng.standard_normal((b, 1280)).astype(np.float32),
            "original_size": np.array([[128, 192], [96, 160]], np.float32),
            "target_size": np.array([[128, 192], [128, 192]], np.float32),
            "crop_coords_top_left": np.array([[0, 0], [16, 8]], np.float32),
            "timesteps": rng.integers(0, 1000, (b,)).astype(np.int32),
            "noise": rng.standard_normal((b, 16, 24, 4)).astype(np.float32),
        })
    return batches


def _jax_run(flat, batches, min_snr_gamma):
    denoiser = JaxDenoiser(JaxDenoiserConfig(**TINY))
    denoiser.set_gradient_checkpointing(True)
    params = jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    trainable, frozen = jax_peft.split_peft_params(params)

    def loss_fn(trainable, frozen, batch, key):
        p = jax_peft.merge_params(frozen, trainable)
        latents, timesteps = batch["cached_latents"], batch["timesteps"]
        a = jax_diffusion.get_alphas_cumprod()[timesteps].reshape(-1, 1, 1, 1)
        noisy = jnp.sqrt(a) * latents + jnp.sqrt(1.0 - a) * batch["noise"]
        pred = denoiser(
            p, noisy, timesteps.astype(jnp.float32), batch["cached_context"],
            batch["cached_pooled"], batch["original_size"], batch["target_size"],
            batch["crop_coords_top_left"],
        )
        if min_snr_gamma is not None:
            loss = jax_diffusion.min_snr_weighted_loss(
                latents, batch["noise"], pred, timesteps, gamma=min_snr_gamma
            )
        else:
            loss = jax_diffusion.loss_with_predicted_noise(latents, batch["noise"], pred)
        return loss, {}

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
    return metrics, _flat(state.trainable)


def _port_model(flat):
    denoiser = tnn.load_flat_params(Denoiser(DenoiserConfig(**TINY)), flat)
    return types.SimpleNamespace(denoiser=denoiser, dtype=torch.float32)


def _supplied_draws_loss(model, min_snr_gamma=None):
    def loss_fn(batch, generator):
        loss = train_text_to_image.loss_with_draws(
            model, batch, batch["timesteps"], batch["noise"], min_snr_gamma
        )
        return loss, {}

    return loss_fn


@pytest.mark.parametrize("min_snr_gamma", [None, 5.0], ids=["mse", "min_snr"])
def test_lora_train_steps_match_jax(min_snr_gamma):
    """loss and grad_norm per step rtol 1e-4 (fp32 sums in other orders
    through a whole UNet forward and backward); adapter parameters after
    step 3 atol 1e-5; the base bit for bit as it was."""
    flat, batches = _weights(), _batches()
    want_metrics, want_trainable = _jax_run(flat, batches, min_snr_gamma)

    model = _port_model(flat)
    model.denoiser.set_gradient_checkpointing(True)
    trainable, frozen = peft.split_peft_params(model.denoiser)
    assert set(trainable) == set(want_trainable)
    optimizer = get_optimizer(
        OPTIMIZER["name"], get_schedule(*OPTIMIZER["schedule"]),
        max_grad_norm=OPTIMIZER["max_grad_norm"],
    )
    state = init_train_state(optimizer, trainable)
    step = make_train_step(_supplied_draws_loss(model, min_snr_gamma), optimizer)
    gen = torch.Generator().manual_seed(0)
    for batch, (want_loss, want_norm) in zip(batches, want_metrics):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, gen)
        np.testing.assert_allclose(metrics["train/loss"].item(), want_loss, rtol=1e-4)
        np.testing.assert_allclose(metrics["train/grad_norm"].item(), want_norm, rtol=1e-4)
        assert want_norm > OPTIMIZER["max_grad_norm"]  # the clip is active
    moved = 0.0
    for key, value in state.trainable.items():
        np.testing.assert_allclose(
            value.detach().numpy(), want_trainable[key], atol=1e-5, rtol=0, err_msg=key
        )
        moved = max(moved, np.abs(value.detach().numpy() - flat[key]).max())
    assert moved > 1e-3
    for key, value in frozen.items():
        np.testing.assert_array_equal(value.detach().numpy(), flat[key], err_msg=key)
        assert value.grad is None and not value.requires_grad


def test_gradients_do_not_depend_on_the_remat_mode():
    flat, batch = _weights(), {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    model = _port_model(flat)
    trainable, _ = peft.split_peft_params(model.denoiser)
    loss_fn = _supplied_draws_loss(model)

    def grads():
        return torch.autograd.grad(loss_fn(batch, None)[0], list(trainable.values()))

    want = grads()
    model.denoiser.set_gradient_checkpointing(True)
    for mode in ("kernel", "none"):
        tnn.set_remat_saves(mode)
        try:
            got = grads()
        finally:
            tnn.set_remat_saves("activations")
        for key, g, w in zip(trainable, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"{mode} {key}")
    # checkpointing is a training-time thing: no region under no_grad
    with torch.no_grad():
        assert not loss_fn(batch, None)[0].requires_grad


def test_loss_fn_draws_from_the_generator_and_needs_cached_latents():
    flat, batch = _weights(), {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    model = _port_model(flat)
    loss, metrics = train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(3))
    again, _ = train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(3))
    other, _ = train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(4))
    assert metrics == {} and loss.ndim == 0 and torch.isfinite(loss)
    assert loss.item() == again.item() != other.item()
    # the same draws, made by hand, through loss_with_draws
    gen = torch.Generator().manual_seed(3)
    timesteps = torch.randint(0, 1000, (2,), generator=gen, dtype=torch.int32)
    noise = torch.randn(batch["cached_latents"].shape, generator=gen)
    by_hand = train_text_to_image.loss_with_draws(model, batch, timesteps, noise)
    assert by_hand.item() == loss.item()
    # without cached latents the loss encodes the batch's pixel values
    del batch["cached_latents"]
    with pytest.raises(KeyError, match="pixel_values"):
        train_text_to_image.loss_fn(model, batch, torch.Generator().manual_seed(3))


def test_loss_fn_encodes_tokens_without_a_text_cache():
    """The un-cached text branch: encode_tokens under no_grad gives the
    context and pooled embedding that the cached branch is handed."""
    from test_torch_sdxl import _tiny_kwargs

    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel

    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config, **kwargs)
    model.init_params(torch.Generator().manual_seed(0))
    peft.replace_to_peft_layer(
        model.denoiser, TARGETS, [], peft.LoRAConfig(rank=2, dtype="float32"),
        torch.Generator().manual_seed(1),
    )
    trainable, _ = peft.split_peft_params(model.denoiser)
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    ids = torch.randint(1, 998, (2, 77), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        emb1, emb2, pooled = model.text_encoder.encode_tokens(ids, ids, 2)
    batch["cached_context"], batch["cached_pooled"] = torch.cat([emb1, emb2], -1), pooled
    cached = train_text_to_image.loss_with_draws(model, batch, batch["timesteps"], batch["noise"])
    del batch["cached_context"], batch["cached_pooled"]
    batch["input_ids"] = ids
    encoded = train_text_to_image.loss_with_draws(model, batch, batch["timesteps"], batch["noise"])
    assert encoded.item() == cached.item()
    grads = torch.autograd.grad(encoded, list(trainable.values()), allow_unused=True)
    assert all(g is not None for g in grads)
    assert all(p.grad is None for p in model.text_encoder.parameters())
