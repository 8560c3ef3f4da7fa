"""The port's AuraFlow train slice against the JAX package's (CPU, fp32):
the text-to-image, shortcut and RoPE migration workloads.

A tiny AuraFlow (the MMDiT, UMT5 and VAE sizes of
tests/test_torch_auraflow.py) gets numpy weights on the JAX package's
tree, LoRA rank 4 on ``attn.``, ``.mlp.``, ``modC.`` and ``modX.`` (config
#3's targets) by the JAX package with lora_up drawn non-zero, and the
shortcut embedder and the migration scale drawn non-zero where a case
says so. The frameworks' random bits differ, so both sides get the same
draws: the port through each workload's ``loss_with_draws``, the JAX
package through its own ``loss_fn`` with its draw functions patched to
return them (the VAE sample, the timesteps, the noise, the Bernoulli
uniforms, the flow-matching steps, the shortcut durations). Gradients of
the trainable leaves are held against ``jax.grad``. A Trainer run of the
text-to-image workload in both packages starts from one safetensors file
written by the JAX package.
"""

import math
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vision_ft_tpu.config import TrainConfig as JaxTrainConfig
from vision_ft_tpu.dataset.text_to_image import TextToImageDatasetConfig as JaxDatasetConfig
from vision_ft_tpu.models.auraflow import config as jax_config
from vision_ft_tpu.models.auraflow import train_rope_migration as jax_rope
from vision_ft_tpu.models.auraflow import train_shortcut as jax_shortcut
from vision_ft_tpu.models.auraflow import train_text_to_image as jax_t2i
from vision_ft_tpu.models.auraflow.pipeline import AuraFlowModel as JaxAuraFlowModel
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.autoencoder import kl as jax_kl
from vision_ft_tpu.models.text_encoders import auto_tokenizer as jax_auto_tokenizer
from vision_ft_tpu.models.text_encoders import umt5 as jax_umt5
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.loss import flow_match as jax_flow
from vision_ft_tpu.modules.loss import shortcut as jax_shortcut_loss
from vision_ft_tpu.modules.migration.scale import MigrationScaleFromZero as JaxMigrationScale
from vision_ft_tpu.nn import flatten_params, unflatten_params
from vision_ft_tpu.trainer import Trainer as JaxTrainer
from vision_ft_tpu.utils import safetensors as jax_st

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.models.auraflow import train_rope_migration as rope_train
from vision_ft_tpu_torch.models.auraflow import train_shortcut as shortcut_train
from vision_ft_tpu_torch.models.auraflow import train_text_to_image as t2i_train
from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig, DenoiserConfig
from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel
from vision_ft_tpu_torch.models.auraflow.util import convert_to_comfy_key
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.text_encoders import auto_tokenizer, umt5
from vision_ft_tpu_torch.modules.loss import shortcut as shortcut_loss
from vision_ft_tpu_torch.modules.migration import MigrationScaleFromZero
from vision_ft_tpu_torch.train.auraflow import rope_migration as rope_cli
from vision_ft_tpu_torch.train.auraflow import shortcut as shortcut_cli
from vision_ft_tpu_torch.train.auraflow import text_to_image as t2i_cli
from vision_ft_tpu_torch.utils import safetensors as st

from test_torch_auraflow import TEXT, TINY, VAE, _vocab_bytes
from test_torch_lumina2_train import _random_tree
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU through UMT5, the VAE encoder and a few MMDiT blocks
# forward and backward, sums in other orders: the AuraFlow slice's limit
# (tests/test_torch_auraflow.py), relative to each compared tensor's max
TOL = 5e-5
# a Trainer run: the losses of three AdamW steps; the saved adapters, where
# AdamW divides each gradient element by its own rms, so an element whose
# gradient sits at fp32 rounding level moves by up to lr either way
# (tests/test_torch_trainer_lumina2.py)
LOSS_RTOL, ADAPTER_ATOL = 1e-4, 1e-3

DENOISER = dict(TINY, joint_attention_dim=TEXT["d_model"])
ROPE_DENOISER = dict(DENOISER, use_rope=True, rope_dim_sizes=[8, 12, 12])
INCLUDE, EXCLUDE = ["attn.", ".mlp.", "modC.", "modX."], ["text_encoder", "vae", "final_linear"]
# configs/auraflow/shortcut.yml's targets: the shortcut embedder trains whole
SHORTCUT_TARGETS = (["attn", "mlp"], ["text_encoder", "vae", "shortcut_embedder"])
PARTS = ("denoiser", "vae", "text_encoder")
B = 2


def _close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (name, err, scale)


# -- the models, both packages -------------------------------------------------------


def _jax_model(cls, config_cls, denoiser, **fields):
    config = config_cls(checkpoint_path="unused", dtype="float32",
                        denoiser=jax_config.DenoiserConfig(**denoiser), **fields)
    return cls(config, tokenizer=None, vae_config=JaxVAEConfig(**VAE),
               text_encoder_config=jax_umt5.UMT5Config(**TEXT))


def _port_model(cls, config_cls, denoiser, flat, **fields):
    config = config_cls(checkpoint_path="", dtype="float32", denoiser=DenoiserConfig(**denoiser),
                        **fields)
    model = cls(config, tokenizer=None, vae_config=AutoencoderKLConfig(**VAE),
                text_encoder_config=umt5.UMT5Config(**TEXT))
    model.load_state_dict(flat, device="cpu")
    return model


def _weights(jax_model, seed, extra_scale=0.0, targets=(INCLUDE, EXCLUDE)):
    """numpy weights on the JAX model's tree, LoRA on the denoiser's
    ``targets`` with lora_up non-zero; the shortcut embedder drawn at
    ``extra_scale`` (0: the zeros the workload starts from)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for root in PARTS:
        tree = _random_tree(getattr(jax_model, root), rng)
        if root == "denoiser":
            tree = jax_peft.replace_to_peft_layer(
                tree, *targets, jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
                jax.random.PRNGKey(seed),
            )
        for key, value in flatten_params(tree).items():
            value = np.asarray(value)
            if key.endswith("lora_up.weight"):
                value = rng.normal(0, 0.05, value.shape).astype(np.float32)
            if key.startswith("shortcut_embedder.") and "lora_" not in key and "alpha" not in key:
                value = (extra_scale * rng.standard_normal(value.shape)).astype(np.float32)
            flat[f"{root}.{key}"] = value
    return flat


def _base(flat):
    """``flat`` without its adapters."""
    return {k: v for k, v in flat.items() if "lora_" not in k and not k.endswith(".alpha")}


def _split(flat, extra_prefix=None):
    """The JAX package's (trainable, frozen) trees: the adapters, plus the
    leaves under ``extra_prefix`` (the workload's peft_extra_trainable_filter)."""
    params = {root: unflatten_params({k[len(root) + 1:]: jnp.asarray(v) for k, v in flat.items()
                                      if k.startswith(root + ".")}) for root in PARTS}
    trainable, frozen = jax_peft.split_peft_params(params)
    if extra_prefix:
        flat_t, flat_f = flatten_params(trainable), flatten_params(frozen)
        for key in [k for k in flat_f if k.startswith(extra_prefix)]:
            flat_t[key] = flat_f.pop(key)
        trainable, frozen = unflatten_params(flat_t), unflatten_params(flat_f)
    return trainable, frozen


def _batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, 8), np.int32)
    mask[0, :8], mask[1, :3] = 1, 1
    return {
        "pixel_values": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32),
        "input_ids": rng.integers(1, TEXT["vocab_size"], (B, 8)).astype(np.int32) * mask,
        "attention_mask": mask,
    }


def _draws(seed, shape=(B, 8, 8, 4)):
    rng = np.random.default_rng(seed)
    return {
        "vae_noise": rng.standard_normal(shape).astype(np.float32),
        "timesteps": rng.uniform(0.05, 0.95, shape[:1]).astype(np.float32),
        "noise": rng.standard_normal(shape).astype(np.float32),
    }


def _patch_jax_draws(monkeypatch, module, vae_noise, noises, timesteps=None):
    """The JAX VAE sample takes ``vae_noise``; ``module``'s timestep
    samplers return ``timesteps``; its ``prepare_noised_latents`` takes the
    ``noises`` in turn."""
    monkeypatch.setattr(jax_kl.DiagonalGaussian, "sample",
                        lambda self, key: self.mean + self.std * jnp.asarray(vae_noise))
    queue = list(noises)

    def noised(key, latents, t):
        noise = jnp.asarray(queue.pop(0))
        s = t.reshape(-1, 1, 1, 1).astype(jnp.float32)
        return jax_flow.NoisedLatents(((1.0 - s) * latents + s * noise).astype(latents.dtype),
                                      noise.astype(latents.dtype))

    monkeypatch.setattr(module, "prepare_noised_latents", noised)
    if timesteps is not None:
        for name in ("sigmoid_randn", "uniform_rand"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, lambda key, shape: jnp.asarray(timesteps))


def _jax_workload(cls, model):
    workload = cls.__new__(cls)
    workload.model, workload.model_config = model, model.config
    return workload


def _jax_loss_and_grads(workload, trainable, frozen, batch):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(tr):
        return workload.loss_fn(tr, frozen, batch, jax.random.PRNGKey(0))

    # jitted: op-by-op dispatch of the tiny model compiles each op on its own
    (value, logs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(trainable)
    return float(value), {k: float(v) for k, v in logs.items()}, {
        k: np.asarray(v) for k, v in flatten_params(grads).items()}


def _port_loss_and_grads(model, trainable_keys, loss):
    """As the port's Trainer splits them: the named leaves train (under the
    shortcut workload's filter also the embedder's LoRA ``alpha`` buffers,
    as in the JAX package), everything else is frozen."""
    leaves = {k: v for k, v in model.as_module().state_dict(keep_vars=True).items()
              if v.is_floating_point()}
    assert set(trainable_keys) <= set(leaves)
    for key, leaf in leaves.items():
        leaf.requires_grad_(key in trainable_keys)
    value, logs = loss()
    value.backward()
    # a leaf the loss does not reach has no gradient (the JAX package's is zeros)
    grads = {k: np.zeros(leaves[k].shape, np.float32) if leaves[k].grad is None
             else leaves[k].grad.numpy() for k in trainable_keys}
    assert all(p.grad is None for k, p in leaves.items() if k not in trainable_keys)
    return value.item(), {k: float(v) for k, v in logs.items()}, grads


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare(got, want):
    value, logs, grads = got
    want_value, want_logs, want_grads = want
    _close(value, want_value, name="loss")
    for key, w in want_logs.items():
        _close(logs[key], w, name=key)
    assert set(grads) == set(want_grads)
    assert any(np.abs(g).max() > 0 for g in want_grads.values())
    for key, g in want_grads.items():
        _close(grads[key], g, name=key)


# -- the three workloads' losses and gradients ----------------------------------------


def test_text_to_image_loss_and_grads_match_jax(monkeypatch):
    """Sigmoid timesteps, the velocity MSE, UMT5 and VAE encode inside; the
    gradients of every adapter."""
    jax_model = _jax_model(JaxAuraFlowModel, jax_config.AuraFlowConig, DENOISER)
    flat = _weights(jax_model, 0)
    batch, draws = _batch(1), _draws(2)
    trainable, frozen = _split(flat)
    _patch_jax_draws(monkeypatch, jax_t2i, draws["vae_noise"], [draws["noise"]], draws["timesteps"])
    jax_model.denoiser.set_gradient_checkpointing(True)
    want = _jax_loss_and_grads(_jax_workload(jax_t2i.AuraFlowForTextToImageTraining, jax_model),
                               trainable, frozen, batch)

    model = _port_model(AuraFlowModel, AuraFlowConig, DENOISER, flat)
    model.denoiser.set_gradient_checkpointing(True)
    keys = [f"denoiser.{k}" for k in flatten_params(trainable["denoiser"])]
    got = _port_loss_and_grads(model, keys, lambda: t2i_train.loss_with_draws(
        model, _torch_batch(batch), *(torch.from_numpy(draws[k]) for k in
                                      ("vae_noise", "timesteps", "noise"))))
    _compare(got, want)


def _shortcut_draws(seed, flow_uniform, exponent):
    rng = np.random.default_rng(seed)
    return {
        "flow_uniform": np.asarray(flow_uniform, np.float32),
        "flow_steps": rng.integers(1, 129, (B,)).astype(np.int32),
        "flow_noise": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
        "exponent": np.asarray(exponent, np.int32),
        "u": rng.uniform(0, 1, (B,)).astype(np.float32),
        "shortcut_noise": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
    }


@pytest.mark.parametrize(
    "flow_uniform,exponent,targets",
    [([0.2, 0.9], [3, 6], SHORTCUT_TARGETS), ([0.9, 0.95], [1, 2], SHORTCUT_TARGETS),
     ([0.1, 0.5], [4, 5], SHORTCUT_TARGETS), ([0.2, 0.9], [3, 6], (INCLUDE, EXCLUDE))],
    ids=["mixed", "shortcut_only", "flow_match_only", "embedder_with_lora"],
)
def test_shortcut_loss_and_grads_match_jax(monkeypatch, flow_uniform, exponent, targets):
    """Both target kinds for the whole batch, blended per sample by the
    Bernoulli mask; the gradients of the adapters and of the (non-zero)
    shortcut embedder, trainable under LoRA. With config #3's targets the
    embedder's MLP also carries LoRA, and the extra-trainable filter then
    reaches its ``alpha``, which trains in both packages."""
    jax_model = _jax_model(jax_shortcut.AuraFlowForShortcut,
                           jax_shortcut.AuraFlowForShortcutConfig, DENOISER)
    flat = _weights(jax_model, 3, extra_scale=0.05, targets=targets)
    assert any("shortcut_embedder" in k and "lora" in k for k in flat) == (targets != SHORTCUT_TARGETS)
    batch, vae_draws, d = _batch(4), _draws(5), _shortcut_draws(6, flow_uniform, exponent)
    trainable, frozen = _split(flat, "denoiser.shortcut_embedder.")
    _patch_jax_draws(monkeypatch, jax_shortcut, vae_draws["vae_noise"],
                     [d["flow_noise"], d["shortcut_noise"]])
    steps = 2.0 ** d["exponent"].astype(np.float32)
    durations = jax_shortcut_loss.ShortcutDuration(
        inference_steps=jnp.asarray(steps), shortcut_exponent=jnp.asarray(d["exponent"]),
        shortcut_duration=jnp.asarray(1.0 / steps),
        departure_timesteps=jnp.asarray((np.floor(d["u"] * steps) + 1.0) / steps),
    )
    monkeypatch.setattr(jax_shortcut, "prepare_random_shortcut_durations",
                        lambda *a, **k: durations)
    draws_random = types.SimpleNamespace(
        split=jax.random.split,
        uniform=lambda key, shape: jnp.asarray(d["flow_uniform"]),
        randint=lambda key, shape, low, high: jnp.asarray(d["flow_steps"]),
    )
    monkeypatch.setattr(jax_shortcut, "jax", types.SimpleNamespace(
        random=draws_random, lax=jax.lax, numpy=jnp))
    want = _jax_loss_and_grads(_jax_workload(jax_shortcut.AuraFlowForShortcutTraining, jax_model),
                               trainable, frozen, batch)
    assert any(k.startswith("denoiser.shortcut_embedder.") for k in want[2])

    model = _port_model(shortcut_train.AuraFlowForShortcut, shortcut_train.AuraFlowForShortcutConfig,
                        DENOISER, flat)
    draws = shortcut_train.ShortcutDraws(
        flow_uniform=torch.from_numpy(d["flow_uniform"]),
        flow_steps=torch.from_numpy(d["flow_steps"]).long(),
        flow_noise=torch.from_numpy(d["flow_noise"]),
        durations=shortcut_loss.shortcut_duration_from(torch.from_numpy(d["exponent"]).long(),
                                                       torch.from_numpy(d["u"])),
        shortcut_noise=torch.from_numpy(d["shortcut_noise"]),
    )
    keys = [k for k in want[2]]
    got = _port_loss_and_grads(model, keys, lambda: shortcut_train.loss_with_draws(
        model, _torch_batch(batch), torch.from_numpy(vae_draws["vae_noise"]), draws))
    _compare(got, want)


@pytest.mark.parametrize(
    "scale,fields",
    [(0.0, {}), (0.3, {"prior_preservation_loss": True}),
     (0.6, {"timestep_sampling": "uniform", "noise_prediction_loss": False})],
    ids=["fresh", "midway_prior_preservation", "uniform_migration_only"],
)
def test_rope_migration_loss_and_grads_match_jax(monkeypatch, scale, fields):
    """The blend of the learned PE and RoPE at a scale, the pull of the scale
    toward 1 and, in one case, the prior preservation with the adapters and
    RoPE off; the gradients of the adapters and of the scale."""
    jax_model = _jax_model(jax_rope.AuraFlowForRoPEMigration,
                           jax_rope.AuraFlowForRoPEMigrationConfig, ROPE_DENOISER, **fields)
    jax_model.denoiser.migration_scale.freezing_threshold = 1e-7
    flat = _weights(jax_model, 7)
    flat["denoiser.migration_scale.scale"] = np.full((1,), scale, np.float32)
    batch, draws = _batch(8), _draws(9)
    trainable, frozen = _split(flat, "denoiser.migration_scale.")
    _patch_jax_draws(monkeypatch, jax_rope, draws["vae_noise"], [draws["noise"]], draws["timesteps"])
    want = _jax_loss_and_grads(_jax_workload(jax_rope.AuraFlowForRoPEMigrationTraining, jax_model),
                               trainable, frozen, batch)
    assert "denoiser.migration_scale.scale" in want[2]

    model = _port_model(rope_train.AuraFlowForRoPEMigration,
                        rope_train.AuraFlowForRoPEMigrationConfig, ROPE_DENOISER, flat, **fields)
    model.denoiser.migration_scale.freezing_threshold = 1e-7
    got = _port_loss_and_grads(model, list(want[2]), lambda: rope_train.loss_with_draws(
        model, _torch_batch(batch), *(torch.from_numpy(draws[k]) for k in
                                      ("vae_noise", "timesteps", "noise"))))
    _compare(got, want)


# -- the pieces ------------------------------------------------------------------------


def test_shortcut_targets_and_durations_match_jax():
    """The self-consistency targets of a denoiser given to both; the
    durations of given exponents and departures; the port's draws never
    give exponent 0 (weight sqrt(0)) and keep departures in (0, 1]."""
    rng = np.random.default_rng(10)
    latents = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    w = rng.standard_normal((2, 2)).astype(np.float32)
    departure = np.asarray([1.0, 0.5, 0.25], np.float32)
    double = np.asarray([0.5, 0.25, 0.125], np.float32)

    def jax_denoise(x, t, d):
        return jnp.einsum("bhwc,cd->bhwd", x, jnp.asarray(w)) * (t + d)[:, None, None, None]

    def denoise(x, t, d):
        return torch.einsum("bhwc,cd->bhwd", x, torch.from_numpy(w)) * (t + d)[:, None, None, None]

    want = jax_shortcut_loss.prepare_self_consistency_targets(
        jax_denoise, jnp.asarray(latents), jnp.asarray(departure), jnp.asarray(double), 5.0)
    got = shortcut_loss.prepare_self_consistency_targets(
        denoise, torch.from_numpy(latents), torch.from_numpy(departure), torch.from_numpy(double), 5.0)
    for g, x in zip(got, want):
        _close(g.numpy(), np.asarray(x))
    _close(shortcut_loss.get_shortcut_target_velocity(*got).numpy(),
           np.asarray(jax_shortcut_loss.get_shortcut_target_velocity(*want)))
    pred = rng.standard_normal(latents.shape).astype(np.float32)
    _close(shortcut_loss.loss_with_shortcut_self_consistency(*got, torch.from_numpy(pred)).item(),
           float(jax_shortcut_loss.loss_with_shortcut_self_consistency(*want, jnp.asarray(pred))))

    exponent, u = np.asarray([0, 1, 3, 6]), np.asarray([0.0, 0.99, 0.5, 0.01], np.float32)
    steps = 2.0 ** exponent
    d = shortcut_loss.shortcut_duration_from(torch.from_numpy(exponent), torch.from_numpy(u))
    np.testing.assert_array_equal(d.shortcut_duration.numpy(), (1.0 / steps).astype(np.float32))
    np.testing.assert_array_equal(d.departure_timesteps.numpy(),
                                  ((np.floor(u * steps) + 1) / steps).astype(np.float32))
    drawn = shortcut_loss.prepare_random_shortcut_durations(torch.Generator().manual_seed(0), 4000)
    exps = drawn.shortcut_exponent.numpy()
    assert exps.min() >= 1 and exps.max() <= 6
    # sqrt-weighted as in the JAX package: P(e) = sqrt(e) / sum sqrt(1..6)
    freq = np.bincount(exps, minlength=7)[1:] / len(exps)
    weights = np.sqrt(np.arange(1, 7)) / np.sqrt(np.arange(1, 7)).sum()
    assert np.abs(freq - weights).max() < 0.03
    dep = drawn.departure_timesteps.numpy()
    assert dep.min() > 0 and dep.max() <= 1
    np.testing.assert_array_equal(dep * drawn.inference_steps.numpy(),
                                  np.round(dep * drawn.inference_steps.numpy()))


def test_zero_shortcut_embedder_is_a_no_op():
    """The shortcut workload's model starts with the embedder at zero (a
    base model's, before any adapter): a forward with a shortcut duration
    gives the forward without one, bit for bit."""
    jax_model = _jax_model(jax_shortcut.AuraFlowForShortcut,
                           jax_shortcut.AuraFlowForShortcutConfig, DENOISER)
    flat = _base(_weights(jax_model, 11, extra_scale=0.05))
    model = _port_model(shortcut_train.AuraFlowForShortcut, shortcut_train.AuraFlowForShortcutConfig,
                        DENOISER, flat)
    model.denoiser.reset_shortcut_params()
    rng = np.random.default_rng(12)
    latent = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((2, 6, TEXT["d_model"])).astype(np.float32))
    t = torch.tensor([0.3, 0.8])
    with torch.no_grad():
        plain = model.denoiser(latent, text, t)
        with_duration = model.denoiser(latent, text, t, shortcut_duration=torch.tensor([0.5, 0.125]))
    torch.testing.assert_close(with_duration, plain, rtol=0, atol=0)


def test_shortcut_generate_matches_jax(monkeypatch, tmp_path):
    """AuraFlowForShortcut.generate (Euler steps of 1 / n with that shortcut
    duration, CFG) against the JAX package's on the same weights, prompts
    and noise: the final latents; ``do_offloading`` is accepted and ignored,
    as in the JAX package."""
    (tmp_path / "tokenizer.model").write_bytes(_vocab_bytes())
    jax_model = _jax_model(jax_shortcut.AuraFlowForShortcut,
                           jax_shortcut.AuraFlowForShortcutConfig, DENOISER)
    jax_model.text_encoder.tokenizer = jax_auto_tokenizer.load_tokenizer(str(tmp_path), family="t5")
    flat = _base(_weights(jax_model, 13, extra_scale=0.05))
    jax_model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    model = _port_model(shortcut_train.AuraFlowForShortcut, shortcut_train.AuraFlowForShortcutConfig,
                        DENOISER, flat)
    model.text_encoder.tokenizer = auto_tokenizer.load_tokenizer(str(tmp_path), family="t5")
    noise = np.random.default_rng(14).standard_normal((2, 4, 4, 4)).astype(np.float32)
    latents = {}
    monkeypatch.setattr(jax_model, "prepare_latents", lambda *a, **kw: jnp.asarray(noise))
    monkeypatch.setattr(model, "prepare_latents", lambda *a, **kw: torch.from_numpy(noise))
    monkeypatch.setattr(jax_model, "decode_image", lambda z: latents.setdefault("jax", np.asarray(z)))
    monkeypatch.setattr(model, "decode_image", lambda z: latents.setdefault("port", z.numpy()))
    common = dict(width=32, height=32, num_inference_steps=4, cfg_scale=4.0, max_token_length=8)
    jax_model.generate(["a cat", "a red car"], **common)
    model.generate(["a cat", "a red car"], **common)
    assert np.isfinite(latents["port"]).all()
    _close(latents["port"], latents["jax"], tol=5e-4)
    monkeypatch.setattr(model, "decode_image", lambda z: latents.setdefault("staged", z.numpy()))
    model.generate(["a cat", "a red car"], do_offloading=True, **common)
    np.testing.assert_array_equal(latents["staged"], latents["port"])


@pytest.mark.parametrize("s", [0.0, 1.0], ids=["s0_learned_pe", "s1_rope"])
def test_rope_blend_ends(s):
    """At s = 0 the migration denoiser is the learned-PE MMDiT (identity
    rotations), at s = 1 the RoPE MMDiT with no PE; each also against the
    JAX package's migration denoiser."""
    jax_model = _jax_model(jax_rope.AuraFlowForRoPEMigration,
                           jax_rope.AuraFlowForRoPEMigrationConfig, ROPE_DENOISER)
    flat = _base(_weights(jax_model, 15))
    flat["denoiser.migration_scale.scale"] = np.full((1,), s, np.float32)
    model = _port_model(rope_train.AuraFlowForRoPEMigration,
                        rope_train.AuraFlowForRoPEMigrationConfig, ROPE_DENOISER, flat)
    rng = np.random.default_rng(16)
    latent = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    text = rng.standard_normal((2, 6, TEXT["d_model"])).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    args = tuple(torch.from_numpy(a) for a in (latent, text, t))
    with torch.no_grad():
        got = model.denoiser(*args)
        if s == 0.0:
            with model.while_rope_disabled():
                end = model.denoiser(*args)
        else:
            with model.while_migration_disabled():
                end = model.denoiser(*args)
    _close(got.numpy(), end.numpy(), tol=1e-6)
    params = unflatten_params({k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items()
                               if k.startswith("denoiser.")})
    want = jax_model.denoiser(params, *(jnp.asarray(a) for a in (latent, text, t)))
    _close(got.numpy(), np.asarray(want))


def test_migration_scale_freezes_and_rezeroes(tmp_path, monkeypatch):
    """Within the threshold of one the scale reads as ones with no
    gradient, as the JAX package's; the workload's setup re-zeroes a scale
    the checkpoint holds."""
    for value, threshold in ((0.99, 0.1), (0.5, 0.1), (0.5, None)):
        ours = MigrationScaleFromZero(1, threshold)
        with torch.no_grad():
            ours.scale.fill_(value)
        got = ours.inner_scale()
        (got.sum() + ours(torch.ones(1), torch.full((1,), 3.0)).sum()).backward()
        theirs = JaxMigrationScale(1, threshold)
        params = {"scale": jnp.full((1,), value, jnp.float32)}
        want = theirs.inner_scale(params)
        want_grad = jax.grad(lambda p: jnp.sum(theirs.inner_scale(p))
                             + jnp.sum(theirs(p, jnp.ones(1), jnp.full((1,), 3.0))))(params)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-7)
        np.testing.assert_allclose(ours.scale.grad.numpy(), np.asarray(want_grad["scale"]), rtol=1e-6)
        frozen = threshold is not None and abs(1 - value) < threshold
        assert (ours.scale.grad.abs().max().item() == 0) == frozen
    ours.rezero()
    assert ours.scale.item() == 0.0

    path = _checkpoint(tmp_path, ROPE_DENOISER, jax_rope.AuraFlowForRoPEMigration,
                       jax_rope.AuraFlowForRoPEMigrationConfig, scale=0.7)
    assert st.load_file(path)["model.migration_scale.scale"].item() == pytest.approx(0.7)
    _tiny_parts(monkeypatch, rope_train.AuraFlowForRoPEMigrationTraining)
    trainer = _port_trainer(_config(tmp_path, path, _image_folder(tmp_path), "rope",
                                    denoiser=ROPE_DENOISER), rope_cli)
    trainer.model.setup_model()
    scale = trainer.model.model.denoiser.migration_scale
    assert scale.scale.item() == 0.0 and scale.freezing_threshold == 1e-7


# -- the Trainer ------------------------------------------------------------------------


def _checkpoint(tmp_path, denoiser, cls=JaxAuraFlowModel, config_cls=jax_config.AuraFlowConig,
                scale=None):
    """The tiny model's weights (numpy draws on the JAX package's tree)
    written by the JAX package's state_dict() in the original single-file
    layout, the synthetic T5 vocab beside it."""
    jax_model = _jax_model(cls, config_cls, denoiser)
    rng = np.random.default_rng(20)
    jax_model.params = {root: _random_tree(getattr(jax_model, root), rng) for root in PARTS}
    if scale is not None:
        jax_model.params["denoiser"]["migration_scale"] = {"scale": jnp.full((1,), scale)}
    path = tmp_path / "tiny_auraflow.safetensors"
    jax_st.save_file(jax_model.state_dict(), path)
    (tmp_path / "tokenizer.model").write_bytes(_vocab_bytes())
    # the adapters both Trainers resume from: lora_down and lora_up numpy draws
    peft = jax_peft.PeftTargetConfig.model_validate(_peft())
    adapters = jax_peft.get_adapter_parameters(
        peft.replace_to_peft_layer(jax_model.params, jax.random.key(1)))
    jax_st.save_file({k: np.asarray(v) if k.endswith("alpha")
                      else (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                      for k, v in adapters.items()}, tmp_path / "adapters.safetensors")
    return path


def _peft(**more):
    return {"include_keys": INCLUDE, "exclude_keys": EXCLUDE,
            "config": {"type": "lora", "rank": 4, "alpha": 2.0, "dtype": "float32"}, **more}


def _image_folder(tmp_path, n=6):
    rng = np.random.default_rng(0)
    folder = tmp_path / "data"
    folder.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)).save(folder / f"{i}.png")
        (folder / f"{i}.txt").write_text("a photo of a cat, " + ", ".join(["red", "car"][: i % 3]))
    return folder


def _config(tmp_path, checkpoint, data_folder, out, denoiser=DENOISER, **model):
    return {
        "model": {"checkpoint_path": str(checkpoint), "dtype": "float32", "denoiser": denoiser,
                  **model},
        "dataset": {
            "folder": str(data_folder), "batch_size": 2, "bucket_base_size": 128, "step": 64,
            "min_size": 64, "num_repeats": 1, "num_workers": 0,
            "caption_processors": [{"type": "shuffle", "split_separator": ","}],
        },
        "peft": _peft(resume_weight_path=str(checkpoint.with_name("adapters.safetensors"))),
        "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1e-3}},
        "saving": {
            "strategy": {"per_epochs": 1, "per_steps": None},
            "callbacks": [{"type": "safetensors", "name": "lora", "save_dir": str(tmp_path / out)}],
        },
        "seed": 0,
        "num_train_epochs": 1,
        "trainer": {"gradient_checkpointing": True, "mesh": {"data": -1, "fsdp": 1, "tensor": 1}},
    }


def _tiny_parts(monkeypatch, workload):
    """The workload's model at the tiny UMT5 and VAE sizes (its own setup
    otherwise: the checkpoint, the zeroed embedder, the re-zeroed scale)."""
    base = workload.model_class

    class Tiny(base):
        def __init__(self, config, tokenizer=None, **kwargs):
            super().__init__(config, tokenizer, vae_config=AutoencoderKLConfig(**VAE),
                             text_encoder_config=umt5.UMT5Config(**TEXT))

    monkeypatch.setattr(workload, "model_class", Tiny)


def _port_trainer(config, cli=t2i_cli, workload=None, losses=None):
    tokenizer = auto_tokenizer.load_tokenizer(str(_folder_of(config)), family="t5")
    trainer = cli.build_trainer(TrainConfig.model_validate(config), tokenizer=tokenizer,
                                device="cpu")
    if workload is not None:
        trainer.register_model_class(workload, tokenizer=tokenizer)
    if losses is not None:
        trainer.log_dict = lambda values, step=None: (
            losses.append(values["train/loss"]) if "train/loss" in values else None)
    return trainer


def _folder_of(config):
    from pathlib import Path

    return Path(config["model"]["checkpoint_path"]).parent


def _latent_draws(batch, seed):
    b, h, w, _ = np.asarray(batch["image"]).shape
    return _draws(seed, (b, h // 8, w // 8, 4))


class JaxTiny(jax_t2i.AuraFlowForTextToImageTraining):
    def sanity_check(self):
        # the JAX workload's own check under one jit: run op by op, the CPU
        # backend compiles every op of the denoiser on its own
        jax.jit(super().sanity_check)()

    def setup_model(self):
        self.model = JaxAuraFlowModel(self.model_config, tokenizer=self.tokenizer,
                                      vae_config=JaxVAEConfig(**VAE),
                                      text_encoder_config=jax_umt5.UMT5Config(**TEXT))
        self.model._load_original_weights()
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        return {**out, **_latent_draws(batch, self.draw_seed)}

    def loss_fn(self, trainable, frozen, batch, key):
        """The body of the JAX ``loss_fn`` with the batch's draws."""
        params = jax_peft.merge_params(frozen, trainable)
        model = self.model
        hidden, _ = model.text_encoder.encode_tokens(
            params["text_encoder"], batch["input_ids"], batch["attention_mask"])
        hidden = jax.lax.stop_gradient(hidden)
        dist = model.vae.encode(params["vae"], batch["pixel_values"])
        latents = jax.lax.stop_gradient(
            (dist.mean + dist.std * batch["vae_noise"]) * model.vae.scaling_factor)
        t = batch["timesteps"]
        s = t.reshape(-1, 1, 1, 1)
        noisy = (1.0 - s) * latents + s * batch["noise"]
        velocity = model.denoiser(params["denoiser"], noisy, hidden, t)
        return jax_flow.loss_with_predicted_velocity(latents, batch["noise"], velocity), {}


class TorchTiny(t2i_train.AuraFlowForTextToImageTraining):
    def setup_model(self):
        self.model = AuraFlowModel(self.model_config, tokenizer=self.tokenizer,
                                   vae_config=AutoencoderKLConfig(**VAE),
                                   text_encoder_config=umt5.UMT5Config(**TEXT))
        self.model._from_checkpoint(device="cpu")
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        out.update({k: torch.from_numpy(v) for k, v in _latent_draws(batch, self.draw_seed).items()})
        return out

    def loss_fn(self, batch, generator):
        return t2i_train.loss_with_draws(self.model, batch, batch["vae_noise"], batch["timesteps"],
                                         batch["noise"])


def test_trainer_run_matches_jax(tmp_path, monkeypatch):
    """One epoch of three batches through both packages' Trainers from one
    JAX-written file (datasets, UMT5 tokenizing, LoRA on config #3's
    targets, AdamW, the saving callback): the per-step losses, the saved
    LoRA file's ComfyUI keys and values, the frozen base bit for bit as the
    file holds it."""
    from vision_ft_tpu.parallel import make_mesh
    from vision_ft_tpu.trainer import common as jax_common

    checkpoint, data = _checkpoint(tmp_path, DENOISER), _image_folder(tmp_path)
    monkeypatch.setattr(jax_common, "make_mesh", lambda cfg: make_mesh(cfg, jax.devices()[:1]))
    jax_trainer = JaxTrainer(JaxTrainConfig.model_validate(_config(tmp_path, checkpoint, data, "jax")))
    jax_trainer.register_train_dataset_class(JaxDatasetConfig)
    jax_trainer.register_model_class(
        JaxTiny, tokenizer=jax_auto_tokenizer.load_tokenizer(str(tmp_path), family="t5"))
    jax_losses, losses = [], []
    monkeypatch.setattr(jax_trainer, "log_dict", lambda values, step=None: jax_losses.append(
        values["train/loss"]) if "train/loss" in values else None)
    random.seed(5)
    jax_trainer.train()

    trainer = _port_trainer(_config(tmp_path, checkpoint, data, "torch"), workload=TorchTiny,
                            losses=losses)
    random.seed(5)
    trainer.train()

    assert len(jax_losses) == len(losses) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    (jax_file,), (file,) = sorted((tmp_path / "jax").glob("*.safetensors")), sorted(
        (tmp_path / "torch").glob("*.safetensors"))
    assert file.name == jax_file.name
    got, want = st.load_file(file), jax_st.load_file(jax_file)
    assert set(got) == set(want) and all(k.startswith("diffusion_model.") for k in got)
    assert any("lora_up" in k for k in got) and any(".modC." in k for k in got)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ADAPTER_ATOL,
                                   err_msg=key)
    adapters = st.load_file(checkpoint.with_name("adapters.safetensors"))
    assert set(got) == {convert_to_comfy_key(k) for k in adapters}
    assert any(not torch.equal(got[convert_to_comfy_key(k)], v)  # the adapters trained
               for k, v in adapters.items() if "lora_up" in k)
    from_file, live = st.load_file(checkpoint), trainer.model.model.state_dict()
    for key, value in from_file.items():
        assert torch.equal(live[key], value), key


@pytest.mark.parametrize("cli", [shortcut_cli, rope_cli], ids=["shortcut", "rope_migration"])
def test_port_trainer_step_of_each_workload(tmp_path, monkeypatch, cli):
    """One Trainer step of the shortcut and the RoPE migration workloads on
    the CPU, every draw from the Trainer's generator: a finite loss, the
    adapters and the workload's own leaf (the shortcut embedder, the
    migration scale) move off their start, the base stays as the file
    holds it, and the saved file holds the adapters and that leaf."""
    rope = cli is rope_cli
    denoiser = ROPE_DENOISER if rope else DENOISER
    cls, config_cls = ((jax_rope.AuraFlowForRoPEMigration, jax_rope.AuraFlowForRoPEMigrationConfig)
                       if rope else (JaxAuraFlowModel, jax_config.AuraFlowConig))
    checkpoint = _checkpoint(tmp_path, denoiser, cls, config_cls)
    config = _config(tmp_path, checkpoint, _image_folder(tmp_path, 2), "out", denoiser=denoiser)
    if not rope:  # configs/auraflow/shortcut.yml's targets and fields, fewer steps
        config["model"].update(flow_matching_ratio=0.5, shortcut_max_steps=8)
        include, exclude = SHORTCUT_TARGETS
        config["peft"] = _peft(include_keys=include, exclude_keys=exclude)
    _tiny_parts(monkeypatch, rope_train.AuraFlowForRoPEMigrationTraining if rope
                else shortcut_train.AuraFlowForShortcutTraining)
    losses = []
    trainer = _port_trainer(config, cli, losses=losses)
    trainer.train()
    assert len(losses) == 1 and math.isfinite(losses[0])
    # the embedder's first gradient reaches only its last bias: both weights are zero
    leaf = "denoiser.migration_scale.scale" if rope else "denoiser.shortcut_embedder.mlp.2.bias"
    value = trainer.model.get_params().state_dict()[leaf]
    assert value.abs().max() > 0  # moved off zero
    (saved,) = (tmp_path / "out").glob("*.safetensors")
    saved = st.load_file(saved)
    assert convert_to_comfy_key(leaf) in saved and any("lora_down" in k for k in saved)
    live = trainer.model.model.state_dict()
    for key, value in st.load_file(checkpoint).items():
        if "migration_scale" not in key:
            assert torch.equal(live[key], value), key


@pytest.mark.parametrize("cli,workload", [
    (t2i_cli, t2i_train.AuraFlowForTextToImageTraining),
    (shortcut_cli, shortcut_train.AuraFlowForShortcutTraining),
    (rope_cli, rope_train.AuraFlowForRoPEMigrationTraining),
])
def test_train_scripts_build_the_registered_trainer(tmp_path, monkeypatch, cli, workload):
    """Each CLI's ``main`` reads the config file and trains the Trainer its
    ``build_trainer`` makes, on the card by default (``device=None``)."""
    seen = {}

    def build(config, tokenizer=None, device=None):
        trainer = types.SimpleNamespace(train=lambda: seen.setdefault("trained", True))
        seen.update(config=config, device=device)
        return trainer

    monkeypatch.setattr(cli, "build_trainer", build)
    folder = tmp_path / "img"
    folder.mkdir()
    path = tmp_path / "c.yml"
    path.write_text(f"model:\n  checkpoint_path: x\ndataset:\n  folder: {folder}\n")
    cli.main(["--config", str(path)])
    assert seen["trained"] and seen["device"] is None
    assert seen["config"].model["checkpoint_path"] == "x"
    monkeypatch.undo()
    built = cli.build_trainer(TrainConfig.from_config_file(str(path)), device="cpu")
    assert type(built.model) is workload and built.device == torch.device("cpu")
