"""The port's AuraFlow VAE-encoder migration workload against the JAX
package's, on the CPU in fp32 with both VAEs at tiny widths (the
workloads' module-level VAE configs patched in both packages): the loss
and the migration scale's gradient against ``jax.grad``, the zero-padding
helpers, the saved keys, the sanity check, and Trainer steps through the
script's ``build_trainer`` in which only the migration scale moves.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.torch import load_file, save_file

from vision_ft_tpu.config import TrainConfig as JaxTrainConfig
from vision_ft_tpu.models.auraflow import train_vae_encode_migration as jax_mig
from vision_ft_tpu.models.autoencoder import AutoencoderKL
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.modules.migration.scale import MigrationScaleFromZero
from vision_ft_tpu.nn import flatten_params, unflatten_params

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.models.auraflow import train_vae_encode_migration as mig
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.train.auraflow import vae_encode_migration as cli
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

TOL = 5e-5
AURA_VAE = dict(block_out_channels=(8, 8, 16, 16), latent_channels=4, norm_num_groups=4)
FLUX_VAE = dict(block_out_channels=(8, 8, 16, 16), latent_channels=16, norm_num_groups=4,
                use_quant_conv=False, scaling_factor=0.3611, shift_factor=0.1159)
DENOISER = dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2,
                attention_head_dim=32, num_double_layers=1, num_single_layers=1)
SAVED = {"diffusion_model.init_x_linear.weight", "diffusion_model.init_x_linear.bias",
         "migration_scale.scale"}


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale, msg


@pytest.fixture(autouse=True)
def tiny_vaes(monkeypatch):
    monkeypatch.setattr(mig, "AURA_VAE_CONFIG", AutoencoderKLConfig(**AURA_VAE))
    monkeypatch.setattr(mig, "FLUX_VAE_CONFIG", AutoencoderKLConfig(**FLUX_VAE))
    monkeypatch.setattr(jax_mig, "AURA_VAE_CONFIG", JaxVAEConfig(**AURA_VAE))
    monkeypatch.setattr(jax_mig, "FLUX_VAE_CONFIG", JaxVAEConfig(**FLUX_VAE))


def _config(checkpoint="absent.safetensors", folder=None, save_dir=None, **model):
    config = {
        "model": {"checkpoint_path": str(checkpoint), "dtype": "float32", "denoiser": DENOISER,
                  **model},
        "dataset": {"folder": str(folder or "."), "batch_size": 2, "bucket_base_size": 128,
                    "step": 64, "min_size": 64, "num_repeats": 1, "num_workers": 0},
        "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1e-2}},
        "seed": 0,
        "num_train_epochs": 1,
    }
    if save_dir is not None:
        config["saving"] = {
            "strategy": {"per_epochs": 1, "per_steps": None},
            "callbacks": [{"type": "safetensors", "name": "migration", "save_dir": str(save_dir)}],
        }
    return config


def _workloads(**model):
    """The port's workload set up on the CPU (its seeded VAEs, the extended
    init_x_linear, a scale of 0.3 + 0.1 n) and the JAX workload on the same
    parameters."""
    config = _config(**model)
    port = cli.build_trainer(TrainConfig.model_validate(config), device="cpu").model
    port.setup_model()
    with torch.no_grad():
        rng = np.random.default_rng(1)
        port.migration_scale.scale.copy_(torch.from_numpy(
            (0.3 + 0.1 * rng.standard_normal(64)).astype(np.float32)))
    flat = {k: v.numpy() for k, v in port.get_params().state_dict().items()}
    ours = jax_mig.AuraFlowForVAEEncoderMigrationTraining(None, JaxTrainConfig.model_validate(config))
    # the modules the JAX setup_model makes, on the port's parameters (the
    # JAX init of two VAEs would cost more than the whole file on the CPU)
    ours.aura_vae = AutoencoderKL(jax_mig.AURA_VAE_CONFIG)
    ours.flux_vae = AutoencoderKL(jax_mig.FLUX_VAE_CONFIG)
    ours.patch_size, ours.latent_channels, ours.new_patch_dim = 2, 16, 64
    ours.migration_scale = MigrationScaleFromZero(
        dim=64, freezing_threshold=ours.model_config.migration_freezing_threshold)
    ours.params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    ours.model = ours
    return port, ours, flat


def test_config_and_padding_helpers_match_jax():
    assert (mig.AuraFlowForVAEEncoderMigrationConfig(checkpoint_path="x").model_dump()
            == jax_mig.AuraFlowForVAEEncoderMigrationConfig(checkpoint_path="x").model_dump())
    rng = np.random.default_rng(0)
    leaves = {"weight": rng.standard_normal((8, 16)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)}
    want = jax_mig.extend_init_x_linear({k: jnp.asarray(v) for k, v in leaves.items()}, 64)
    got = mig.extend_init_x_linear({k: torch.from_numpy(v) for k, v in leaves.items()}, 64)
    for key in leaves:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert not got["weight"][:, 16:].any()
    patches = rng.standard_normal((2, 5, 16)).astype(np.float32)
    np.testing.assert_array_equal(mig.pad_patches(torch.from_numpy(patches), 64).numpy(),
                                  np.asarray(jax_mig.pad_patches(jnp.asarray(patches), 64)))


@pytest.mark.parametrize("losses", [dict(), dict(migration_loss=False),
                                    dict(prior_preservation_loss=False)],
                         ids=["both", "ppl_only", "migration_only"])
def test_loss_and_gradient_match_jax(losses):
    """The loss, its logs and the scale's gradient (the only trainable leaf)
    on seeded images, against ``jax.value_and_grad`` of the JAX loss."""
    port, ours, flat = _workloads(**losses)
    image = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    trainable = {"migration_scale": ours.params["migration_scale"]}
    frozen = {k: v for k, v in ours.params.items() if k != "migration_scale"}

    def loss(tr):
        return ours.loss_fn(tr, frozen, {"pixel_values": jnp.asarray(image)}, None)

    (want, want_logs), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(trainable)
    scale = port.migration_scale.scale
    scale.requires_grad_(True)
    value, logs = port.loss_fn({"pixel_values": torch.from_numpy(image)}, None)
    value.backward()
    _close(value.item(), float(want), msg="loss")
    assert set(logs) == set(want_logs)
    for key, w in want_logs.items():
        _close(float(logs[key]), float(w), msg=key)
    _close(scale.grad.numpy(), np.asarray(want_grads["migration_scale"]["scale"]), msg="grad")
    assert float(np.abs(scale.grad.numpy()).max()) > 0
    assert all(p.grad is None for k, p in port.get_params().named_parameters()
               if not k.startswith("migration_scale."))


def test_saved_keys_and_sanity_check():
    port, ours, flat = _workloads()
    port._set_is_peft(False)
    saved = port.get_state_dict_to_save()
    theirs = ours.get_state_dict_to_save()
    assert set(saved) == set(theirs) == SAVED
    for key, value in saved.items():
        np.testing.assert_array_equal(value.detach().numpy(), np.asarray(theirs[key]), err_msg=key)
    port.sanity_check()
    assert [k for k in flatten_params(ours.params) if ours.trainable_filter(k)] == [
        k for k in flat if port.trainable_filter(k)] == ["migration_scale.scale"]


def _image_folder(path, n=4):
    rng = np.random.default_rng(0)
    path.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)).save(path / f"{i}.png")
        (path / f"{i}.txt").write_text("a photo of a cat")
    return path


def test_trainer_moves_only_the_migration_scale(tmp_path, monkeypatch):
    """Two Trainer steps through the script: init_x_linear comes from the
    checkpoint (its 16 columns, zeros past them), the loss is finite, the
    scale moves off zero, nothing else moves, and the saved file holds the
    ComfyUI keys; ``main`` trains the Trainer ``build_trainer`` makes."""
    rng = np.random.default_rng(3)
    weight = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    checkpoint = tmp_path / "aura.safetensors"
    save_file({"model.init_x_linear.weight": weight, "model.init_x_linear.bias": bias,
               "model.register_tokens": torch.zeros(1, 2, 64)}, str(checkpoint))
    config = _config(checkpoint, _image_folder(tmp_path / "data"), tmp_path / "out")
    trainer = cli.build_trainer(TrainConfig.model_validate(config), device="cpu")
    losses = []
    trainer.log_dict = lambda values, step=None: (
        losses.append(values["train/loss"]) if "train/loss" in values else None)
    trainer.train()
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    params = trainer.model.get_params().state_dict()
    linear = params["denoiser.init_x_linear.weight"]
    assert torch.equal(linear[:, :16], weight) and not linear[:, 16:].any()
    assert torch.equal(params["denoiser.init_x_linear.bias"], bias)
    assert params["migration_scale.scale"].abs().max() > 0
    fresh = cli.build_trainer(TrainConfig.model_validate(config), device="cpu").model
    fresh.setup_model()
    for key, value in fresh.get_params().state_dict().items():
        if not key.startswith("migration_scale."):
            assert torch.equal(params[key], value), key
    (saved,) = (tmp_path / "out").glob("*.safetensors")
    assert set(load_file(saved)) == SAVED

    seen = {}
    monkeypatch.setattr(cli, "build_trainer", lambda config, tokenizer=None, device=None: (
        seen.update(config=config, device=device) or type("T", (), {"train": lambda self: None})()))
    path = tmp_path / "c.yml"
    path.write_text(f"model:\n  checkpoint_path: x\ndataset:\n  folder: {tmp_path}\n")
    cli.main(["--config", str(path)])
    assert seen["device"] is None and seen["config"].model["checkpoint_path"] == "x"
