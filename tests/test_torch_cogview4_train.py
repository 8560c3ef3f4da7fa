"""The port's CogView4 train slice against the JAX package's (CPU, fp32):
the text-to-image workload's loss and LoRA gradients, and a Trainer run of
both packages on ``configs/cogview4/text_to_image.yml``.

The tiny CogView4 of tests/test_torch_cogview4.py gets numpy weights on
the JAX package's tree and LoRA rank 8 on ``attn`` / ``ff`` (the config's
targets) by the JAX package, lora_up drawn non-zero. The frameworks'
random bits differ, so both sides get the same draws: the port through the
workload's ``loss_with_draws``, the JAX package through its own
``loss_fn`` with its draw functions patched to return them (the VAE
sample, the timesteps, the noise). Gradients of the adapters are held
against ``jax.grad``.
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vision_ft_tpu.config import TrainConfig as JaxTrainConfig
from vision_ft_tpu.dataset.text_to_image import TextToImageDatasetConfig as JaxDatasetConfig
from vision_ft_tpu.models.cogview4 import train_text_to_image as jax_t2i
from vision_ft_tpu.models.cogview4.pipeline import CogView4Model as JaxCogView4Model
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.loss import flow_match as jax_flow
from vision_ft_tpu.nn import flatten_params, unflatten_params
from vision_ft_tpu.trainer import Trainer as JaxTrainer
from vision_ft_tpu.utils import safetensors as jax_st

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.cogview4 import train_text_to_image as t2i_train
from vision_ft_tpu_torch.models.cogview4.config import CogView4Config
from vision_ft_tpu_torch.models.cogview4.pipeline import CogView4Model, convert_to_comfy_key
from vision_ft_tpu_torch.models.text_encoders import glm
from vision_ft_tpu_torch.modules.peft import PeftTargetConfig
from vision_ft_tpu_torch.train.cogview4 import text_to_image as t2i_cli
from vision_ft_tpu_torch.utils import safetensors as st

from test_torch_auraflow_train import (
    _compare,
    _image_folder,
    _jax_loss_and_grads,
    _jax_workload,
    _patch_jax_draws,
    _port_loss_and_grads,
)
from test_torch_cogview4 import (
    GLM,
    TINY,
    VAE,
    GlmTok,
    jax_pipeline_model,
    port_pipeline,
    pipeline_weights,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# a Trainer run: the losses of three AdamW steps; the saved adapters, where
# AdamW divides each gradient element by its own rms, so an element whose
# gradient sits at fp32 rounding level moves by up to lr either way
# (tests/test_torch_trainer_lumina2.py)
LOSS_RTOL, ADAPTER_ATOL = 1e-4, 1e-3
YAML = "configs/cogview4/text_to_image.yml"
INCLUDE, EXCLUDE = ["attn", "ff"], ["text_encoder", "vae"]
PARTS = ("denoiser", "vae", "text_encoder")
B = 2


def _weights(seed):
    """The tiny pipeline's seeded weights with rank-8 LoRA on the config's
    targets (lora_up non-zero), internal keys."""
    jax_model = jax_pipeline_model()
    flat = pipeline_weights(jax_model)
    denoiser = unflatten_params({k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items()
                                 if k.startswith("denoiser.")})
    denoiser = jax_peft.replace_to_peft_layer(
        denoiser, INCLUDE, EXCLUDE, jax_peft.LoRAConfig(rank=8, alpha=4.0, dtype="float32"),
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for key, value in flatten_params(denoiser).items():
        value = np.asarray(value)
        if key.endswith("lora_up.weight"):
            value = rng.normal(0, 0.05, value.shape).astype(np.float32)
        flat[f"denoiser.{key}"] = value
    return jax_model, flat


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, GLM["vocab_size"], (B, 16)).astype(np.int32)
    ids[1, :9] = 0  # left padding
    return {
        "pixel_values": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32),
        "input_ids": ids,
        "original_size": np.asarray([[64, 64], [640, 512]], np.float32),
        "target_size": np.asarray([[64, 64], [64, 64]], np.float32),
        "crop_coords_top_left": np.asarray([[0, 0], [32, 0]], np.float32),
    }


def _draws(seed, shape=(B, 8, 8, 4)):
    rng = np.random.default_rng(seed)
    return {
        "vae_noise": rng.standard_normal(shape).astype(np.float32),
        "timesteps": rng.uniform(0.05, 0.95, shape[:1]).astype(np.float32),
        "noise": rng.standard_normal(shape).astype(np.float32),
    }


def _split(flat):
    params = {root: unflatten_params({k[len(root) + 1:]: jnp.asarray(v) for k, v in flat.items()
                                      if k.startswith(root + ".")}) for root in PARTS}
    return jax_peft.split_peft_params(params)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_lora_grads_match_jax(monkeypatch, remat):
    """Sigmoid timesteps, the velocity MSE with the size conditioning, GLM
    and VAE encode inside under no_grad; the gradients of every adapter,
    with and without gradient checkpointing."""
    jax_model, flat = _weights(0)
    batch, draws = _batch(1), _draws(2)
    trainable, frozen = _split(flat)
    _patch_jax_draws(monkeypatch, jax_t2i, draws["vae_noise"], [draws["noise"]], draws["timesteps"])
    jax_model.denoiser.set_gradient_checkpointing(remat)
    want = _jax_loss_and_grads(_jax_workload(jax_t2i.CogView4ForTextToImageTraining, jax_model),
                               trainable, frozen, batch)

    model = port_pipeline(flat)
    model.denoiser.set_gradient_checkpointing(remat)
    keys = [f"denoiser.{k}" for k in flatten_params(trainable["denoiser"])]
    assert len(keys) == 2 * 2 * 6 and all(".attn1." in k or ".ff." in k for k in keys)
    got = _port_loss_and_grads(model, keys, lambda: t2i_train.loss_with_draws(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        *(torch.from_numpy(draws[k]) for k in ("vae_noise", "timesteps", "noise"))))
    _compare(got, want)


def test_loss_fn_draws_from_the_generator():
    """The Trainer's loss draws everything from its generator: the same
    seed gives the same loss, another seed another one."""
    _, flat = _weights(3)
    model = port_pipeline(flat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    with torch.no_grad():
        losses = [t2i_train.loss_fn(model, batch, torch.Generator().manual_seed(s))[0].item()
                  for s in (0, 0, 1)]
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]


def test_yaml_loads_unchanged_in_the_port():
    """configs/cogview4/text_to_image.yml in the port's TrainConfig as it
    is: LoRA rank 8 on attn / ff, batch 2, torch.optim.AdamW,
    checkpointing; its model section is a CogView4Config, and both CLIs'
    Trainers take it."""
    config = TrainConfig.from_config_file(YAML)
    jax_config = JaxTrainConfig.from_config_file(YAML)
    assert config.model == jax_config.model
    model = CogView4Config.model_validate(config.model)
    assert model.dtype == "bfloat16" and model.denoiser.num_layers == 28
    peft = PeftTargetConfig.model_validate(config.peft.model_dump())
    assert (peft.include_keys, peft.exclude_keys) == (INCLUDE, EXCLUDE)
    assert peft.config.rank == 8 and peft.config.alpha == 4.0
    assert config.dataset["batch_size"] == 2 and config.optimizer.name == "torch.optim.AdamW"
    assert config.trainer.gradient_checkpointing is True
    trainer = t2i_cli.build_trainer(config, tokenizer=GlmTok(), device="cpu")
    assert type(trainer.model) is t2i_train.CogView4ForTextToImageTraining
    assert trainer.device == torch.device("cpu")


def test_train_script_builds_the_registered_trainer(tmp_path, monkeypatch):
    """The CLI's ``main`` reads the config file and trains the Trainer its
    ``build_trainer`` makes, on the card by default (``device=None``)."""
    seen = {}

    def build(config, tokenizer=None, device=None):
        seen.update(config=config, device=device)
        return types.SimpleNamespace(train=lambda: seen.setdefault("trained", True))

    monkeypatch.setattr(t2i_cli, "build_trainer", build)
    t2i_cli.main(["--config", YAML])
    assert seen["trained"] and seen["device"] is None
    assert seen["config"].model["checkpoint_path"] == "./models/cogview4-6b.safetensors"


# -- the Trainer ------------------------------------------------------------------------


def _checkpoint(tmp_path):
    """The tiny model's weights written by the JAX package's state_dict() in
    the single-file layout, and the adapters both Trainers resume from."""
    jax_model = jax_pipeline_model()
    jax_model.params = {root: unflatten_params({
        k[len(root) + 1:]: jnp.asarray(v) for k, v in pipeline_weights(jax_model).items()
        if k.startswith(root + ".")}) for root in PARTS}
    path = tmp_path / "tiny_cogview4.safetensors"
    jax_st.save_file(jax_model.state_dict(), path)
    peft = jax_peft.PeftTargetConfig.model_validate(_peft())
    adapters = jax_peft.get_adapter_parameters(
        peft.replace_to_peft_layer(jax_model.params, jax.random.key(1)))
    rng = np.random.default_rng(20)
    jax_st.save_file({k: np.asarray(v) if k.endswith("alpha")
                      else (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                      for k, v in adapters.items()}, tmp_path / "adapters.safetensors")
    return path


def _peft(**more):
    with open(YAML) as f:
        peft = yaml.safe_load(f)["peft"]
    return {**peft, "config": {**peft["config"], "dtype": "float32"}, **more}


def _config(tmp_path, checkpoint, data_folder, out):
    """The YAML with what a tiny CPU run needs: the tiny model from
    ``checkpoint`` in fp32, the seeded images at 128 px, fp32 adapters
    resumed from one file, lr 1e-3 (so that three steps move the adapters
    past the saved file's limit), one epoch, one device."""
    with open(YAML) as f:
        config = yaml.safe_load(f)
    config["model"] = {"checkpoint_path": str(checkpoint), "dtype": "float32", "denoiser": TINY}
    config["dataset"].update(folder=str(data_folder), bucket_base_size=128, step=64, min_size=64,
                             num_repeats=1, num_workers=0)
    config["peft"] = _peft(resume_weight_path=str(checkpoint.with_name("adapters.safetensors")))
    config["optimizer"]["args"]["lr"] = 1e-3
    config["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / out)
    config["num_train_epochs"] = 1
    config["trainer"]["mesh"] = {"data": -1, "fsdp": 1, "tensor": 1}
    return config


def _latent_draws(batch, seed):
    b, h, w, _ = np.asarray(batch["image"]).shape
    return _draws(seed, (b, h // 8, w // 8, 4))


class JaxTiny(jax_t2i.CogView4ForTextToImageTraining):
    def sanity_check(self):
        # the JAX workload's own check under one jit: run op by op, the CPU
        # backend compiles every op of the denoiser on its own
        jax.jit(super().sanity_check)()

    def setup_model(self):
        from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
        from vision_ft_tpu.models.text_encoders.glm import GlmConfig as JaxGlmConfig

        self.model = JaxCogView4Model(self.model_config, tokenizer=self.tokenizer,
                                      vae_config=JaxVAEConfig(**VAE),
                                      text_encoder_config=JaxGlmConfig(**GLM))
        self.model._from_checkpoint()
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        return {**out, **_latent_draws(batch, self.draw_seed)}

    def loss_fn(self, trainable, frozen, batch, key):
        """The body of the JAX ``loss_fn`` with the batch's draws."""
        params = jax_peft.merge_params(frozen, trainable)
        model = self.model
        hidden = jax.lax.stop_gradient(
            model.text_encoder.encode_tokens(params["text_encoder"], batch["input_ids"]))
        dist = model.vae.encode(params["vae"], batch["pixel_values"])
        latents = jax.lax.stop_gradient(
            (dist.mean + dist.std * batch["vae_noise"]) * model.vae.scaling_factor)
        t = batch["timesteps"]
        s = t.reshape(-1, 1, 1, 1)
        noisy = (1.0 - s) * latents + s * batch["noise"]
        velocity = model.denoiser(params["denoiser"], noisy, hidden, t, batch["original_size"],
                                  batch["target_size"], batch["crop_coords_top_left"])
        return jax_flow.loss_with_predicted_velocity(latents, batch["noise"], velocity), {}


class TorchTiny(t2i_train.CogView4ForTextToImageTraining):
    def setup_model(self):
        self.model = CogView4Model(self.model_config, tokenizer=self.tokenizer,
                                   vae_config=AutoencoderKLConfig(**VAE),
                                   text_encoder_config=glm.GlmConfig(**GLM))
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
    """One epoch of three batches of configs/cogview4/text_to_image.yml
    through both packages' Trainers from one JAX-written file (datasets,
    GLM tokenizing, size conditioning, LoRA rank 8 on attn / ff, AdamW,
    checkpointing, the saving callback): the per-step losses, the saved
    LoRA file's ComfyUI keys and values, the frozen base bit for bit as the
    file holds it."""
    from vision_ft_tpu.parallel import make_mesh
    from vision_ft_tpu.trainer import common as jax_common

    checkpoint, data = _checkpoint(tmp_path), _image_folder(tmp_path)
    monkeypatch.setattr(jax_common, "make_mesh", lambda cfg: make_mesh(cfg, jax.devices()[:1]))
    jax_trainer = JaxTrainer(JaxTrainConfig.model_validate(_config(tmp_path, checkpoint, data, "jax")))
    jax_trainer.register_train_dataset_class(JaxDatasetConfig)
    jax_trainer.register_model_class(JaxTiny, tokenizer=GlmTok())
    jax_losses, losses = [], []
    monkeypatch.setattr(jax_trainer, "log_dict", lambda values, step=None: jax_losses.append(
        values["train/loss"]) if "train/loss" in values else None)
    random.seed(5)
    jax_trainer.train()

    trainer = t2i_cli.build_trainer(
        TrainConfig.model_validate(_config(tmp_path, checkpoint, data, "torch")),
        tokenizer=GlmTok(), device="cpu")
    trainer.register_model_class(TorchTiny, tokenizer=GlmTok())
    trainer.log_dict = lambda values, step=None: (
        losses.append(values["train/loss"]) if "train/loss" in values else None)
    random.seed(5)
    trainer.train()

    assert trainer.model.model.denoiser.gradient_checkpointing
    assert len(jax_losses) == len(losses) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    (jax_file,), (file,) = sorted((tmp_path / "jax").glob("*.safetensors")), sorted(
        (tmp_path / "torch").glob("*.safetensors"))
    assert file.name == jax_file.name
    got, want = st.load_file(file), jax_st.load_file(jax_file)
    assert set(got) == set(want) and all(k.startswith("diffusion_model.") for k in got)
    assert any(".attn1.to_q.lora_up" in k for k in got) and any(".ff.net.2." in k for k in got)
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
