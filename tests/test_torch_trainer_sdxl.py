"""The port's Trainer on the SDXL text-to-image workload against the JAX
package's (CPU, fp32).

A tiny SDXL (the sizes of tests/test_torch_sdxl.py) is written once with
the JAX package's ``state_dict()`` to a safetensors file, and both
Trainers start from that file through their workload's checkpoint
loading. The same image folder, config and seed then go through both
packages' datasets, dataloaders, preprocessing (tokenizing, the latent and
text caches), LoRA, the schedule-free optimizer and the saving callback.
The frameworks' random bits differ, so the timesteps, the noise and the
VAE sample's noise are drawn with numpy in ``preprocess_batch`` and read by
a ``loss_fn`` written for the test in each package; everything else is
the packages' own code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vision_ft_tpu.config import TrainConfig as JaxTrainConfig
from vision_ft_tpu.dataset.text_to_image import TextToImageDatasetConfig as JaxDatasetConfig
from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel
from vision_ft_tpu.models.sdxl.train_text_to_image import (
    SDXLForTextToImageTraining as JaxSDXLTraining,
)
from vision_ft_tpu.modules.loss import diffusion as jax_diffusion
from vision_ft_tpu.modules.peft import PeftTargetConfig as JaxPeftTargetConfig
from vision_ft_tpu.modules.peft import get_adapter_parameters
from vision_ft_tpu.modules.peft import merge_params as jax_merge_params
from vision_ft_tpu.trainer import Trainer as JaxTrainer
from vision_ft_tpu.utils import safetensors as jax_st

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.dataset.text_to_image import TextToImageDatasetConfig
from vision_ft_tpu_torch.models.sdxl import train_text_to_image
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.sdxl.util import convert_to_comfy_key
from vision_ft_tpu_torch.trainer import Trainer
from vision_ft_tpu_torch.train.sdxl.text_to_image import build_trainer
from vision_ft_tpu_torch.utils import safetensors as st

from test_torch_sdxl import _random_params, _tiny_kwargs
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

PEFT = {
    "include_keys": ["attn1", "attn2", ".ff."],
    "exclude_keys": ["text_encoder", "vae"],
    "config": {"type": "lora", "rank": 4, "alpha": 2.0, "dtype": "float32"},
}
LOSS_RTOL = 1e-4     # fp32 sums in other orders through a whole UNet forward and backward
# the saved adapters after the run: the schedule-free AdamW step divides
# each gradient element by its own rms, so an element whose gradient sits
# at fp32 rounding level still moves by up to about lr (1e-3) a step, either
# way, and the two packages' roundings differ: lr (with SGD in its place
# the adapters agree within 1e-5)
ADAPTER_ATOL = 1e-3


def _draws(batch, latent_shape, seed):
    rng = np.random.default_rng(seed)
    b = latent_shape[0]
    batch["timesteps"] = rng.integers(0, 1000, (b,)).astype(np.int32)
    batch["noise"] = rng.standard_normal(latent_shape).astype(np.float32)
    batch["vae_noise"] = rng.standard_normal(latent_shape).astype(np.float32)
    return batch


def _latent_shape(batch):
    b, h, w, _ = np.asarray(batch["image"]).shape
    return (b, h // 8, w // 8, 4)


class JaxTiny(JaxSDXLTraining):
    def setup_model(self):
        self.model = JaxSDXLModel(self.model_config, **_tiny_kwargs("jax")[1])
        self.model._from_checkpoint()
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        return _draws(out, _latent_shape(batch), self.draw_seed)

    def loss_fn(self, trainable, frozen, batch, key):
        params = jax_merge_params(frozen, trainable)
        model = self.model
        if "cached_context" in batch:
            context, pooled = batch["cached_context"], batch["cached_pooled"]
        else:
            emb1, emb2, pooled = model.text_encoder.encode_tokens(
                params["text_encoder"], batch["input_ids"], batch["input_ids"],
                batch["original_size"].shape[0],
            )
            context = jnp.concatenate([emb1, emb2], axis=-1)
        if "cached_latents" in batch:
            latents = batch["cached_latents"]
        else:
            dist = model.vae.encode(params["vae"], batch["pixel_values"])
            latents = (dist.mean + dist.std * batch["vae_noise"]) * model.vae.scaling_factor
        context, pooled, latents = (jax.lax.stop_gradient(t) for t in (context, pooled, latents))
        timesteps = batch["timesteps"]
        a = jax_diffusion.get_alphas_cumprod()[timesteps].reshape(-1, 1, 1, 1)
        noisy = jnp.sqrt(a) * latents + jnp.sqrt(1.0 - a) * batch["noise"]
        pred = model.denoiser(
            params["denoiser"], noisy, timesteps.astype(jnp.float32), context, pooled,
            batch["original_size"], batch["target_size"], batch["crop_coords_top_left"],
        )
        loss = jax_diffusion.loss_with_predicted_noise(latents, batch["noise"], pred)
        return loss, {}


class TorchTiny(train_text_to_image.SDXLForTextToImageTraining):
    def setup_model(self):
        self.model = SDXLModel(self.model_config, **_tiny_kwargs("torch")[1])
        self.model._from_checkpoint(device="cpu")
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        draws = _draws({}, _latent_shape(batch), self.draw_seed)
        out.update({k: torch.from_numpy(v) for k, v in draws.items()})
        return out

    def loss_fn(self, batch, generator):
        vae_noise = None if "cached_latents" in batch else batch["vae_noise"]
        loss = train_text_to_image.loss_with_draws(
            self.model, batch, batch["timesteps"], batch["noise"], vae_noise=vae_noise
        )
        return loss, {}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny SDXL's weights in the sgm single-file layout, written by the
    JAX package, and beside them an adapter file (lora_down and lora_up
    drawn with numpy): the frameworks' random bits differ, so both
    Trainers resume their adapters from it."""
    path = tmp_path_factory.mktemp("ckpt") / "tiny_sdxl.safetensors"
    config, kwargs = _tiny_kwargs("jax")
    model = JaxSDXLModel(config, **kwargs)
    shapes = {name: jax.eval_shape(getattr(model, name).init, jax.random.key(0))
              for name in ("denoiser", "vae", "text_encoder")}
    flat = _random_params(shapes, 0)
    model.load_state_dict({k: jnp.asarray(v) for k, v in flat.items()})
    jax_st.save_file(model.state_dict(), path)
    peft = JaxPeftTargetConfig.model_validate(PEFT)
    adapters = get_adapter_parameters(peft.replace_to_peft_layer(model.params, jax.random.key(1)))
    rng = np.random.default_rng(1)
    adapters = {
        k: np.asarray(v) if k.endswith("alpha")
        else (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in adapters.items()
    }
    jax_st.save_file(adapters, path.with_name("adapters.safetensors"))
    return path


@pytest.fixture(scope="module")
def data_folder(tmp_path_factory):
    rng = np.random.default_rng(0)
    folder = tmp_path_factory.mktemp("data")
    sizes = [(96, 96)] * 4 + [(32, 128)] * 2  # (h, w): a 64x64 and a 128x32 bucket
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(folder / f"img_{i}.png")
        (folder / f"img_{i}.txt").write_text(f"a photo, number {i}, red, blue")
    return folder


def _config(tmp_path, checkpoint, data_folder, out, cached=True, accum=1, epochs=2):
    return {
        "model": {
            "checkpoint_path": str(checkpoint),
            "dtype": "float32",
            "max_token_length": 75,
            "cache_latents": cached,
            "cache_text_embeddings": cached,
            "denoiser": {
                "hidden_dim": 32, "num_head_channels": 8, "context_dim": 64 + 48,
                "block_out_channels": [32, 64, 64], "num_transformers_per_block": [1, 1, 1],
            },
        },
        "dataset": {
            "folder": str(data_folder), "batch_size": 2, "bucket_base_size": 64, "step": 32,
            "min_size": 32, "num_repeats": 1, "num_workers": 0,
            "caption_processors": [{"type": "shuffle", "split_separator": ","}],
        },
        "peft": {**PEFT, "resume_weight_path": str(checkpoint.with_name("adapters.safetensors"))},
        # warmup_steps: with 0 the JAX package's schedule is 0 at every step
        "optimizer": {"name": "schedulefree.RAdamScheduleFree",
                      "args": {"lr": 1e-3, "warmup_steps": 2}},
        "saving": {
            "strategy": {"per_epochs": 1, "per_steps": None},
            "callbacks": [{"type": "safetensors", "name": "lora", "save_dir": str(tmp_path / out)}],
        },
        "seed": 0,
        "num_train_epochs": epochs,
        "trainer": {"gradient_checkpointing": True, "gradient_accumulation_steps": accum,
                    "mesh": {"data": -1, "fsdp": 1, "tensor": 1}},
    }


def _run_both(tmp_path, checkpoint, data_folder, monkeypatch, **kwargs):
    import random

    from vision_ft_tpu.parallel import make_mesh
    from vision_ft_tpu.trainer import common as jax_common

    # one device, as the port runs: the tests' 8 virtual CPU devices would
    # split a batch of 2 eight ways
    monkeypatch.setattr(jax_common, "make_mesh", lambda cfg: make_mesh(cfg, jax.devices()[:1]))
    jax_trainer = JaxTrainer(JaxTrainConfig.model_validate(
        _config(tmp_path, checkpoint, data_folder, "jax", **kwargs)))
    jax_trainer.register_train_dataset_class(JaxDatasetConfig)
    jax_trainer.register_model_class(JaxTiny)
    jax_losses, torch_losses = [], []
    monkeypatch.setattr(jax_trainer, "log_dict", lambda values, step=None: jax_losses.append(
        values["train/loss"]) if "train/loss" in values else None)
    random.seed(5)
    jax_trainer.train()

    trainer = Trainer(TrainConfig.model_validate(
        _config(tmp_path, checkpoint, data_folder, "torch", **kwargs)), device="cpu")
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_model_class(TorchTiny)
    monkeypatch.setattr(trainer, "log_dict", lambda values, step=None: torch_losses.append(
        values["train/loss"]) if "train/loss" in values else None)
    random.seed(5)
    trainer.train()
    return jax_trainer, jax_losses, trainer, torch_losses


@pytest.mark.parametrize(
    "cached,accum", [(True, 1), (False, 2)], ids=["cached", "uncached_accum2"]
)
def test_trainer_run_matches_jax(tmp_path, checkpoint, data_folder, monkeypatch, cached, accum):
    """Two epochs of 3 loader batches (two buckets), one step a batch or, with
    gradient accumulation, a step every two batches: the per-step losses
    rtol 1e-4 (the JAX package logs each batch's loss, the port each step's
    mean), the saved LoRA files (one an epoch) with equal ComfyUI key sets
    and values within ``ADAPTER_ATOL``, the frozen base bit for bit as
    loaded."""
    jax_trainer, jax_losses, trainer, torch_losses = _run_both(
        tmp_path, checkpoint, data_folder, monkeypatch, cached=cached, accum=accum)
    assert len(jax_losses) == 6 and len(torch_losses) == 6 // accum
    want = np.asarray(jax_losses).reshape(-1, accum).mean(axis=1)
    np.testing.assert_allclose(torch_losses, want, rtol=LOSS_RTOL)

    jax_files = sorted((tmp_path / "jax").glob("*.safetensors"))
    files = sorted((tmp_path / "torch").glob("*.safetensors"))
    assert [f.name for f in files] == [f.name for f in jax_files] and len(files) == 2
    for f, jf in zip(files, jax_files):
        got, want = st.load_file(f), jax_st.load_file(jf)
        assert set(got) == set(want)
        assert all(k.startswith("diffusion_model.") for k in got)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=ADAPTER_ATOL, err_msg=key)
    resumed = st.load_file(checkpoint.with_name("adapters.safetensors"))
    saved = st.load_file(files[-1])
    assert all(convert_to_comfy_key(k) in saved for k in resumed)
    assert any(not torch.equal(saved[convert_to_comfy_key(k)], v)  # the adapters trained
               for k, v in resumed.items() if "lora_up" in k)

    # the frozen base is as the checkpoint gave it
    loaded = SDXLModel(trainer.model.model_config, **_tiny_kwargs("torch")[1])
    loaded._from_checkpoint(device="cpu")
    live = trainer.model.get_params().state_dict()
    for key, value in loaded.as_module().state_dict().items():
        assert torch.equal(live[key], value), key


def test_trainer_raises_on_unported_options(tmp_path, checkpoint, data_folder):
    """A mesh of more than one device is the one trainer option left
    unported (EMA, state checkpoints, the profiler and the debug modes run:
    tests/test_torch_trainer_lumina2.py)."""
    base = _config(tmp_path, checkpoint, data_folder, "x")
    for mesh in ({"data": 2}, {"fsdp": 2}, {"data": 1, "tensor": 2}):
        config = TrainConfig.model_validate({**base, "trainer": {"mesh": mesh}})
        with pytest.raises(NotImplementedError, match="mesh"):
            Trainer(config, device="cpu")
    for trainer_cfg in ({"ema_decay": 0.99}, {"state_checkpoint_dir": str(tmp_path)},
                        {"profile": True}, {"debug_mode": "1step", "debug_nans": True}):
        Trainer(TrainConfig.model_validate({**base, "trainer": trainer_cfg}), device="cpu")


def test_train_script_builds_the_registered_trainer(tmp_path, checkpoint, data_folder):
    """The CLI's trainer from the repo's canonical config: every section
    validates, the workload and datasets are SDXL text-to-image."""
    from vision_ft_tpu_torch.dataset.preview import TextToImagePreviewConfig

    config = TrainConfig.from_config_file("configs/sdxl/text_to_image_lora.yml")
    assert config.optimizer.name == "schedulefree.RAdamScheduleFree"
    assert config.trainer.remat_saves == "activations"  # the JAX package's default
    trainer = build_trainer(config, device="cpu")
    assert isinstance(trainer.model, train_text_to_image.SDXLForTextToImageTraining)
    assert isinstance(trainer.preview_dataset_config, TextToImagePreviewConfig)
    assert trainer.dataset_config.batch_size == 2 and trainer.dataset_config.num_repeats == 4


@pytest.mark.parametrize("warmup,weight_decay", [(None, 0.0), (3, 0.01)])
def test_schedule_free_adamw_matches_optax(warmup, weight_decay):
    """Six updates of the port's schedule-free AdamW against
    optax.contrib.schedule_free_adamw, parameters and eval_params within
    fp32 rounding (1e-6 on O(1) values)."""
    import optax

    from vision_ft_tpu_torch.training.optimizer import eval_params, get_optimizer

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    args = {"weight_decay": weight_decay, "betas": [0.9, 0.99]}
    if warmup is not None:
        args["warmup_steps"] = warmup
    optimizer = get_optimizer("schedulefree.AdamWScheduleFree", 1e-2, args)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    state = optimizer.init([p])
    tx = optax.contrib.schedule_free_adamw(1e-2, warmup_steps=warmup, b1=0.9, b2=0.99,
                                           weight_decay=weight_decay)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    for count in range(6):
        g = rng.standard_normal(p0.shape).astype(np.float32)
        optimizer.update_(state, [p], [torch.from_numpy(g)], count)
        updates, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-6)
    x = eval_params("schedulefree.AdamWScheduleFree", state, {"p": p})["p"]
    want = optax.contrib.schedule_free_eval_params(js, jp)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=1e-6)
    assert eval_params("torch.optim.AdamW", state, {"p": p})["p"] is p


def test_schedule_free_trains_with_the_default_warmup():
    """warmup_steps 0 (the configs' default) is no warm-up here: the first
    update moves the parameters (the JAX package's schedule is 0 at every
    step for that value, so its parameters never move)."""
    from vision_ft_tpu_torch.training.optimizer import get_optimizer

    optimizer = get_optimizer("schedulefree.RAdamScheduleFree", 1e-3, {})
    p = torch.nn.Parameter(torch.ones(3))
    state = optimizer.init([p])
    optimizer.update_(state, [p], [torch.ones(3)], 0)
    assert not torch.equal(p.detach(), torch.ones(3))


def test_train_script_reads_its_config_and_the_short_k_switch(monkeypatch):
    """``python -m vision_ft_tpu_torch.train.sdxl.text_to_image --config``:
    the config file through argparse, ``VFT_FLASH_SHORTK=1`` turning the
    short-K kernels on, then ``train()`` (stubbed here: it runs on the card)."""
    from vision_ft_tpu_torch.ops import flash_attention as flash_module
    from vision_ft_tpu_torch.train.sdxl import text_to_image as script

    trained = []
    monkeypatch.setattr(Trainer, "train", lambda self: trained.append(self))
    monkeypatch.setenv("VFT_FLASH_SHORTK", "1")
    try:
        script.main(["--config", "configs/sdxl/text_to_image_lora.yml"])
        assert flash_module._flash_shortk is True
    finally:
        flash_module.set_flash_shortk(False)
    assert len(trained) == 1 and trained[0].device == torch.device("cuda")
    assert trained[0].config.optimizer.name == "schedulefree.RAdamScheduleFree"
