"""The port's Trainer on the Lumina2 text-to-image workload against the JAX
package's (CPU, fp32), and the Trainer's EMA, state checkpoints, profiler
window and debug modes.

A tiny Lumina2 (the NextDiT, VAE and Gemma-2 sizes of
tests/test_torch_lumina2.py, 2 main blocks) is written once with the JAX
package's ``state_dict()`` to a safetensors file beside a synthetic
SentencePiece vocab, and both Trainers start from that file through their
workload's checkpoint loading. The same image folder, config and seed then
go through both packages' datasets, dataloaders, Gemma tokenizing, LoRA on
``attention`` and ``feed_forward``, AdamW and the saving callback. The
frameworks' random bits differ, so the adapters start from a file of numpy
draws, and the VAE sample's noise, the timesteps, the noise and the low-res
noise are drawn with numpy in ``preprocess_batch`` and read by a
``loss_fn`` written for the test in each package; everything else is the
packages' own code.
"""

import json
import logging
import random

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vision_ft_tpu.config import TrainConfig as JaxTrainConfig
from vision_ft_tpu.dataset.text_to_image import TextToImageDatasetConfig as JaxDatasetConfig
from vision_ft_tpu.models.autoencoder import AutoencoderKLConfig as JaxVAEConfig
from vision_ft_tpu.models.lumina2 import train_text_to_image as jax_train
from vision_ft_tpu.models.lumina2.pipeline import Lumina2 as JaxLumina2
from vision_ft_tpu.models.sdxl import train_text_to_image as jax_sdxl_train
from vision_ft_tpu.models.sdxl.config import SDXLConfig as JaxSDXLConfig
from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel
from vision_ft_tpu.models.text_encoders.gemma2 import Gemma2Config as JaxGemma2Config
from vision_ft_tpu.modules.loss import flow_match as jax_flow
from vision_ft_tpu.modules.peft import PeftTargetConfig as JaxPeftTargetConfig
from vision_ft_tpu.modules.peft import get_adapter_parameters
from vision_ft_tpu.modules.peft import merge_params as jax_merge_params
from vision_ft_tpu.trainer import Trainer as JaxTrainer
from vision_ft_tpu.utils import safetensors as jax_st

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.dataset.text_to_image import TextToImageDatasetConfig
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.lumina2 import train_text_to_image
from vision_ft_tpu_torch.models.lumina2.pipeline import Lumina2
from vision_ft_tpu_torch.models.lumina2.util import convert_to_comfy_key
from vision_ft_tpu_torch.models.sdxl import train_text_to_image as sdxl_train
from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.text_encoders import sentencepiece
from vision_ft_tpu_torch.models.text_encoders.gemma2 import Gemma2Config
from vision_ft_tpu_torch.train.lumina2.text_to_image import build_trainer
from vision_ft_tpu_torch.trainer import Trainer
from vision_ft_tpu_torch.training import state_checkpoint
from vision_ft_tpu_torch.utils import safetensors as st

from test_torch_lumina2 import TEXT, VAE, _model_bytes
from test_torch_lumina2_train import DENOISER, _random_tree
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

TEXT_CONFIG = dict(TEXT, vocab_size=512)  # the synthetic vocab's ids reach 300
PEFT = {
    "include_keys": ["attention", "feed_forward"],
    "exclude_keys": ["text_encoder", "vae"],
    "config": {"type": "lora", "rank": 4, "alpha": 2.0, "dtype": "float32"},
}
LOSS_RTOL = 1e-4  # fp32 sums in other orders through Gemma-2, the VAE and the NextDiT
# the saved adapters: AdamW divides each gradient element by its own rms, so
# an element whose gradient sits at fp32 rounding level still moves by up to
# lr (1e-3) a step, either way, and the two packages' roundings differ
ADAPTER_ATOL = 1e-3
# (h, w): a 128x128 and a 64x128 bucket; one bucket where a case needs no
# second shape (each shape costs the JAX package a trace and a compile)
IMAGE_SIZES = {"two_buckets": [(128, 128)] * 4 + [(64, 128)] * 2, "one_bucket": [(128, 128)] * 6}


def _draws(latent_shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = latent_shape
    return {
        "vae_noise": rng.standard_normal(latent_shape).astype(np.float32),
        "timesteps": rng.uniform(0.05, 0.95, (b,)).astype(np.float32),
        "noise": rng.standard_normal(latent_shape).astype(np.float32),
        "lowres_noise": rng.standard_normal((b, h // 4, w // 4, c)).astype(np.float32),
    }


def _latent_shape(batch):
    b, h, w, _ = np.asarray(batch["image"]).shape
    return (b, h // 8, w // 8, 4)


class JaxTiny(jax_train.Lumina2ForTextToImageTraining):
    def sanity_check(self):
        # the JAX workload's own check under one jit: run op by op, the CPU
        # backend compiles every op of the denoiser on its own
        jax.jit(super().sanity_check)()

    def setup_model(self):
        self.model = JaxLumina2(self.model_config, vae_config=JaxVAEConfig(**VAE),
                                text_encoder_config=JaxGemma2Config(**TEXT_CONFIG))
        self.model._from_checkpoint()
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        return {**out, **_draws(_latent_shape(batch), self.draw_seed)}

    def loss_fn(self, trainable, frozen, batch, key):
        """The body of the JAX ``loss_fn`` with the batch's draws."""
        params = jax_merge_params(frozen, trainable)
        model = self.model
        hidden = jax.lax.stop_gradient(model.text_encoder.encode_tokens(
            params["text_encoder"], batch["input_ids"], batch["attention_mask"]))
        caption_mask = batch["attention_mask"].astype(bool)
        dist = model.vae.encode(params["vae"], batch["pixel_values"])
        z = dist.mean + dist.std * batch["vae_noise"]
        latents = jax.lax.stop_gradient((z - model.vae.shift_factor) * model.vae.scaling_factor)
        t = batch["timesteps"]

        def forward_and_loss(latents, noise):
            s = (1 - t).reshape(-1, 1, 1, 1)
            noisy = (1.0 - s) * latents + s * noise
            velocity, _, _ = model.denoiser(params["denoiser"], noisy, hidden, t, caption_mask)
            return jax_flow.loss_with_predicted_velocity(latents, noise, -velocity)

        loss = forward_and_loss(latents, batch["noise"])
        lo_loss = forward_and_loss(jax_train._avg_pool_4x(latents), batch["lowres_noise"])
        return loss + lo_loss, {"train/highres_loss": loss, "train/lowres_loss": lo_loss}


class TorchTiny(train_text_to_image.Lumina2ForTextToImageTraining):
    def setup_model(self):
        self.model = Lumina2(self.model_config, vae_config=AutoencoderKLConfig(**VAE),
                             text_encoder_config=Gemma2Config(**TEXT_CONFIG))
        self.model._from_checkpoint(device="cpu")
        self.draw_seed = 100

    def preprocess_batch(self, batch):
        out = super().preprocess_batch(batch)
        self.draw_seed += 1
        draws = _draws(_latent_shape(batch), self.draw_seed)
        out.update({k: torch.from_numpy(v) for k, v in draws.items()})
        return out

    def loss_fn(self, batch, generator):
        return train_text_to_image.loss_with_draws(
            self.model, batch, batch["vae_noise"], batch["timesteps"], batch["noise"],
            batch["lowres_noise"],
        )


def _jax_model(checkpoint_path="unused"):
    return JaxLumina2(
        jax_train.Lumina2ForTextToImageTrainingConfig(
            checkpoint_path=str(checkpoint_path), dtype="float32", denoiser=DENOISER),
        tokenizer=None, vae_config=JaxVAEConfig(**VAE),
        text_encoder_config=JaxGemma2Config(**TEXT_CONFIG),
    )


def _port_model(checkpoint_path="unused"):
    return Lumina2(
        train_text_to_image.Lumina2ForTextToImageTrainingConfig(
            checkpoint_path=str(checkpoint_path), dtype="float32", denoiser=DENOISER),
        tokenizer=None, vae_config=AutoencoderKLConfig(**VAE),
        text_encoder_config=Gemma2Config(**TEXT_CONFIG),
    )


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny Lumina2's weights (numpy draws on the JAX package's tree) in
    the original single-file layout, written by the JAX package; beside it
    the synthetic SentencePiece vocab and an adapter file (lora_down and
    lora_up drawn with numpy), which both Trainers resume their adapters
    from."""
    folder = tmp_path_factory.mktemp("ckpt")
    path = folder / "tiny_lumina2.safetensors"
    (folder / "tokenizer.model").write_bytes(_model_bytes(sentencepiece))
    model = _jax_model()
    rng = np.random.default_rng(0)
    model.params = {root: _random_tree(getattr(model, root), rng)
                    for root in ("denoiser", "vae", "text_encoder")}
    jax_st.save_file(model.state_dict(), path)
    peft = JaxPeftTargetConfig.model_validate(PEFT)
    adapters = get_adapter_parameters(peft.replace_to_peft_layer(model.params, jax.random.key(1)))
    adapters = {
        k: np.asarray(v) if k.endswith("alpha")
        else (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in adapters.items()
    }
    jax_st.save_file(adapters, folder / "adapters.safetensors")
    return path


def _image_folder(tmp_path_factory, sizes):
    rng = np.random.default_rng(0)
    folder = tmp_path_factory.mktemp("data")
    for i, (h, w) in enumerate(IMAGE_SIZES[sizes]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(folder / f"img_{i}.png")
        # captions of different lengths: holes of different sizes in the joint mask
        (folder / f"img_{i}.txt").write_text("a photo of a cat, " + ", ".join(["red", "car"][: i % 3]))
    return folder


@pytest.fixture(scope="module")
def data_folder(tmp_path_factory):
    return _image_folder(tmp_path_factory, "two_buckets")


@pytest.fixture(scope="module")
def one_bucket_folder(tmp_path_factory):
    return _image_folder(tmp_path_factory, "one_bucket")


def _config(tmp_path, checkpoint, data_folder, out, accum=1, epochs=2, **trainer):
    return {
        "model": {
            "checkpoint_path": str(checkpoint),
            "tokenizer_path": str(checkpoint.parent),
            "dtype": "float32",
            "max_token_length": 16,
            "denoiser": DENOISER,
        },
        "dataset": {
            "folder": str(data_folder), "batch_size": 2, "bucket_base_size": 128, "step": 64,
            "min_size": 64, "num_repeats": 1, "num_workers": 0,
            "caption_processors": [{"type": "shuffle", "split_separator": ","}],
        },
        "peft": {**PEFT, "resume_weight_path": str(checkpoint.with_name("adapters.safetensors"))},
        "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1e-3}},
        "saving": {
            "strategy": {"per_epochs": 1, "per_steps": None},
            "callbacks": [{"type": "safetensors", "name": "lora", "save_dir": str(tmp_path / out)}],
        },
        "seed": 0,
        "num_train_epochs": epochs,
        "trainer": {"gradient_checkpointing": True, "gradient_accumulation_steps": accum,
                    "mesh": {"data": -1, "fsdp": 1, "tensor": 1}, **trainer},
    }


def _port_trainer(config, losses=None, workload=TorchTiny):
    trainer = Trainer(TrainConfig.model_validate(config), device="cpu")
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_model_class(workload)
    if losses is not None:
        trainer.log_dict = lambda values, step=None: (
            losses.append(values["train/loss"]) if "train/loss" in values else None)
    return trainer


@pytest.mark.parametrize(
    "trainer_extra,accum,folder",
    [({}, 1, "data_folder"), ({"ema_decay": 0.9}, 2, "one_bucket_folder")],
    ids=["plain", "ema_accum2"],
)
def test_trainer_run_matches_jax(tmp_path, checkpoint, request, monkeypatch, trainer_extra,
                                 accum, folder):
    """Two epochs of 3 loader batches (two buckets, or one), one AdamW step a
    batch or, with gradient accumulation, a step every two batches (the odd
    batch carried into the next epoch) with EMA: the per-step losses rtol
    1e-4 (the JAX package logs each batch's loss, the port each step's
    mean), the saved LoRA files (one an epoch, the EMA's under
    ``ema_decay``) with equal ComfyUI key sets and values within
    ``ADAPTER_ATOL``, the frozen base bit for bit as the file holds it."""
    from vision_ft_tpu.parallel import make_mesh
    from vision_ft_tpu.trainer import common as jax_common

    data_folder = request.getfixturevalue(folder)

    # one device, as the port runs: the tests' 8 virtual CPU devices would
    # split a batch of 2 eight ways
    monkeypatch.setattr(jax_common, "make_mesh", lambda cfg: make_mesh(cfg, jax.devices()[:1]))
    jax_trainer = JaxTrainer(JaxTrainConfig.model_validate(
        _config(tmp_path, checkpoint, data_folder, "jax", accum, **trainer_extra)))
    jax_trainer.register_train_dataset_class(JaxDatasetConfig)
    jax_trainer.register_model_class(JaxTiny)
    jax_losses, losses = [], []
    monkeypatch.setattr(jax_trainer, "log_dict", lambda values, step=None: jax_losses.append(
        values["train/loss"]) if "train/loss" in values else None)
    random.seed(5)
    jax_trainer.train()

    trainer = _port_trainer(_config(tmp_path, checkpoint, data_folder, "torch", accum,
                                    **trainer_extra), losses)
    random.seed(5)
    trainer.train()

    assert len(jax_losses) == 6 and len(losses) == 6 // accum
    want = np.asarray(jax_losses).reshape(-1, accum).mean(axis=1)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)

    jax_files = sorted((tmp_path / "jax").glob("*.safetensors"))
    files = sorted((tmp_path / "torch").glob("*.safetensors"))
    assert [f.name for f in files] == [f.name for f in jax_files] and len(files) == 2
    adapters = st.load_file(checkpoint.with_name("adapters.safetensors"))
    for f, jf in zip(files, jax_files):
        got, want = st.load_file(f), jax_st.load_file(jf)
        assert set(got) == set(want) == {convert_to_comfy_key(k) for k in adapters}
        assert all(k.startswith("diffusion_model.") for k in got)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=ADAPTER_ATOL, err_msg=key)
    saved = st.load_file(files[-1])
    assert any(not torch.equal(saved[convert_to_comfy_key(k)], v)  # the adapters trained
               for k, v in adapters.items() if "lora_up" in k)
    if trainer.ema is not None:
        # what was saved last (and what the model keeps) is the EMA, not the live weights
        assert all(e.dtype == torch.float32 for e in trainer.ema.values())
        for key, value in trainer.ema.items():
            assert torch.equal(saved[convert_to_comfy_key(key)], value), key

    # the frozen base is as the file holds it
    from_file = st.load_file(checkpoint)
    live = trainer.model.model.state_dict()
    for key, value in from_file.items():
        assert torch.equal(live[key], value), key


# -- checkpoint I/O ------------------------------------------------------------------


def test_jax_written_file_loads_in_the_port(checkpoint):
    """Every tensor of the JAX package's file lands in the port's modules bit
    for bit, and the port's ``state_dict()`` gives the file's keys back."""
    model = _port_model(checkpoint)
    model._from_checkpoint(device="cpu")
    got, want = model.state_dict(), st.load_file(checkpoint)
    assert set(got) == set(want)
    assert any(k.startswith("model.diffusion_model.") for k in got)
    assert any(k.startswith("text_encoders.gemma2_2b.transformer.") for k in got)
    assert any(k.startswith("vae.") for k in got)
    for key, value in want.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], value), key


def test_port_state_dict_matches_jax(checkpoint):
    """Both packages loaded from one file: ``state_dict()`` key for key and
    bit for bit."""
    jax_model = _jax_model(checkpoint)
    jax_model._from_checkpoint()
    model = _port_model(checkpoint)
    model._from_checkpoint(device="cpu")
    want, got = jax_model.state_dict(), model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


def test_port_written_file_loads_in_jax(tmp_path):
    """Seeded port weights written by the port's ``state_dict()`` load in
    the JAX package bit for bit."""
    model = _port_model()
    model.init_params(torch.Generator().manual_seed(3), device="cpu")
    path = tmp_path / "port.safetensors"
    st.save_file(model.state_dict(), path)
    jax_model = _jax_model(path)
    jax_model._from_checkpoint()
    want, got = model.state_dict(), jax_model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), value.numpy(), err_msg=key)


# -- state checkpoints ---------------------------------------------------------------


def test_state_checkpoint_round_trip(tmp_path, caplog):
    """The newest whole ``step_<N>`` comes back bit for bit; without an
    ``ema`` in the file the EMA is seeded from the trainable parameters (fp32
    copies) with a warning; no state, or a step without its file, is
    skipped."""
    trainable = {"a": torch.randn(3, 4).bfloat16(), "b": torch.randn(5)}
    opt_state = {"optimizer": {"state": {0: {"step": torch.tensor(2.0)}}, "param_groups": [
        {"lr": 1e-3, "betas": (0.9, 0.999), "params": [0, 1]}]}, "updates": 2}
    ema = {k: v.float() + 1 for k, v in trainable.items()}
    assert state_checkpoint.restore_train_state(str(tmp_path / "none")) is None
    state_checkpoint.save_train_state(str(tmp_path), 3, trainable, opt_state, ema=ema)
    (tmp_path / "step_9").mkdir()  # a state cut before its file was renamed into place
    assert state_checkpoint.latest_checkpoint_step(str(tmp_path)) == 3
    step, got, got_opt, got_ema = state_checkpoint.restore_train_state(str(tmp_path), with_ema=True)
    assert step == 3 and got_opt == opt_state
    for want, have in ((trainable, got), (ema, got_ema)):
        assert all(torch.equal(have[k], v) and have[k].dtype == v.dtype for k, v in want.items())

    state_checkpoint.save_train_state(str(tmp_path), 5, trainable, opt_state)  # no EMA
    with caplog.at_level(logging.WARNING):
        step, got, _, got_ema = state_checkpoint.restore_train_state(str(tmp_path), with_ema=True)
    assert step == 5 and "seeding the EMA" in caplog.text
    for key, value in trainable.items():
        assert got_ema[key].dtype == torch.float32 and torch.equal(got_ema[key], value.float())
        assert got_ema[key].data_ptr() != got[key].data_ptr()
    assert len(state_checkpoint.restore_train_state(str(tmp_path))) == 3


def test_trainer_resumes_from_state_checkpoint(tmp_path, checkpoint, data_folder):
    """A run with EMA writes ``step_1`` .. ``step_3``; a second Trainer on the
    same config restores step 3's trainable parameters, optimizer state and
    EMA bit for bit before its first step, then counts on from step 4."""
    config = _config(tmp_path, checkpoint, data_folder, "out", epochs=1, ema_decay=0.9,
                     state_checkpoint_dir=str(tmp_path / "state"),
                     state_checkpoint_every_steps=1)
    first = _port_trainer(config)
    random.seed(5)
    first.train()
    assert state_checkpoint.latest_checkpoint_step(str(tmp_path / "state")) == 3
    _, saved, saved_opt, saved_ema = state_checkpoint.restore_train_state(
        str(tmp_path / "state"), with_ema=True)

    second = _port_trainer(config)
    second.before_train()
    assert second.restore_state_checkpoint() == 3
    for key, value in saved.items():
        assert torch.equal(second.trainable[key].detach(), value), key
        assert torch.equal(second.ema[key], saved_ema[key]) and second.ema[key].dtype == torch.float32
        assert torch.equal(second.ema[key], first.ema[key]), key
    assert second.state.step == first.state.step == saved_opt["updates"] == 3
    want, got = first.state.opt_state.state_dict(), second.state.opt_state.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for index, entry in want["state"].items():
        for name, value in entry.items():
            assert torch.equal(got["state"][index][name], value), (index, name)

    steps = []
    third = _port_trainer(config)
    third.call_saving_callbacks = lambda epoch, step: steps.append(step)
    third.train()  # resumes inside training_loop; the data stream restarts
    assert steps == [4, 5, 6]
    assert state_checkpoint.latest_checkpoint_step(str(tmp_path / "state")) == 6


# -- debug modes, NaN checks, profiler -------------------------------------------------


@pytest.mark.parametrize("mode", ["dataset", "sanity_check", "1step"])
def test_debug_modes(tmp_path, checkpoint, data_folder, capsys, mode):
    """As tests/test_trainer_e2e.py::test_debug_modes: "dataset" prints the
    batches and stops before the model is set up, "sanity_check" stops
    after the sanity check, "1step" after one step."""
    losses = []
    trainer = _port_trainer(
        _config(tmp_path, checkpoint, data_folder, "out", debug_mode=mode), losses)
    trainer.train()
    out = capsys.readouterr().out
    assert f"Debug mode is enabled: {mode}" in out
    if mode == "dataset":
        assert "Dataset check done" in out and "'image': (2, 128, 128, 3)" in out
        assert not hasattr(trainer, "model") or not hasattr(trainer.model, "model")
    elif mode == "sanity_check":
        assert "Sanity check done" in out and losses == []
    else:
        assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("where", ["loss", "gradient"])
def test_debug_nans_raises_at_the_first_non_finite_value(tmp_path, checkpoint, data_folder, where):
    """``debug_nans``: a NaN pixel (a NaN loss) or a finite loss whose
    backward makes a NaN raises ``FloatingPointError`` before the optimizer
    moves a parameter."""

    class NaN(TorchTiny):
        def loss_fn(self, batch, generator):
            loss, metrics = super().loss_fn(batch, generator)
            if where == "loss":
                return loss * float("nan"), metrics
            # sqrt'(0) is inf, times the zero of 0 * p^2: NaN in the backward only
            p = next(iter(self.trainer.trainable.values()))
            return loss + torch.sqrt(0.0 * p.pow(2).sum()), metrics

    trainer = _port_trainer(_config(tmp_path, checkpoint, data_folder, "out", debug_nans=True),
                            workload=NaN)
    trainer.before_train()
    before = {k: p.detach().clone() for k, p in trainer.trainable.items()}
    with pytest.raises(FloatingPointError, match="nan" if where == "gradient" else "loss"):
        trainer.training_loop()
    assert all(torch.equal(trainer.trainable[k].detach(), v) for k, v in before.items())


def test_profiler_window_writes_a_trace(tmp_path, checkpoint, data_folder):
    """``profile`` over steps 2-3 of a 3-step run: one Chrome trace under
    ``profile_dir`` with the NextDiT's ops in it."""
    trainer = _port_trainer(_config(
        tmp_path, checkpoint, data_folder, "out", epochs=1, profile=True,
        profile_dir=str(tmp_path / "profile"), profile_start_step=2, profile_stop_step=3))
    trainer.train()
    traces = list((tmp_path / "profile").glob("*.json"))
    assert traces == [tmp_path / "profile" / "trace_steps_2-3.json"]
    assert str(traces[0]) == trainer.profile_trace
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::scaled_dot_product_attention" in names or "aten::softmax" in names


# -- the train script, the SDXL tokenizer lookup -----------------------------------------


def test_train_script_builds_the_registered_trainer(monkeypatch):
    """``python -m vision_ft_tpu_torch.train.lumina2.text_to_image --config``
    on config #4: every section validates, the workload and datasets are
    Lumina2 text-to-image, the run on the card (``train()`` stubbed here)."""
    from vision_ft_tpu_torch.train.lumina2 import text_to_image as script

    config = TrainConfig.from_config_file("configs/lumina2/text_to_image.yml")
    trainer = build_trainer(config, device="cpu")
    assert isinstance(trainer.model, train_text_to_image.Lumina2ForTextToImageTraining)
    assert trainer.model.model_config.max_token_length == 256
    assert trainer.dataset_config.batch_size == 2 and trainer.dataset_config.bucket_base_size == 1024
    assert trainer.preview_dataset_config is None  # config #4 has no preview section
    assert config.peft.config.rank == 8 and config.peft.include_keys == ["attention", "feed_forward"]
    trained = []
    monkeypatch.setattr(Trainer, "train", lambda self: trained.append(self))
    script.main(["--config", "configs/lumina2/text_to_image.yml"])
    assert len(trained) == 1 and trained[0].device == torch.device("cuda")
    assert isinstance(trained[0].model, train_text_to_image.Lumina2ForTextToImageTraining)


@pytest.fixture()
def clip_vocab(tmp_path):
    vocab = {ch + suffix: 0 for ch in "abcdefghijklmnopqrstuvwxyz" for suffix in ("", "</w>")}
    vocab.update({t: 0 for t in ("hello</w>", "he", "llo</w>", "<|startoftext|>", "<|endoftext|>")})
    (tmp_path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh e\nl l\nll o</w>\nhe llo</w>\n")
    return tmp_path


@pytest.mark.parametrize("where", ["checkpoint_dir", "tokenizer_path", "none"])
def test_sdxl_pipeline_finds_the_tokenizer_where_jax_does(clip_vocab, where):
    """A ``checkpoint_path`` directory with ``vocab.json`` + ``merges.txt``
    (a snapshot's layout) or a ``tokenizer_path`` gives both packages' SDXL
    pipelines the same CLIP tokenizer; neither gives none."""
    fields = {"checkpoint_dir": dict(checkpoint_path=str(clip_vocab)),
              "tokenizer_path": dict(checkpoint_path="x.safetensors",
                                     tokenizer_path=str(clip_vocab)),
              "none": dict(checkpoint_path=str(clip_vocab / "nothing"))}[where]
    port = SDXLModel(SDXLConfig(**fields)).text_encoder.tokenizer
    jax_tokenizer = JaxSDXLModel(JaxSDXLConfig(**fields)).text_encoder.tokenizer
    if where == "none":
        assert port is None and jax_tokenizer is None
        return
    prompts = ["Hello  world", "a cat said hello"]
    np.testing.assert_array_equal(port(prompts, max_length=12), jax_tokenizer(prompts, max_length=12))


def test_sdxl_workload_reads_clip_vocab_dir(clip_vocab, monkeypatch):
    """``CLIP_VOCAB_DIR`` names the SDXL workload's default tokenizer in both
    packages; unset, or not a directory, there is none."""
    monkeypatch.setenv("CLIP_VOCAB_DIR", str(clip_vocab))
    port, want = sdxl_train._default_tokenizer(), jax_sdxl_train._default_tokenizer()
    np.testing.assert_array_equal(port(["hello cat"], max_length=8), want(["hello cat"], max_length=8))
    monkeypatch.setenv("CLIP_VOCAB_DIR", str(clip_vocab / "nothing"))
    assert sdxl_train._default_tokenizer() is None is jax_sdxl_train._default_tokenizer()
    monkeypatch.delenv("CLIP_VOCAB_DIR")
    assert sdxl_train._default_tokenizer() is None
