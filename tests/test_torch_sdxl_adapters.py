"""The port's SDXL flow-match and RoPE-distillation workloads against the
JAX package's (CPU, fp32).

A two-level tiny UNet (one transformer level, head dim 8, RoPE dims 4 + 4)
with the tiny VAE and CLIP towers of tests/test_torch_sdxl.py; numpy
weights written on the JAX package's tree, LoRA rank 4 on the attention
with non-zero lora_up, loaded in both packages. The frameworks' random
bits differ, so the draws (the VAE sample's noise, the timesteps, the
noise, the low-res ones) are numpy arrays handed to the port's
``loss_with_draws`` and, through patched samplers, to the JAX workloads'
``loss_fn`` under ``jax.jit``. Tolerance: fp32 parity, relative error
<= 1e-4 of the output's max (losses 1e-4 relative).

Also the RoPE retrofit's structure (no parameters added, RoPE off is the
base UNet), the flow-match sampler, and one Trainer step of each
workload from its YAML (configs/sdxl/flow_match.yml, flow_match_x0.yml,
rope_distill.yml) on the tiny model.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from vision_ft_tpu.models.sdxl import train_flow_match as jax_fm
from vision_ft_tpu.models.sdxl import train_rope_distill as jax_rd
from vision_ft_tpu.models.sdxl.adapter import flow_match as jax_fm_model
from vision_ft_tpu.models.sdxl.adapter import rope as jax_rope
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.nn import flatten_params, unflatten_params

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.models.sdxl import train_flow_match, train_rope_distill
from vision_ft_tpu_torch.models.sdxl.adapter import flow_match, rope
from vision_ft_tpu_torch.models.sdxl.denoiser import Denoiser
from vision_ft_tpu_torch.modules import peft
from vision_ft_tpu_torch.train.sdxl import flow_match as fm_cli
from vision_ft_tpu_torch.train.sdxl import rope_distill as rd_cli

from test_torch_sdxl import _random_params, _tiny_kwargs
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-4
UNET = dict(
    hidden_dim=32, num_head_channels=8, context_dim=64 + 48, block_out_channels=[32, 32],
    num_transformers_per_block=[1, 1], layers_per_block=1,
    down_blocks=["DownBlock2D", "TransformerDownBlock2D"],
    up_blocks=["TransformerUpBlock2D", "UpBlock2D"],
)
ROPE = dict(UNET, rope_dims=[4, 4])
PARTS = ("denoiser", "vae", "text_encoder")
B = 2


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= RTOL, f"{name}: relative error {err:.3g}"


def _jax_model(cls, config_cls, denoiser_cls, denoiser, **fields):
    config = config_cls(checkpoint_path="unused", dtype="float32",
                        denoiser=denoiser_cls(**denoiser), **fields)
    return cls(config, **_tiny_kwargs("jax")[1])


def _port_model(cls, config_cls, denoiser_cls, denoiser, flat, **fields):
    config = config_cls(checkpoint_path="", dtype="float32", denoiser=denoiser_cls(**denoiser),
                        **fields)
    model = cls(config, **_tiny_kwargs("torch")[1])
    model.load_state_dict(flat, device="cpu")
    return model


def _weights(jax_model, seed, targets=("attn1", "attn2")):
    """numpy weights on the JAX model's tree, LoRA on ``targets`` with
    lora_up non-zero, flattened under denoiser. / vae. / text_encoder."""
    shapes = {name: jax.eval_shape(getattr(jax_model, name).init, jax.random.key(0))
              for name in PARTS}
    flat = _random_params(shapes, seed)
    denoiser = unflatten_params({k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items()
                                 if k.startswith("denoiser.")})
    denoiser = jax_peft.replace_to_peft_layer(
        denoiser, list(targets), [], jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    for key, value in flatten_params(denoiser).items():
        value = np.asarray(value)
        if key.endswith("lora_up.weight"):
            value = rng.normal(0, 0.05, value.shape).astype(np.float32)
        flat[f"denoiser.{key}"] = value
    return flat


def _split(flat):
    params = {root: unflatten_params({k[len(root) + 1:]: jnp.asarray(v) for k, v in flat.items()
                                      if k.startswith(root + ".")}) for root in PARTS}
    return jax_peft.split_peft_params(params)


def _batch(seed, size=64):
    rng = np.random.default_rng(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
        "input_ids": rng.integers(1, 998, (B, 77)).astype(np.int32),
        "original_size": np.asarray([[size, size], [size * 2, size]], np.float32),
        "target_size": np.full((B, 2), size, np.float32),
        "crop_coords_top_left": np.asarray([[0, 0], [8, 0]], np.float32),
    }


def _patch_normals(monkeypatch, arrays):
    """``jax.random.normal`` returns ``arrays`` in turn (the VAE samples
    and the noisings draw through it)."""
    queue = [jnp.asarray(a) for a in arrays]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: queue.pop(0))
    return queue


def _jax_loss_and_grads(cls, model, trainable, frozen, batch):
    workload = cls.__new__(cls)
    workload.model, workload.model_config = model, model.config
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(tr):
        return workload.loss_fn(tr, frozen, batch, jax.random.PRNGKey(0))

    (value, logs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(trainable)
    return float(value), {k: float(v) for k, v in logs.items()}, {
        f"denoiser.{k}": np.asarray(v) for k, v in flatten_params(grads["denoiser"]).items()}


def _port_loss_and_grads(model, keys, loss):
    leaves = model.as_module().state_dict(keep_vars=True)
    for key, leaf in leaves.items():
        if leaf.is_floating_point():
            leaf.requires_grad_(key in keys)
    out = loss()
    value, logs = out if isinstance(out, tuple) else (out, {})
    value.backward()
    return value.detach().item(), {k: float(v) for k, v in logs.items()}, {
        k: leaves[k].grad.numpy() for k in keys}


def _compare(got, want):
    value, logs, grads = got
    want_value, want_logs, want_grads = want
    _close(value, want_value, "loss")
    assert set(logs) == set(want_logs)
    for key, w in want_logs.items():
        _close(logs[key], w, key)
    assert set(grads) == set(want_grads)
    assert any(np.abs(g).max() > 0 for g in want_grads.values())
    for key, g in want_grads.items():
        _close(grads[key], g, key)


# -- the RoPE retrofit ----------------------------------------------------------------


def _unet_inputs(seed, hw=8):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, hw, hw, 4)).astype(np.float32),
        np.asarray([10.0, 600.0], np.float32),
        rng.standard_normal((B, 77, 112)).astype(np.float32),
        rng.standard_normal((B, 1280)).astype(np.float32),
        np.asarray([[64, 64], [128, 64]], np.float32),
        np.full((B, 2), 64, np.float32),
        np.zeros((B, 2), np.float32),
    )


@pytest.fixture(scope="module")
def rope_pair():
    jax_model = _jax_model(jax_rope.SDXLWithRoPEModel, jax_rope.SDXLWithRoPEConfig,
                           jax_rope.DenoiserConfigWithRoPE, ROPE)
    flat = _weights(jax_model, 0)
    model = _port_model(rope.SDXLWithRoPEModel, rope.SDXLWithRoPEConfig,
                        rope.DenoiserConfigWithRoPE, ROPE, flat)
    return jax_model, model, flat


def test_rope_denoiser_matches_jax(rope_pair):
    """The rotated UNet (centre origin, 2-axis tables, context diagonal)
    against JAX rope.py, with its LoRA, on a 8x8 latent."""
    jax_model, model, flat = rope_pair
    params = unflatten_params({k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items()
                               if k.startswith("denoiser.")})
    args = _unet_inputs(3)
    want = np.asarray(jax.jit(jax_model.denoiser)(params, *args))
    with torch.no_grad():
        got = model.denoiser(*(torch.from_numpy(a) for a in args)).numpy()
    _close(got, want, "rope denoiser")
    # the tables: float64 angles on the host, cached per shape and device
    embedder = model.denoiser.rope_embedder
    cos, sin = embedder.image_freqs(4, 4, device="cpu")
    want_cos, want_sin = jax_model.denoiser.rope_embedder.image_freqs(4, 4)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(want_cos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(want_sin))
    assert embedder.image_freqs(4, 4, device="cpu")[0] is cos


def test_rope_adds_no_parameters_and_off_is_the_base_unet(rope_pair):
    _, model, flat = rope_pair
    base = Denoiser(model.config.denoiser)
    assert set(model.denoiser.state_dict()) - {k for k in model.denoiser.state_dict()
                                                if "lora_" in k or k.endswith(".alpha")} \
        == set(base.state_dict())
    from vision_ft_tpu_torch.nn import load_flat_params

    base_flat = {k[len("denoiser."):]: v for k, v in flat.items() if k.startswith("denoiser.")}
    load_flat_params(base, base_flat)
    args = [torch.from_numpy(a) for a in _unet_inputs(4)]
    with torch.no_grad():
        want = base(*args)
        with rope.while_rope_disabled():
            off = model.denoiser(*args)
        on = model.denoiser(*args)
        model.denoiser.set_rope_enabled(False)
        try:
            flag_off = model.denoiser(*args)
        finally:
            model.denoiser.set_rope_enabled(True)
        with rope.while_rope_enabled():
            assert torch.equal(model.denoiser(*args), on)
    assert torch.equal(off, want) and torch.equal(flag_off, want)
    assert not torch.allclose(on, want)


# -- flow match -----------------------------------------------------------------------


def _fm_config_fields(prediction):
    return dict(model_prediction=prediction, loss_type="velocity",
                clean_at_zero=prediction == "image", noise_scale=1.0)


def test_flow_match_loss_and_grads_match_jax(monkeypatch):
    """The velocity workload (scale_shift_sigmoid timesteps x 1000, scaled
    noising, velocity MSE; CLIP and VAE encode inside), loss and the LoRA
    gradients."""
    fields = _fm_config_fields("velocity")
    jax_model = _jax_model(jax_fm_model.SDXLFlowMatch, jax_fm.SDXLForFlowMatchingTrainingConfig,
                           jax_rope.DenoiserConfig, UNET, **fields)
    flat = _weights(jax_model, 1, targets=("attn1", "attn2", ".ff."))
    trainable, frozen = _split(flat)
    batch = _batch(2)
    rng = np.random.default_rng(3)
    vae_noise, noise = (rng.standard_normal((B, 8, 8, 4)).astype(np.float32) for _ in range(2))
    t01 = np.asarray([0.2, 0.85], np.float32)
    _patch_normals(monkeypatch, [vae_noise, noise])
    monkeypatch.setattr(jax_fm, "sample_timestep", lambda key, shape, kind, **kw: jnp.asarray(t01))
    # the JAX side without checkpointing compiles a smaller program: the
    # gradients are the same
    want = _jax_loss_and_grads(jax_fm.SDXLForFlowMatchingTraining, jax_model, trainable, frozen,
                               batch)

    model = _port_model(flow_match.SDXLFlowMatch, train_flow_match.SDXLForFlowMatchingTrainingConfig,
                        rope.DenoiserConfig, UNET, flat, **fields)
    model.denoiser.set_gradient_checkpointing(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _port_loss_and_grads(model, set(want[2]), lambda: train_flow_match.loss_with_draws(
        model, model.config, tb, torch.from_numpy(t01 * np.float32(1000)), torch.from_numpy(noise),
        torch.from_numpy(vae_noise)))
    _compare(got, want)


def test_flow_match_generate_ignores_offloading():
    """``do_offloading`` is accepted and ignored, as in the JAX package: the
    request is the plain one bit for bit."""
    jax_model = _jax_model(jax_fm_model.SDXLFlowMatch, jax_fm.SDXLForFlowMatchingTrainingConfig,
                           jax_rope.DenoiserConfig, UNET, **_fm_config_fields("image"))
    model = _port_model(flow_match.SDXLFlowMatch, train_flow_match.SDXLForFlowMatchingTrainingConfig,
                        rope.DenoiserConfig, UNET, _weights(jax_model, 4),
                        **_fm_config_fields("image"))
    kwargs = dict(prompt="a cat", negative_prompt="", width=64, height=64, num_inference_steps=2,
                  cfg_scale=3.0, seed=3)
    plain = np.asarray(model.generate(**kwargs)[0])
    np.testing.assert_array_equal(np.asarray(model.generate(do_offloading=True, **kwargs)[0]),
                                  plain)


@pytest.mark.parametrize("loss_type", ["velocity", "image"])
def test_flow_match_image_prediction_losses_match_jax(loss_type):
    """The x0 (image) prediction's two losses (through the implied
    velocity, clean at zero, or against the latents) on given tensors."""
    rng = np.random.default_rng(5)
    pred, latents, noise, noisy = (rng.standard_normal((B, 4, 4, 4)).astype(np.float32)
                                   for _ in range(4))
    t = np.asarray([0.0, 0.6], np.float32)  # t = 0 takes the eps clamp
    fields = dict(_fm_config_fields("image"), loss_type=loss_type, checkpoint_path="u")
    jax_cfg = jax_fm.SDXLForFlowMatchingTrainingConfig(**fields)
    want = jax_fm.SDXLForFlowMatchingTraining._treat_loss(
        types.SimpleNamespace(model_config=jax_cfg), *(jnp.asarray(a) for a in (pred, latents, noise, noisy, t)))
    got = train_flow_match.treat_loss(
        train_flow_match.SDXLForFlowMatchingTrainingConfig(**fields),
        *(torch.from_numpy(a) for a in (pred, latents, noise, noisy, t)))
    _close(got.item(), float(want), loss_type)


def test_flow_match_sampler_matches_jax():
    """The Euler flow: the schedule, and one CFG step with an x0 model
    (the velocity it implies, the guidance, x + v (next - sigma)) against
    the JAX package's ``_fm_step`` with the same denoiser output."""
    jax_cfg = jax_fm_model.SDXLFlowMatchConfig(checkpoint_path="u", model_prediction="image",
                                               clean_at_zero=True)
    want = jax_fm_model.SDXLFlowMatch.prepare_timesteps(None, 5)
    got = flow_match.SDXLFlowMatch.prepare_timesteps(None, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(6)
    latents = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    pred = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)

    jax_self = types.SimpleNamespace(config=jax_cfg, denoiser=lambda p, *a: jnp.asarray(pred))
    want = jax_fm_model.SDXLFlowMatch._fm_step(
        jax_self, None, jnp.asarray(latents), jnp.float32(750.0), jnp.float32(0.75),
        jnp.float32(0.5), None, None, None, None, None, jnp.float32(3.5), do_cfg=True)
    port_cfg = flow_match.SDXLFlowMatchConfig(checkpoint_path="u", model_prediction="image",
                                              clean_at_zero=True)
    port_self = types.SimpleNamespace(config=port_cfg, denoiser=lambda *a: torch.from_numpy(pred))
    got = flow_match.SDXLFlowMatch._fm_step(
        port_self, torch.from_numpy(latents), np.float32(750.0), np.float32(0.75),
        np.float32(0.5), None, None, None, None, None, 3.5, do_cfg=True)
    _close(got.numpy(), np.asarray(want), "fm step")


# -- RoPE distillation ----------------------------------------------------------------


def test_rope_distill_loss_and_grads_match_jax(monkeypatch):
    """The four terms (epsilon L2, teacher distill, and both at half
    resolution: bicubic antialiased pixels, halved size conditioning),
    the teacher with RoPE and PEFT off under no_grad; the loss, each logged
    term and the LoRA gradients. 128 px: at 64 px the half-resolution
    UNet's deepest GroupNorms see 4 values a group, whose statistics
    amplify fp32 rounding past the tolerance in both packages."""
    fields = dict(lowres_l2_loss_weight=0.5, lowres_distill_loss_weight=1.0, lowres_ratio=2.0)
    jax_model = _jax_model(jax_rope.SDXLWithRoPEModel, jax_rd.SDXLForRoPEDistillTrainingConfig,
                           jax_rope.DenoiserConfigWithRoPE, ROPE, **fields)
    flat = _weights(jax_model, 7)
    trainable, frozen = _split(flat)
    batch = _batch(8, size=128)
    rng = np.random.default_rng(9)
    vae_noise, noise = (rng.standard_normal((B, 16, 16, 4)).astype(np.float32) for _ in range(2))
    lr_vae_noise, lr_noise = (rng.standard_normal((B, 8, 8, 4)).astype(np.float32) for _ in range(2))
    timesteps = np.asarray([37, 811], np.int32)
    _patch_normals(monkeypatch, [vae_noise, noise, lr_vae_noise, lr_noise])
    monkeypatch.setattr(jax_rd, "uniform_randint", lambda key, shape, lo, hi: jnp.asarray(timesteps))
    # the JAX side without checkpointing compiles a smaller program: the
    # gradients are the same
    want = _jax_loss_and_grads(jax_rd.SDXLForRoPEDistillTraining, jax_model, trainable, frozen, batch)
    assert set(want[1]) == {"l2_loss", "distill_loss", "lowres_distill_loss", "lowres_l2_loss"}

    model = _port_model(rope.SDXLWithRoPEModel, train_rope_distill.SDXLForRoPEDistillTrainingConfig,
                        rope.DenoiserConfigWithRoPE, ROPE, flat, **fields)
    model.denoiser.set_gradient_checkpointing(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _port_loss_and_grads(model, set(want[2]), lambda: train_rope_distill.loss_with_draws(
        model, model.config, tb, *(torch.from_numpy(a) for a in (
            vae_noise, timesteps, noise, lr_vae_noise, lr_noise))))
    _compare(got, want)


# -- the workloads through the Trainer, from their YAMLs ------------------------------


@pytest.fixture(scope="module")
def data_folder(tmp_path_factory):
    rng = np.random.default_rng(0)
    folder = tmp_path_factory.mktemp("data")
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(folder / f"img_{i}.png")
        (folder / f"img_{i}.txt").write_text(f"a photo, number {i}")
    return folder


def _tiny_workload(cls, model_cls):
    class Tiny(cls):
        def setup_model(self):
            if hasattr(self.model_config.denoiser, "rope_enabled"):
                self.model_config.denoiser.rope_enabled = True
            self.model = model_cls(self.model_config, **_tiny_kwargs("torch")[1])
            self.model.init_params(torch.Generator().manual_seed(self.config.seed))

    return Tiny


def _yaml_config(path, data_folder, out, denoiser):
    with open(path) as f:
        config = yaml.safe_load(f)
    config["model"].update(checkpoint_path="", dtype="float32", max_token_length=75)
    config["model"]["denoiser"] = {**config["model"].get("denoiser", {}), **denoiser}
    config["dataset"].update(folder=str(data_folder), bucket_base_size=64, step=32, min_size=32,
                             num_workers=0)
    config["peft"]["config"]["dtype"] = "float32"
    config["saving"]["callbacks"][0]["save_dir"] = str(out)
    config.pop("preview", None)
    config["num_train_epochs"] = 1
    return TrainConfig.model_validate(config)


@pytest.mark.parametrize("yaml_path,cli,workload,model_cls,denoiser", [
    ("configs/sdxl/flow_match.yml", fm_cli, train_flow_match.SDXLForFlowMatchingTraining,
     flow_match.SDXLFlowMatch, UNET),
    ("configs/sdxl/flow_match_x0.yml", fm_cli, train_flow_match.SDXLForFlowMatchingTraining,
     flow_match.SDXLFlowMatch, UNET),
    ("configs/sdxl/rope_distill.yml", rd_cli, train_rope_distill.SDXLForRoPEDistillTraining,
     rope.SDXLWithRoPEModel, ROPE),
], ids=["flow_match", "flow_match_x0", "rope_distill"])
def test_workload_trains_through_the_trainer_from_its_yaml(tmp_path, data_folder, yaml_path, cli,
                                                           workload, model_cls, denoiser):
    """One step of the YAML's workload on the tiny model (its remat mode,
    "activations" by default): a finite loss, the adapters moved, the
    base untouched, the LoRA file saved."""
    config = _yaml_config(yaml_path, data_folder, tmp_path / "out", denoiser)
    trainer = cli.build_trainer(config, device="cpu")
    assert type(trainer.model) is workload
    trainer.register_model_class(_tiny_workload(workload, model_cls))
    losses = []
    trainer.log_dict = lambda values, step=None: losses.append(values["train/loss"]) \
        if "train/loss" in values else None
    trainer.train()
    assert len(losses) == 1 and np.isfinite(losses[0])
    saved = list((tmp_path / "out").glob("*.safetensors"))
    assert len(saved) == 1
    model = trainer.model.model
    moved = [k for k, v in trainer.trainable.items() if "lora_up" in k and v.detach().abs().max() > 0]
    assert moved
    assert all(not v.requires_grad for v in trainer.frozen.values())
    assert peft.get_adapter_parameters(model.denoiser)
