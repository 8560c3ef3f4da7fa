"""The port's IP-Adapter against the JAX package's (CPU, fp32): the
SigLIP and CLIP vision towers, the four projector types, the seven
attn2 variants on a tiny UNet, the self-reference train step, the two
datasets, generate() and the three training modes through the Trainer.

Weights are numpy arrays written on the JAX package's trees and loaded in
both packages; the JAX side runs under ``jax.jit``. Tolerance: fp32
parity, relative error <= 1e-4 of the output's max. The train step's
draws (the VAE sample's noise, the timesteps, the noise) are numpy
arrays, handed to the port's ``loss_with_draws`` and, through patched
samplers, to the JAX workload's ``loss_fn``.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from vision_ft_tpu.dataset import kyara as jax_kyara
from vision_ft_tpu.dataset import referenced_text_to_image as jax_ref_ds
from vision_ft_tpu.models.sdxl import train_ip_adapter as jax_ipt
from vision_ft_tpu.models.sdxl.adapter import ip_adapter as jax_ip
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.vision_encoders import clip_vision as jax_clip
from vision_ft_tpu.models.vision_encoders import siglip as jax_siglip
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.adapter.ip_adapter import IPAdapterConfig as JaxIPAdapterConfig
from vision_ft_tpu.modules.adapter.ip_adapter import projectors as jax_proj
from vision_ft_tpu.nn import flatten_params, unflatten_params

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.dataset import kyara, referenced_text_to_image
from vision_ft_tpu_torch.models.sdxl import train_ip_adapter
from vision_ft_tpu_torch.models.sdxl.adapter import ip_adapter
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.vision_encoders import clip_vision, siglip
from vision_ft_tpu_torch.modules.adapter.ip_adapter import IPAdapterConfig
from vision_ft_tpu_torch.modules.adapter.ip_adapter import projectors
from vision_ft_tpu_torch.modules.peft import LoRAConfig
from vision_ft_tpu_torch.nn import load_flat_params
from vision_ft_tpu_torch.train.sdxl import ip_adapter_kyara, ip_adapter_ref, ip_adapter_self

from test_torch_sdxl import _random_params, _tiny_kwargs
from test_torch_sdxl_adapters import (
    UNET, _batch, _close, _compare, _patch_normals, _port_loss_and_grads,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

B = 2
N_TOK = 4
FEATURES = 64
SIGLIP = dict(hidden_size=FEATURES, num_layers=2, num_heads=4, mlp_dim=128, patch_size=8,
              image_size=32)
VARIANTS = ["original", "adaln_zero", "tanh_gate", "gate", "flamingo", "time_gate", "peft"]
LORA = dict(type="lora", rank=4, alpha=2.0, dtype="float32")


# -- the vision towers -----------------------------------------------------------------


def test_siglip_matches_jax_in_the_timm_layout():
    """Last, penultimate and pooled outputs (16 patches, the MAP head)
    against the JAX tower; the keys are timm's; the encoder callable picks
    the penultimate or the pooled output and keeps it on the device."""
    config = jax_siglip.SigLIPVisionConfig(**SIGLIP)
    jax_model = jax_siglip.SigLIPVisionModel(config)
    flat = _random_params(jax.eval_shape(jax_model.init, jax.random.key(0)), 0)
    for key in ("patch_embed.proj.weight", "pos_embed", "blocks.0.attn.qkv.weight",
                "blocks.1.mlp.fc2.bias", "attn_pool.latent", "attn_pool.kv.weight", "norm.bias"):
        assert key in flat, key
    pixels = np.random.default_rng(1).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jax_model)(unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
                           jnp.asarray(pixels))
    encoder = siglip.ImageEncoder(siglip.SigLIPVisionConfig(**SIGLIP), dtype=torch.float32,
                                  device="cpu").load_state_dict(flat)
    assert set(encoder.model.state_dict()) == set(flat)
    with torch.no_grad():
        got = encoder.model(torch.from_numpy(pixels))
    for name, g, w in zip(("last", "penultimate", "pooled"), got, want):
        _close(g.numpy(), np.asarray(w), name)
    features = encoder(pixels)
    assert isinstance(features, torch.Tensor) and torch.equal(features, got[1])
    encoder.feature_type = "pooler_output"
    assert torch.equal(encoder(torch.from_numpy(pixels)), got[2])


def test_clip_vision_matches_jax():
    """The HF-layout CLIP vision tower with its projection (plain
    attention), and the differentiable CLIP preprocessing."""
    fields = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                  image_size=28, patch_size=14, projection_dim=16)
    jax_model = jax_clip.CLIPVisionModelWithProjection(jax_clip.CLIPVisionConfig(**fields))
    flat = _random_params(jax.eval_shape(jax_model.init, jax.random.key(0)), 2)
    with torch.device("meta"):
        model = clip_vision.CLIPVisionModelWithProjection(clip_vision.CLIPVisionConfig(**fields))
    load_flat_params(model, flat)
    images = np.random.default_rng(3).uniform(-1, 1, (B, 40, 36, 3)).astype(np.float32)
    pixels = jax_clip.clip_preprocess(jnp.asarray(images), image_size=28)
    got_pixels = clip_vision.clip_preprocess(torch.from_numpy(images), image_size=28)
    _close(got_pixels.numpy(), np.asarray(pixels), "clip_preprocess")
    want = jax.jit(jax_model)(unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), pixels)
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(pixels)))
    for name, g, w in zip(("last", "image_embeds"), got, want):
        _close(g.numpy(), np.asarray(w), name)


# -- the projectors ---------------------------------------------------------------------


PROJECTORS = {
    "linear": (dict(in_features=FEATURES, cross_attention_dim=32, num_ip_tokens=N_TOK), False),
    "mlp": (dict(in_features=FEATURES, mlp_ratio=1.5, cross_attention_dim=32,
                 num_style_tokens=N_TOK), False),
    "resampler": (dict(in_features=FEATURES, num_heads=4, mlp_ratio=2.0, cross_attention_dim=32,
                       num_ip_tokens=N_TOK, depth=2, normalization="rms", qk_norm=True), False),
    "image_text": (dict(image_dim=FEATURES, text_dim=48, hidden_dim=32, num_heads=4,
                        num_blocks=2, mlp_ratio=2.0, num_ip_tokens=N_TOK), True),
}
PROJECTOR_CLASSES = {
    "linear": "LinearImageProjector", "mlp": "MLPImageProjector",
    "resampler": "ResamplerProjector", "image_text": "ImageTextProjector",
}


@pytest.mark.parametrize("kind", list(PROJECTORS))
def test_projector_matches_jax_and_is_detected(kind):
    fields, with_text = PROJECTORS[kind]
    jax_module = getattr(jax_proj, PROJECTOR_CLASSES[kind])(**fields)
    flat = _random_params(jax.eval_shape(jax_module.init, jax.random.key(0)), 4)
    rng = np.random.default_rng(5)
    # pooled features for the linear / mlp projectors, a sequence for the others
    features = rng.standard_normal((B, FEATURES) if kind in ("linear", "mlp")
                                   else (B, 6, FEATURES)).astype(np.float32)
    # image_text: the text rows tiled to the image batch
    text = rng.standard_normal((1, 5, 48)).astype(np.float32) if with_text else None
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = jax.jit(lambda p, f, t: jax_module(p, f, t))(params, jnp.asarray(features),
                                                      None if text is None else jnp.asarray(text))
    assert projectors.detect_projector_type(flat) == jax_proj.detect_projector_type(flat) == kind
    module = projectors.load_projector_from_state_dict(
        flat, **({"num_heads": 4} if kind in ("resampler", "image_text") else {}))
    assert type(module).__name__ == PROJECTOR_CLASSES[kind]
    with torch.no_grad():
        got = module(torch.from_numpy(features), None if text is None else torch.from_numpy(text))
    assert got.shape == (B, N_TOK, 32)
    _close(got.numpy(), np.asarray(want), kind)


# -- the attn2 variants on a tiny UNet ----------------------------------------------------


def _ip_config(pkg, variant, **more):
    ip_cls, peft_cls = ((JaxIPAdapterConfig, jax_peft.LoRAConfig) if pkg == "jax"
                        else (IPAdapterConfig, LoRAConfig))
    return ip_cls(num_ip_tokens=N_TOK, image_size=32, feature_dim=FEATURES, dtype="float32",
                  variant=variant, peft=peft_cls(**LORA) if variant == "peft" else None, **more)


def _jax_ip_model(variant, **more):
    config = jax_ipt.SDXLModelWithIPAdapterTrainingConfig(
        checkpoint_path="unused", dtype="float32", denoiser=JaxDenoiserConfig(**UNET),
        adapter=_ip_config("jax", variant, **more))
    return jax_ip.SDXLModelWithIPAdapter(config, image_encoder=lambda x: x, **_tiny_kwargs("jax")[1])


def _port_ip_model(variant, flat, encoder=None, **more):
    config = train_ip_adapter.SDXLModelWithIPAdapterTrainingConfig(
        checkpoint_path="", dtype="float32", denoiser=DenoiserConfig(**UNET),
        adapter=_ip_config("torch", variant, **more))
    model = ip_adapter.SDXLModelWithIPAdapter(config, image_encoder=encoder or (lambda x: x),
                                              **_tiny_kwargs("torch")[1])
    # each part whose weights ``flat`` holds, on the CPU
    for name, part in model.as_module().items():
        sub = {k[len(name) + 1:]: v for k, v in flat.items() if k.startswith(name + ".")}
        if sub:
            load_flat_params(part, sub)
    return model


def _ip_weights(jax_model, seed, parts=("denoiser",)):
    """numpy weights of the JAX IP model's ``parts``: the base drawn with
    numpy, the adapters made by the JAX package's ``init_adapter_params``
    (the peft variant's LoRA included) and then every adapter and
    projector leaf drawn with numpy too, gates included."""
    bases = [name for name in ("denoiser", "vae", "text_encoder") if name in parts or name == "denoiser"]
    flat = _random_params({name: jax.eval_shape(getattr(jax_model, name).init, jax.random.key(0))
                           for name in bases}, seed)
    jax_model.params = {name: unflatten_params({k[len(name) + 1:]: jnp.asarray(v)
                                                for k, v in flat.items() if k.startswith(name + ".")})
                        for name in bases}
    jax_model.init_adapter_params(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    names = jax_model.manager.adapter_class.adapter_param_names + ("lora_down", "lora_up")
    out = {}
    for root in parts:
        for key, value in flatten_params(jax_model.params[root]).items():
            value = np.asarray(value)
            split = key.split(".")
            adapter = root == "image_proj" or any(
                i > 0 and split[i - 1] in ("attn2", "to_k_ip", "to_v_ip") and part in names
                for i, part in enumerate(split))
            if adapter and value.ndim >= 2:
                bound = 1.0 / np.sqrt(np.prod(value.shape[1:]))
                value = rng.uniform(-bound, bound, value.shape).astype(np.float32)
            elif adapter and value.ndim == 1:
                value = rng.normal(0, 0.5, value.shape).astype(np.float32)
            out[f"{root}.{key}"] = value
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_denoiser_matches_jax(variant):
    """The UNet with each variant's attn2, every adapter weight random:
    the original / peft variants take ip tokens and a key mask (one row
    partly masked) through cross_attention_kwargs, the others read the
    tokens on the context's tail and gate on the time embedding."""
    options = dict(skip_zero_tokens=True, attn_renorm=variant == "original")
    jax_model = _jax_ip_model(variant, **options)
    flat = _ip_weights(jax_model, 6)
    rng = np.random.default_rng(7)
    latents = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = np.asarray([20.0, 700.0], np.float32)
    context = rng.standard_normal((B, 77, 112)).astype(np.float32)
    tokens = rng.standard_normal((B, N_TOK, 112)).astype(np.float32)
    pooled = rng.standard_normal((B, 1280)).astype(np.float32)
    sizes = (np.full((B, 2), 64, np.float32), np.full((B, 2), 64, np.float32),
             np.zeros((B, 2), np.float32))
    via_kwargs = variant in ("original", "peft")
    if via_kwargs:
        mask = np.ones((B, N_TOK), bool)
        mask[1, 2:] = False
        kwargs = {"ip_tokens": tokens, "ip_mask": mask}
    else:
        context, kwargs = np.concatenate([context, tokens], axis=1), {}
    params = unflatten_params({k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items()})
    want = jax.jit(lambda p, x, tt, c, pl, o, s, cc, kw: jax_model.denoiser(
        p, x, tt, c, pl, o, s, cc, cross_attention_kwargs=kw))(
        params, latents, t, context, pooled, *sizes, {k: jnp.asarray(v) for k, v in kwargs.items()})

    model = _port_ip_model(variant, flat, **options)
    with torch.no_grad():
        got = model.denoiser(*(torch.from_numpy(a) for a in (latents, t, context, pooled, *sizes)),
                             cross_attention_kwargs={k: torch.from_numpy(v) for k, v in kwargs.items()}
                             or None)
    _close(got.numpy(), np.asarray(want), variant)


def test_adapter_init_copies_base_weights_and_round_trips():
    """init_adapter_params copies the base k / v and zeroes the gates; the
    adapter state dict is keyed ip_adapter.{1, 3, ...} in attn2 order, as
    the JAX package's, and loads back."""
    jax_model = _jax_ip_model("tanh_gate")
    flat = _ip_weights(jax_model, 9, parts=("denoiser", "image_proj"))
    model = _port_ip_model("tanh_gate", flat)
    jax_model.params = {"denoiser": unflatten_params(
        {k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items() if k.startswith("denoiser.")})}
    assert model.manager.target_paths == jax_model.manager.target_paths
    before = {k: v.clone() for k, v in model.get_adapter_state_dict().items()}
    model.init_adapter_params(torch.Generator().manual_seed(0))
    for path in model.manager.target_paths:
        attn2 = model.denoiser.get_submodule(path)
        assert torch.equal(attn2["to_k_ip"].weight, attn2["to_k"].weight)
        assert torch.equal(attn2["to_v_ip"].weight, attn2["to_v"].weight)
        assert not attn2["tanh_gate"].weight.any()
    saved = model.get_adapter_state_dict()
    want_keys = set(jax_model.manager.get_state_dict(jax_model.params["denoiser"]))
    assert {k for k in saved if k.startswith("ip_adapter.")} == want_keys
    assert {k.split(".")[1] for k in want_keys} == {str(2 * i + 1) for i in range(len(model.manager.target_paths))}
    model.load_adapter_params(before)
    for key, value in model.get_adapter_state_dict().items():
        assert torch.equal(value, before[key]), key


# -- the self-reference train step ---------------------------------------------------------


def test_self_mode_loss_and_grads_match_jax(monkeypatch):
    """The self-reference loss with the image dropped on one row and the
    tokens cut to 3 with a key mask: the projector maps the frozen
    features, the adapters and the projector get their gradients."""
    jax_model = _jax_ip_model("original")
    flat = _ip_weights(jax_model, 10, parts=("denoiser", "vae", "text_encoder", "image_proj"))
    workload = jax_ipt.SDXLIPAdapterSelfTraining.__new__(jax_ipt.SDXLIPAdapterSelfTraining)
    workload.model, workload.model_config, workload._tokens_to_keep = (
        jax_model, jax_model.config, 3)
    trainable_keys = {k for k in flat if workload.trainable_filter(k)}
    assert any(k.startswith("image_proj.") for k in trainable_keys)
    assert any(".attn2.to_k_ip." in k for k in trainable_keys)
    trainable = unflatten_params({k: jnp.asarray(flat[k]) for k in trainable_keys})
    frozen = unflatten_params({k: jnp.asarray(v) for k, v in flat.items() if k not in trainable_keys})
    batch = _batch(11)
    rng = np.random.default_rng(12)
    batch["reference_features"] = rng.standard_normal((B, FEATURES)).astype(np.float32)
    batch["drop_image"] = np.asarray([0.0, 1.0], np.float32)
    vae_noise, noise = (rng.standard_normal((B, 8, 8, 4)).astype(np.float32) for _ in range(2))
    timesteps = np.asarray([99, 640], np.int32)
    _patch_normals(monkeypatch, [vae_noise, noise])
    monkeypatch.setattr(jax_ipt, "uniform_randint", lambda key, shape, lo, hi: jnp.asarray(timesteps))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(tr):
        return workload.loss_fn(tr, frozen, jbatch, jax.random.PRNGKey(0))

    (value, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(trainable)
    want = (float(value), {}, {k: np.asarray(v) for k, v in flatten_params(grads).items()})

    model = _port_ip_model("original", flat)
    model.denoiser.set_gradient_checkpointing(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _port_loss_and_grads(model, trainable_keys, lambda: train_ip_adapter.loss_with_draws(
        model, tb, torch.from_numpy(vae_noise), torch.from_numpy(timesteps),
        torch.from_numpy(noise), True, 3))
    _compare(got, want)


# -- generate ----------------------------------------------------------------------------


def _tiny_encoder(seed=0):
    """The tiny SigLIP's pooled output: the mlp projector takes one vector
    a sample."""
    return siglip.ImageEncoder(siglip.SigLIPVisionConfig(**SIGLIP), dtype=torch.float32,
                               device="cpu", seed=seed, feature_type="pooler_output")


def test_generate_with_and_without_a_reference_image():
    """Without a reference the dropped image's all-False mask zeroes the ip
    branch: the images are the base SDXL's, bit for bit. With one, the
    tokens change them. ``do_offloading`` is accepted and ignored, as in
    the JAX package."""
    jax_model = _jax_ip_model("original")
    flat = _ip_weights(jax_model, 13, parts=("denoiser", "vae", "text_encoder", "image_proj"))
    model = _port_ip_model("original", flat, encoder=_tiny_encoder())
    base = SDXLModel(model.config, **_tiny_kwargs("torch")[1])
    base.load_state_dict({k: v for k, v in flat.items()
                          if not k.startswith("image_proj.") and "_ip." not in k}, device="cpu")
    kwargs = dict(prompt="a cat", negative_prompt="", width=64, height=64, num_inference_steps=2,
                  cfg_scale=4.0, seed=3)
    plain = np.asarray(model.generate(**kwargs)[0])
    np.testing.assert_array_equal(plain, np.asarray(base.generate(**kwargs)[0]))
    reference = Image.fromarray(np.random.default_rng(0).integers(0, 255, (48, 40, 3), np.uint8))
    with_ref = np.asarray(model.generate(reference_image=reference, **kwargs)[0])
    assert with_ref.shape == plain.shape and not np.array_equal(with_ref, plain)
    np.testing.assert_array_equal(
        with_ref, np.asarray(model.generate(reference_image=reference, do_offloading=True,
                                            **kwargs)[0]))


# -- the datasets ------------------------------------------------------------------------


def _write_images(folder, ids, size=(96, 64)):
    rng = np.random.default_rng(0)
    for id_ in ids:
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(folder / f"{id_}.webp")


@pytest.fixture(scope="module")
def referenced_data(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("referenced")
    images = root / "images"
    images.mkdir()
    ids = ["a", "b", "c", "d"]
    _write_images(images, ids)
    pq.write_table(pa.table({
        "id": ids,
        "another_id": [["b", "c"], ["a", "c"], ["a", "d"], ["a", "b"]],
        "copyright": [["cp"]] * 4, "character": [["ch"], ["ch"], ["ch2"], ["ch2"]],
        "general": [["tag1", "tag2"]] * 4, "meta": [["m"]] * 4, "people": [["1girl"]] * 4,
    }), str(root / "meta.parquet"))
    return images, root / "meta.parquet"


def _detections(general):
    det = {"coords": {"top": 4, "left": 2, "right": 40, "bottom": 30, "width": 38, "height": 26},
           "tags": {"rating": "general", "general": ["blue eyes"], "characters": ["a"]}}
    return {"heads": [det], "upper_bodies": [det], "full_bodies": [],
            "whole_image_tags": {"rating": "general", "general": general, "characters": ["a"]}}


@pytest.fixture(scope="module")
def kyara_data(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("kyara")
    folder = root / "images"
    folder.mkdir()
    ids = [101, 102, 103, 104]
    _write_images(folder, ids)
    for id_ in ids:
        (folder / f"{id_}.json").write_text(json.dumps(_detections(["blue eyes", "smile", "sky"])))
    pq.write_table(pa.table({"id": ids, "group": [[102, 103], [101], [104], [103]]}),
                   str(root / "groups.parquet"))
    return folder, root / "groups.parquet"


def _batches(config_cls, fields, seed=4):
    """Every batch, the reference picks, the crops and the caption
    shuffles drawn from the same seeds in both packages."""
    random.seed(seed)
    dataset = config_cls.model_validate(fields).get_dataset()
    for ds in dataset.datasets:
        ds.bucket.rng = np.random.default_rng(seed)
    return [dataset[i] for i in range(len(dataset))]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


def test_referenced_dataset_matches_jax(referenced_data):
    images, parquet = referenced_data
    fields = dict(folder=str(images), metadata_parquet=str(parquet), batch_size=2,
                  bucket_base_size=64, step=32, min_size=32, image_size=32, num_repeats=1)
    got = _batches(referenced_text_to_image.ReferencedTextToImageDatasetConfig, fields)
    want = _batches(jax_ref_ds.ReferencedTextToImageDatasetConfig, fields)
    _same_batches(got, want)
    assert got[0]["reference_image"].shape[1:] == (32, 32, 3)


def test_kyara_dataset_matches_jax(kyara_data):
    folder, parquet = kyara_data
    fields = dict(folder=str(folder), group_parquet_path=str(parquet), batch_size=2,
                  bucket_base_size=64, step=32, min_size=32, image_size=32, background_color=1,
                  num_repeats=1)
    got = _batches(kyara.KyaraDatasetConfig, fields)
    want = _batches(jax_kyara.KyaraDatasetConfig, fields)
    _same_batches(got, want)
    assert all("blue eyes" not in c for batch in got for c in batch["caption"])


# -- the three modes through the Trainer, from the YAML ------------------------------------


def _tiny_workload(cls):
    class Tiny(cls):
        def setup_model(self):
            self.model = ip_adapter.SDXLModelWithIPAdapter(
                self.model_config, image_encoder=_tiny_encoder(), **_tiny_kwargs("torch")[1])
            self.model.init_params(torch.Generator().manual_seed(self.config.seed))
            self.model.init_adapter_params(torch.Generator().manual_seed(self.config.seed + 1))

    return Tiny


@pytest.mark.parametrize("mode", ["self", "ref", "kyara"])
def test_mode_trains_through_the_trainer_from_the_yaml(tmp_path, referenced_data, kyara_data,
                                                       monkeypatch, mode):
    """configs/sdxl/ip_adapter.yml on the tiny model and SigLIP: an epoch
    of two steps (self mode with the tail-drop), the adapters and the
    projector move, the base stays, the adapter file is saved."""
    cli, workload = {
        "self": (ip_adapter_self, train_ip_adapter.SDXLIPAdapterSelfTraining),
        "ref": (ip_adapter_ref, train_ip_adapter.SDXLIPAdapterTraining),
        "kyara": (ip_adapter_kyara, train_ip_adapter.SDXLIPAdapterKyaraTraining),
    }[mode]
    with open("configs/sdxl/ip_adapter.yml") as f:
        config = yaml.safe_load(f)
    config["model"].update(checkpoint_path="", dtype="float32", max_token_length=75,
                           denoiser=UNET, token_tail_drop=True, token_tail_drop_rate=1.0)
    # the YAML's mlp projector takes pooled features: the SigLIP's
    # "hidden_state" default gives it a token sequence (ROADMAP section 3)
    config["model"]["adapter"].update(image_size=32, feature_dim=FEATURES, dtype="float32")
    config["model"]["adapter"]["image_encoder"]["feature_type"] = "pooler_output"
    folder, parquet = {"ref": referenced_data, "kyara": kyara_data}.get(mode, referenced_data)
    dataset = dict(folder=str(folder), batch_size=2, bucket_base_size=64, step=32, min_size=32,
                   image_size=32, num_repeats=1, num_workers=0)
    if mode == "ref":
        dataset["metadata_parquet"] = str(parquet)
    if mode == "kyara":
        dataset["group_parquet_path"] = str(parquet)
    if mode == "self":
        for path in folder.glob("*.webp"):
            path.with_suffix(".txt").write_text("a photo")
    config["dataset"] = dataset
    config["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    config["num_train_epochs"] = 1
    trainer = cli.build_trainer(TrainConfig.model_validate(config), device="cpu")
    assert type(trainer.model) is workload
    trainer.register_model_class(_tiny_workload(workload))
    losses = []
    trainer.log_dict = lambda values, step=None: losses.append(values["train/loss"]) \
        if "train/loss" in values else None
    start = {}
    original = trainer.prepare_optimizer

    def prepare():
        original()
        start.update({k: v.detach().clone() for k, v in trainer.trainable.items()})

    monkeypatch.setattr(trainer, "prepare_optimizer", prepare)
    trainer.train()
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(k.startswith("image_proj.") for k in trainer.trainable)
    assert all(k.startswith("image_proj.") or "_ip." in k for k in trainer.trainable)
    moved = [k for k, v in trainer.trainable.items() if not torch.equal(v.detach(), start[k])]
    assert any(k.startswith("image_proj.") for k in moved) and any("_ip." in k for k in moved)
    saved = list((tmp_path / "out").glob("*.safetensors"))
    assert len(saved) == 1
    if mode == "self":
        assert trainer.model._tokens_to_keep is not None
