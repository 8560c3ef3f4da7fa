"""The port's PickScore reward model and DRaFT+ workload against the JAX
package's (CPU, fp32).

A tiny PickScore (CLIP text and vision towers of width 32, 2 layers,
28 px images in 14 px patches) on numpy weights written on the JAX
package's tree, and the tiny SDXL of tests/test_torch_sdxl_adapters.py
with LoRA rank 4 on its attention (non-zero lora_up). The JAX side runs
under ``jax.jit``. DRaFT+ samples 3 CFG steps, the last with its gradient
beside the adapter-off reference prediction, decodes and scores; the
port takes the JAX package's own per-step noises (``fold_in(key, i)``)
through ``loss_with_draws``. Tolerance: fp32 parity, relative error
<= 1e-4 of the output's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from vision_ft_tpu.models.sdxl import train_draft_plus as jax_draft
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel
from vision_ft_tpu.models.text_encoders.clip import CLIPTextConfig as JaxCLIPTextConfig
from vision_ft_tpu.models.vision_encoders.clip_vision import CLIPVisionConfig as JaxCLIPVisionConfig
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.reward import pickscore as jax_pickscore
from vision_ft_tpu.nn import flatten_params, unflatten_params

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.models.sdxl import train_draft_plus
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.text_encoders.clip import CLIPTextConfig
from vision_ft_tpu_torch.models.vision_encoders.clip_vision import CLIPVisionConfig
from vision_ft_tpu_torch.modules import peft
from vision_ft_tpu_torch.modules.reward import PickScoreConfig, load_reward_models, pickscore
from vision_ft_tpu_torch.train.sdxl import draft_plus as draft_cli
from vision_ft_tpu_torch.utils import safetensors as st

from test_torch_prompt_free_style import _tokenizers, write_vocab
from test_torch_sdxl import _random_params, _tiny_kwargs
from test_torch_sdxl_adapters import UNET, _close, _compare, _port_loss_and_grads
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

B = 2
TEXT = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, hidden_act="gelu", projection_dim=16)
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
              image_size=28, patch_size=14, hidden_act="gelu", projection_dim=16)
PROMPTS = ["a cat", "a style cat, 42"]


class _HFSignature:
    """The JAX package calls a reward model's tokenizer with the Hugging
    Face signature; this gives it the JAX CLIP tokenizer's ids."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def __call__(self, prompts, padding=None, truncation=None, max_length=77, return_tensors=None):
        return {"input_ids": self.tokenizer(prompts, max_length=max_length)}


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab"))


@pytest.fixture(scope="module")
def rewards(vocab_dir):
    """(JAX, port) tiny PickScore on the same numpy weights, and the flat
    weights."""
    jax_tok, port_tok = _tokenizers(vocab_dir)
    text, vision = JaxCLIPTextConfig(**TEXT), JaxCLIPVisionConfig(**VISION)
    shell = jax_pickscore.PickScoreRewardModel({}, text_config=text, vision_config=vision)
    shapes = {**jax.eval_shape(shell.text_model.init, jax.random.key(0)),
              **jax.eval_shape(shell.vision_model.init, jax.random.key(0))}
    flat = _random_params(shapes, 0)
    flat["logit_scale"] = np.asarray(np.log(100.0), np.float32)
    jax_model = jax_pickscore.PickScoreRewardModel(
        unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
        tokenizer=_HFSignature(jax_tok), text_config=text, vision_config=vision)
    model = pickscore.PickScoreRewardModel(
        tokenizer=port_tok, text_config=CLIPTextConfig(**TEXT),
        vision_config=CLIPVisionConfig(**VISION)).load_state_dict_flat(flat, device="cpu")
    assert set(model.state_dict()) == set(flat)
    return jax_model, model, flat


def test_pickscore_score_and_its_image_gradient_match_jax(rewards):
    """Per-sample scores of 40 x 36 images (the differentiable antialiased
    resize to 28 included) and d(sum of scores)/d(images)."""
    jax_model, model, _ = rewards
    images = np.random.default_rng(1).uniform(-1, 1, (B, 40, 36, 3)).astype(np.float32)
    ids = model.tokenizer(PROMPTS, max_length=77)
    np.testing.assert_array_equal(ids, jax_model.tokenizer(PROMPTS)["input_ids"])
    want_scores = jax.jit(jax_model.score)(jnp.asarray(images), jnp.asarray(ids))
    want_grad = jax.jit(jax.grad(lambda im: jnp.sum(jax_model.score(im, jnp.asarray(ids)))))(
        jnp.asarray(images))
    x = torch.from_numpy(images).requires_grad_(True)
    scores = model.score(x, torch.from_numpy(ids).long())
    scores.sum().backward()
    _close(scores.detach().numpy(), np.asarray(want_scores), "scores")
    _close(x.grad.numpy(), np.asarray(want_grad), "image gradient")
    assert np.abs(np.asarray(want_grad)).max() > 0
    assert not any(p.requires_grad for p in model.parameters())


def test_pickscore_call_matches_jax(rewards):
    """The host API: a softmax over PIL candidates against the first
    prompt."""
    jax_model, model, _ = rewards
    rng = np.random.default_rng(2)
    images = [Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)) for _ in range(3)]
    want = jax_model(images, PROMPTS)
    got = model(images, PROMPTS)
    _close(got.numpy(), np.asarray(want), "probs")
    assert abs(float(got.sum()) - 1.0) < 1e-6


def test_pickscore_loads_a_local_hf_directory(rewards, vocab_dir, tmp_path):
    """model.safetensors (with HF's position_ids, dropped) and the vocab
    in one directory load to the same model; a hub id raises."""
    _, model, flat = rewards
    import shutil

    for name in ("vocab.json", "merges.txt"):
        shutil.copy(vocab_dir / name, tmp_path / name)
    on_disk = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    on_disk["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    st.save_file(on_disk, tmp_path / "model.safetensors")
    loaded = pickscore.PickScoreRewardModel.from_pretrained(
        str(tmp_path), device="cpu", text_config=CLIPTextConfig(**TEXT),
        vision_config=CLIPVisionConfig(**VISION))
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    assert loaded.tokenizer(PROMPTS, 77).tolist() == model.tokenizer(PROMPTS, 77).tolist()
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        load_reward_models([PickScoreConfig(model_id="yuvalkirstain/PickScore_v1")], device="cpu")


# -- DRaFT+ ---------------------------------------------------------------------------------


def _draft_fields():
    return dict(total_steps=3, truncation_steps=1, cfg_scale=4.0, reward_loss_scale=0.7,
                kl_coeff=2.0, max_token_length=75)


def _sdxl_pair(vocab_dir, seed):
    """JAX and port tiny SDXL with LoRA on attn1 / attn2, on the same
    numpy weights. lora_up is drawn N(0, 0.5): the KL term is the mean
    square of the LoRA's effect on the prediction, which a near-zero
    lora_up would leave at the level of fp32 rounding in both packages."""
    jax_tok, port_tok = _tokenizers(vocab_dir)
    jax_cfg = jax_draft.SDXLForDRaFTPlusTrainingConfig(
        checkpoint_path="", dtype="float32", denoiser=JaxDenoiserConfig(**UNET), **_draft_fields())
    kwargs = {k: v for k, v in _tiny_kwargs("jax")[1].items() if k != "tokenizer"}
    jax_model = JaxSDXLModel(jax_cfg, tokenizer=jax_tok, **kwargs)
    parts = ("denoiser", "vae", "text_encoder")
    flat = _random_params({name: jax.eval_shape(getattr(jax_model, name).init, jax.random.key(0))
                           for name in parts}, seed)
    params = {name: unflatten_params({k[len(name) + 1:]: jnp.asarray(v) for k, v in flat.items()
                                      if k.startswith(name + ".")}) for name in parts}
    params = jax_peft.PeftTargetConfig(
        include_keys=["attn1", "attn2"], exclude_keys=["text_encoder", "vae"],
        config=jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
    ).replace_to_peft_layer(params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    flat = {}
    for key, value in flatten_params(params).items():
        value = np.asarray(value)
        if key.endswith("lora_up.weight"):
            value = rng.normal(0, 0.5, value.shape).astype(np.float32)
        flat[key] = value
    jax_model.params = {name: unflatten_params({k[len(name) + 1:]: jnp.asarray(v)
                                                for k, v in flat.items() if k.startswith(name + ".")})
                        for name in parts}
    port_cfg = train_draft_plus.SDXLForDRaFTPlusTrainingConfig(
        checkpoint_path="", dtype="float32", denoiser=DenoiserConfig(**UNET), **_draft_fields())
    kwargs = {k: v for k, v in _tiny_kwargs("torch")[1].items() if k != "tokenizer"}
    model = SDXLModel(port_cfg, tokenizer=port_tok, **kwargs)
    model.load_state_dict(flat, device="cpu")
    return jax_model, model, flat


def test_draft_plus_loss_reward_kl_and_lora_grads_match_jax(vocab_dir, rewards):
    """total_steps 3 and truncation 1 at 64 px: two gradient-free steps,
    one tail step with its gradient and the adapter-off reference beside
    it, the VAE decode and the tiny PickScore. The loss, the reward, the
    KL and every LoRA gradient."""
    jax_reward, reward, _ = rewards
    jax_model, model, flat = _sdxl_pair(vocab_dir, 3)
    workload = jax_draft.SDXLForDRaFTPlusTraining.__new__(jax_draft.SDXLForDRaFTPlusTraining)
    workload.model, workload.model_config = jax_model, jax_model.config
    workload.reward_models = [jax_reward]

    from vision_ft_tpu.modules.long_prompt import tokenize_long_prompt

    ids, _ = tokenize_long_prompt(jax_model.text_encoder.tokenizer, PROMPTS + ["", ""],
                                  max_length=75, chunk_length=75)
    rng = np.random.default_rng(4)
    batch = {
        "input_ids": np.asarray(ids),
        "original_size": np.asarray([[64, 64], [128, 64]], np.float32),
        "target_size": np.full((B, 2), 64, np.float32),
        "crop_coords_top_left": np.zeros((B, 2), np.float32),
        "initial_noise": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
        "reward_input_ids_0": reward.tokenizer(PROMPTS, max_length=77),
    }
    trainable, frozen = jax_peft.split_peft_params(jax_model.params)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (value, logs), grads = jax.jit(jax.value_and_grad(
        lambda tr: workload.loss_fn(tr, frozen, jbatch, key), has_aux=True))(trainable)
    want = (float(value), {k: float(v) for k, v in logs.items()},
            {k: np.asarray(v) for k, v in flatten_params(grads).items()})
    assert set(want[1]) == {"reward_0", "reward", "kl"} and want[1]["kl"] > 0
    noises = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), (B, 8, 8, 4))))
              for i in range(3)]

    model.denoiser.set_gradient_checkpointing(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _port_loss_and_grads(model, set(want[2]), lambda: train_draft_plus.loss_with_draws(
        model, model.config, [reward], tb, noises))
    _compare(got, want)


def test_draft_plus_trains_through_the_trainer_from_the_yaml(vocab_dir, rewards, tmp_path):
    """configs/sdxl/draft_plus.yml on the tiny model, 3 sampling steps and
    the injected tiny PickScore: one step, a finite loss with the reward
    and KL logged, only the LoRA trained and moved, the saved keys the
    JAX package's ComfyUI LoRA keys."""
    _, reward, _ = rewards
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(folder / f"{i}.png")
        (folder / f"{i}.txt").write_text(PROMPTS[i])
    with open("configs/sdxl/draft_plus.yml") as f:
        config = yaml.safe_load(f)
    config["model"].update(checkpoint_path="", dtype="float32", denoiser=UNET, **_draft_fields())
    config["peft"]["config"]["dtype"] = "float32"
    config["dataset"].update(folder=str(folder), batch_size=2, bucket_base_size=64, step=32,
                             min_size=32, num_workers=0)
    config["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    train_config = TrainConfig.model_validate(config)
    trainer = draft_cli.build_trainer(train_config, device="cpu")
    assert type(trainer.model) is train_draft_plus.SDXLForDRaFTPlusTraining

    class Tiny(train_draft_plus.SDXLForDRaFTPlusTraining):
        def setup_model(self):
            kwargs = {k: v for k, v in _tiny_kwargs("torch")[1].items() if k != "tokenizer"}
            self.model = SDXLModel(self.model_config, tokenizer=_tokenizers(vocab_dir)[1], **kwargs)
            self.model.init_params(torch.Generator().manual_seed(self.config.seed))

    trainer.register_model_class(Tiny, reward_models=[reward])
    logged = []
    trainer.log_dict = lambda values, step=None: logged.append(dict(values))
    trainer.train()
    step_logs = [v for v in logged if "train/loss" in v]
    assert len(step_logs) == 1 and np.isfinite(step_logs[0]["train/loss"])
    assert {"reward", "kl", "reward_0"} <= set(step_logs[0])
    assert trainer.trainable and all("lora_" in k for k in trainer.trainable)
    assert any(v.detach().abs().max() > 0 for k, v in trainer.trainable.items() if "lora_up" in k)
    saved = list((tmp_path / "out").glob("*.safetensors"))
    assert len(saved) == 1

    jax_model, _, _ = _sdxl_pair(vocab_dir, 0)
    workload = jax_draft.SDXLForDRaFTPlusTraining.__new__(jax_draft.SDXLForDRaFTPlusTraining)
    workload.model, workload._is_peft = jax_model, True
    assert set(st.load_file(saved[0])) == set(workload.get_state_dict_to_save())
    assert peft.get_adapter_parameters(trainer.model.model.denoiser)
