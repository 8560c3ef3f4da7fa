"""The port's prompt-free generation (PFG) and style tokenizer workloads
against the JAX package's (CPU, fp32).

A written CLIP vocabulary of exactly 1000 entries (the tiny towers'
``vocab_size``, eos 999), so the added ``<|style|>`` token takes id 1000
and both token-embedding matrices grow by a row. The tiny SDXL of
tests/test_torch_sdxl.py with the two-level UNet of
tests/test_torch_sdxl_adapters.py; numpy weights written on the JAX
package's trees and loaded in both packages; the JAX side runs under
``jax.jit``. The image encoder is injected: one fixed numpy linear map of
the normalized NCHW pixels, the same in both packages.

Tolerances: fp32 parity; projectors 1e-5 and everything else 1e-4 of the
output's max. The train steps' draws (the VAE sample's noise, the
timesteps, the noise) are numpy arrays handed to the port's
``loss_with_draws`` and, through patched samplers, to the JAX workloads'
``loss_fn``. ``generate()`` runs end to end in both packages with the
JAX package's initial latents and step noises in the port.
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

from vision_ft_tpu.dataset import single_caption_bucket as jax_scb
from vision_ft_tpu.dataset.transform import to_array as jax_to_array
from vision_ft_tpu.models.sdxl import train_prompt_free as jax_tpf
from vision_ft_tpu.models.sdxl import train_style_tokenizer as jax_tst
from vision_ft_tpu.models.sdxl.adapter import prompt_free as jax_pfg
from vision_ft_tpu.models.sdxl.adapter import style_tokenizer as jax_style
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.text_encoders import clip as jax_clip
from vision_ft_tpu.models.text_encoders.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules.adapter import prompt_free as jax_pf_mod
from vision_ft_tpu.modules.adapter import style_tokenizer as jax_st_mod
from vision_ft_tpu.nn import flatten_params, unflatten_params
from vision_ft_tpu.utils import tensor as jax_tensor_utils

from vision_ft_tpu_torch.config import TrainConfig
from vision_ft_tpu_torch.dataset import single_caption_bucket
from vision_ft_tpu_torch.models import auto
from vision_ft_tpu_torch.models.sdxl import train_prompt_free, train_style_tokenizer
from vision_ft_tpu_torch.models.sdxl.adapter import prompt_free, style_tokenizer
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_ft_tpu_torch.models.text_encoders import clip
from vision_ft_tpu_torch.models.text_encoders.tokenizer import CLIPTokenizer
from vision_ft_tpu_torch.modules.adapter import prompt_free as pf_mod
from vision_ft_tpu_torch.modules.adapter import style_tokenizer as st_mod
from vision_ft_tpu_torch.nn import load_flat_params
from vision_ft_tpu_torch.train.sdxl import prompt_free_ref, prompt_free_self
from vision_ft_tpu_torch.train.sdxl import style_tokenizer as style_cli
from vision_ft_tpu_torch.utils import tensor as tensor_utils

from test_torch_sdxl import _random_params, _tiny_kwargs
from test_torch_sdxl_adapters import UNET, _batch, _compare, _patch_normals, _port_loss_and_grads
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

B = 2
N_TOK = 4
FEATURES = 24
IMAGE = 32
PARTS = ("denoiser", "vae", "text_encoder")


def _close(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rtol, f"{name}: relative error {err:.3g}"


# -- the written vocabulary and the added token ---------------------------------------------


def write_vocab(path):
    """letters and digits with and without the end-of-word mark, a few
    merges, fillers up to 998, bos 998, eos 999: 1000 entries."""
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789,.|<>":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for token in ("ca", "cat</w>", "st", "sty", "styl", "style</w>"):
        vocab[token] = len(vocab)
    while len(vocab) < 998:
        vocab[f"<filler{len(vocab)}>"] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 998, 999
    (path / "vocab.json").write_text(json.dumps(vocab))
    merges = ["#version: 0.2", "c a", "ca t</w>", "s t", "st y", "sty l", "styl e</w>"]
    (path / "merges.txt").write_text("\n".join(merges) + "\n")
    return path


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab"))


def _tokenizers(vocab_dir):
    return (JaxCLIPTokenizer.from_pretrained_dir(str(vocab_dir)),
            CLIPTokenizer.from_pretrained_dir(str(vocab_dir)))


def test_added_tokens_match_jax(vocab_dir):
    """len, add_tokens, convert_tokens_to_ids, and encode / __call__ /
    decode with the added token split out before BPE, lower-cased."""
    want_tok, got_tok = _tokenizers(vocab_dir)
    assert len(got_tok) == len(want_tok) == 1000
    assert got_tok.add_tokens("<|style|>") == want_tok.add_tokens("<|style|>") == 1
    assert got_tok.add_tokens("<|style|>") == want_tok.add_tokens("<|style|>") == 0
    assert got_tok.add_tokens("cat</w>") == 0
    assert len(got_tok) == len(want_tok) == 1001
    assert got_tok.convert_tokens_to_ids("<|style|>") == want_tok.convert_tokens_to_ids("<|style|>") == 1000
    assert got_tok.convert_tokens_to_ids("cat</w>") == want_tok.convert_tokens_to_ids("cat</w>")
    prompts = ["a <|STYLE|><|style|> cat, style", "<|style|>", "no tokens here 42", ""]
    for prompt in prompts:
        assert got_tok.encode(prompt) == want_tok.encode(prompt), prompt
    np.testing.assert_array_equal(got_tok(prompts, max_length=10), want_tok(prompts, max_length=10))
    ids = got_tok.encode("a cat, style 42")
    assert got_tok.decode(ids) == want_tok.decode(ids)


# -- the CLIP style scatter ---------------------------------------------------------------------


@pytest.mark.parametrize("num_vectors", [4, 2, 6], ids=["as_many", "fewer_vectors", "more_vectors"])
def test_style_scatter_matches_jax(num_vectors):
    """The k-th style position (row-major over batch and sequence) takes
    the k-th vector: 4 positions against 4, 2 (the gather clips: the last
    vector repeats) and 6 vectors, through the projected tower."""
    fields = dict(vocab_size=1001, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, hidden_act="gelu", projection_dim=16)
    jax_model = jax_clip.CLIPTextModelWithProjection(jax_clip.CLIPTextConfig(**fields))
    flat = _random_params(jax.eval_shape(jax_model.init, jax.random.key(0)), 1)
    with torch.device("meta"):
        model = clip.CLIPTextModelWithProjection(clip.CLIPTextConfig(**fields))
    load_flat_params(model, flat)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 990, (B, 12)).astype(np.int32)
    ids[ids == 7] = 8
    ids[:, 0], ids[:, -1] = 998, 1000  # bos; eos at vocab_size - 1
    ids[0, 3:6] = 7  # three style positions (id 7) in row 0 ...
    ids[1, 2] = 7  # ... and one in row 1
    vectors = rng.standard_normal((num_vectors, 32)).astype(np.float32)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = jax.jit(lambda p, i, s: jax_model(p, i, s, 7))(params, jnp.asarray(ids), jnp.asarray(vectors))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(vectors), 7)
        plain = model(torch.from_numpy(ids).long())
    for name, g, w in zip(("last", "penultimate", "pooled"), got, want):
        _close(g.numpy(), np.asarray(w), 1e-4, name)
    assert not torch.allclose(got[0], plain[0])


# -- the six projectors -------------------------------------------------------------------------


PROJECTORS = {
    "pfg_linear": (jax_pf_mod.LinearImageProjector, pf_mod.LinearImageProjector, (FEATURES, 32, N_TOK), {}),
    "pfg_mlp": (jax_pf_mod.MLPImageProjector, pf_mod.MLPImageProjector, (FEATURES, 32, N_TOK),
                {"mlp_ratio": 2.0}),
    "pfg_resampler": (jax_pf_mod.ResamplerImageProjector, pf_mod.ResamplerImageProjector,
                      (FEATURES, 32, N_TOK), {"num_layers": 2, "num_heads": 4, "mlp_ratio": 2.0}),
    "style_linear": (jax_st_mod.LinearImageProjector, st_mod.LinearImageProjector, (FEATURES, 32, N_TOK), {}),
    "style_mlp": (jax_st_mod.MLPImageProjector, st_mod.MLPImageProjector, (FEATURES, 32, N_TOK), {}),
    "style_resampler": (jax_st_mod.ResamplerImageProjector, st_mod.ResamplerImageProjector,
                        (FEATURES, 32, N_TOK), {"num_layers": 2, "num_heads": 4, "mlp_ratio": 2.0}),
}


@pytest.mark.parametrize("kind", list(PROJECTORS))
def test_projector_matches_jax(kind):
    """fp32 outputs on random weights to 1e-5 (the resamplers on a token
    sequence, the others on pooled features); the keys are the JAX
    package's; ``init_weights`` gives the JAX package's zeros."""
    jax_cls, port_cls, args, kwargs = PROJECTORS[kind]
    jax_module = jax_cls(*args, **kwargs)
    flat = _random_params(jax.eval_shape(jax_module.init, jax.random.key(0)), 3)
    rng = np.random.default_rng(4)
    features = rng.standard_normal((B, 6, FEATURES) if "resampler" in kind else (B, FEATURES))
    features = features.astype(np.float32)
    want = jax.jit(jax_module)(unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
                              jnp.asarray(features))[0]
    with torch.device("meta"):
        module = port_cls(*args, **kwargs)
    assert set(module.state_dict()) == set(flat)
    load_flat_params(module, flat)
    with torch.no_grad():
        got = module(torch.from_numpy(features))
    assert got.shape == (B, N_TOK, 32)
    _close(got.numpy(), np.asarray(want), 1e-5, kind)

    module.init_weights(torch.Generator().manual_seed(0))
    initial = jax_module.init(jax.random.key(1))
    for key, value in flatten_params(initial).items():
        port_value = module.state_dict()[key]
        assert (not np.asarray(value).any()) == (not port_value.any()), key


# -- the tiny models --------------------------------------------------------------------------


def _encoder(pkg, seed=5):
    """The injected image encoder: a fixed linear map of the flattened
    normalized NCHW pixels to FEATURES, numpy in (numpy or a tensor) ->
    numpy out (JAX) or a tensor (the port)."""
    weight = np.random.default_rng(seed).standard_normal((3 * IMAGE * IMAGE, FEATURES))
    weight = (weight / np.sqrt(3 * IMAGE * IMAGE)).astype(np.float32)

    def encode(pixels):
        x = np.asarray(pixels.cpu() if isinstance(pixels, torch.Tensor) else pixels, np.float32)
        out = np.tanh(x.reshape(x.shape[0], -1) @ weight)
        return out if pkg == "jax" else torch.from_numpy(out)

    return encode


def _configs(pkg, kind, **adapter):
    """(model class, config) of the tiny PFG or style model."""
    adapter = dict(image_size=IMAGE, feature_dim=FEATURES, projector_type="mlp",
                   projector_args={"mlp_ratio": 2.0}, **adapter)
    if kind == "pfg":
        adapter["num_image_tokens"] = N_TOK
        cls, cfg = ((jax_pfg.SDXLModelWithPFG, jax_tpf.SDXLModelWithPFGTrainingConfig) if pkg == "jax"
                    else (prompt_free.SDXLModelWithPFG, train_prompt_free.SDXLModelWithPFGTrainingConfig))
    else:
        adapter["num_style_tokens"] = N_TOK
        cls, cfg = ((jax_style.SDXLModelWithStyleTokenizer,
                     jax_tst.SDXLModelWithStyleTokenizerTrainingConfig) if pkg == "jax"
                    else (style_tokenizer.SDXLModelWithStyleTokenizer,
                          train_style_tokenizer.SDXLModelWithStyleTokenizerTrainingConfig))
    denoiser = (JaxDenoiserConfig if pkg == "jax" else DenoiserConfig)(**UNET)
    return cls, cfg(checkpoint_path="", dtype="float32", denoiser=denoiser, adapter=adapter)


def _projector_names(kind):
    return ("projector",) if kind == "pfg" else ("projector_1", "projector_2")


def _pair(kind, vocab_dir, seed, peft=False):
    """The JAX and port models on the same numpy weights (the projectors'
    drawn like the base's; with ``peft``, LoRA rank 4 on the UNet's
    attention with non-zero lora_up) and their flat weights."""
    jax_cls, jax_cfg = _configs("jax", kind)
    kwargs = {k: v for k, v in _tiny_kwargs("jax")[1].items() if k != "tokenizer"}
    jax_model = jax_cls(jax_cfg, tokenizer=_tokenizers(vocab_dir)[0], image_encoder=_encoder("jax"),
                        **kwargs)
    names = PARTS + _projector_names(kind)
    flat = _random_params({name: jax.eval_shape(getattr(jax_model, name).init, jax.random.key(0))
                           for name in names}, seed)
    if peft:
        denoiser = jax_peft.replace_to_peft_layer(
            unflatten_params({k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items()
                              if k.startswith("denoiser.")}),
            ["attn1", "attn2"], [], jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
            jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed + 1)
        for key, value in flatten_params(denoiser).items():
            value = np.asarray(value)
            if key.endswith("lora_up.weight"):
                value = rng.normal(0, 0.05, value.shape).astype(np.float32)
            flat[f"denoiser.{key}"] = value
    jax_model.params = {name: unflatten_params({k[len(name) + 1:]: jnp.asarray(v)
                                                for k, v in flat.items() if k.startswith(name + ".")})
                        for name in names}
    if kind == "style":
        jax_model.setup_style_token()

    port_cls, port_cfg = _configs("torch", kind)
    kwargs = {k: v for k, v in _tiny_kwargs("torch")[1].items() if k != "tokenizer"}
    model = port_cls(port_cfg, tokenizer=_tokenizers(vocab_dir)[1], image_encoder=_encoder("torch"),
                     **kwargs)
    model.load_state_dict(flat, device="cpu")
    return jax_model, model, flat


# -- generate ---------------------------------------------------------------------------------


def _jax_noise(shape, seed, dtype=torch.float32, device=None):
    """The JAX package's seeded draws, for the port's generate()."""
    out = jax_tensor_utils._incremental_seed_randn_jit(jnp.int32(seed), tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(out)).to(dtype)


def test_preprocess_normalizes_the_image_bytes(vocab_dir):
    """The port scales a reference image's bytes to [0, 1] before the
    mean / std; the JAX package divides to_array's [-1, 1] by 255 again
    (a fault kept there: every image comes out near -1)."""
    jax_model, model, _ = _pair("pfg", vocab_dir, 0)
    image = Image.fromarray(np.random.default_rng(1).integers(0, 255, (40, 24, 3), np.uint8))
    got = model.preprocess_reference_image(image)
    square = np.asarray(model._resize(image), np.float32)
    np.testing.assert_allclose(got[0], ((square / 255.0 - 0.5) / 0.5).transpose(2, 0, 1), atol=1e-6)
    want = jax_model.preprocess_reference_image(image)
    faulty = (jax_to_array(jax_model._resize(image)) / 255.0 - 0.5) / 0.5
    np.testing.assert_allclose(want[0], faulty.transpose(2, 0, 1), atol=1e-6)
    assert np.abs(want + 1).max() < 0.01 and np.abs(got).max() > 0.5


@pytest.mark.parametrize("kind", ["pfg", "style"])
def test_generate_matches_jax(vocab_dir, monkeypatch, kind):
    """generate() with a normalized reference batch, CFG, 2 steps, the
    PFG tokens on the context's tail (zeros for the negative) or the
    style vectors in both towers (a prompt with the style token, the
    embeddings grown to 1001 rows, the pooled output at eos 999): the
    final latents against the JAX package's, and without a reference the
    base model's context."""
    jax_model, model, _ = _pair(kind, vocab_dir, 6)
    if kind == "style":
        for tower in (model.text_encoder.text_encoder_1, model.text_encoder.text_encoder_2):
            assert tower.text_model["embeddings"]["token_embedding"].weight.shape[0] == 1001
            assert tower.config.vocab_size == 1000
        assert model.text_encoder.style_token_id == 1000
    reference = np.random.default_rng(7).uniform(-1, 1, (1, 3, IMAGE, IMAGE)).astype(np.float32)
    captured = {}
    monkeypatch.setattr(jax_model, "decode_image", lambda latents, use_tiling=False:
                        captured.setdefault("jax", np.asarray(latents)))
    monkeypatch.setattr(model, "decode_image", lambda latents, use_tiling=False:
                        captured.setdefault("port", latents.numpy()))
    monkeypatch.setattr(tensor_utils, "incremental_seed_randn", _jax_noise)
    prompt = "a <|style|> cat" if kind == "style" else "a cat"
    kwargs = dict(prompt=prompt, negative_prompt="", reference_image=reference, width=64, height=64,
                  num_inference_steps=2, cfg_scale=4.0, seed=3, max_token_length=75)
    jax_model.generate(**kwargs)
    model.generate(**kwargs)
    _close(captured["port"], captured["jax"], 1e-4, f"{kind} latents")

    # the context itself, with and without the reference
    contexts = {}
    monkeypatch.setattr(model, "_generate_core", lambda emb, *a, **k: contexts.setdefault(
        len(contexts), emb))
    model.generate(**kwargs)
    model.generate(**{**kwargs, "reference_image": None})
    with_ref, without = contexts[0], contexts[1]
    if kind == "pfg":
        assert with_ref.shape[1] == without.shape[1] + N_TOK
        assert not with_ref[1, -N_TOK:].any() and with_ref[0, -N_TOK:].abs().max() > 0
    else:
        assert with_ref.shape == without.shape and not torch.equal(with_ref, without)


# -- the losses and gradients -------------------------------------------------------------------


def _trainable(kind, key, peft):
    if peft and "lora_" in key:
        return True
    return key.startswith(_projector_names(kind))


@pytest.mark.parametrize("case", ["pfg_ref", "pfg_self_lora", "style"])
def test_loss_and_grads_match_jax(vocab_dir, monkeypatch, case):
    """One step's loss and trainable gradients with JAX's draws, one
    image dropped: the PFG projector in the model's dtype (and, self mode
    under peft, the UNet's LoRA beside it), or both style projectors in
    fp32 with their gradient through both CLIP towers."""
    kind = "pfg" if case.startswith("pfg") else "style"
    peft = case == "pfg_self_lora"
    jax_model, model, flat = _pair(kind, vocab_dir, 8, peft=peft)
    jax_cls = {"pfg_ref": jax_tpf.SDXLPFGTraining, "pfg_self_lora": jax_tpf.SDXLPFGSelfTraining,
               "style": jax_tst.SDXLStyleTokenizerTraining}[case]
    port_loss = (train_prompt_free if kind == "pfg" else train_style_tokenizer).loss_with_draws
    workload = jax_cls.__new__(jax_cls)
    workload.model, workload.model_config = jax_model, jax_model.config

    batch = _batch(9)
    if kind == "style":
        prompts = [jax_model.text_encoder.preprocess_style_token(p)
                   for p in ("a <|style|> cat", "<|style|>, 42")]
        batch["input_ids"] = jax_model.text_encoder.tokenizer(prompts, max_length=77)
    rng = np.random.default_rng(10)
    batch["reference_features"] = rng.standard_normal((B, FEATURES)).astype(np.float32)
    batch["drop_image"] = np.asarray([0.0, 1.0] if kind == "pfg" else [1.0, 0.0], np.float32)
    vae_noise, noise = (rng.standard_normal((B, 8, 8, 4)).astype(np.float32) for _ in range(2))
    timesteps = np.asarray([120, 710], np.int32)
    _patch_normals(monkeypatch, [vae_noise, noise])
    jax_mod = jax_tpf if kind == "pfg" else jax_tst
    monkeypatch.setattr(jax_mod, "uniform_randint", lambda key, shape, lo, hi: jnp.asarray(timesteps))

    params = dict(jax_model.params)
    keys = {k for k in flatten_params(params) if _trainable(kind, k, peft)}
    trainable = unflatten_params({k: v for k, v in flatten_params(params).items() if k in keys})
    frozen = unflatten_params({k: v for k, v in flatten_params(params).items() if k not in keys})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (value, _), grads = jax.jit(jax.value_and_grad(
        lambda tr: workload.loss_fn(tr, frozen, jbatch, jax.random.PRNGKey(0)), has_aux=True))(trainable)
    want = (float(value), {}, {k: np.asarray(v) for k, v in flatten_params(grads).items()})
    assert any(k.startswith(_projector_names(kind)) for k in want[2])
    assert peft == any("lora_" in k for k in want[2])

    model.denoiser.set_gradient_checkpointing(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _port_loss_and_grads(model, keys, lambda: port_loss(
        model, tb, torch.from_numpy(vae_noise), torch.from_numpy(timesteps), torch.from_numpy(noise)))
    _compare(got, want)


# -- the Trainer, from the YAMLs ------------------------------------------------------------------


class _NCHWEncoder:
    """The port's auto-encoder contract on the injected map."""

    def __init__(self):
        self.calls = []
        self._encode = _encoder("torch")

    def __call__(self, pixels):
        assert pixels.ndim == 4 and pixels.shape[1] == 3
        self.calls.append(tuple(pixels.shape))
        return self._encode(pixels)


def _tiny_workload(cls, kind, vocab_dir, encoder):
    class Tiny(cls):
        def setup_model(self):
            model_cls = (prompt_free.SDXLModelWithPFG if kind == "pfg"
                         else style_tokenizer.SDXLModelWithStyleTokenizer)
            kwargs = {k: v for k, v in _tiny_kwargs("torch")[1].items() if k != "tokenizer"}
            self.model = model_cls(self.model_config, tokenizer=_tokenizers(vocab_dir)[1],
                                   image_encoder=encoder, **kwargs)
            self.model.init_params(torch.Generator().manual_seed(self.config.seed))

    return Tiny


def _jax_saved_keys(kind, workload_cls, vocab_dir):
    jax_model, _, _ = _pair(kind, vocab_dir, 0)
    workload = workload_cls.__new__(workload_cls)
    workload.model, workload.model_config, workload._is_peft = jax_model, jax_model.config, False
    return set(workload.get_state_dict_to_save())


@pytest.mark.parametrize("mode", ["pfg_ref", "pfg_self", "style"])
def test_workload_trains_through_the_trainer_from_the_yaml(tmp_path, vocab_dir, monkeypatch, mode):
    """The workload's YAML on the tiny model and the injected encoder, an
    epoch of one step of batch 2: a finite loss, only the projectors
    trained and moved, the encoder fed normalized NCHW batches, and the
    saved file's keys the JAX package's; it reloads to the same
    projectors."""
    from test_torch_ip_adapter import _write_images

    kind = "pfg" if mode.startswith("pfg") else "style"
    cli, workload, jax_workload, yaml_path = {
        "pfg_ref": (prompt_free_ref, train_prompt_free.SDXLPFGTraining, jax_tpf.SDXLPFGTraining,
                    "configs/sdxl/prompt_free.ref.yml"),
        "pfg_self": (prompt_free_self, train_prompt_free.SDXLPFGSelfTraining,
                     jax_tpf.SDXLPFGSelfTraining, "configs/sdxl/prompt_free.self.yml"),
        "style": (style_cli, train_style_tokenizer.SDXLStyleTokenizerTraining,
                  jax_tst.SDXLStyleTokenizerTraining, "configs/sdxl/style_tokenizer.yml"),
    }[mode]
    folder = tmp_path / "images"
    folder.mkdir()
    _write_images(folder, ["a", "b"], size=(64, 64))
    for id_ in ("a", "b"):
        (folder / f"{id_}.txt").write_text("a <|style|> cat" if kind == "style" else "a cat")
    with open(yaml_path) as f:
        config = yaml.safe_load(f)
    config["model"].update(checkpoint_path="", dtype="float32", max_token_length=75, denoiser=UNET,
                           drop_image_rate=0.0)
    config["model"]["adapter"].update(image_size=IMAGE, feature_dim=FEATURES)
    dataset = dict(folder=str(folder), batch_size=2, bucket_base_size=64, step=32, min_size=32,
                   num_repeats=1, num_workers=0)
    if "metadata_parquet" in config["dataset"]:
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(pa.table({
            "id": ["a", "b"], "another_id": [["b"], ["a"]], "copyright": [["cp"]] * 2,
            "character": [["ch"]] * 2, "general": [["cat"]] * 2, "meta": [["m"]] * 2,
            "people": [["1girl"]] * 2,
        }), str(tmp_path / "meta.parquet"))
        dataset.update(metadata_parquet=str(tmp_path / "meta.parquet"), image_size=IMAGE)
    if kind == "style":
        # the referenced dataset's captions are its tags: the style token comes first
        dataset["caption_processors"] = [{"type": "prefix", "prefix": "<|style|>, "}]
    config["dataset"] = dataset
    config["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    config["num_train_epochs"] = 1
    trainer = cli.build_trainer(TrainConfig.model_validate(config), device="cpu")
    assert type(trainer.model) is workload
    encoder = _NCHWEncoder()
    trainer.register_model_class(_tiny_workload(workload, kind, vocab_dir, encoder))
    losses = []
    norms = []
    trainer.log_dict = lambda values, step=None: (losses.append(values["train/loss"]), norms.append(
        values["train/grad_norm"])) if "train/loss" in values else None
    start = {}
    original = trainer.prepare_optimizer

    def prepare():
        original()
        start.update({k: v.detach().clone() for k, v in trainer.trainable.items()})

    monkeypatch.setattr(trainer, "prepare_optimizer", prepare)
    trainer.train()
    assert len(losses) == 1 and np.isfinite(losses).all() and norms[0] > 0
    names = _projector_names(kind)
    assert trainer.trainable and all(k.startswith(names) for k in trainer.trainable)
    moved = {k.split(".")[0] for k, v in trainer.trainable.items() if not torch.equal(v.detach(), start[k])}
    assert moved == set(names)
    assert encoder.calls == [(2, 3, IMAGE, IMAGE)]
    saved = list((tmp_path / "out").glob("*.safetensors"))
    assert len(saved) == 1
    from vision_ft_tpu_torch.utils import safetensors as st

    state = st.load_file(saved[0])
    assert set(state) == _jax_saved_keys(kind, jax_workload, vocab_dir)
    model = trainer.model.model
    model.config.adapter.checkpoint_weight = str(saved[0])
    before = {k: v.clone() for k, v in model.adapter_state_dict().items()}
    model.init_adapter_params(torch.Generator().manual_seed(99))
    loaded = {k: v for k, v in state.items()}
    if kind == "pfg":
        model._load_projector({k[len("projector."):]: v for k, v in loaded.items()})
    else:
        model._load_projectors(loaded)
    for key, value in model.adapter_state_dict().items():
        torch.testing.assert_close(value, before[key], rtol=0, atol=0)


@pytest.mark.parametrize("cls", [train_prompt_free.SDXLPFGTraining,
                                 train_prompt_free.SDXLPFGSelfTraining])
def test_pfg_projector_trains_beside_peft(cls):
    """Under a PEFT config the Trainer trains the adapters and the
    workload's extra filter: the port's PFG workloads keep the projector
    there; the JAX package's filter leaves it frozen (ROADMAP section 3)."""
    workload = cls.__new__(cls)
    assert workload.peft_extra_trainable_filter("projector.mlp.0.weight")
    assert not workload.peft_extra_trainable_filter("denoiser.out.2.weight")
    jax_cls = {train_prompt_free.SDXLPFGTraining: jax_tpf.SDXLPFGTraining,
               train_prompt_free.SDXLPFGSelfTraining: jax_tpf.SDXLPFGSelfTraining}[cls]
    assert not jax_cls.__new__(jax_cls).peft_extra_trainable_filter("projector.mlp.0.weight")


def test_auto_image_encoder_names_the_missing_package(monkeypatch):
    """Where timm or transformers is not installed, loading raises
    ImportError naming it (the packages are hidden here, so nothing is
    fetched)."""
    import importlib

    real = importlib.import_module

    def hidden(name, *args):
        if name in ("timm", "transformers"):
            raise ImportError(f"No module named {name!r}")
        return real(name, *args)

    monkeypatch.setattr(importlib, "import_module", hidden)
    for config, name in ((auto.TimmModelConfig(), "timm"),
                         (auto.TransformersModelConfig(model_name="x"), "transformers")):
        encoder = auto.AutoImageEncoder(config, device="cpu")
        with pytest.raises(ImportError, match=f"the {name} package is not installed"):
            encoder(np.zeros((1, 3, IMAGE, IMAGE), np.float32))


# -- the single-caption dataset -----------------------------------------------------------------


def test_single_caption_buckets_match_jax(tmp_path):
    """For a seed, the sampled sizes, the buckets and every batch."""
    for i in range(7):
        (tmp_path / f"c{i}.txt").write_text(f"caption {i}\n")
    (tmp_path / "skip.png").write_bytes(b"")
    fields = dict(folder=str(tmp_path), batch_size=2, bucket_base_size=256, step=32, min_size=64,
                  num_repeats=2)

    def batches(config_cls):
        random.seed(11)
        buckets = config_cls.model_validate(fields).generate_buckets()
        out = []
        for bucket in sorted(buckets, key=lambda b: (b.width, b.height)):
            items = sorted(bucket.items, key=lambda it: str(it.caption))
            bucket.items = items
            out.append(((bucket.width, bucket.height), [(str(it.caption), it.width, it.height)
                                                        for it in items], bucket[0:len(bucket)]))
        return out

    got = batches(single_caption_bucket.SingleCaptionDatasetConfig)
    want = batches(jax_scb.SingleCaptionDatasetConfig)
    assert got == want and sum(len(b[1]) for b in got) == 7
    dataset = single_caption_bucket.SingleCaptionDatasetConfig.model_validate(fields).get_dataset()
    assert len(dataset) > 0 and set(dataset[0]) == {"caption", "height", "width"}
