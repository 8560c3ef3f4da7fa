"""The port's gradient checkpointing modes and the folded LoRA matmul
(CPU, fp32).

``remat_saves``: "activations" (the default, as in the JAX package),
"kernel" and "none" give the same gradients, bit for bit, on the LoRA
train steps of the four trained families' tiny models (the weights and
draws of their own parity tests, which hold the port's gradients to the
JAX package's); what differs is what the recomputation runs, counted here
as the matmuls and convolutions of the backward.

``VFT_LORA_CONCAT=1`` (the JAX ``_lora_concat_dot``): one (M, K+r) @
(K+r, N) product against the separate route, forward and gradients,
including a trainable alpha, which keeps its gradient.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu.nn import flatten_params
from vision_ft_tpu_torch.config import TrainerConfig
from vision_ft_tpu_torch.nn import core

from test_torch_lumina2_train import weights as lumina_weights  # noqa: F401 (fixture)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

MODES = ("activations", "kernel", "none")
GEMMS = {"aten.mm.default", "aten.addmm.default", "aten.convolution.default"}


class _CountGemms(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += str(func) in GEMMS
        return func(*args, **(kwargs or {}))


def _sdxl():
    from test_torch_sdxl_train import _batches, _port_model, _supplied_draws_loss, _weights

    from vision_ft_tpu_torch.modules import peft

    model = _port_model(_weights())
    trainable, _ = peft.split_peft_params(model.denoiser)
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    loss_fn = _supplied_draws_loss(model)
    return model, list(trainable.values()), lambda: loss_fn(batch, None)[0]


def _lumina2(flat):
    from test_torch_lumina2_train import _batches, _draws_loss, _port_model, _torch_batch

    from vision_ft_tpu_torch.modules import peft

    model = _port_model(flat)
    trainable, _ = peft.split_peft_params(model.denoiser)
    batch = _torch_batch(_batches(steps=1)[0])
    loss_fn = _draws_loss(model)
    return model, list(trainable.values()), lambda: loss_fn(batch, None)[0]


def _auraflow():
    from test_torch_auraflow_train import (
        DENOISER, _batch, _draws, _jax_model, _split, _torch_batch, _weights,
        _port_model,
    )
    from vision_ft_tpu.models.auraflow import config as jax_config
    from vision_ft_tpu.models.auraflow.pipeline import AuraFlowModel as JaxAuraFlowModel

    from vision_ft_tpu_torch.models.auraflow import train_text_to_image as t2i_train
    from vision_ft_tpu_torch.models.auraflow.config import AuraFlowConig
    from vision_ft_tpu_torch.models.auraflow.pipeline import AuraFlowModel

    flat = _weights(_jax_model(JaxAuraFlowModel, jax_config.AuraFlowConig, DENOISER), 0)
    trainable, _ = _split(flat)
    model = _port_model(AuraFlowModel, AuraFlowConig, DENOISER, flat)
    batch, draws = _torch_batch(_batch(1)), _draws(2)
    leaves = model.as_module().state_dict(keep_vars=True)
    params = [leaves[f"denoiser.{k}"] for k in flatten_params(trainable["denoiser"])]
    return model, params, lambda: t2i_train.loss_with_draws(
        model, batch, *(torch.from_numpy(draws[k]) for k in ("vae_noise", "timesteps", "noise"))
    )


def _cogview4():
    from test_torch_cogview4_train import _batch, _draws, _split, _weights
    from test_torch_cogview4 import port_pipeline

    from vision_ft_tpu_torch.models.cogview4 import train_text_to_image as t2i_train

    _, flat = _weights(0)
    trainable, _ = _split(flat)
    model = port_pipeline(flat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    draws = _draws(2)
    leaves = model.as_module().state_dict(keep_vars=True)
    params = [leaves[f"denoiser.{k}"] for k in flatten_params(trainable["denoiser"])]
    return model, params, lambda: t2i_train.loss_with_draws(
        model, batch, *(torch.from_numpy(draws[k]) for k in ("vae_noise", "timesteps", "noise"))
    )


def _grads_by_mode(model, params, loss):
    """{mode: (gradients, matmuls and convolutions of the backward)} with
    gradient checkpointing on."""
    for p in params:
        p.requires_grad_(True)
    model.denoiser.set_gradient_checkpointing(True)
    out = {}
    try:
        for mode in MODES:
            tnn.set_remat_saves(mode)
            value = loss()
            value = value[0] if isinstance(value, tuple) else value
            with _CountGemms() as counter:
                grads = torch.autograd.grad(value, params)
            out[mode] = grads, counter.count
    finally:
        tnn.set_remat_saves("activations")
    return out


@pytest.mark.parametrize("family", ["sdxl", "lumina2", "auraflow", "cogview4"])
def test_gradients_are_bit_identical_across_remat_modes(family, request):
    model, params, loss = {
        "sdxl": _sdxl,
        "lumina2": lambda: _lumina2(request.getfixturevalue("lumina_weights")),
        "auraflow": _auraflow,
        "cogview4": _cogview4,
    }[family]()
    runs = _grads_by_mode(model, params, loss)
    want, _ = runs["none"]
    assert any(g.abs().max() > 0 for g in want)
    for mode in ("activations", "kernel"):
        for i, (g, w) in enumerate(zip(runs[mode][0], want)):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"{family} {mode} leaf {i}")
    # the recomputation of "activations" runs no forward matmul or
    # convolution: its backward runs fewer than the other two modes'
    gemms = {mode: count for mode, (_, count) in runs.items()}
    assert gemms["activations"] < gemms["kernel"] == gemms["none"], gemms


def test_activations_is_the_default_mode():
    assert TrainerConfig().remat_saves == "activations" == core.remat_saves()
    with pytest.raises(ValueError):
        tnn.set_remat_saves("everything")


def _lora_layer(rng, n_in=24, n_out=20, rank=4, bias=True):
    layer = tnn.Linear(n_in, n_out, bias=bias)
    flat = {
        "weight": rng.uniform(-0.2, 0.2, (n_out, n_in)),
        "lora_down.weight": rng.normal(0, 0.2, (rank, n_in)),
        "lora_up.weight": rng.normal(0, 0.2, (n_out, rank)),
        "alpha": np.asarray(2.0),
    }
    if bias:
        flat["bias"] = rng.normal(0, 0.1, (n_out,))
    tnn.load_flat_params(layer, {k: np.asarray(v, np.float32) for k, v in flat.items()})
    layer.weight.requires_grad_(False)
    return layer


@pytest.mark.parametrize("trainable_alpha", [False, True], ids=["frozen_alpha", "trainable_alpha"])
def test_lora_concat_matches_the_separate_route(monkeypatch, trainable_alpha):
    """Forward and the gradients of x, lora_down, lora_up (and alpha when it
    trains) of the folded product against the separate delta."""
    rng = np.random.default_rng(0)
    layer = _lora_layer(rng)
    if trainable_alpha:
        layer.alpha.requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((2, 5, 20)).astype(np.float32))
    leaves = [x, layer.lora_down.weight, layer.lora_up.weight] + ([layer.alpha] if trainable_alpha else [])

    def run():
        y = layer(x)
        return y, torch.autograd.grad(y, leaves, dy)

    monkeypatch.delenv("VFT_LORA_CONCAT", raising=False)
    want_y, want_grads = run()
    monkeypatch.setenv("VFT_LORA_CONCAT", "1")
    assert core._lora_concat_applies(layer)
    got_y, got_grads = run()
    torch.testing.assert_close(got_y, want_y, rtol=1e-5, atol=1e-6)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if trainable_alpha:
        assert got_grads[-1].abs() > 0  # not the JAX custom VJP's zero


def test_lora_concat_leaves_other_layers_on_the_separate_route(monkeypatch):
    """An up bias, a base that trains, a layer without LoRA or PEFT off:
    the separate route, as in the JAX package's condition."""
    monkeypatch.setenv("VFT_LORA_CONCAT", "1")
    rng = np.random.default_rng(1)
    layer = _lora_layer(rng)
    assert core._lora_concat_applies(layer)
    layer.weight.requires_grad_(True)
    assert not core._lora_concat_applies(layer)
    layer.weight.requires_grad_(False)
    tnn.set_peft_enabled(False)
    try:
        assert not core._lora_concat_applies(layer)
    finally:
        tnn.set_peft_enabled(True)
    layer.lora_up.bias = torch.nn.Parameter(torch.zeros(20))
    assert not core._lora_concat_applies(layer)
    assert not core._lora_concat_applies(tnn.Linear(4, 4))
