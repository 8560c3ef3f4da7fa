"""The port's LoRA / LoHa layers and PEFT functions against the JAX
package (CPU, fp32).

Key sets and shapes on the tiny SDXL denoiser; per-layer outputs and
gradients against jax.grad on the same numpy weights and inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.sdxl.config import DenoiserConfig as JaxDenoiserConfig
from vision_ft_tpu.models.sdxl.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.modules import peft as jax_peft

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_ft_tpu_torch.models.sdxl.denoiser import Denoiser
from vision_ft_tpu_torch.modules import peft
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU in both packages: the same products summed in other orders
TOL = 1e-5
TINY = dict(
    hidden_dim=32, num_head_channels=8, context_dim=48,
    block_out_channels=[32, 64, 64], num_transformers_per_block=[1, 1, 1],
)
TARGETS = ["attn1", "attn2", ".ff."]


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jnn.flatten_params(tree).items()}


@pytest.mark.parametrize(
    "config",
    [
        dict(type="lora", rank=4, alpha=2.0, dtype="float32"),
        dict(type="lora", rank=4, alpha=2.0, dtype="float32", use_bias=True),
        dict(type="loha", rank=3, alpha=1.5, dtype="float32"),
    ],
    ids=["lora", "lora_bias", "loha"],
)
def test_peft_keys_and_shapes_match_jax_on_the_tiny_denoiser(config):
    kind = config.pop("type")
    jax_config = (jax_peft.LoRAConfig if kind == "lora" else jax_peft.LoHaConfig)(**config)
    port_config = (peft.LoRAConfig if kind == "lora" else peft.LoHaConfig)(**config)
    shapes = jax.eval_shape(JaxDenoiser(JaxDenoiserConfig(**TINY)).init, jax.random.key(0))
    params = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    exclude = ["to_out"]
    jax_params = jax_peft.replace_to_peft_layer(
        params, TARGETS, exclude, jax_config, jax.random.key(1)
    )
    want_all = {k: v.shape for k, v in _flat(jax_params).items()}
    want_adapter = {k: v.shape for k, v in jax_peft.get_adapter_parameters(jax_params).items()}
    want_trainable, want_frozen = (set(_flat(t)) for t in jax_peft.split_peft_params(jax_params))

    denoiser = Denoiser(DenoiserConfig(**TINY)).to_empty(device="cpu")
    assert sorted(peft.find_targetable_paths(denoiser)) == sorted(
        jax_peft.functional.find_targetable_paths(params)
    )
    peft.replace_to_peft_layer(
        denoiser, TARGETS, exclude, port_config, torch.Generator().manual_seed(1)
    )
    assert {k: tuple(v.shape) for k, v in denoiser.state_dict().items()} == want_all
    got_adapter = peft.get_adapter_parameters(denoiser)
    assert {k: tuple(v.shape) for k, v in got_adapter.items()} == want_adapter
    assert all(v.dtype == torch.float32 for v in got_adapter.values())
    trainable, frozen = peft.split_peft_params(denoiser)
    assert set(trainable) == want_trainable and set(frozen) == want_frozen
    assert all(p.requires_grad for p in trainable.values())
    assert not any(t.requires_grad for t in frozen.values())
    assert set(peft.merge_params(frozen, trainable)) == set(want_all)

    stats = peft.calculate_trainable_parameters(denoiser)
    want_stats = jax_peft.calculate_trainable_parameters(jax_params)
    assert stats[:2] == want_stats[:2]
    lines = []
    peft.print_trainable_parameters(denoiser, lines.append)
    assert lines[0].startswith("Trainable params: ")

    # init rules: zero delta, the down / hada draws inside their distributions
    for key, value in got_adapter.items():
        if key.endswith(("lora_up.weight", "lora_up.bias", "hada_w2_a")):
            assert not value.any(), key
        elif key.endswith("lora_down.weight"):
            bound = np.sqrt(6.0 / value.shape[1])
            assert value.abs().max() <= bound and value.std() > 0.3 * bound, key
        elif key.endswith("alpha"):
            assert value.item() == config["alpha"]
    if kind == "loha":
        w1_a = torch.cat([v.flatten() for k, v in got_adapter.items() if k.endswith("hada_w1_a")])
        w1_b = torch.cat([v.flatten() for k, v in got_adapter.items() if k.endswith("hada_w1_b")])
        assert abs(w1_a.std().item() - 0.1) < 0.01 and abs(w1_b.std().item() - 1.0) < 0.1


def test_replace_to_peft_layer_takes_regex_and_warns_on_no_match():
    denoiser = Denoiser(DenoiserConfig(**TINY)).to_empty(device="cpu")
    config = peft.LoRAConfig(rank=2, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    with pytest.warns(UserWarning):
        peft.replace_to_peft_layer(denoiser, ["no_such_layer"], [], config, gen)
    assert not peft.get_adapter_parameters(denoiser)
    target = peft.PeftTargetConfig(
        include_keys=[peft.RegexMatch(regex=r".*attn2\.to_k$")], config=config
    )
    target.replace_to_peft_layer(denoiser, gen)
    roots = {k.rsplit(".lora_down", 1)[0] for k in peft.get_adapter_parameters(denoiser)
             if ".lora_down" in k}
    assert roots and all(r.endswith("attn2.to_k") for r in roots)
    with pytest.raises(ValueError):
        peft.PeftTargetConfig(include_keys=[], config=config)


def _adapter(kind, rng, in_f, out_f, rank=4):
    if kind == "loha":
        return {
            "hada_w1_a": rng.standard_normal((in_f, rank)) * 0.3,
            "hada_w1_b": rng.standard_normal((rank, out_f)),
            "hada_w2_a": rng.standard_normal((in_f, rank)) * 0.3,
            "hada_w2_b": rng.standard_normal((rank, out_f)),
            "alpha": np.asarray(2.0),
        }
    adapter = {
        "lora_down.weight": rng.standard_normal((rank, in_f)) * 0.3,
        "lora_up.weight": rng.standard_normal((out_f, rank)) * 0.3,
        "alpha": np.asarray(2.0),
    }
    if kind == "lora_bias":
        adapter["lora_up.bias"] = rng.standard_normal((out_f,)) * 0.3
    return adapter


def _check_layer(jax_layer, port_layer, flat, x, trained):
    """Output, d(adapter weights) and dx of sum(sin(layer(x))) in both."""
    params = jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})

    def jax_loss(trainable, x):
        merged = jnn.unflatten_params(
            {**{k: jnp.asarray(v) for k, v in flat.items()}, **trainable}
        )
        return jnp.sum(jnp.sin(jax_layer(merged, x)))

    want_out = jax_layer(params, jnp.asarray(x))
    want_grads, want_dx = jax.grad(jax_loss, argnums=(0, 1))(
        {k: jnp.asarray(flat[k]) for k in trained}, jnp.asarray(x)
    )

    tnn.load_flat_params(port_layer, flat)
    trainable, frozen = peft.split_peft_params(port_layer)
    assert sorted(trainable) == sorted(trained)
    tx = torch.from_numpy(x).requires_grad_()
    out = port_layer(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    grads = torch.autograd.grad(out.sin().sum(), [tx, *trainable.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_dx), atol=TOL, rtol=TOL)
    for key, got in zip(trainable, grads[1:]):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want_grads[key]), atol=TOL, rtol=TOL, err_msg=key
        )
    assert all(t.grad is None for t in frozen.values())
    with peft.while_peft_disabled():
        base = port_layer(tx)
    base_flat = {k: v for k, v in flat.items() if k in ("weight", "bias")}
    want_base = jax_layer(jnn.unflatten_params({k: jnp.asarray(v) for k, v in base_flat.items()}),
                          jnp.asarray(x))
    np.testing.assert_allclose(base.detach().numpy(), np.asarray(want_base), atol=TOL, rtol=TOL)
    assert tnn.peft_enabled()


@pytest.mark.parametrize("kind", ["lora", "lora_bias", "loha"])
def test_linear_adapter_output_and_gradients_match_jax(kind):
    rng = np.random.default_rng(3)
    in_f, out_f = 24, 40
    flat = {"weight": rng.standard_normal((out_f, in_f)) * 0.2, "bias": rng.standard_normal(out_f)}
    flat.update(_adapter(kind, rng, in_f, out_f))
    flat = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    trained = [k for k in flat if k not in ("weight", "bias", "alpha")]
    _check_layer(jnn.Linear(in_f, out_f), tnn.Linear(in_f, out_f), flat, _np(4, (2, 7, in_f)), trained)


@pytest.mark.parametrize("how", ["load_state_dict", "in_place", "replace_buffer"])
def test_adapter_scale_follows_the_alpha_buffer(how):
    """The layer reads alpha / rank on the host once; a new alpha, however
    it arrives, must scale the delta of the next call."""
    rng = np.random.default_rng(5)
    in_f, out_f = 8, 12
    flat = {"weight": rng.standard_normal((out_f, in_f)) * 0.2}
    flat.update(_adapter("lora", rng, in_f, out_f))
    layer = tnn.Linear(in_f, out_f, bias=False)
    tnn.load_flat_params(layer, {k: np.asarray(v, np.float32) for k, v in flat.items()})
    x = torch.from_numpy(_np(6, (3, in_f)))
    with peft.while_peft_disabled():
        base = layer(x)
    delta = layer(x) - base  # alpha 2
    if how == "load_state_dict":
        layer.load_state_dict({**layer.state_dict(), "alpha": torch.tensor(6.0)})
    elif how == "in_place":
        layer.alpha.fill_(6.0)
    else:
        layer.alpha = torch.tensor(6.0)
    np.testing.assert_allclose(
        (layer(x) - base).detach().numpy(), 3 * delta.detach().numpy(), atol=TOL, rtol=TOL
    )


@pytest.mark.parametrize("stride,kernel_size,bias", [(1, 3, False), (2, 3, True), (1, 1, False)])
def test_conv_lora_output_and_gradients_match_jax(stride, kernel_size, bias):
    rng = np.random.default_rng(5)
    in_c, out_c, rank, pad = 6, 10, 3, kernel_size // 2
    flat = {
        "weight": rng.standard_normal((out_c, in_c, kernel_size, kernel_size)) * 0.2,
        "bias": rng.standard_normal(out_c),
        "lora_down.weight": rng.standard_normal((rank, in_c, kernel_size, kernel_size)) * 0.3,
        "lora_up.weight": rng.standard_normal((out_c, rank, 1, 1)) * 0.3,
        "alpha": np.asarray(1.5),
    }
    if bias:
        flat["lora_up.bias"] = rng.standard_normal(out_c) * 0.3
    flat = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    trained = [k for k in flat if k.startswith("lora_")]
    _check_layer(
        jnn.Conv2d(in_c, out_c, kernel_size, stride=stride, padding=pad),
        tnn.Conv2d(in_c, out_c, kernel_size, stride=stride, padding=pad),
        flat, _np(6, (2, 9, 8, in_c)), trained,
    )


def test_loha_on_a_conv_falls_back_to_conv_lora():
    conv = tnn.Conv2d(4, 8, 3, padding=1).to_empty(device="cpu")
    holder = torch.nn.ModuleDict({"conv": conv})
    peft.replace_to_peft_layer(
        holder, ["conv"], [], peft.LoHaConfig(rank=2, dtype="float32"), torch.Generator().manual_seed(0)
    )
    assert sorted(peft.get_adapter_parameters(holder)) == [
        "conv.alpha", "conv.lora_down.weight", "conv.lora_up.weight"
    ]


def test_load_peft_weight_attaches_and_rejects():
    denoiser = Denoiser(DenoiserConfig(**TINY)).to_empty(device="cpu")
    root = "middle_block.blocks.1.transformer_blocks.0.attn1.to_q"
    state = {
        f"{root}.lora_down.weight": torch.from_numpy(_np(9, (4, 64))),
        f"{root}.lora_up.weight": torch.from_numpy(_np(10, (64, 4))),
        f"{root}.alpha": torch.tensor(4.0),
    }
    assert peft.detect_peft_method(state) == "lora"
    peft.load_peft_weight(denoiser, state)
    got = peft.get_adapter_parameters(denoiser)
    assert sorted(got) == sorted(state)
    for key, value in state.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    assert peft.detect_peft_method({"x.hada_w1_a": 0}) == "loha"
    with pytest.raises(ValueError):  # no adapter in it at all
        peft.load_peft_weight(denoiser, {f"{root}.weight": torch.zeros(64, 64)})
    with pytest.raises(KeyError):  # an adapter for a layer that is not there
        peft.load_peft_weight(denoiser, {
            "no.such.layer.lora_down.weight": torch.zeros(4, 64),
            "no.such.layer.lora_up.weight": torch.zeros(64, 4),
            "no.such.layer.alpha": torch.tensor(1.0),
        })
    with pytest.raises(KeyError):  # half an adapter
        peft.load_peft_weight(denoiser, {f"{root}.lora_up.weight": torch.zeros(64, 4)})


def test_load_peft_state_carries_the_jax_split_over():
    shapes = jax.eval_shape(JaxDenoiser(JaxDenoiserConfig(**TINY)).init, jax.random.key(0))
    rng = np.random.default_rng(11)
    params = jnn.unflatten_params({
        k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.05)
        for k, v in jnn.flatten_params(shapes).items()
    })
    params = jax_peft.replace_to_peft_layer(
        params, TARGETS, [], jax_peft.LoRAConfig(rank=4, alpha=2.0, dtype="float32"),
        jax.random.key(1),
    )
    trainable, frozen = (_flat(t) for t in jax_peft.split_peft_params(params))
    denoiser = Denoiser(DenoiserConfig(**TINY))
    tnn.load_peft_state(denoiser, trainable, frozen)
    state = denoiser.state_dict(keep_vars=True)
    assert set(state) == set(trainable) | set(frozen)
    for key, value in {**frozen, **trainable}.items():
        np.testing.assert_array_equal(state[key].detach().numpy(), value, err_msg=key)
        assert state[key].requires_grad == (key in trainable), key


def test_unported_peft_and_quant_paths_raise_by_name(monkeypatch):
    layer = tnn.Linear(8, 8)
    # quantized leaves load now; half a quantized weight is still an error by name
    with pytest.raises(KeyError, match="quantized weight"):
        tnn.load_flat_params(layer, {"weight.packed": np.zeros(32, np.uint8)})
    flat = {k: np.asarray(v, np.float32) for k, v in _adapter("lora", np.random.default_rng(0), 8, 8).items()}
    flat.update(weight=np.zeros((8, 8), np.float32), bias=np.zeros(8, np.float32))
    tnn.load_flat_params(layer, flat)
    # VFT_LORA_CONCAT=1 is ported: the folded matmul gives the separate route's output
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32))
    layer.weight.requires_grad_(False)  # the route takes a frozen base
    want = layer(x)
    monkeypatch.setenv("VFT_LORA_CONCAT", "1")
    assert tnn.core._lora_concat_applies(layer)
    torch.testing.assert_close(layer(x), want, rtol=1e-5, atol=1e-6)
