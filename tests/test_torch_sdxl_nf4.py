"""The port's SDXL slice with an NF4 base against the JAX package (CPU,
fp32): where a model's weights land and what a cast leaves alone, the
quantized UNet's forward, and NF4 LoRA train steps on every route.

The train steps use a denoiser wide enough (128 channels) for the fused
and the stream routes to take its attention and feed-forward layers; on
the CPU the fused route's wrappers take their plain versions. The JAX side
dequantizes into its matmuls, its path on a CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sdxl_train as train_helpers
import vision_ft_tpu.nn as jnn
from test_torch_sdxl import _random_params, _tiny_kwargs
from vision_ft_tpu.models.sdxl.denoiser import Denoiser as JaxDenoiser
from vision_ft_tpu.modules import quant as jax_quant

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.modules import peft, quant
from vision_ft_tpu_torch.ops import nf4_matmul, nf4_stream
from vision_ft_tpu_torch.training import get_optimizer, get_schedule, init_train_state, make_train_step
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

TARGETS = ["attn1", "attn2", ".ff."]
WIDE = dict(
    hidden_dim=128, num_head_channels=32, context_dim=128,
    block_out_channels=[128, 128, 128], num_transformers_per_block=[1, 1, 1],
)
QUANT_LEAF_DTYPES = {"packed": torch.uint8, "split": torch.uint8, "_meta": torch.uint8,
                     "absmax": torch.float32, "code": torch.float32}


def _flat(tree):
    return {k: np.asarray(v) for k, v in jnn.flatten_params(tree).items()}


def _tiny_flat(quantized: bool):
    """Flat numpy weights of the tiny SDXL model, the denoiser's attention
    and feed-forward Linears NF4-quantized by the JAX package on request."""
    config, kwargs = _tiny_kwargs("jax")
    from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel

    jax_model = JaxSDXLModel(config, **kwargs)
    flat = _random_params(
        jax.eval_shape(
            lambda key: {
                "denoiser": jax_model.denoiser.init(key),
                "vae": jax_model.vae.init(key),
                "text_encoder": jax_model.text_encoder.init(key),
            },
            jax.random.key(0),
        ),
        seed=0,
    )
    if quantized:
        tree = jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
        tree["denoiser"] = jax_quant.quantize_params(tree["denoiser"], "bnb_nf4", TARGETS)
        flat = _flat(tree)
    return jax_model, flat


def _quant_leaves(module):
    return {k: v for k, v in module.state_dict().items() if ".weight." in k and "lora" not in k}


@pytest.mark.parametrize("device", [None, "cpu"], ids=["default", "cpu"])
def test_load_state_dict_lands_on_the_card_unless_told(monkeypatch, device):
    """Without a device the target is the card: here, where there is none,
    the move raises; with the moves recorded instead of made, the device
    asked for is ``cuda``. ``device="cpu"`` stays on the CPU."""
    _, flat = _tiny_flat(quantized=False)
    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config, **kwargs)
    if device == "cpu":
        model.load_state_dict(flat, device="cpu")
        assert model.device == torch.device("cpu")
        return
    assert not torch.cuda.is_available()
    with pytest.raises((RuntimeError, AssertionError)):
        model.load_state_dict(flat)
    moves = []
    monkeypatch.setattr(
        torch.nn.Module, "to", lambda self, *args, **kw: moves.append((args, kw)) or self
    )
    SDXLModel(config, **kwargs).load_state_dict(flat)
    targets = [args[0] for args, _ in moves if args]
    assert targets == [torch.device("cuda")] * 3


def test_quantized_leaves_keep_their_dtypes_and_bits_in_a_bf16_model():
    """A bf16 model with an NF4 denoiser: ``load_state_dict`` of the JAX
    package's quantized tree, ``init_params`` over the loaded model and a
    cast of a part leave every quantized leaf in its own dtype with its
    own bits, while the dense weights take the model's dtype."""
    _, flat = _tiny_flat(quantized=True)
    config, kwargs = _tiny_kwargs("torch")
    config.dtype = "bfloat16"
    model = SDXLModel(config, **kwargs)
    model.load_state_dict(flat, device="cpu")
    leaves = _quant_leaves(model.denoiser)
    assert len(leaves) >= 5 * 30 and model.device == torch.device("cpu")

    def check(what):
        state = model.denoiser.state_dict()
        for key, value in leaves.items():
            assert state[key].dtype == QUANT_LEAF_DTYPES[key.rsplit(".", 1)[-1]], (what, key)
            np.testing.assert_array_equal(state[key].numpy(), flat["denoiser." + key], err_msg=what)
        dense = [v for k, v in state.items() if k not in leaves]
        assert all(v.dtype == torch.bfloat16 for v in dense), what

    check("load_state_dict")
    dense_key = next(k for k, v in model.denoiser.state_dict().items() if v.ndim == 4)
    dense_before = model.denoiser.state_dict()[dense_key].clone()
    model.init_params(torch.Generator().manual_seed(3))
    check("init_params")
    assert not torch.equal(model.denoiser.state_dict()[dense_key], dense_before)
    model.denoiser.to(torch.float16).to(torch.bfloat16)
    check("to(dtype)")
    # adapters land beside the quantized base; the split leaves it frozen
    peft.replace_to_peft_layer(
        model.denoiser, TARGETS, [], peft.LoRAConfig(rank=2, dtype="bfloat16"),
        torch.Generator().manual_seed(1),
    )
    trainable, frozen = peft.split_peft_params(model.denoiser)
    assert set(leaves) <= set(frozen) and all("lora_" in k for k in trainable)
    assert len(trainable) == 2 * len([k for k in leaves if k.endswith("packed")])


def test_quantized_unet_forward_matches_jax():
    jax_model, flat = _tiny_flat(quantized=True)
    config, kwargs = _tiny_kwargs("torch")
    port = SDXLModel(config, **kwargs)
    port.load_state_dict(flat, device="cpu")
    params = jnn.unflatten_params(
        {k[len("denoiser."):]: jnp.asarray(v) for k, v in flat.items() if k.startswith("denoiser.")}
    )
    rng = np.random.default_rng(0)
    args = (
        rng.standard_normal((2, 16, 24, 4)).astype(np.float32), np.array([999.0, 251.0], np.float32),
        rng.standard_normal((2, 10, 112)).astype(np.float32),
        rng.standard_normal((2, 1280)).astype(np.float32),
        np.array([[128, 192], [96, 160]], np.float32), np.array([[128, 192], [96, 160]], np.float32),
        np.array([[0, 0], [16, 8]], np.float32),
    )
    want = jax.jit(jax_model.denoiser.__call__)(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port.denoiser(*map(torch.from_numpy, args))
    # fp32 in both packages, sums in other orders through the whole UNet
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def nf4_lora_run():
    """Weights of the wide denoiser with an NF4 base (quantized by the JAX
    package) and rank-4 LoRA, three batches, and the JAX package's three
    train steps on them."""
    saved = train_helpers.TINY
    train_helpers.TINY = WIDE
    try:
        flat = train_helpers._weights()
        base = {k: v for k, v in flat.items() if not tnn.core.is_adapter_key(k)}
        qbase = _flat(jax_quant.quantize_params(
            jnn.unflatten_params({k: jnp.asarray(v) for k, v in base.items()}), "bnb_nf4", TARGETS
        ))
        qflat = {**qbase, **{k: v for k, v in flat.items() if k not in base}}
        batches = train_helpers._batches()
        rng = np.random.default_rng(2)
        for batch in batches:  # the wide denoiser's context width
            batch["cached_context"] = rng.standard_normal((2, 10, 128)).astype(np.float32)
        want_metrics, want_trainable = train_helpers._jax_run(qflat, batches, None)
    finally:
        train_helpers.TINY = saved
    return qflat, batches, want_metrics, want_trainable


@pytest.mark.parametrize("route", ["fused", "stream", "dequant"])
def test_nf4_lora_train_steps_match_jax(monkeypatch, nf4_lora_run, route):
    """Three NF4 LoRA train steps: loss and grad_norm per step rtol 1e-4,
    adapters after step 3 atol 1e-5 (fp32 sums in other orders through a
    whole UNet forward and backward), quantized leaves bit-identical."""
    qflat, batches, want_metrics, want_trainable = nf4_lora_run
    monkeypatch.setattr(train_helpers, "TINY", WIDE)
    model = train_helpers._port_model(qflat)
    model.denoiser.set_gradient_checkpointing(True)
    trainable, frozen = peft.split_peft_params(model.denoiser)
    assert set(trainable) == set(want_trainable)
    packed = [k for k in frozen if k.endswith(".packed")]
    assert len(packed) == len(trainable) // 2 >= 30

    # which route really ran: count the calls of each route's entry point
    calls = {"fused": 0, "stream": 0}
    for name, module, entry in (("fused", nf4_matmul, "nf4_matmul"), ("stream", nf4_stream, "nf4_stream_matmul")):
        original = getattr(module, entry)

        def counted(*args, _name=name, _original=original, **kw):
            calls[_name] += 1
            return _original(*args, **kw)

        monkeypatch.setattr(module, entry, counted)

    optimizer = get_optimizer(
        train_helpers.OPTIMIZER["name"], get_schedule(*train_helpers.OPTIMIZER["schedule"]),
        max_grad_norm=train_helpers.OPTIMIZER["max_grad_norm"],
    )
    state = init_train_state(optimizer, trainable)
    step = make_train_step(train_helpers._supplied_draws_loss(model), optimizer)
    gen = torch.Generator().manual_seed(0)
    tnn.set_nf4_route(route)
    try:
        for batch, (want_loss, want_norm) in zip(batches, want_metrics):
            state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, gen)
            np.testing.assert_allclose(metrics["train/loss"].item(), want_loss, rtol=1e-4)
            np.testing.assert_allclose(metrics["train/grad_norm"].item(), want_norm, rtol=1e-4)
    finally:
        tnn.set_nf4_route("fused")
    # forward and recomputation, three steps, every quantized layer
    want_calls = 2 * 3 * len(packed)
    assert calls == {"fused": want_calls if route == "fused" else 0,
                     "stream": want_calls if route == "stream" else 0}
    for key, value in state.trainable.items():
        np.testing.assert_allclose(
            value.detach().numpy(), want_trainable[key], atol=1e-5, rtol=0, err_msg=key
        )
    for key, value in frozen.items():
        np.testing.assert_array_equal(value.detach().numpy(), qflat[key], err_msg=key)
        assert value.grad is None and not value.requires_grad
    assert quant.is_quantized_weight(model.denoiser.get_submodule(packed[0][: -len(".packed")]))
