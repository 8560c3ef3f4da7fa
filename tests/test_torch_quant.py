"""The port's quantization modules and quantized ``Linear`` against the JAX
package (CPU, fp32).

Weights and inputs are made with numpy from a seed and handed to both
packages. The JAX package's quantized trees, flattened, load into the
port's modules through ``load_flat_params``; both then compute the same
function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.modules import peft as jax_peft
from vision_ft_tpu.modules import quant as jax_quant

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.modules import peft, quant
from vision_ft_tpu_torch.nn.core import _w8a8_linear
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

QUANT_TYPES = ["fp8_e4m3fn", "bnb_int8", "bnb_fp4", "bnb_nf4", "quanto_int4", "quanto_int8",
               "ao_nf4", "ao_fp8", "int8_w8a8"]
# fp32 on the CPU in both packages: the same products summed in other orders
TOL = 1e-5
LEAF_DTYPES = {
    "packed": torch.uint8, "split": torch.uint8, "_meta": torch.uint8, "absmax": torch.float32,
    "code": torch.float32, "scale": torch.float32, "SCB": torch.float32, "shift": torch.float32,
    "w8a8": torch.int8,
}


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bits(value):
    """numpy array of a leaf (torch or jax), fp8 as its bytes."""
    if isinstance(value, torch.Tensor):
        return (value.view(torch.uint8) if value.dtype in tnn.core.FP8_DTYPES else value).numpy()
    arr = np.asarray(value)
    return arr.view(np.uint8) if arr.dtype.name.startswith("float8") else arr


def _flat(tree):
    return {k: np.asarray(v) for k, v in jnn.flatten_params(tree).items()}


def _fc(in_f=32, out_f=16, bias=True):
    """A port module with one Linear under the key ``fc``, on the CPU."""
    return nn.ModuleDict({"fc": tnn.Linear(in_f, out_f, bias=bias)}).to_empty(device="cpu")


def _jax_fc_params(in_f=32, out_f=16, seed=3):
    return {"fc": {"weight": jnp.asarray(_np(seed, (out_f, in_f), 0.1)),
                   "bias": jnp.asarray(_np(seed + 1, (out_f,), 0.1))}}


def test_validate_quant_type_and_exports():
    for quant_type in QUANT_TYPES:
        quant.validate_quant_type(quant_type)
    with pytest.raises(ValueError, match="Unknown quant_type"):
        quant.validate_quant_type("int3")
    assert set(quant.__all__) == set(jax_quant.__all__)
    assert quant.replace_to_quant_linear is quant.quantize_params is quant.quantize_inplace
    assert quant.replace_by_prequantized_weights is quant.convert_prequantized_state_dict


@pytest.mark.parametrize("shape", [(16, 64), (10, 6)], ids=str)
@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_quantize_weight_leaves_equal_jax(quant_type, shape):
    w = _np(0, shape, 0.05)
    want = jax_quant.quantize_weight(w, quant_type)
    got = quant.quantize_weight(torch.from_numpy(w), quant_type)
    assert quant.is_quantized_weight(got) and jax_quant.is_quantized_weight(want)
    assert not quant.is_quantized_weight(torch.from_numpy(w))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for name, leaf in want.items():
            assert _bits(got[name]).dtype == _bits(leaf).dtype, name
            np.testing.assert_array_equal(_bits(got[name]), _bits(leaf), err_msg=name)
    else:
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for dtype in ("float32", "bfloat16"):
        back = quant.dequantize_weight(got, getattr(torch, dtype), shape=shape)
        want_back = jax_quant.dequantize_weight(want, getattr(jnp, dtype), shape=shape)
        np.testing.assert_array_equal(back.float().numpy(), np.asarray(want_back, np.float32))
    if isinstance(want, dict) and "packed" in want:  # the shape read from _meta
        np.testing.assert_array_equal(
            quant.dequantize_weight(got).numpy(), np.asarray(jax_quant.dequantize_weight(want))
        )


def test_quanto_int4_grouped_layout_and_unknown_layouts():
    out_f, in_f, gs = 8, 64, 16
    g = _np(11, (out_f, in_f)).reshape(-1, gs)
    rmin, rmax = g.min(1, keepdims=True), g.max(1, keepdims=True)
    scale = np.maximum((rmax - rmin) / 15.0, 1e-12).astype(np.float32)
    shift = (-rmin).astype(np.float32)
    q = np.round((g + shift) / scale).clip(0, 15).astype(np.uint8)
    half = q.shape[0] // 2
    sub = {"data": (q[:half] | (q[half:] << 4)).astype(np.uint8), "scale": scale, "shift": shift}
    want = jax_quant.dequantize_weight({k: jnp.asarray(v) for k, v in sub.items()}, jnp.float32, (out_f, in_f))
    leaves = {k: torch.from_numpy(v) for k, v in sub.items()}
    got = quant.dequantize_weight(leaves, torch.float32, shape=(out_f, in_f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="unsupported QBitsTensor"):
        quant.dequantize_weight(leaves, torch.float32, shape=(out_f, in_f + 2))
    with pytest.raises(ValueError, match="Unknown quantized weight layout"):
        quant.dequantize_weight({"bits": leaves["data"]})
    with pytest.raises(ValueError, match="even out_features"):
        quant.quantize_weight(torch.zeros(3, 4), "quanto_int4")


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_linear_matches_jax_on_the_same_quantized_tree(quant_type):
    """The JAX package's quantized tree, flattened, loads into the port's
    Linear (strict, every leaf in its own dtype), and both layers give the
    same output for fp32 inputs."""
    params = _jax_fc_params()
    qparams = jax_quant.quantize_params(params, quant_type, include_keys=["fc"])
    flat = _flat(qparams)
    module = tnn.load_flat_params(_fc(), flat)
    state = module.state_dict()
    assert set(state) == set(flat)
    for key, value in state.items():
        leaf = key.rsplit(".", 1)[-1]
        if key == "fc.weight":
            assert value.dtype == torch.float8_e4m3fn
        elif leaf == "data":
            assert value.dtype == (torch.uint8 if quant_type == "quanto_int4" else torch.int8)
        elif leaf != "bias":
            assert value.dtype == LEAF_DTYPES[leaf], key
        np.testing.assert_array_equal(_bits(value), _bits(flat[key]), err_msg=key)
    assert module["fc"].is_quantized
    x = _np(5, (2, 3, 32))
    want = jnn.Linear(32, 16)(qparams["fc"], jnp.asarray(x))
    with torch.no_grad():
        got = module["fc"](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # casting the module leaves every quantized leaf as it is
    module.to(torch.bfloat16)
    for key, value in module.state_dict().items():
        if key != "fc.bias":
            assert value.dtype == state[key].dtype, key
            np.testing.assert_array_equal(_bits(value), _bits(state[key]), err_msg=key)
    assert module["fc"].bias.dtype == torch.bfloat16


def test_w8a8_int32_product_is_exact():
    rng = np.random.default_rng(4)
    x = _np(6, (5, 7, 64), 3.0)
    data = rng.integers(-127, 128, (48, 64), dtype=np.int8)
    scale = (rng.random((48, 1)) + 0.5).astype(np.float32)
    x_scale = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    x_q = np.clip(np.round(x / x_scale), -127, 127).astype(np.int32)
    product = x_q @ data.astype(np.int32).T
    want = product.astype(np.float32) * (x_scale * scale[:, 0])
    got = _w8a8_linear(torch.from_numpy(x), torch.from_numpy(data), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    params = {"weight": {"data": jnp.asarray(data), "scale": jnp.asarray(scale),
                         "w8a8": jnp.ones((), jnp.int8)}}
    want_jax = jnn.Linear(64, 48, bias=False)(params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-6, atol=0)
    bf16 = _w8a8_linear(torch.from_numpy(x).bfloat16(), torch.from_numpy(data), torch.from_numpy(scale))
    assert bf16.dtype == torch.bfloat16 and not bf16.requires_grad


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_quantize_params_in_place_equals_jax(quant_type):
    """The port's own quantizer on a module: the same keys and the same
    bits as the JAX package's tree transformation."""
    params = {**_jax_fc_params(), "other": {"weight": jnp.asarray(_np(9, (8, 32)))}}
    want = _flat(jax_quant.quantize_params(params, quant_type, ["fc", "other"], ["other"]))
    module = nn.ModuleDict({"fc": tnn.Linear(32, 16), "other": tnn.Linear(32, 8, bias=False)})
    tnn.load_flat_params(module.to_empty(device="cpu"), _flat(params))
    assert quant.quantize_params(module, quant_type, ["fc", "other"], ["other"]) is module
    state = module.state_dict()
    assert set(state) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(_bits(state[key]), _bits(value), err_msg=key)
    assert module["fc"].is_quantized and not module["other"].is_quantized
    assert not any(p.requires_grad for n, p in module.named_parameters() if n == "fc.weight")
    # again: a quantized layer is left as it is; init leaves it alone too
    quant.quantize_params(module, quant_type, ["fc"])
    tnn.init_parameters_(module, torch.Generator().manual_seed(0))
    after = module.state_dict()
    for key, value in want.items():
        if key.startswith("fc.weight"):
            np.testing.assert_array_equal(_bits(after[key]), _bits(value), err_msg=key)
    assert not np.array_equal(after["fc.bias"].numpy(), want["fc.bias"])
    with pytest.raises(ValueError, match="meta"):
        with torch.device("meta"):
            on_meta = nn.ModuleDict({"fc": tnn.Linear(32, 16)})
        quant.quantize_params(on_meta, quant_type, ["fc"])


@pytest.mark.parametrize("quant_type", ["bnb_nf4", "bnb_fp4", "int8_w8a8", "quanto_int4", "fp8_e4m3fn"])
def test_state_dict_quantizer_and_converter_equal_jax(quant_type):
    """quantize_state_dict -> convert_prequantized_state_dict, key for key
    and tensor for tensor; the converted dictionary loads into a module."""
    sd = {"layer.weight": _np(2, (32, 64), 0.05), "layer.bias": _np(3, (32,)),
          "conv.weight": _np(4, (4, 4, 3, 3))}
    include = ["layer.weight", "conv"] if quant_type != "fp8_e4m3fn" else ["layer.weight"]
    want_q = jax_quant.quantize_state_dict({k: jnp.asarray(v) for k, v in sd.items()}, quant_type, include)
    got_q = quant.quantize_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, quant_type, include)
    assert list(got_q) == list(want_q)
    for key, value in want_q.items():
        assert _bits(got_q[key]).dtype == _bits(value).dtype, key
        np.testing.assert_array_equal(_bits(got_q[key]), _bits(value), err_msg=key)
    children = quant.collect_children_dict("layer.weight.", got_q)
    if quant_type != "fp8_e4m3fn":
        assert quant.get_quant_type_from_children_dict(children) == quant_type
        assert list(children) == list(jax_quant.collect_children_dict("layer.weight.", want_q))
    want_c = jax_quant.convert_prequantized_state_dict(want_q)
    got_c = quant.convert_prequantized_state_dict(got_q)
    assert set(got_c) == set(want_c)
    for key, value in want_c.items():
        if key.endswith("absmax"):  # un-double-quantized: multiply and add, one ulp
            np.testing.assert_allclose(_bits(got_c[key]), _bits(value), rtol=2e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(_bits(got_c[key]), _bits(value), err_msg=key)
    layer = tnn.load_flat_params(
        nn.ModuleDict({"layer": tnn.Linear(64, 32)}).to_empty(device="cpu"),
        {k: v for k, v in got_c.items() if k.startswith("layer.")},
    )["layer"]
    x = _np(6, (4, 64))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    dense = x @ sd["layer.weight"].T + sd["layer.bias"]
    assert np.abs(got.numpy() - dense).max() < 0.25 * np.abs(dense).max()
    with pytest.raises(ValueError, match="quant_type not found"):
        quant.get_quant_type_from_children_dict({"bias": torch.zeros(1)})


def test_state_dict_quantizer_rejects_runtime_only_types():
    for quant_type in ("bnb_int8", "quanto_int8", "ao_nf4"):
        with pytest.raises(NotImplementedError, match="offline"):
            quant.quantize_state_dict({"a.weight": torch.zeros(2, 64)}, quant_type, ["a"])
    plain = {"a.weight": torch.zeros(2, 64)}
    assert quant.convert_prequantized_state_dict(plain) == plain


def test_load_flat_params_stays_strict_on_quantized_keys():
    qparams = jax_quant.quantize_params(_jax_fc_params(), "bnb_nf4", include_keys=["fc"])
    flat = _flat(qparams)
    with pytest.raises(KeyError, match="missing"):
        tnn.load_flat_params(_fc(), {k: v for k, v in flat.items() if not k.endswith("absmax")})
    with pytest.raises(KeyError, match="unexpected"):
        tnn.load_flat_params(_fc(), {**flat, "fc.weight.scale": np.ones((16, 1), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        tnn.load_flat_params(_fc(in_f=64), flat)
    with pytest.raises(KeyError, match="no Linear"):
        tnn.load_flat_params(_fc(), {k.replace("fc.", "norm."): v for k, v in flat.items()})
    w8a8 = _flat(jax_quant.quantize_params(_jax_fc_params(), "int8_w8a8", include_keys=["fc"]))
    with pytest.raises(ValueError, match="shape"):
        tnn.load_flat_params(_fc(out_f=8), w8a8)
    # a module that is quantized already takes new leaves of the same kind
    module = tnn.load_flat_params(_fc(), flat)
    other = _flat(jax_quant.quantize_params(_jax_fc_params(seed=8), "bnb_nf4", include_keys=["fc"]))
    tnn.load_flat_params(module, other)
    np.testing.assert_array_equal(module.state_dict()["fc.weight.packed"].numpy(), other["fc.weight.packed"])


def test_qlora_on_a_quantized_base_matches_jax():
    """Adapters on a quantized base: zero initial delta, only the adapter
    weights trainable, gradients equal to jax.grad's."""
    model = jnn.ModuleDict({"attn": jnn.ModuleDict({"to_q": jnn.Linear(32, 32)})})
    params = {"attn": {"to_q": {"weight": jnp.asarray(_np(1, (32, 32), 0.2)),
                                "bias": jnp.asarray(_np(2, (32,), 0.1))}}}
    qparams = jax_quant.quantize_params(params, "bnb_nf4", include_keys=["to_q"])
    jax_lora = jax_peft.replace_to_peft_layer(
        qparams, ["to_q"], [], jax_peft.LoRAConfig(rank=4, dtype="float32"), jax.random.PRNGKey(1)
    )
    flat = _flat(jax_lora)
    x = _np(0, (2, 32))

    port = nn.ModuleDict({"attn": nn.ModuleDict({"to_q": tnn.Linear(32, 32)})}).to_empty(device="cpu")
    tnn.load_flat_params(port, _flat(qparams))
    assert peft.find_targetable_paths(port) == ["attn.to_q"]
    peft.replace_to_peft_layer(
        port, ["to_q"], [], peft.LoRAConfig(rank=4, dtype="float32"), torch.Generator().manual_seed(1)
    )
    layer = port["attn"]["to_q"]
    with torch.no_grad():
        base_out = layer(torch.from_numpy(x))
        with peft.while_peft_disabled():
            torch.testing.assert_close(layer(torch.from_numpy(x)), base_out, rtol=0, atol=0)
    want_base = model["attn"]["to_q"](qparams["attn"]["to_q"], jnp.asarray(x))
    np.testing.assert_allclose(base_out.numpy(), np.asarray(want_base), atol=TOL)
    trainable, frozen = peft.split_peft_params(port)
    assert set(trainable) == {"attn.to_q.lora_down.weight", "attn.to_q.lora_up.weight"}
    assert set(trainable) | set(frozen) == set(flat)
    assert not any(t.requires_grad for t in frozen.values())
    assert all(not isinstance(v, nn.Parameter) for k, v in frozen.items() if ".weight." in k)

    # the same adapters on both sides, lora_up non-zero
    flat["attn.to_q.lora_up.weight"] = _np(7, (32, 4), 0.1)
    tnn.load_flat_params(port, flat)
    jax_trainable, jax_frozen = jax_peft.split_peft_params(
        jnn.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    )

    def loss(tr):
        merged = jax_peft.merge_params(jax_frozen, tr)
        return jnp.sum(model["attn"]["to_q"](merged["attn"]["to_q"], jnp.asarray(x)) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss)(jax_trainable)
    trainable, _ = peft.split_peft_params(port)
    got_loss = (layer(torch.from_numpy(x)) ** 2).sum()
    grads = torch.autograd.grad(got_loss, list(trainable.values()))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    for key, grad in zip(trainable, grads):
        want = _flat(want_grads)[key]
        assert torch.isfinite(grad).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("route", ["fused", "stream", "dequant"])
@pytest.mark.parametrize("needs_grad", [False, True], ids=["no_grad", "grad"])
def test_nf4_routes_agree_through_a_linear(route, needs_grad):
    """A packed 4-bit Linear at a width all three routes take: every route
    gives the JAX Linear's output and, for an input that needs a gradient,
    the gradient of the plain dequantize-then-matmul."""
    in_f, out_f = 256, 384
    params = {"fc": {"weight": jnp.asarray(_np(3, (out_f, in_f), 0.05)),
                     "bias": jnp.asarray(_np(4, (out_f,), 0.1))}}
    qparams = jax_quant.quantize_params(params, "bnb_nf4", include_keys=["fc"])
    layer = tnn.load_flat_params(_fc(in_f, out_f), _flat(qparams))["fc"]
    x = _np(5, (2, 5, in_f))
    want = jnn.Linear(in_f, out_f)(qparams["fc"], jnp.asarray(x))
    w = jax_quant.dequantize_weight(qparams["fc"]["weight"], jnp.float32, (out_f, in_f))
    want_dx = np.ones((2, 5, out_f), np.float32) @ np.asarray(w)
    tx = torch.from_numpy(x).requires_grad_(needs_grad)
    assert tnn.nf4_route() == "fused"
    tnn.set_nf4_route(route)
    try:
        got = layer(tx)
        dx = torch.autograd.grad(got.sum(), tx)[0] if needs_grad else None
    finally:
        tnn.set_nf4_route("fused")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    if needs_grad:
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="unknown nf4 route"):
        tnn.set_nf4_route("xla")


def test_dequant_route_keeps_no_dense_weight_for_the_backward():
    """The plain route saves the packed leaves: between forward and backward
    the graph holds no tensor of the dense weight's size."""
    in_f, out_f = 128, 256
    layer = tnn.Linear(in_f, out_f, bias=False)
    layer.set_quantized_weight(quant.quantize_weight(torch.from_numpy(_np(1, (out_f, in_f), 0.05)), "bnb_nf4"))
    x = torch.from_numpy(_np(2, (4, in_f))).requires_grad_()
    saved = []
    tnn.set_nf4_route("dequant")
    try:
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t, lambda t: t):
            y = layer(x)
    finally:
        tnn.set_nf4_route("fused")
    assert all(int(np.prod(shape)) < in_f * out_f for shape in saved), saved
    dx, = torch.autograd.grad(y.sum(), x)
    want = quant.dequantize_weight(layer.weight, torch.float32, (out_f, in_f)).sum(0)
    torch.testing.assert_close(dx, want.expand(4, in_f), rtol=1e-5, atol=1e-6)
