"""The port's 8-bit AdamW, Adafactor, schedule-free SGD and optax.<name>
optimizers against the JAX package's (CPU, fp32, the JAX updates under
``jax.jit``), and their state checkpoints.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_ft_tpu.training import get_optimizer as jax_get_optimizer
from vision_ft_tpu.training import get_schedule as jax_get_schedule
from vision_ft_tpu.training.optimizer import adamw_8bit as jax_adamw_8bit
from vision_ft_tpu.training.optimizer import eval_params as jax_eval_params

from vision_ft_tpu_torch.training import get_optimizer, get_schedule
from vision_ft_tpu_torch.training.optimizer import (
    OPTAX_NAMES,
    AdamW8bit,
    Optimizer,
    eval_params,
)
from vision_ft_tpu_torch.training.state_checkpoint import restore_train_state, save_train_state
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

STEPS = 5


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


# a tensor of 150 values is two whole 64-value blocks and 22 more
SHAPES_8BIT = {"w": (10, 15), "b": (7,), "c": (2, 64)}
# factored: both largest axes >= 128 (the 3-D one over axes 2 and 0);
# unfactored: one axis short, a vector
SHAPES_ADAFACTOR = {"f": (160, 130), "g": (130, 3, 140), "u": (127, 200), "v": (9,)}


def _run_jax(tx, params, grads):
    update = jax.jit(tx.update)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _run_port(optimizer, params, grads, dtype=torch.float32):
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype)) for k, v in params.items()}
    opt_state = optimizer.init(tensors.values())
    for count, g in enumerate(grads):
        optimizer.update_(opt_state, list(tensors.values()),
                          [torch.from_numpy(g[k].copy()).to(dtype) for k in tensors], count)
    return tensors, opt_state


def _assert_params(tensors, jax_params, atol, moved_from=None):
    for key, value in tensors.items():
        np.testing.assert_allclose(value.detach().float().numpy(), np.asarray(jax_params[key]),
                                   atol=atol, rtol=0, err_msg=key)
        if moved_from is not None:
            assert np.abs(value.detach().numpy() - moved_from[key]).max() > 1e-4, key


def test_adamw_8bit_matches_jax_codes_and_scales():
    """5 steps at block_size 64 with a warm-up schedule (the JAX update reads
    it at count + 1): params to 1e-6 (they differ by at most 1.2e-7), scales
    to 1e-6 relative and every int8 code equal. A code could move by one
    where an fp32 ulp of mu-law's log1p / expm1 between XLA and PyTorch
    crosses a .5 rounding boundary; none of the 768 codes here does."""
    params = _tree(0, SHAPES_8BIT)
    grads = [_tree(10 + i, SHAPES_8BIT) for i in range(STEPS)]
    tx = jax_adamw_8bit(jax_get_schedule("linear", 0.01, 8, 2), weight_decay=0.05, block_size=64)
    jax_params, jax_state = _run_jax(tx, params, grads)

    factory = lambda p, lr, args: AdamW8bit(p, lr=lr, weight_decay=0.05, block_size=64)  # noqa: E731
    optimizer = Optimizer("adamw_8bit", get_schedule("linear", 0.01, 8, 2), factory, {})
    tensors, opt_state = _run_port(optimizer, params, grads)
    _assert_params(tensors, jax_params, 1e-6, moved_from=params)
    assert opt_state.count == STEPS == int(jax_state["count"])
    for key, p in tensors.items():
        state = opt_state.state[p]
        for moment in ("mu", "nu"):
            want = jax_state[moment][key]
            q, scale = state[f"{moment}_q"], state[f"{moment}_scale"]
            assert q.dtype == torch.int8 and scale.dtype == torch.float32
            assert q.shape == want["q"].shape == (-(-p.numel() // 64), 64)
            np.testing.assert_allclose(scale.numpy(), np.asarray(want["scale"]), rtol=1e-6)
            np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]), err_msg=key)


@pytest.mark.parametrize("name", ["bitsandbytes.optim.AdamW8bit", "bitsandbytes.optim.Adam8bit"])
def test_8bit_names_match_jax(name):
    """The registry's names at the default block of 2048 (each tensor one
    padded block), with clipping: params to 1e-6."""
    params = _tree(1, SHAPES_8BIT)
    grads = [_tree(20 + i, SHAPES_8BIT) for i in range(STEPS)]
    args = {"betas": [0.8, 0.95], "weight_decay": 0.1}
    jax_params, _ = _run_jax(
        jax_get_optimizer(name, jax_get_schedule("cosine", 0.01, 8, 1),
                          {**args, "betas": tuple(args["betas"])}, max_grad_norm=2.0),
        params, grads)
    tensors, opt_state = _run_port(
        get_optimizer(name, get_schedule("cosine", 0.01, 8, 1), args, max_grad_norm=2.0),
        params, grads)
    _assert_params(tensors, jax_params, 1e-6, moved_from=params)
    want_decay = 0.0 if name.endswith("Adam8bit") else 0.1
    assert opt_state.param_groups[0]["weight_decay"] == want_decay


@pytest.mark.parametrize("name", ["torch.optim.Adafactor", "adafactor"])
def test_adafactor_matches_optax(name):
    """optax.adafactor's defaults (the config's args ignored in both
    packages), factored and unfactored moments, 5 steps: atol 1e-6 on
    parameters of unit scale (each update is lr x the parameter's RMS)."""
    params = _tree(2, SHAPES_ADAFACTOR)
    grads = [_tree(30 + i, SHAPES_ADAFACTOR) for i in range(STEPS)]
    args = {"betas": [0.5, 0.5]}  # ignored
    jax_params, _ = _run_jax(jax_get_optimizer(name, jax_get_schedule("linear", 0.02, 8, 2), args),
                             params, grads)
    tensors, opt_state = _run_port(get_optimizer(name, get_schedule("linear", 0.02, 8, 2), args),
                                   params, grads)
    _assert_params(tensors, jax_params, 1e-6, moved_from=params)
    kinds = {k: sorted(opt_state.state[p]) for k, p in tensors.items()}
    assert kinds == {"f": ["v_col", "v_row"], "g": ["v_col", "v_row"], "u": ["v"], "v": ["v"]}
    assert tuple(opt_state.state[tensors["g"]]["v_row"].shape) == (130, 3)  # less axis 2


def test_schedule_free_sgd_and_eval_params():
    """optax.contrib.schedule_free_sgd at lr(0), b1 0.9: the trained y and
    the averaged x that ``eval_params`` returns, 5 steps, atol 1e-6."""
    name = "schedulefree.SGDScheduleFree"
    params = _tree(3, SHAPES_8BIT)
    grads = [_tree(40 + i, SHAPES_8BIT) for i in range(STEPS)]
    jax_params, jax_state = _run_jax(
        jax_get_optimizer(name, jax_get_schedule("constant", 0.05), {}), params, grads)
    jax_x = jax_eval_params(name, jax_state, jax_params)
    tensors, opt_state = _run_port(get_optimizer(name, get_schedule("constant", 0.05), {}),
                                   params, grads)
    _assert_params(tensors, jax_params, 1e-6, moved_from=params)
    x = eval_params(name, opt_state, tensors)
    _assert_params(x, jax_x, 1e-6)
    assert not torch.equal(x["w"], tensors["w"].detach())


OPTAX_CASES = [
    ("optax.adamw", {}),
    ("optax.adamw", {"b1": 0.8, "weight_decay": 0.1, "eps": 1e-6}),
    ("optax.adam", {"b2": 0.99}),
    ("optax.sgd", {"momentum": 0.9, "nesterov": True}),
    ("optax.rmsprop", {}),
    ("optax.rmsprop", {"decay": 0.95, "momentum": 0.5}),
    ("optax.adafactor", {"decay_rate": 0.7, "momentum": 0.9, "weight_decay_rate": 1e-2}),
    ("optax.lion", {}),
]


@pytest.mark.parametrize("name,args", OPTAX_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTAX_CASES)])
def test_optax_names_match_optax(name, args):
    """optax.<name> with optax's keyword names and defaults (optax.adamw's
    weight decay 1e-4, optax.lion's 1e-3 and b2 0.99, optax.rmsprop's decay
    0.9): 5 steps with a warm-up schedule, atol 1e-6 (Lion's sign steps are
    exact multiples of the rate)."""
    shapes = SHAPES_ADAFACTOR if "adafactor" in name else SHAPES_8BIT
    params = _tree(4, shapes)
    grads = [_tree(50 + i, shapes) for i in range(STEPS)]
    jax_params, _ = _run_jax(jax_get_optimizer(name, jax_get_schedule("linear", 0.01, 8, 2), args),
                             params, grads)
    tensors, _ = _run_port(get_optimizer(name, get_schedule("linear", 0.01, 8, 2), args),
                           params, grads)
    _assert_params(tensors, jax_params, 1e-6, moved_from=params)
    assert name in OPTAX_NAMES


def test_unknown_optax_name_and_keyword_raise():
    with pytest.raises(ValueError) as error:
        get_optimizer("optax.noisy_sgd", 1e-3)
    for listed in OPTAX_NAMES:
        assert listed in str(error.value)
    p = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(TypeError, match="mu_dtype"):
        get_optimizer("optax.adamw", 1e-3, {"mu_dtype": "bfloat16"}).init([p])


RESUME_CASES = ["bitsandbytes.optim.AdamW8bit", "torch.optim.Adafactor", "schedulefree.SGDScheduleFree"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", RESUME_CASES)
def test_state_checkpoint_resumes_bit_for_bit(tmp_path, name, dtype):
    """3 steps, a state checkpoint, a fresh optimizer restored from it and 2
    more steps equal 5 unbroken steps bit for bit, parameters and state:
    the 8-bit codes stay int8 and its scales fp32 beside bf16 parameters."""
    shapes = SHAPES_ADAFACTOR if "Adafactor" in name else SHAPES_8BIT
    params = _tree(5, shapes)
    grads = [_tree(60 + i, shapes) for i in range(STEPS)]
    schedule = get_schedule("linear", 0.01, 8, 2)
    optimizer = get_optimizer(name, schedule, {})
    whole, whole_state = _run_port(optimizer, params, grads, dtype)

    tensors, opt_state = _run_port(optimizer, params, grads[:3], dtype)
    save_train_state(str(tmp_path), 3, tensors, {"optimizer": opt_state.state_dict(), "updates": 3})
    step, trainable, saved = restore_train_state(str(tmp_path))
    assert step == 3
    resumed = {k: torch.nn.Parameter(v.clone()) for k, v in trainable.items()}
    resumed_state = optimizer.init(resumed.values())
    resumed_state.load_state_dict(saved["optimizer"])
    for count, g in enumerate(grads[3:], start=saved["updates"]):
        optimizer.update_(resumed_state, list(resumed.values()),
                          [torch.from_numpy(g[k].copy()).to(dtype) for k in resumed], count)
    for key in whole:
        assert torch.equal(resumed[key], whole[key]), key
        want, got = whole_state.state[whole[key]], resumed_state.state[resumed[key]]
        assert sorted(want) == sorted(got)
        for part in want:
            assert got[part].dtype == want[part].dtype and torch.equal(got[part], want[part]), part
