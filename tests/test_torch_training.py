"""The port's schedules, optimizers, clipping, losses, timestep samplers
and train step against the JAX package (CPU, fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_ft_tpu.modules.loss import diffusion as jax_diffusion
from vision_ft_tpu.modules.timestep import sampling as jax_sampling
from vision_ft_tpu.training import get_optimizer as jax_get_optimizer
from vision_ft_tpu.training import get_schedule as jax_get_schedule
from vision_ft_tpu.training import make_train_step as jax_make_train_step
from vision_ft_tpu.training.train_step import init_train_state as jax_init_train_state

from vision_ft_tpu_torch.modules.loss import diffusion
from vision_ft_tpu_torch.modules.timestep import sampling
from vision_ft_tpu_torch.training import (
    get_optimizer,
    get_schedule,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from vision_ft_tpu_torch.training.optimizer import eval_params, is_schedule_free
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

SCHEDULES = [
    (None, {}),
    ("constant", {}),
    ("constant_with_warmup", {}),
    ("linear", {}),
    ("cosine", {}),
    ("cosine_with_restarts", {"num_cycles": 3}),
    ("polynomial", {"power": 2.0, "lr_end": 1e-6}),
    ("inverse_sqrt", {}),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[str(n) for n, _ in SCHEDULES])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedules_match_optax(name, args, warmup):
    """Every schedule name at steps 0..N+5; the JAX side computes in fp32,
    the port in Python floats, so rtol 2e-6 (a few fp32 ulps) plus an fp32
    ulp of the base rate, where 1 + cos cancels at the end of a decay."""
    base_lr, total = 3e-4, 40
    want = jax_get_schedule(name, base_lr, total, warmup, args)
    got = get_schedule(name, base_lr, total, warmup, args)
    for step in range(total + 6):
        np.testing.assert_allclose(
            got(step), float(want(step)), rtol=2e-6, atol=base_lr * 1.2e-7, err_msg=f"{name} step {step}"
        )
        assert isinstance(got(step), float)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        get_schedule("no_such_schedule", 1e-3)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a.weight": rng.standard_normal((6, 5)).astype(np.float32),
        "a.bias": rng.standard_normal((6,)).astype(np.float32),
        "b": rng.standard_normal((3, 2, 2)).astype(np.float32),
    }


OPTIMIZERS = [
    ("torch.optim.AdamW", {"weight_decay": 0.1, "betas": [0.8, 0.95]}),
    ("adamw", {}),
    ("torch.optim.Adam", {"eps": 1e-6}),
    ("torch.optim.SGD", {}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("torch.optim.RMSprop", {"alpha": 0.9, "momentum": 0.5}),
    ("torch.optim.RMSprop", {}),
]


@pytest.mark.parametrize("name,args", OPTIMIZERS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTIMIZERS)])
@pytest.mark.parametrize(
    "clip", [{}, {"max_grad_norm": 0.7}, {"max_grad_value": 0.5}, {"max_grad_norm": 0.7, "max_grad_value": 0.5}],
    ids=["noclip", "norm", "value", "both"],
)
def test_optimizers_with_clipping_match_optax(name, args, clip):
    """5 steps on a small tree with a warm-up schedule (read at count 0 for
    the first update), the same gradients on both sides, atol 1e-6 on
    parameters that move by ~1e-2 a step (optax takes Adam's bias
    corrections in fp32, 1 - 0.999**t to ~1e-5 relative; torch in doubles)."""
    steps = 5
    params = _tree(0)
    grads = [_tree(10 + i) for i in range(steps)]
    grads[2] = {k: 0.01 * v for k, v in grads[2].items()}  # one step below the norm limit

    jax_tx = jax_get_optimizer(name, jax_get_schedule("linear", 0.01, 8, 2), args, **clip)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    jax_state = jax_tx.init(jax_params)
    for g in grads:
        updates, jax_state = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()}, jax_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)

    optimizer = get_optimizer(name, get_schedule("linear", 0.01, 8, 2), args, **clip)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt_state = optimizer.init(tensors.values())
    for count, g in enumerate(grads):
        optimizer.update_(
            opt_state, list(tensors.values()), [torch.from_numpy(g[k].copy()) for k in tensors], count
        )
    for key, value in tensors.items():
        np.testing.assert_allclose(
            value.detach().numpy(), np.asarray(jax_params[key]), atol=1e-6, rtol=0, err_msg=key
        )
        assert value.grad is None
    assert np.abs(tensors["b"].detach().numpy() - params["b"]).max() > 1e-3  # it moved


@pytest.mark.parametrize(
    "name",
    ["bitsandbytes.optim.AdamW8bit", "schedulefree.SGDScheduleFree", "torch.optim.Adafactor",
     "optax.lion"],
)
def test_unported_optimizers_raise_by_name(name):
    """The four names that raised before the port took them now resolve,
    and one update moves every parameter (parity with optax:
    tests/test_torch_optimizers_rest.py)."""
    optimizer = get_optimizer(name, 1e-2)
    tensors = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in _tree(0).values()]
    before = [t.detach().clone() for t in tensors]
    opt_state = optimizer.init(tensors)
    optimizer.update_(opt_state, tensors, [torch.from_numpy(v.copy()) for v in _tree(1).values()], 0)
    for b, t in zip(before, tensors):
        assert not torch.equal(b, t.detach()) and torch.isfinite(t).all()


def test_unknown_optimizer_and_schedule_free_helpers():
    with pytest.raises(ValueError):
        get_optimizer("torch.optim.NoSuch", 1e-3)
    assert is_schedule_free("schedulefree.AdamWScheduleFree") and not is_schedule_free("adamw")
    params = object()
    assert eval_params("adamw", None, params) is params
    # schedule-free: before the first update x is y itself (z starts at y)
    p = torch.nn.Parameter(torch.ones(2))
    state = get_optimizer("schedulefree.AdamWScheduleFree", 1e-3).init([p])
    x = eval_params("schedulefree.AdamWScheduleFree", state, {"p": p})["p"]
    assert torch.equal(x, p.detach()) and x is not p


def test_alphas_cumprod_matches_jax():
    """fp32 linspace and a 1000-term cumprod in two libraries: rtol 1e-5."""
    got = diffusion.get_alphas_cumprod()
    want = np.asarray(jax_diffusion.get_alphas_cumprod())
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def _noising_case():
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((3, 6, 5, 4)).astype(np.float32)
    timestep = np.array([0, 417, 999], np.int32)
    noised = jax_diffusion.prepare_noised_latents(
        jax.random.key(1), jnp.asarray(latents), jnp.asarray(timestep), max_sigma=1.0
    )
    return latents, timestep, noised


def test_noising_matches_jax_on_its_own_draw():
    latents, timestep, want = _noising_case()
    noise = torch.from_numpy(np.array(want.random_noise))
    got = diffusion.add_noise(torch.from_numpy(latents), noise, torch.from_numpy(timestep))
    np.testing.assert_allclose(got.noisy_latents.numpy(), np.asarray(want.noisy_latents), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.random_noise, noise, rtol=0, atol=0)


def test_prepare_noised_latents_draws_from_the_generator():
    latents = torch.from_numpy(_noising_case()[0])
    timestep = torch.tensor([0, 417, 999], dtype=torch.int32)
    first = diffusion.prepare_noised_latents(torch.Generator().manual_seed(5), latents, timestep, max_sigma=0.5)
    again = diffusion.prepare_noised_latents(torch.Generator().manual_seed(5), latents, timestep, max_sigma=0.5)
    other = diffusion.prepare_noised_latents(torch.Generator().manual_seed(6), latents, timestep, max_sigma=0.5)
    torch.testing.assert_close(first.noisy_latents, again.noisy_latents, rtol=0, atol=0)
    assert not torch.equal(first.random_noise, other.random_noise)
    assert first.random_noise.shape == latents.shape
    assert 0.4 < first.random_noise.std().item() < 0.6  # unit noise times max_sigma
    rebuilt = diffusion.add_noise(latents, first.random_noise, timestep)
    torch.testing.assert_close(rebuilt.noisy_latents, first.noisy_latents, rtol=0, atol=0)


@pytest.mark.parametrize("gamma", [None, 5.0, 0.5])
def test_losses_match_jax(gamma):
    rng = np.random.default_rng(2)
    noise, pred = (rng.standard_normal((4, 6, 5, 4)).astype(np.float32) for _ in range(2))
    timestep = np.array([3, 250, 600, 990], np.int32)
    t_noise, t_pred = torch.from_numpy(noise), torch.from_numpy(pred)
    if gamma is None:
        want = jax_diffusion.loss_with_predicted_noise(None, jnp.asarray(noise), jnp.asarray(pred))
        got = diffusion.loss_with_predicted_noise(None, t_noise, t_pred)
    else:
        want = jax_diffusion.min_snr_weighted_loss(
            None, jnp.asarray(noise), jnp.asarray(pred), jnp.asarray(timestep), gamma=gamma
        )
        got = diffusion.min_snr_weighted_loss(None, t_noise, t_pred, torch.from_numpy(timestep), gamma=gamma)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


SHAPE = (4096, 64, 48, 4)


def _normal_draws(seed):
    """The port's unit-normal draws for a seed, as numpy, for the JAX transforms."""
    return torch.randn((SHAPE[0],), generator=torch.Generator().manual_seed(seed)).numpy()


@pytest.mark.parametrize(
    "name,kwargs,transform",
    [
        ("sigmoid_randn", {"sigmoid_scale": 1.3}, lambda z: jax.nn.sigmoid(z * 1.3)),
        ("shift_sigmoid_randn", {"discrete_flow_shift": 3.0},
         lambda z: (jax.nn.sigmoid(z) * 3.0) / (1.0 + 2.0 * jax.nn.sigmoid(z))),
        ("flux_shift_randn", {},
         lambda z: jax_sampling.time_shift(
             jax_sampling.get_lin_function(y1=0.5, y2=1.15)(32 * 24), 1.0, jax.nn.sigmoid(z))),
        ("scale_shift_sigmoid_randn", {"std": 0.8, "mean": -0.8},
         lambda z: jax.nn.sigmoid(z * 0.8 - 0.8)),
    ],
)
def test_normal_samplers_apply_the_jax_transforms(name, kwargs, transform):
    got = getattr(sampling, name)(torch.Generator().manual_seed(3), SHAPE, **kwargs)
    want = np.asarray(transform(jnp.asarray(_normal_draws(3))))
    assert got.shape == (SHAPE[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    assert 0.0 < got.min() and got.max() < 1.0
    via_dispatch = {"sigmoid_randn": "sigmoid", "shift_sigmoid_randn": "shift_sigmoid",
                    "flux_shift_randn": "flux_shift", "scale_shift_sigmoid_randn": "scale_shift_sigmoid"}
    again = sampling.sample_timestep(torch.Generator().manual_seed(3), SHAPE, via_dispatch[name], **kwargs)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_uniform_and_fraction_samplers():
    gen = torch.Generator().manual_seed(4)
    u = sampling.uniform_rand(gen, SHAPE)
    assert 0.0 <= u.min() and u.max() < 1.0 and abs(u.mean().item() - 0.5) < 0.03
    torch.testing.assert_close(
        sampling.sample_timestep(torch.Generator().manual_seed(4), SHAPE, "uniform"), u, rtol=0, atol=0
    )
    shifted = sampling.shift_uniform_rand(torch.Generator().manual_seed(4), SHAPE, shift=6.0)
    torch.testing.assert_close(shifted, (u * 6.0) / (1.0 + 5.0 * u))
    fractions = jax_sampling._create_fraction(tuple(range(20, 30)))
    f = sampling.fraction_uniform_rand(gen, SHAPE)
    assert np.isin(f.numpy(), fractions).all() and len(np.unique(f.numpy())) > 100
    sf = sampling.shift_fraction_uniform_rand(gen, SHAPE, shift=2.0, divisible=(4,))
    assert np.isin(sf.numpy(), (fractions4 := np.array([0, .25, .5, .75, 1], np.float32)) * 2 / (1 + fractions4)).all()
    with pytest.raises(ValueError):
        sampling.sample_timestep(gen, SHAPE, "no_such_sampler")


def test_integer_samplers():
    gen = torch.Generator().manual_seed(5)
    t = sampling.uniform_randint(gen, SHAPE, 0, 1000)
    assert t.dtype == torch.int32 and t.shape == (SHAPE[0],)
    assert 0 <= t.min() and t.max() <= 999 and abs(t.float().mean().item() - 499.5) < 20
    t = sampling.uniform_randint(gen, SHAPE, 100, 110)
    assert set(t.tolist()) == set(range(100, 110))
    g = sampling.gaussian_randint(gen, SHAPE, 0, 1000, mean=300, std=50)
    assert g.dtype == torch.int32 and 0 <= g.min() and g.max() <= 1000
    assert abs(g.float().mean().item() - 300) < 5 and abs(g.float().std().item() - 50) < 5
    s = sampling.sigmoid_randint(torch.Generator().manual_seed(6), SHAPE, 0, 1000, sigmoid_scale=1.0)
    want = np.round(np.asarray(jax.nn.sigmoid(jnp.asarray(_normal_draws(6)))) * 1000)
    # round-half-even in both; a draw within 1e-4 of a half may fall either way
    assert s.dtype == torch.int32 and np.abs(s.numpy() - want).max() <= 1
    assert (s.numpy() == want).mean() > 0.999


def _regression_problem():
    rng = np.random.default_rng(0)
    weights = {"w": rng.standard_normal((5, 3)).astype(np.float32),
               "b": rng.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((2, 4, 5)).astype(np.float32),
             "y": rng.standard_normal((2, 4, 3)).astype(np.float32)}
    return weights, batch


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    """3 steps of a small regression, AdamW + clipping; with grad_accum=2
    the JAX scan over two microbatches against the port's loop."""
    weights, batch = _regression_problem()
    if grad_accum == 1:
        batch = {k: v.reshape(8, -1) for k, v in batch.items()}

    def jax_loss(trainable, frozen, batch, key):
        pred = batch["x"] @ trainable["w"] + trainable["b"]
        return jnp.mean(jnp.square(pred - batch["y"])) * frozen["scale"], {}

    tx = jax_get_optimizer("torch.optim.AdamW", jax_get_schedule("linear", 0.05, 10, 1), max_grad_norm=1.0)
    state = jax_init_train_state(tx, {k: jnp.asarray(v) for k, v in weights.items()})
    jax_step = jax_make_train_step(jax_loss, tx, grad_accum=grad_accum, donate=False)
    want = []
    for _ in range(3):
        state, metrics = jax_step(
            state, {"scale": jnp.float32(3.0)}, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0),
        )
        want.append((float(metrics["train/loss"]), float(metrics["train/grad_norm"])))

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in weights.items()}
    draws = []

    def loss_fn(batch, generator):
        draws.append(torch.rand((), generator=generator).item())
        pred = batch["x"] @ params["w"] + params["b"]
        return torch.mean(torch.square(pred - batch["y"])) * 3.0, {"extra": 1}

    optimizer = get_optimizer("torch.optim.AdamW", get_schedule("linear", 0.05, 10, 1), max_grad_norm=1.0)
    train_state = init_train_state(optimizer, params)
    step = make_train_step(loss_fn, optimizer, grad_accum=grad_accum)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        train_state, metrics = step(train_state, t_batch, gen)
        assert train_state.step == i + 1
        np.testing.assert_allclose(metrics["train/loss"].item(), want[i][0], rtol=1e-5)
        np.testing.assert_allclose(metrics["train/grad_norm"].item(), want[i][1], rtol=1e-5)
        assert want[i][1] > 1.0  # the clip is active
    assert (metrics.get("extra") == 1) == (grad_accum == 1)
    assert len(set(draws)) == 3 * grad_accum  # every microbatch drew its own numbers
    for key, value in params.items():
        np.testing.assert_allclose(
            value.detach().numpy(), np.asarray(state.trainable[key]), atol=1e-6, rtol=0, err_msg=key
        )
        assert value.grad is None

    eval_metrics = make_eval_step(loss_fn)(
        {k: v[0] for k, v in t_batch.items()} if grad_accum > 1 else t_batch, gen
    )
    assert eval_metrics["eval/loss"].ndim == 0 and not eval_metrics["eval/loss"].requires_grad


def test_train_step_rejects_a_mesh():
    optimizer = get_optimizer("adamw", 1e-3)
    with pytest.raises(NotImplementedError):
        make_train_step(lambda batch, generator: None, optimizer, mesh=object())
    with pytest.raises(NotImplementedError):
        make_eval_step(lambda batch, generator: None, mesh=object())
