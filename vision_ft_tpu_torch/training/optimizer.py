"""Optimizer factory (``vision_ft_tpu/training/optimizer.py`` counterpart).

The same config strings resolve to ``torch.optim`` optimizers that take,
step for step, the updates of the optax transformations the JAX package
builds:

  torch.optim.AdamW   -> torch.optim.AdamW   (optax.adamw)
  torch.optim.Adam    -> torch.optim.Adam    (optax.adam)
  torch.optim.SGD     -> torch.optim.SGD     (optax.sgd)
  torch.optim.RMSprop -> RMSpropEpsInSqrt    (optax.rmsprop, whose eps sits
                         inside the square root, unlike torch's RMSprop)
  torch.optim.Adafactor, adafactor
                      -> Adafactor           (optax.adafactor with its
                         defaults; the config's args are ignored, as in the
                         JAX package. torch.optim.Adafactor is another
                         algorithm: no parameter scale, no update clipping)
  schedulefree.AdamWScheduleFree,
  schedulefree.RAdamScheduleFree
                      -> ScheduleFreeAdamW   (optax.contrib.schedule_free_adamw,
                         as the JAX package maps both names)
  schedulefree.SGDScheduleFree
                      -> ScheduleFreeSGD     (optax.contrib.schedule_free_sgd
                         with its defaults)
  bitsandbytes.optim.AdamW8bit, bitsandbytes.optim.Adam8bit
                      -> AdamW8bit           (the JAX package's adamw_8bit:
                         int8 block-quantized moments; Adam8bit without
                         weight decay)
  optax.<name>        -> the counterpart of optax.<name> with optax's own
                         keyword names and defaults, for the names in
                         ``OPTAX_NAMES`` (the JAX package reaches all of
                         optax; any other name raises ``ValueError``)

:func:`get_optimizer` returns an :class:`Optimizer`: the recipe (name,
learning rate or schedule, clipping) from which ``init`` builds the
``torch.optim`` object for a set of parameters and ``update_`` applies one
step. Clipping is optax's: by value first, then by global norm with the
factor ``max_norm / norm`` applied only when ``norm >= max_norm`` (torch's
``clip_grad_norm_`` divides by ``norm + 1e-6`` instead).

The schedule-free optimizers train the interpolation y of two sequences
and evaluate at the average x: :func:`eval_params` gives x, which saving
and previews use. Their learning rate is the configured one, warmed up
linearly over ``warmup_steps`` (``args``, default 0). One departure from
the JAX package: there ``warmup_steps`` 0 becomes
``optax.warmup_constant_schedule(0, lr, 0)``, a schedule that is 0 at every
step, so nothing trains; here 0 means no warm-up. ``eps`` is passed on,
where the JAX package drops it.

The optimizers written here keep their state tensors in the dtypes they
were made in when a state dict is loaded (``torch.optim.Optimizer`` casts
floating state to the parameter's dtype, and would make the int8 codes of
the 8-bit AdamW floats), so a resumed run continues bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

ScheduleOrFloat = float | Callable[[int], float]


class _ExactState(torch.optim.Optimizer):
    """``load_state_dict`` that keeps each state tensor's dtype (torch's
    casts every tensor of a floating parameter's state to that dtype) and
    restores the counters ``_counters`` names beside the per-tensor state."""

    _counters: tuple[str, ...] = ()

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["counters"] = {name: getattr(self, name) for name in self._counters}
        return state

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        counters = state_dict.pop("counters", {})
        saved = state_dict["state"]
        super().load_state_dict(state_dict)
        ids = [i for group in state_dict["param_groups"] for i in group["params"]]
        params = [p for group in self.param_groups for p in group["params"]]
        for index, p in zip(ids, params):
            for key, value in saved.get(index, {}).items():
                if isinstance(value, torch.Tensor):
                    self.state[p][key] = value.to(p.device, copy=True)
        for name, value in counters.items():
            setattr(self, name, value)


class RMSpropEpsInSqrt(torch.optim.Optimizer):
    """RMSprop as optax.rmsprop computes it: nu = decay nu + (1 - decay) g^2,
    u = lr g / sqrt(nu + eps), then momentum on the scaled update
    (buf = momentum buf + u, p -= buf): eps sits inside the square root and
    the learning rate is applied before the momentum, unlike torch's RMSprop."""

    def __init__(self, params, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["buf"] = torch.zeros_like(p)
                nu, buf = state["nu"], state["buf"]
                nu.mul_(group["alpha"]).addcmul_(p.grad, p.grad, value=1 - group["alpha"])
                buf.mul_(group["momentum"]).add_(
                    p.grad * torch.rsqrt(nu + group["eps"]), alpha=group["lr"]
                )
                p.sub_(buf)


class _ScheduleFree(_ExactState):
    """optax.contrib.schedule_free around a base update, the arithmetic in
    fp32 and each tensor stored in its parameter's dtype (Defazio et al.,
    "The Road Less Scheduled", 2024). Per parameter it keeps z (the base
    optimizer's iterate); the parameter itself is y = b1 x + (1 - b1) z,
    where gradients are taken. Per step, with the warm-up
    lr(c) = lr * min(c / warmup_steps, 1) and u the subclass's base update
    ``_base_update(group, state, g, y, lr)`` at lr(k) (k counts updates from
    0):

        max_lr = max(max_lr, lr(k + 1)); c = max_lr^2 / sum of max_lr^2
        z' = z + u;  x = (y - (1 - b1) z) / b1;  x' = (1 - c) x + c z'
        y' = b1 x' + (1 - b1) z'
    """

    _counters = ("count", "weight_sum", "max_lr")

    def __init__(self, params, defaults: dict, warmup_steps: int = 0,
                 weight_lr_power: float = 2.0):
        if not defaults["betas"][0] > 0:
            raise ValueError("schedule-free needs betas[0] > 0")
        super().__init__(params, dict(defaults, warmup_steps=warmup_steps,
                                      weight_lr_power=weight_lr_power))
        self.count = 0  # updates taken
        self.weight_sum = 0.0
        self.max_lr = 0.0

    @staticmethod
    def _lr(group, count: int) -> float:
        warmup = group["warmup_steps"]
        if warmup and warmup > 0:
            return group["lr"] * min(count / warmup, 1.0)
        return group["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        group0 = self.param_groups[0]
        # the averaging weight reads the schedule one step ahead (optax's
        # step_count starts at 1), the update itself at the update count
        self.max_lr = max(self.max_lr, self._lr(group0, self.count + 1))
        weight = self.max_lr ** group0["weight_lr_power"]
        self.weight_sum += weight
        ck = weight / self.weight_sum if self.weight_sum > 0 else 0.0
        for group in self.param_groups:
            b1 = group["betas"][0]
            lr = self._lr(group, self.count)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["z"] = p.detach().clone()
                g, y, z = p.grad.float(), p.float(), state["z"].float()
                z_new = (z + self._base_update(group, state, g, y, lr)).to(p.dtype).float()
                x = (y - (1 - b1) * z) / b1
                x = (1 - ck) * x + ck * z_new
                p.copy_(b1 * x + (1 - b1) * z_new)
                state["z"].copy_(z_new)
        self.count += 1

    @torch.no_grad()
    def eval_param(self, p: torch.Tensor) -> torch.Tensor:
        """x = (y - (1 - b1) z) / b1 of one parameter (y itself before the
        first update, when z is y)."""
        state = self.state.get(p)
        if not state:
            return p.detach().clone()
        b1 = self.param_groups[0]["betas"][0]
        return ((p.float() - (1 - b1) * state["z"].float()) / b1).to(p.dtype)


class ScheduleFreeAdamW(_ScheduleFree):
    """optax.contrib.schedule_free_adamw step for step: the base update is
    u = -lr(k) (g / (sqrt(nu_hat) + eps) + weight_decay y) (scale_by_rms
    with bias correction, decayed weights, scale_by_learning_rate), nu the
    second moment kept per parameter."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, warmup_steps: int = 0, weight_lr_power: float = 2.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay), warmup_steps, weight_lr_power)

    def _base_update(self, group, state, g, y, lr):
        b2 = group["betas"][1]
        if "nu" not in state:
            state["nu"] = torch.zeros_like(state["z"])
        nu = state["nu"].float().mul_(b2).addcmul_(g, g, value=1 - b2)
        state["nu"].copy_(nu)
        u = g / ((nu / (1.0 - b2 ** (self.count + 1))).sqrt_().add_(group["eps"]))
        return u.add_(y, alpha=group["weight_decay"]).mul_(-lr)


class ScheduleFreeSGD(_ScheduleFree):
    """optax.contrib.schedule_free_sgd step for step: the base update is
    plain SGD, u = -lr(k) (g + weight_decay y)."""

    def __init__(self, params, lr: float, b1: float = 0.9, weight_decay: float = 0.0,
                 warmup_steps: int = 0, weight_lr_power: float = 2.0):
        super().__init__(params, dict(lr=lr, betas=(b1,), weight_decay=weight_decay),
                         warmup_steps, weight_lr_power)

    def _base_update(self, group, state, g, y, lr):
        return (g + group["weight_decay"] * y).mul_(-lr)


class Adafactor(_ExactState):
    """optax.adafactor step for step (Shazeer and Stern, 2018): a second
    moment factored into row and column means over the two largest axes
    where both are at least ``min_dim_size_to_factor`` long (else kept
    whole), decayed at 1 - (k + 1 - decay_offset)^-decay_rate; the update
    g / sqrt(v) clipped to RMS ``clipping_threshold``, times the learning
    rate, times the parameter's RMS (at least 1e-3) with
    ``multiply_by_parameter_scale``, then the optional momentum (an EMA
    without bias correction) and decayed weights (not scaled by the
    learning rate, as in optax). The state is kept in the parameter's
    dtype, the arithmetic in fp32."""

    _counters = ("count",)

    def __init__(self, params, lr: float, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
                 factored: bool = True):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset, multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored,
        ))
        self.count = 0

    @staticmethod
    def factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
        """(d1, d0), the two largest axes (numpy's argsort of the shape, as
        optax picks them), or None where the moment is kept whole."""
        if not factored or len(shape) < 2:
            return None
        sorted_dims = np.argsort(shape)
        if shape[sorted_dims[-2]] < min_dim_size_to_factor:
            return None
        return int(sorted_dims[-2]), int(sorted_dims[-1])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            t = torch.tensor(self.count - group["decay_offset"] + 1, dtype=torch.float32)
            decay = float(1.0 - t ** (-group["decay_rate"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                dims = self.factored_dims(tuple(p.shape), group["factored"],
                                          group["min_dim_size_to_factor"])
                if not state:
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros(np.delete(p.shape, d0).tolist())
                        state["v_col"] = p.new_zeros(np.delete(p.shape, d1).tolist())
                    if group["momentum"] is not None:
                        state["m"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad.float()
                grad_sqr = g * g + group["eps"]
                if dims is None:
                    v = decay * state["v"].float() + (1.0 - decay) * grad_sqr
                    state["v"].copy_(v)
                    u = g * state["v"].float().pow(-0.5)
                else:
                    d1, d0 = dims
                    v_row = decay * state["v_row"].float() + (1.0 - decay) * grad_sqr.mean(d0)
                    v_col = decay * state["v_col"].float() + (1.0 - decay) * grad_sqr.mean(d1)
                    state["v_row"].copy_(v_row)
                    state["v_col"].copy_(v_col)
                    v_row, v_col = state["v_row"].float(), state["v_col"].float()
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).pow(-0.5)
                    u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
                if group["clipping_threshold"] is not None:
                    rms = u.square().mean().sqrt()
                    u = u / torch.clamp_min(rms / group["clipping_threshold"], 1.0)
                u = u * group["lr"]
                if group["multiply_by_parameter_scale"]:
                    rms = p.float().square().mean().sqrt()
                    u = u * torch.where(rms <= 1e-3, 1e-3, rms)
                if group["momentum"] is not None:
                    m = state["m"].mul_(group["momentum"]).add_(u, alpha=1 - group["momentum"])
                    u = m.clone()
                if group["weight_decay_rate"] is not None:
                    u = u + group["weight_decay_rate"] * p.float()
                p.sub_(u.to(p.dtype))
        self.count += 1


class Lion(torch.optim.Optimizer):
    """optax.lion: u = sign((1 - b1) g + b1 mu), mu = b2 mu + (1 - b2) g,
    p -= lr (u + weight_decay p) (Chen et al., 2023)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                g, mu = p.grad, state["mu"]
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.mul_(b2).add_(g, alpha=1.0 - b2)
                p.sub_(group["lr"] * (u + group["weight_decay"] * p))


_MU = 255.0
_LOG1P_MU = math.log1p(_MU)


def _compand(n: torch.Tensor) -> torch.Tensor:
    """Signed mu-law (mu 255): uniform relative error across magnitudes."""
    return torch.sign(n) * torch.log1p(_MU * n.abs()) / _LOG1P_MU


def _expand(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(y.abs() * _LOG1P_MU) / _MU


class AdamW8bit(_ExactState):
    """The JAX package's ``adamw_8bit`` (its counterpart of
    ``bitsandbytes.optim.AdamW8bit``): AdamW whose moments are stored per
    tensor as int8 codes with one fp32 absmax scale a block of
    ``block_size`` values of the flattened tensor (zero-padded to whole
    blocks). The first moment takes signed mu-law codes, round(compand(m /
    scale) * 127); the second its square root's, round(compand(root /
    scale) * 255) - 128. Each step dequantizes both, takes Adam's
    bias-corrected step with decoupled weight decay in fp32, and
    quantizes them again. The schedule is read at the update's count from
    1, as the JAX transformation reads it (``schedule_offset``)."""

    _counters = ("count",)
    schedule_offset = 1

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, block_size: int = 2048):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, block_size=block_size))
        self.count = 0

    @staticmethod
    def blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
        flat = x.reshape(-1)
        return torch.nn.functional.pad(flat, (0, (-flat.numel()) % block_size)).reshape(
            -1, block_size)

    @classmethod
    def quantize(cls, x: torch.Tensor, block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        blocks = cls.blocks(x, block_size)
        scale = blocks.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
        return torch.round(_compand(blocks / scale) * 127.0).to(torch.int8), scale.float()

    @staticmethod
    def dequantize(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        flat = (_expand(q.float() / 127.0) * scale).reshape(-1)[:like.numel()]
        return flat.reshape(like.shape)

    @classmethod
    def quantize_sqrt(cls, x: torch.Tensor, block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        root = torch.sqrt(cls.blocks(x, block_size))
        scale = root.amax(dim=1, keepdim=True).clamp_min(1e-12)
        q = torch.round(_compand(root / scale) * 255.0) - 128.0
        return q.to(torch.int8), scale.float()

    @staticmethod
    def dequantize_sqrt(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        root = _expand((q.float() + 128.0) / 255.0) * scale
        return torch.square(root).reshape(-1)[:like.numel()].reshape(like.shape)

    @torch.no_grad()
    def step(self, closure=None):
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            size = group["block_size"]
            # fp32 powers, as the JAX update takes them
            correction1, correction2 = (
                float(1.0 - torch.tensor(b, dtype=torch.float32) ** self.count) for b in (b1, b2))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                state = self.state[p]
                if not state:
                    zeros = torch.zeros_like(g)
                    state["mu_q"], state["mu_scale"] = self.quantize(zeros, size)
                    # code -128 in the square-root domain decodes to exactly 0
                    state["nu_q"], state["nu_scale"] = self.quantize_sqrt(zeros, size)
                mu = self.dequantize(state["mu_q"], state["mu_scale"], g)
                nu = self.dequantize_sqrt(state["nu_q"], state["nu_scale"], g)
                mu = b1 * mu + (1 - b1) * g
                nu = b2 * nu + (1 - b2) * torch.square(g)
                mu_hat = mu / correction1
                nu_hat = nu / correction2
                update = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p.float()
                p.add_((-group["lr"] * update).to(p.dtype))
                state["mu_q"], state["mu_scale"] = self.quantize(mu, size)
                state["nu_q"], state["nu_scale"] = self.quantize_sqrt(nu, size)


def _betas(args: dict) -> tuple[float, float]:
    return tuple(args.get("betas", (0.9, 0.999)))


def _adamw(params, lr, args):
    return torch.optim.AdamW(
        params, lr=lr, betas=_betas(args), eps=args.get("eps", 1e-8),
        weight_decay=args.get("weight_decay", 0.01),
    )


def _adam(params, lr, args):
    return torch.optim.Adam(params, lr=lr, betas=_betas(args), eps=args.get("eps", 1e-8))


def _sgd(params, lr, args):
    return torch.optim.SGD(
        params, lr=lr, momentum=args.get("momentum") or 0.0, nesterov=args.get("nesterov", False)
    )


def _rmsprop(params, lr, args):
    return RMSpropEpsInSqrt(
        params, lr=lr, alpha=args.get("alpha", 0.99), eps=args.get("eps", 1e-8),
        momentum=args.get("momentum", 0.0),
    )


def _schedule_free_adamw(params, lr, args):
    b1, b2 = _betas(args)
    return ScheduleFreeAdamW(
        params, lr=lr, betas=(b1, b2), eps=args.get("eps", 1e-8),
        weight_decay=args.get("weight_decay", 0.0), warmup_steps=args.get("warmup_steps", 0),
    )


def _adamw_8bit(weight_decay: Optional[float]):
    def make(params, lr, args):
        return AdamW8bit(params, lr=lr, betas=_betas(args), eps=args.get("eps", 1e-8),
                         weight_decay=(args.get("weight_decay", 0.01) if weight_decay is None
                                       else weight_decay))
    return make


_REGISTRY = {
    "schedulefree.adamwschedulefree": _schedule_free_adamw,
    "schedulefree.radamschedulefree": _schedule_free_adamw,
    "schedulefree.sgdschedulefree": lambda params, lr, args: ScheduleFreeSGD(params, lr=lr),
    "torch.optim.adamw": _adamw,
    "adamw": _adamw,
    "torch.optim.adam": _adam,
    "adam": _adam,
    "torch.optim.sgd": _sgd,
    "sgd": _sgd,
    "torch.optim.rmsprop": _rmsprop,
    "torch.optim.adafactor": lambda params, lr, args: Adafactor(params, lr=lr),
    "adafactor": lambda params, lr, args: Adafactor(params, lr=lr),
    "bitsandbytes.optim.adamw8bit": _adamw_8bit(None),
    "bitsandbytes.optim.adam8bit": _adamw_8bit(0.0),
}


def _optax(make: Callable, **defaults):
    """A factory of ``make(params, lr, **kwargs)`` that takes optax's
    keyword names with optax's defaults and refuses any other keyword."""

    def factory(params, lr, args):
        unknown = sorted(set(args) - set(defaults))
        if unknown:
            raise TypeError(f"unsupported keyword(s) {unknown}; this name takes {sorted(defaults)}")
        return make(params, lr, **{**defaults, **args})

    return factory


def _optax_sgd(params, lr, momentum, nesterov):
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0, nesterov=nesterov)


# optax.<name>: the names the port takes, with optax's keywords and defaults
_OPTAX = {
    "adamw": _optax(lambda params, lr, b1, b2, eps, weight_decay: torch.optim.AdamW(
        params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay),
        b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4),
    "adam": _optax(lambda params, lr, b1, b2, eps: torch.optim.Adam(
        params, lr=lr, betas=(b1, b2), eps=eps), b1=0.9, b2=0.999, eps=1e-8),
    "sgd": _optax(_optax_sgd, momentum=None, nesterov=False),
    "rmsprop": _optax(lambda params, lr, decay, eps, momentum: RMSpropEpsInSqrt(
        params, lr=lr, alpha=decay, eps=eps, momentum=momentum or 0.0),
        decay=0.9, eps=1e-8, momentum=None),
    "adafactor": _optax(lambda params, lr, **kw: Adafactor(params, lr=lr, **kw),
                        min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0,
                        multiply_by_parameter_scale=True, clipping_threshold=1.0, momentum=None,
                        weight_decay_rate=None, eps=1e-30, factored=True),
    "lion": _optax(lambda params, lr, b1, b2, weight_decay: Lion(
        params, lr=lr, b1=b1, b2=b2, weight_decay=weight_decay),
        b1=0.9, b2=0.99, weight_decay=1e-3),
}
OPTAX_NAMES = tuple(f"optax.{name}" for name in _OPTAX)


def is_schedule_free(name: str) -> bool:
    return "schedulefree" in name.lower().replace("_", "")


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32 (optax.global_norm);
    one fused pass over the list, not three launches a tensor."""
    grads = list(grads)
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer recipe: what ``get_optimizer`` resolved."""

    name: str
    learning_rate: ScheduleOrFloat
    factory: Callable
    args: dict
    max_grad_norm: Optional[float] = None
    max_grad_value: Optional[float] = None

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self.factory(list(params), self.lr_at(0), self.args)

    @torch.no_grad()
    def clip_(self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """Clip in place: by value, then by global norm (optax's chain).
        ``norm`` is the global norm of ``grads`` where the caller has it
        already; it is computed here after a clip by value."""
        grads = list(grads)
        if self.max_grad_value is not None:
            torch._foreach_clamp_min_(grads, -self.max_grad_value)
            torch._foreach_clamp_max_(grads, self.max_grad_value)
            norm = None
        if self.max_grad_norm is not None:
            if norm is None:
                norm = global_norm(grads)
            # optax.clip_by_global_norm: untouched below max_norm, else
            # (g / norm) * max_norm; one factor, no host synchronization
            factor = torch.where(norm < self.max_grad_norm, 1.0, self.max_grad_norm / norm)
            torch._foreach_mul_(grads, factor)

    @torch.no_grad()
    def update_(
        self,
        opt_state: torch.optim.Optimizer,
        params: Sequence[torch.nn.Parameter],
        grads: Sequence[torch.Tensor],
        count: int,
        norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One update in place: clip ``grads`` (consumed; ``norm`` is their
        global norm where the caller has it), read the schedule at ``count``
        (0 for the first update; plus the optimizer's ``schedule_offset``,
        where it has one) and step."""
        self.clip_(grads, norm)
        lr = self.lr_at(count + getattr(opt_state, "schedule_offset", 0))
        for group in opt_state.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        opt_state.step()
        for p in params:
            p.grad = None


def get_optimizer(
    name: str,
    lr: ScheduleOrFloat,
    args: Optional[dict] = None,
    max_grad_norm: Optional[float] = None,
    max_grad_value: Optional[float] = None,
) -> Optimizer:
    """Resolve an optimizer string to an :class:`Optimizer` recipe, with the
    clipping hooks folded in."""
    args = dict(args or {})
    key = name.lower()
    if key.startswith("optax."):
        factory = _OPTAX.get(key.split(".", 1)[1])
        if factory is None:
            raise ValueError(f"Unknown optimizer: {name!r}; the optax names the port takes are "
                             f"{', '.join(OPTAX_NAMES)}")
        return Optimizer(name, lr, factory, args, max_grad_norm, max_grad_value)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown optimizer: {name!r}")
    if is_schedule_free(key):
        # the JAX package reads a schedule once, at step 0: the optimizer
        # warms up on its own
        lr = float(lr(0)) if callable(lr) else float(lr)
    return Optimizer(name, lr, _REGISTRY[key], args, max_grad_norm, max_grad_value)


def eval_params(name: str, opt_state, params):
    """Evaluation parameters of ``params`` (a mapping of name to parameter):
    for the schedule-free optimizers the average x of each, new tensors;
    for every other optimizer the parameters themselves."""
    if not is_schedule_free(name):
        return params
    return {k: opt_state.eval_param(p) for k, p in params.items()}
