"""Optimizer factory (``vision_ft_tpu/training/optimizer.py`` counterpart).

The same config strings resolve to ``torch.optim`` optimizers that take,
step for step, the updates of the optax transformations the JAX package
builds:

  torch.optim.AdamW   -> torch.optim.AdamW   (optax.adamw)
  torch.optim.Adam    -> torch.optim.Adam    (optax.adam)
  torch.optim.SGD     -> torch.optim.SGD     (optax.sgd)
  torch.optim.RMSprop -> RMSpropEpsInSqrt    (optax.rmsprop, whose eps sits
                         inside the square root, unlike torch's RMSprop)
  schedulefree.AdamWScheduleFree,
  schedulefree.RAdamScheduleFree
                      -> ScheduleFreeAdamW     (optax.contrib.schedule_free_adamw,
                         as the JAX package maps both names)

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

Not ported, each raising ``NotImplementedError`` by name: the 8-bit AdamW
(``bitsandbytes.optim.AdamW8bit`` / ``Adam8bit``), the schedule-free SGD,
Adafactor and the ``optax.<name>`` passthrough.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import torch

ScheduleOrFloat = float | Callable[[int], float]


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


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """optax.contrib.schedule_free_adamw step for step (Defazio et al.,
    "The Road Less Scheduled", 2024), the arithmetic in fp32 and each
    tensor stored in its parameter's dtype. Per parameter it keeps z (the
    base optimizer's iterate) and nu (the second moment); the parameter
    itself is y = b1 x + (1 - b1) z, where gradients are taken. Per step,
    with the warm-up lr(c) = lr * min(c / warmup_steps, 1):

        u = -lr(k) (g / (sqrt(nu_hat) + eps) + weight_decay y)   (scale_by_rms
            with bias correction, decayed weights, scale_by_learning_rate;
            k counts updates from 0)
        max_lr = max(max_lr, lr(k + 1)); c = max_lr^2 / sum of max_lr^2
        z' = z + u;  x = (y - (1 - b1) z) / b1;  x' = (1 - c) x + c z'
        y' = b1 x' + (1 - b1) z'
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, warmup_steps: int = 0, weight_lr_power: float = 2.0):
        if not betas[0] > 0:
            raise ValueError("schedule-free needs betas[0] > 0")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, warmup_steps=warmup_steps,
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
            b1, b2 = group["betas"]
            lr = self._lr(group, self.count)
            correction = 1.0 - b2 ** (self.count + 1)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["z"] = p.detach().clone()
                    state["nu"] = torch.zeros_like(p)
                g, y = p.grad.float(), p.float()
                z, nu = state["z"].float(), state["nu"].float()
                nu = nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = g / ((nu / correction).sqrt_().add_(group["eps"]))
                u.add_(y, alpha=group["weight_decay"]).mul_(-lr)
                z_new = (z + u).to(p.dtype).float()
                x = (y - (1 - b1) * z) / b1
                x = (1 - ck) * x + ck * z_new
                p.copy_(b1 * x + (1 - b1) * z_new)
                state["z"].copy_(z_new)
                state["nu"].copy_(nu)
        self.count += 1

    def state_dict(self) -> dict:
        """``torch.optim.Optimizer.state_dict()`` with the update count and
        the averaging weights beside it."""
        state = super().state_dict()
        state["schedule_free"] = {
            "count": self.count, "weight_sum": self.weight_sum, "max_lr": self.max_lr,
        }
        return state

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        extra = state_dict.pop("schedule_free")
        super().load_state_dict(state_dict)
        self.count, self.weight_sum, self.max_lr = (
            extra["count"], extra["weight_sum"], extra["max_lr"]
        )

    @torch.no_grad()
    def eval_param(self, p: torch.Tensor) -> torch.Tensor:
        """x = (y - (1 - b1) z) / b1 of one parameter (y itself before the
        first update, when z is y)."""
        state = self.state.get(p)
        if not state:
            return p.detach().clone()
        b1 = self.param_groups[0]["betas"][0]
        return ((p.float() - (1 - b1) * state["z"].float()) / b1).to(p.dtype)


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


_REGISTRY = {
    "schedulefree.adamwschedulefree": _schedule_free_adamw,
    "schedulefree.radamschedulefree": _schedule_free_adamw,
    "torch.optim.adamw": _adamw,
    "adamw": _adamw,
    "torch.optim.adam": _adam,
    "adam": _adam,
    "torch.optim.sgd": _sgd,
    "sgd": _sgd,
    "torch.optim.rmsprop": _rmsprop,
}
_NOT_PORTED = {
    "torch.optim.adafactor": "Adafactor",
    "adafactor": "Adafactor",
    "bitsandbytes.optim.adamw8bit": "adamw_8bit (the blockwise int8-state AdamW)",
    "bitsandbytes.optim.adam8bit": "adamw_8bit (the blockwise int8-state AdamW)",
    "schedulefree.sgdschedulefree": "the schedule-free SGD",
}


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
        (0 for the first update) and step."""
        self.clip_(grads, norm)
        lr = self.lr_at(count)
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
    if key in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[key]} ({name}) is not ported")
    if key.startswith("optax."):
        raise NotImplementedError(f"the optax passthrough ({name}) has no counterpart in the port")
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
