"""Train step factory (``vision_ft_tpu/training/train_step.py``
counterpart).

The JAX package jits one function over (trainable, frozen, batch, key).
Here the model is an ``nn.Module`` that holds both parameter sets, so a
loss function is ``loss_fn(batch, generator) -> (loss, metrics)`` closed
over its model, and the step is eager: backward over the trainable
parameters only, global gradient norm, clipping, schedule, optimizer step.

With ``grad_accum > 1`` every batch leaf carries a leading
(grad_accum, micro_batch, ...) axis, or the batch is a
:class:`Microbatches` of ``grad_accum`` batches (which may differ in
shape, as the Trainer's aspect-ratio buckets do); the microbatches run one
after the other, each with its own draws from the generator, their
gradients summed in fp32 buffers and scaled by 1/grad_accum once.

Not ported: the ``mesh`` argument (SPMD sharding of the step) raises
``NotImplementedError``; buffer donation has no counterpart (parameters
and optimizer state update in place).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import torch

from .optimizer import Optimizer, global_norm

# loss_fn(batch, generator) -> (loss, metrics dict)
LossFn = Callable[[Any, torch.Generator], tuple[torch.Tensor, dict]]


class TrainState(NamedTuple):
    trainable: dict[str, torch.nn.Parameter]  # updated in place
    opt_state: torch.optim.Optimizer
    step: int


def init_train_state(
    optimizer: Optimizer, trainable: Mapping[str, torch.nn.Parameter]
) -> TrainState:
    trainable = dict(trainable)
    return TrainState(trainable, optimizer.init(trainable.values()), 0)


class Microbatches(tuple):
    """The ``grad_accum`` microbatches of one step, each a whole batch."""


def _microbatch(batch: Any, index: int) -> Any:
    if isinstance(batch, Microbatches):
        return batch[index]
    if isinstance(batch, Mapping):
        return {k: _microbatch(v, index) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_microbatch(v, index) for v in batch)
    return batch[index] if isinstance(batch, torch.Tensor) and batch.ndim else batch


def _check_finite(what: str, value: torch.Tensor) -> None:
    if not bool(torch.isfinite(value).all()):
        raise FloatingPointError(f"non-finite {what}: {value.detach().float().cpu().tolist()}")


def make_train_step(
    loss_fn: LossFn,
    optimizer: Optimizer,
    mesh=None,
    grad_accum: int = 1,
    check_finite: bool = False,
):
    """Build the train step.

    Returns ``step(state, batch, generator) -> (state, metrics)``; metrics
    hold ``train/loss`` and ``train/grad_norm`` (the global norm before
    clipping) as 0-dim tensors, besides what ``loss_fn`` reports. With
    ``check_finite`` each microbatch's loss and then the gradients' norm
    are read on the host, and a non-finite one raises
    ``FloatingPointError`` before the optimizer touches the parameters.
    """
    if mesh is not None:
        raise NotImplementedError("make_train_step(mesh=...) (the sharded step) is not ported")

    def grads_of(params, batch, generator):
        loss, metrics = loss_fn(batch, generator)
        if check_finite:
            _check_finite("loss", loss)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return loss.detach(), metrics, grads

    def step(state: TrainState, batch: Any, generator: torch.Generator):
        params = list(state.trainable.values())
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, batch, generator)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = 0.0
            for index in range(grad_accum):
                micro_loss, _, micro_grads = grads_of(params, _microbatch(batch, index), generator)
                torch._foreach_add_(grads, [g.float() for g in micro_grads])
                loss = loss + micro_loss.float()
            inv = 1.0 / grad_accum
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
            metrics = {}
        metrics = dict(metrics)
        metrics["train/loss"] = loss
        norm = metrics["train/grad_norm"] = global_norm(grads)
        if check_finite:
            _check_finite("gradient norm", norm)
        optimizer.update_(state.opt_state, params, grads, state.step, norm)
        return TrainState(state.trainable, state.opt_state, state.step + 1), metrics

    return step


def make_eval_step(loss_fn: LossFn, mesh=None):
    if mesh is not None:
        raise NotImplementedError("make_eval_step(mesh=...) (the sharded step) is not ported")

    @torch.no_grad()
    def step(batch: Any, generator: torch.Generator):
        loss, metrics = loss_fn(batch, generator)
        metrics = dict(metrics)
        metrics["eval/loss"] = loss
        return metrics

    return step
