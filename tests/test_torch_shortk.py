"""The port's short-K attention (``flash_attention_shortk``: SDXL's
cross-attention with the whole key context on chip) against the JAX
package's Pallas kernels, run in interpret mode on the CPU
(``flash_attention_shortk(..., interpret=True)``, forward and ``jax.vjp``).
On the CPU the port's wrappers take their plain versions; the kernels
themselves are held against those in ``tests/test_torch_cuda_kernels.py``
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.ops.pallas.flash_attention import SHORTK_MAX as JAX_SHORTK_MAX
from vision_ft_tpu.ops.pallas.flash_attention import flash_attention_shortk as jax_shortk

import vision_ft_tpu_torch.ops.flash_attention as flash_module
from vision_ft_tpu_torch.nn import remat_layer, set_remat_saves
from vision_ft_tpu_torch.ops.attention import attention_heads_packed
from vision_ft_tpu_torch.ops.flash_attention import (
    SHORTK_MAX,
    flash_attention,
    flash_attention_shortk,
    flash_attention_shortk_backward,
    flash_attention_shortk_bwd,
    flash_attention_shortk_reference,
    set_flash_shortk,
    shortk_bwd_plan,
    shortk_fwd_plan,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU: the interpreted kernel sums over padded key blocks and
# takes its row sum through a ones column of V at head dim 64; the plain
# version softmaxes whole rows. O(1) inputs agree to fp32 rounding of a few
# hundred terms.
FWD_TOL = 2e-5
GRAD_TOL = 5e-5


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _inputs(b, h, sq, sk, d, seed=0):
    return [_rand(seed + i, shape) for i, shape in enumerate(
        [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)])]


SHAPES = [
    (2, 2, 256, 77, 64),   # SDXL's 77 CLIP tokens
    (1, 2, 128, 152, 64),  # 150-token prompts
    (1, 2, 128, 192, 64),  # SHORTK_MAX keys
    (1, 2, 130, 77, 64),   # a ragged sq: the JAX entry pads q to 256 rows
    (1, 2, 128, 40, 128),  # head dim 128
]


@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES)
def test_shortk_matches_jax_kernel(b, h, sq, sk, d):
    """Forward within 2e-5 and the q, k, v gradients of <out, dout> within
    5e-5 (absolute, O(1) values) of the interpreted Pallas kernels."""
    q, k, v, dout = _inputs(b, h, sq, sk, d)
    want, vjp = jax.vjp(lambda *a: jax_shortk(*a, interpret=True), *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention_shortk(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=FWD_TOL)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, err_msg=name)


def test_shortk_backward_pieces_agree_on_cpu():
    """The whole backward (plain delta, then the backward wrapper's plain
    version) is autograd's gradient of the plain forward; no launch is
    counted on the CPU."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(1, 2, 96, 77, 64, seed=5))
    before = (flash_attention_shortk.launches, flash_attention_shortk_bwd.launches)
    out, lse = flash_attention_shortk(q, k, v, return_lse=True)
    got = flash_attention_shortk_backward(q, k, v, out, lse, dout)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_shortk_reference(*leaves), leaves, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_TOL)
    assert (flash_attention_shortk.launches, flash_attention_shortk_bwd.launches) == before


@pytest.mark.parametrize("b,h,sq,sms", [
    (2, 10, 4096, 132),  # the 1024 px request's first stage: 640 items
    (2, 20, 1024, 132),  # its second stage: 320 items
    (2, 10, 3952, 132),  # the ragged bucket: 62 tiles a head, the last of 48 rows
    (4, 10, 4096, 132),  # the batch-4 train step
    (1, 2, 1, 132),      # fewer items than SMs
    (2, 5, 3952, 132),   # 620 items over 132 blocks
])
def test_kernel_h_plan_walks_every_item_once(b, h, sq, sms):
    """Kernel H's persistent blocks take contiguous runs of the (batch, head,
    64-row tile) items that cover each once, none empty, so a block meets
    at most ceil(run / tiles) + 1 heads and loads each one's K and V once."""
    tiles, blocks = shortk_fwd_plan(b, h, sq, sms)
    items = b * h * tiles
    assert tiles == -(-sq // 64) and blocks == min(items, sms)
    runs = [range(i * items // blocks, (i + 1) * items // blocks) for i in range(blocks)]
    assert [item for run in runs for item in run] == list(range(items))
    for run in runs:
        assert len(run) >= 1
        heads = {item // tiles for item in run}
        assert len(heads) <= -(-len(run) // tiles) + 1


@pytest.mark.parametrize("b,h,sq,d,sms", [
    (2, 10, 1024, 64, 132),  # 192 keys at batch 2: a unit over several blocks
    (4, 20, 1024, 64, 132),  # the train step's second stage: a block over several units
    (4, 10, 4096, 64, 132),  # and its first stage
    (2, 20, 988, 64, 132),   # a ragged sq: 16 tiles, the last of 28 rows
    (2, 8, 1024, 128, 132),  # head dim 128: two halves a head
    (1, 1, 1, 64, 132),      # a single item
    (3, 7, 130, 64, 8),      # few SMs: every unit split, runs not on tile borders
])
def test_kernel_i_plan_walks_every_item_once(b, h, sq, d, sms):
    """Kernel I's persistent blocks cover each (batch, head, half, tile)
    item once; every unit lists the slots block + unit of exactly the
    blocks whose runs hold its tiles, in ascending (block) order and inside
    the blocks + units slots the scratch holds, none shared with another
    unit; and the plan, reduction order included, is the same on every
    call, cached or not."""
    plan = shortk_bwd_plan(b, h, sq, d, sms)
    tiles, units, blocks = plan.tiles, plan.units, plan.blocks
    items = units * tiles
    assert tiles == -(-sq // 64) and units == b * h * (d // 64) and blocks == min(items, sms)
    runs = [range(i * items // blocks, (i + 1) * items // blocks) for i in range(blocks)]
    assert [item for run in runs for item in run] == list(range(items))
    assert all(len(run) >= 1 for run in runs)
    touched = {}  # unit -> the blocks whose runs hold its tiles
    for i, run in enumerate(runs):
        for item in run:
            touched.setdefault(item // tiles, set()).add(i)
    want = tuple((u, tuple(i + u for i in sorted(blks))) for u, blks in sorted(touched.items()))
    assert plan.reduction == want and len(want) == units
    slots = [slot for _, unit_slots in plan.reduction for slot in unit_slots]
    assert len(slots) == len(set(slots)) and all(0 <= s < blocks + units for s in slots)
    shortk_bwd_plan.cache_clear()
    assert shortk_bwd_plan(b, h, sq, d, sms) == plan == shortk_bwd_plan(b, h, sq, d, sms)


def test_kernel_i_parts_tool_guards_every_part():
    """The measurement tool's guards still find each of their parts of
    kernel I in the source, and every copy it builds leaves out parts that
    exist."""
    from vision_ft_tpu_torch.tools import kernel_i_parts

    source = kernel_i_parts.SOURCE.read_text()
    guarded = kernel_i_parts.guarded_source(source)
    added_endifs = guarded.count("#endif\n") - source.count("#endif\n")
    assert guarded.count("#if !defined(") == added_endifs == len(kernel_i_parts.GUARDS)
    macros = {macro for macro, _, _ in kernel_i_parts.GUARDS}
    assert all(set(parts) <= macros for parts in kernel_i_parts.PARTS.values())


def test_shortk_max_is_the_jax_package_s():
    assert SHORTK_MAX == JAX_SHORTK_MAX == 192


@pytest.mark.parametrize("case", ["77 keys", "193 keys", "mask", "causal"])
def test_routing_on_the_cpu_takes_the_plain_formula(case):
    """With the switch on, CPU tensors take the plain formula whatever the
    call (the JAX package's rule off its TPU): the same numbers as with the
    switch off, and no launch."""
    sk = 193 if case == "193 keys" else 77
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 77, sk, 64, seed=9))
    kwargs = {"mask": torch.ones(1, 1, 1, sk, dtype=torch.bool)} if case == "mask" else {}
    kwargs["is_causal"] = case == "causal"
    before = flash_attention_shortk.launches
    off = flash_attention(q, k, v, **kwargs)
    set_flash_shortk(True)
    try:
        on = flash_attention(q, k, v, **kwargs)
    finally:
        set_flash_shortk(False)
    assert torch.equal(on, off) and flash_attention_shortk.launches == before


def test_switch_is_off_by_default_and_heads_packed_calls_reach_the_routing():
    assert flash_module._flash_shortk is False
    b, s, h, d = 1, 64, 2, 64
    q, k, v = (torch.from_numpy(_rand(i, (b, n, h * d))) for i, n in enumerate((s, 77, 77)))
    set_flash_shortk(True)
    try:
        out = attention_heads_packed(q, k, v, h, backend="flash")
    finally:
        set_flash_shortk(False)
    heads = lambda t: t.reshape(b, t.shape[1], h, d).transpose(1, 2)  # noqa: E731
    want = flash_attention_shortk_reference(heads(q), heads(k), heads(v))
    torch.testing.assert_close(out, want.transpose(1, 2).reshape(b, s, h * d), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["kernel", "none"])
def test_autograd_function_inside_a_remat_layer(monkeypatch, mode):
    """Checkpointed, two cross-attentions give the same gradients bit for
    bit; in the "kernel" mode the recomputation takes the recorded
    (out, lse) and does not run the forward again, in "none" it does."""
    b, h, s, sk, d = 2, 2, 64, 77, 64
    arrays = [_rand(30, (b, s, h * d)), _rand(31, (h * d, h * d)), _rand(32, (b, sk, 2 * h * d))]
    calls = []
    forward = flash_module._shortk_forward

    def counted(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)

    monkeypatch.setattr(flash_module, "_shortk_forward", counted)

    def region(x, wq, context):
        for _ in range(2):
            q = (x @ wq * 0.05).reshape(b, s, h, d).transpose(1, 2)
            kv = context.reshape(b, sk, 2 * h, d).transpose(1, 2)
            out = flash_attention_shortk(q, kv[:, :h], kv[:, h:])
            x = x + out.transpose(1, 2).reshape(b, s, h * d)
        return x

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    want = torch.autograd.grad(region(*leaves).square().sum(), leaves)
    calls.clear()
    set_remat_saves(mode)
    try:
        got = torch.autograd.grad(remat_layer(region)(*leaves).square().sum(), leaves)
    finally:
        set_remat_saves("activations")
    assert len(calls) == (2 if mode == "kernel" else 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
