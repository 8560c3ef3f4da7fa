"""The port's offload module (``modules/offload.py``) on the CPU: subtree
moves, the layerwise strategy and the generate()-stage context, as
``tests/test_offload.py`` checks the JAX one; and the helper with which
each family's tests hold an offloaded ``generate()`` to the plain one.

The CPU has one device, so the "other device" of these moves is ``meta``:
a move there changes a tensor's device and keeps its dtype and shape.
"""

import numpy as np
import torch
from torch import nn

from vision_ft_tpu_torch.modules import offload
from vision_ft_tpu_torch.modules.offload import (
    LayerwiseOfflodStrategy,
    OffloadableModuleMixin,
    move_params,
    move_subtrees,
    stage_on_device,
)
from vision_ft_tpu_torch.nn import Linear, init_parameters_
from vision_ft_tpu_torch.modules.quant import quantize_params
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


def _model():
    model = nn.ModuleDict({
        "denoiser": nn.ModuleDict({"blocks": nn.ModuleList([Linear(64, 64) for _ in range(3)])}),
        "vae": Linear(4, 4),
    })
    model.register_buffer("scale", torch.ones(2))
    return init_parameters_(model, torch.Generator().manual_seed(0))


def _devices(module):
    return {k: t.device.type for k, t in (*module.named_parameters(), *module.named_buffers())}


def test_move_subtrees_only_touches_prefixes():
    model = _model()
    move_subtrees(model, ["denoiser.blocks.0", "scale"], "meta")
    devices = _devices(model)
    assert {k for k, d in devices.items() if d == "meta"} == {
        "denoiser.blocks.0.weight", "denoiser.blocks.0.bias", "scale"}
    move_params(model["vae"], "meta")
    assert _devices(model)["vae.weight"] == "meta"


def test_moves_keep_quantized_leaves_and_their_dtypes():
    """A packed 4-bit weight's leaves (outside ``nn.Parameter``) all move,
    none is cast: codes uint8, scales fp32, in a bf16 model."""
    model = _model().to(torch.bfloat16)
    quantize_params(model["denoiser"], "bnb_nf4", [""])
    leaves = dict(model["denoiser"]["blocks"][1].weight.named_buffers())
    dtypes = {k: v.dtype for k, v in leaves.items()}
    assert dtypes["packed"] == torch.uint8 and dtypes["absmax"] != torch.bfloat16
    move_params(model, "meta")
    moved = dict(model["denoiser"]["blocks"][1].weight.named_buffers())
    assert sorted(moved) == sorted(leaves)
    assert {k: v.dtype for k, v in moved.items()} == dtypes
    assert all(v.device.type == "meta" for v in moved.values())


def test_layerwise_strategy_streams_groups():
    model = _model()
    strategy = LayerwiseOfflodStrategy(
        [["denoiser.blocks.0"], ["denoiser.blocks.1"]], execution_device="cpu",
        offload_device="meta")
    assert strategy.group_index_of("denoiser.blocks.1.weight") == 1
    assert strategy.group_index_of("vae.weight") is None
    # entering group 1 keeps it on the execution device and parks group 0
    strategy.maybe_offload_by_group(strategy.maybe_offload_by_group(model, 0), 1)
    devices = _devices(model)
    assert devices["denoiser.blocks.0.weight"] == "meta"
    assert devices["denoiser.blocks.1.weight"] == devices["denoiser.blocks.2.weight"] == "cpu"
    fresh = _model()
    strategy.offload_all(fresh)
    assert {k for k, d in _devices(fresh).items() if d == "meta"} == {
        f"denoiser.blocks.{i}.{n}" for i in (0, 1) for n in ("weight", "bias")}


def test_stage_on_device_and_mixin_round_trip_placement():
    model = _model()
    with stage_on_device(model["vae"], True, execution="cpu", offload="meta"):
        assert model["vae"].weight.device.type == "cpu"
    assert model["vae"].weight.device.type == "meta"
    # disabled: no move at all
    before = model["denoiser"]["blocks"][2].weight.data_ptr()
    with stage_on_device(model["denoiser"], False, execution="meta", offload="meta"):
        pass
    assert model["denoiser"]["blocks"][2].weight.data_ptr() == before
    holder = OffloadableModuleMixin()
    holder.set_offload_strategy(LayerwiseOfflodStrategy([], "cpu", "meta"))
    with holder.on_device(model["denoiser"], "cpu") as placed:
        assert placed is model["denoiser"]
    assert model["denoiser"]["blocks"][2].weight.device.type == "meta"


def test_moves_inside_inference_mode_keep_trainable_tensors():
    model = _model()
    with torch.inference_mode():
        move_params(model, "meta")
    assert not any(p.is_inference() for p in model.parameters())


def assert_no_stray_tensors(module: nn.Module) -> None:
    """Every tensor the modules hold is a parameter or a buffer, so a move
    reaches it (a tensor attribute would stay on the old device)."""
    stray = [f"{name}.{attr}" for name, m in module.named_modules()
             for attr, value in vars(m).items()
             if isinstance(value, torch.Tensor) and not attr.startswith("_")]
    assert not stray, stray


def assert_offloaded_generate_is_plain(monkeypatch, model, generate, parts):
    """``generate(do_offloading=True)`` for a first request (every part on
    the device) and a later one (every part parked) equals ``generate()``
    bit for bit, and each of ``parts`` goes on, then off, in that order;
    no module of the model holds a tensor a move would miss."""
    moves = []
    real = offload._move_tensors

    def record(module, device, keep):
        moves.append(module)
        real(module, device, keep)

    monkeypatch.setattr(offload, "_move_tensors", record)
    plain = generate()
    assert moves == []
    runs = [generate(do_offloading=True) for _ in range(2)]
    stages = [getattr(model, part) for part in parts for _ in (0, 1)]
    assert len(moves) == 2 * len(stages) and all(a is b for a, b in zip(moves, stages * 2))
    for run in runs:
        assert len(run) == len(plain)
        for got, want in zip(run, plain):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for part in parts:
        assert_no_stray_tensors(getattr(model, part))
