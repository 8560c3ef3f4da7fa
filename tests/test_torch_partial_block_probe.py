"""The port's ragged-tile probe (``vision_ft_tpu_torch.tools.partial_block_probe``)
against the JAX package's ``tools/bench/partial_block_probe.py``, whose
Pallas kernels run on the CPU under ``force_tpu_interpret_mode()``. On the
CPU the port's wrappers take their plain versions; kernel L itself runs in
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` on the card.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools.bench import partial_block_probe as jax_probe

from vision_ft_tpu_torch.tools import partial_block_probe as probe
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jax_result():
    out = io.StringIO()
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(out):
        jax_probe.main()
    return json.loads(out.getvalue())


def test_cpu_line_has_the_jax_tools_cases_and_keys(jax_result, capsys):
    """The JAX tool's four cases, case for case, then the port's TMA case."""
    assert probe.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    port = json.loads(lines[0])
    assert list(port) == list(jax_result) == ["partial_blocks", "cases"]
    assert port["partial_blocks"] is True and jax_result["partial_blocks"] is True
    assert len(jax_result["cases"]) == 4 and len(port["cases"]) == 5
    for ours, theirs in zip(port["cases"], jax_result["cases"]):
        assert list(ours) == list(theirs) and ours == theirs
    assert port["cases"][4] == {"dtype": "bf16-tma", "shape": [4360, 256], "box": [128, 64],
                                "swizzle": "128B", "ok": True, "error": None}


def test_a_failed_case_makes_the_line_false_and_carries_its_error(capsys):
    """Here there is no card: every case fails on the device move, and the
    tool exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cases would run")
    assert probe.main([]) == 1
    result = json.loads(capsys.readouterr().out)
    assert result["partial_blocks"] is False
    assert all(not c["ok"] and c["error"] for c in result["cases"])


def _jax_tool_inputs():
    """The JAX tool's four inputs, drawn as its ``main()`` draws them."""
    rng = np.random.default_rng(0)
    return [
        (jnp.asarray(rng.standard_normal((4360, 256)), jnp.float32), 512),
        (jnp.asarray(rng.standard_normal((4360, 256)), jnp.bfloat16), 512),
        (jnp.asarray(rng.standard_normal((1219, 256)), jnp.bfloat16), 512),
        (jnp.asarray(np.random.default_rng(1).standard_normal((8, 4352)), jnp.float32), 512),
    ]


def _to_torch(x):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.bfloat16() if x.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("case", range(4), ids=["f32", "bf16", "bf16-odd", "f32-lastaxis"])
def test_plain_outputs_equal_the_interpreted_pallas_calls(case):
    """The port's plain copy and ``x * 2 + 1`` on the JAX tool's inputs
    equal its interpreted ``pallas_call`` outputs value for value."""
    x, block = _jax_tool_inputs()[case]
    lastaxis = case == 3
    index = (lambda i: (0, i)) if lastaxis else (lambda i: (i, 0))
    spec = pl.BlockSpec((8, block) if lastaxis else (block, x.shape[1]), index)
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            jax_probe._lastaxis_kernel if lastaxis else jax_probe._kernel,
            grid=(-(-x.shape[lastaxis] // block),), in_specs=[spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        )(x)
    x_port = _to_torch(x)
    tail = block if lastaxis else block * x.shape[1]
    out = torch.full((x_port.numel() + tail,), probe.SENTINEL, dtype=x_port.dtype)
    run = probe.partial_block_lastaxis if lastaxis else probe.partial_block_copy
    assert int(run(x_port, block, out).sum()) == 0
    assert torch.equal(out[: x_port.numel()].view(x_port.shape), _to_torch(want))
    assert (out[x_port.numel():] == probe.SENTINEL).all()


@pytest.mark.parametrize("s,block", [(10, 4), (8, 4), (3, 8)])
def test_plain_copy_writes_nothing_past_s(s, block):
    x = torch.arange(s * 8, dtype=torch.float32).reshape(s, 8) + 1
    out = torch.full((s + block, 8), probe.SENTINEL)
    overhang = probe.partial_block_copy(x, block, out)
    assert torch.equal(out[:s], x)
    assert (out[s:] == probe.SENTINEL).all()
    assert overhang.shape == (-(-s // block),) and int(overhang.sum()) == 0


@pytest.mark.parametrize("s,block", [(10, 4), (3, 8)])
def test_plain_lastaxis_writes_nothing_past_s(s, block):
    x = torch.linspace(-1, 1, 2 * s).reshape(2, s)
    out = torch.full((2 * s + block,), probe.SENTINEL)
    overhang = probe.partial_block_lastaxis(x, block, out)
    assert torch.equal(out[: 2 * s].view(2, s), x * 2 + 1)
    assert (out[2 * s:] == probe.SENTINEL).all()
    assert overhang.shape == (-(-s // block),) and int(overhang.sum()) == 0


@pytest.mark.parametrize("s,c", [(4360, 256), (8, 64), (128, 128), (129, 192)])
def test_plain_tma_case_writes_nothing_past_s(s, c):
    """The TMA case's plain version: (128, 64) boxes, zeros staged past S,
    the copy exact, the tail untouched, one pair of counts per box."""
    x = torch.randn(s, c, generator=torch.Generator().manual_seed(s)).bfloat16()
    out = torch.full((s + probe.TMA_BOX[0], c), probe.SENTINEL, dtype=torch.bfloat16)
    counts = probe.partial_block_tma(x, out)
    assert torch.equal(out[:s], x)
    assert (out[s:] == probe.SENTINEL).all()
    assert counts.shape == (-(-s // 128) * (c // 64), 2) and int(counts.sum()) == 0
    assert probe.partial_block_tma.launches == 0


# (S, row bytes, block rows) of the copy: the probe's cases, 16-byte rows at
# small blocks, blocks that are not powers of two, the widest row, S a
# multiple of the block (no overhang) and S under one block
COPY_PLAN_CASES = [(4360, 512, 512), (4360, 1024, 512), (1219, 512, 512), (4608, 512, 512),
                   (1, 16, 512), (63, 512, 512), (7, 16, 2), (100, 16, 64), (513, 16, 512),
                   (1000, 32768, 9), (5, 48, 3), (300, 16384, 64)]


@pytest.mark.parametrize("s,row_bytes,block", COPY_PLAN_CASES)
def test_copy_plan_covers_every_row_once(s, row_bytes, block):
    """Kernel L's copy plan, walked as ``csrc/partial_block_probe.cu`` walks
    it: tile t is a cluster whose CTA k stages rows [k * cta_rows, (k + 1) *
    cta_rows) of the tile in chunks of chunk_rows. Every row of every tile,
    past S included, is staged once; clusters, stages and the grid stay
    within the card's limits."""
    plan = probe.copy_plan(s, row_bytes, block)
    tiles, cluster, cta_rows, chunk_rows = plan
    assert tiles == -(-s // block) and cluster in (1, 2, 4, 8, 16) and cluster <= block
    assert 1 <= chunk_rows <= cta_rows and chunk_rows * row_bytes <= 32768
    assert 4 * chunk_rows * row_bytes <= 227 * 1024 and tiles * cluster < 2**31
    staged = np.zeros(tiles * block, np.int64)
    for t in range(tiles):
        for k in range(cluster):
            first = min(k * cta_rows, block)
            n_rows = min(cta_rows, block - first)
            for chunk in range(-(-n_rows // chunk_rows)):
                rows = np.arange(chunk * chunk_rows, min((chunk + 1) * chunk_rows, n_rows))
                np.add.at(staged, t * block + first + rows, 1)
    assert (staged == 1).all()
    # 16 CTAs (non-portable) only where a CTA's ring of 4 stages is at most 32 KB
    assert cluster == min(16 if row_bytes <= 8192 else 8, 1 << (block.bit_length() - 1))
    assert cluster <= 8 or 4 * chunk_rows * row_bytes <= 32768


@pytest.mark.parametrize("rows,cols,block", [(8, 4352, 512), (8, 4360, 512), (3, 1, 512),
                                             (3, 513, 512), (1, 7, 2), (5, 100, 64)])
def test_lastaxis_plan_covers_every_column_once(rows, cols, block):
    """The last-axis plan: tile t (columns [t * block, (t + 1) * block)) is
    a cluster whose CTA k stages rows [k * cta_rows, (k + 1) * cta_rows);
    every (row, column) of every tile is staged once and a CTA's tile fits
    its 48 KB."""
    tiles, cluster, cta_rows = probe.lastaxis_plan(rows, cols, block)
    assert tiles == -(-cols // block) and cluster in (1, 2, 4, 8) and cluster <= rows
    assert cta_rows * block * 4 <= rows * block * 4
    staged = np.zeros((rows, tiles * block), np.int64)
    for k in range(cluster):
        r0 = min(k * cta_rows, rows)
        staged[r0:r0 + min(cta_rows, rows - r0)] += 1
    assert (staged == 1).all()
