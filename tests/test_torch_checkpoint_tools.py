"""The port's checkpoint tools (``quantize_model``, ``checkpoint.convert_dtype``,
``checkpoint.to_safetensors``, ``snapshot_max_memory``) against the JAX
package's tools on seeded weights (CPU): the files they write, read back.
"""

import pickle

import numpy as np
import pytest
import torch

from tools import quantize_model as jax_quantize_model
from tools.checkpoint import convert_dtype as jax_convert_dtype
from tools.checkpoint import to_safetensors as jax_to_safetensors

from vision_ft_tpu_torch.tools import quantize_model, snapshot_max_memory
from vision_ft_tpu_torch.tools.checkpoint import convert_dtype, to_safetensors
from vision_ft_tpu_torch.utils import safetensors as st
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


def _weights():
    """An AuraFlow-like single file: targeted 2-D weights (one with an odd
    column count), the tool's default exclusions, a bias, a conv, an int
    table and a VAE weight outside ``model.``."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return {
        "model.double_layers.0.attn.w1q.weight": f(64, 96),
        "model.double_layers.0.mlpC.c_fc1.weight": f(128, 64),
        "model.single_layers.0.attn.w1o.weight": f(48, 33),
        "model.t_embedder.mlp.0.weight": f(64, 32),
        "model.final_linear.weight": f(16, 64),
        "model.modF.1.weight": f(128, 64),
        "model.single_layers.0.attn.w1o.bias": f(48),
        "model.init_x_linear.conv.weight": f(8, 4, 2, 2),
        "model.positions": torch.arange(12, dtype=torch.int64).reshape(3, 4),
        "vae.decoder.conv_in.weight": f(8, 4),
    }


# what the JAX tools' arrays cannot hold: numpy has no bf16 (widened to
# fp32) and JAX without x64 narrows int64 to int32
JAX_DTYPES = {torch.bfloat16: torch.float32, torch.int64: torch.int32}


def _assert_same_files(got_path, want_path, jax_dtypes=False):
    """Same keys, dtypes and values; with ``jax_dtypes`` the port's bf16 and
    int64 tensors are held to the JAX file's fp32 and int32 ones by value."""
    got, want = st.load_file(got_path), st.load_file(want_path)
    assert sorted(got) == sorted(want)
    for key in want:
        value = got[key]
        if jax_dtypes and value.dtype != want[key].dtype and value.dtype in JAX_DTYPES:
            assert want[key].dtype == JAX_DTYPES[value.dtype], key
            value = value.to(want[key].dtype)
        assert value.dtype == want[key].dtype, key
        assert torch.equal(value, want[key]), key
    return got


@pytest.mark.parametrize("quant_type", ["bnb_nf4", "bnb_fp4", "fp8_e4m3fn"])
def test_quantize_model_matches_jax_tool(tmp_path, quant_type):
    """The JAX CLI's defaults (include ``model.``, exclude ``t_embedder``,
    ``final_linear``, ``modF``; 2-D weights only for the 4-bit types): the
    same keys and the same bytes of every tensor, codes and quant state."""
    src = tmp_path / "model.safetensors"
    st.save_file(_weights(), src)
    jax_quantize_model.main.main(
        ["--model-path", str(src), "--save-path", str(tmp_path / "jax.safetensors"),
         "--quant-type", quant_type], standalone_mode=False)
    quantize_model.main(["--model-path", str(src), "--save-path", str(tmp_path / "port.safetensors"),
                         "--quant-type", quant_type, "--device", "cpu"])
    got = _assert_same_files(tmp_path / "port.safetensors", tmp_path / "jax.safetensors")
    packed = "model.double_layers.0.attn.w1q.weight"
    if quant_type == "fp8_e4m3fn":
        assert got[packed].dtype == torch.float8_e4m3fn
    else:
        assert got[packed].dtype == torch.uint8 and f"{packed}.absmax" in got
    for kept in ("model.t_embedder.mlp.0.weight", "model.final_linear.weight",
                 "model.modF.1.weight", "vae.decoder.conv_in.weight"):
        assert torch.equal(got[kept], _weights()[kept])


def test_quantize_model_takes_repeated_keys(tmp_path):
    src = tmp_path / "model.safetensors"
    st.save_file(_weights(), src)
    out = quantize_model.main([
        "--model-path", str(src), "--save-path", str(tmp_path / "out.safetensors"),
        "--include-keys", "attn", "--include-keys", "vae.", "--exclude-keys", "w1o",
        "--device", "cpu"])
    quantized = {k for k, v in out.items() if v.dtype == torch.uint8 and k.endswith("weight")}
    assert quantized == {"model.double_layers.0.attn.w1q.weight", "vae.decoder.conv_in.weight"}


@pytest.mark.parametrize("dtype", ["bfloat16", "fp16", "float32"])
def test_convert_dtype_matches_jax_tool(tmp_path, dtype):
    """Every floating tensor cast, the int64 table left as it is (the JAX
    tool's is int32, equal by value): the same file."""
    src = tmp_path / "model.safetensors"
    weights = _weights()
    weights["model.half"] = torch.ones(3, dtype=torch.bfloat16)
    st.save_file(weights, src)
    jax_convert_dtype.main.main(["--input-path", str(src), "--output-path",
                                 str(tmp_path / "jax.safetensors"), "--dtype", dtype],
                                standalone_mode=False)
    convert_dtype.main(["--input-path", str(src), "--output-path",
                        str(tmp_path / "port.safetensors"), "--dtype", dtype])
    got = _assert_same_files(tmp_path / "port.safetensors", tmp_path / "jax.safetensors",
                             jax_dtypes=True)
    assert got["model.positions"].dtype == torch.int64
    assert got["model.half"].dtype == convert_dtype.DTYPES[dtype]


@pytest.mark.parametrize("wrapped", [True, False], ids=["state_dict", "flat"])
def test_to_safetensors_matches_jax_tool(tmp_path, wrapped):
    """A pickle (wrapped in ``state_dict`` with a non-tensor beside it, or
    flat) to safetensors: the port keeps bf16 where the JAX tool widens it
    to fp32 (and int64 where it narrows to int32); the values are equal and
    every other tensor is the same."""
    tensors = {k: v for k, v in _weights().items()}
    tensors["model.bf16.weight"] = torch.randn(4, 5, generator=torch.Generator().manual_seed(0)
                                               ).to(torch.bfloat16)
    tensors["model.view"] = tensors["model.modF.1.weight"][:, :8]  # shares storage
    payload = {"state_dict": tensors, "epoch": 3} if wrapped else {**tensors, "note": "x"}
    src = tmp_path / "model.ckpt"
    torch.save(payload, src)
    jax_to_safetensors.main.main([str(src), str(tmp_path / "jax.safetensors")],
                                 standalone_mode=False)
    to_safetensors.main([str(src), str(tmp_path / "port.safetensors")])
    got = _assert_same_files(tmp_path / "port.safetensors", tmp_path / "jax.safetensors",
                             jax_dtypes=True)
    assert got["model.bf16.weight"].dtype == torch.bfloat16
    assert torch.equal(got["model.bf16.weight"], tensors["model.bf16.weight"])


def test_snapshot_peak_replays_the_trace(tmp_path, capsys):
    """A synthetic ``_dump_snapshot`` dict: 300 bytes allocated at the end,
    the trace reaching 700 before two frees."""
    snapshot = {
        "segments": [{"device": 0, "blocks": [
            {"size": 300, "state": "active_allocated"}, {"size": 200, "state": "inactive"}]}],
        "device_traces": [[
            {"action": "alloc", "size": 100}, {"action": "alloc", "size": 400},
            {"action": "alloc", "size": 200}, {"action": "free_requested", "size": 400},
            {"action": "free_completed", "size": 400}, {"action": "alloc", "size": 100},
            {"action": "free_completed", "size": 100},
        ]],
    }
    assert snapshot_max_memory.snapshot_peak(snapshot) == {0: 700}
    path = tmp_path / "snap.pickle"
    path.write_bytes(pickle.dumps(snapshot))
    lines = snapshot_max_memory.main(["--snapshot", str(path)])
    assert lines[0]["peak_bytes_in_use"] == 700 and lines[0]["peak_human"] == "700.00 B"
    assert '"peak_bytes_in_use": 700' in capsys.readouterr().out


def test_quantize_model_output_loads_into_the_nf4_path(tmp_path):
    """The tool's NF4 file of a tiny bf16 SDXL checkpoint loads through
    ``SDXLModel`` into the quantized Linears that ``quantize_params`` makes
    of the same weights: the packed codes equal, the code table and the
    absmax as the loader's cast to the model's dtype leaves them (the JAX
    loader casts them the same way), and a request runs."""
    from test_torch_sdxl import _tiny_kwargs

    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.modules.quant import quantize_params
    from vision_ft_tpu_torch.nn import Linear

    config, kwargs = _tiny_kwargs("torch")
    config = config.model_copy(update={"dtype": "bfloat16", "checkpoint_path": str(tmp_path / "q.safetensors")})
    dense = SDXLModel(config, **kwargs)
    dense.init_params(torch.Generator().manual_seed(0))
    st.save_file(dense.state_dict(), tmp_path / "sdxl.safetensors")
    quantize_model.main(["--model-path", str(tmp_path / "sdxl.safetensors"), "--save-path",
                         str(tmp_path / "q.safetensors"), "--device", "cpu",
                         *(a for t in ("attn1", "attn2", ".ff.") for a in ("--include-keys", t))])
    loaded = SDXLModel(config, **kwargs)
    loaded._from_checkpoint("cpu")
    quantize_params(dense.denoiser, "bnb_nf4", ["attn1", "attn2", ".ff."])

    def quantized(model):
        return {n: dict(m.weight.named_buffers()) for n, m in model.denoiser.named_modules()
                if isinstance(m, Linear) and m.is_quantized}

    want, got = quantized(dense), quantized(loaded)
    assert sorted(got) == sorted(want) and len(got) > 50
    for name, leaves in want.items():
        for leaf in ("packed", "split", "_meta"):
            assert torch.equal(got[name][leaf], leaves[leaf]), (name, leaf)
        assert torch.equal(got[name]["code"], leaves["code"].bfloat16().float()), name
        torch.testing.assert_close(got[name]["absmax"], leaves["absmax"], rtol=1e-2, atol=0)
    image = loaded.generate("a cat", width=64, height=64, num_inference_steps=1, cfg_scale=1.0,
                            seed=1)[0]
    assert np.asarray(image).std() > 0
