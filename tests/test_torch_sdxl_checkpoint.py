"""SDXL single-file checkpoint I/O of the port against the JAX package's
(CPU): the tiny SDXL of tests/test_torch_sdxl.py written by one package's
``state_dict()`` to safetensors and loaded by the other's
``from_checkpoint``, both ways; the key converters and the OpenCLIP qkv
split key for key; the safetensors helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.models.sdxl import util as jax_util
from vision_ft_tpu.models.sdxl.pipeline import SDXLModel as JaxSDXLModel
from vision_ft_tpu.utils import safetensors as jax_st
from vision_ft_tpu.utils import state_dict as jax_state_dict

from vision_ft_tpu_torch.models.sdxl import util
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.utils import safetensors as st
from vision_ft_tpu_torch.utils import state_dict

from test_torch_sdxl import _random_params, _tiny_kwargs
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jax_model():
    config, kwargs = _tiny_kwargs("jax")
    model = JaxSDXLModel(config, **kwargs)
    shapes = {name: jax.eval_shape(getattr(model, name).init, jax.random.key(0))
              for name in ("denoiser", "vae", "text_encoder")}
    model.load_state_dict({k: jnp.asarray(v) for k, v in _random_params(shapes, 3).items()})
    return model


def _port_model(path):
    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config.model_copy(update={"checkpoint_path": str(path)}), **kwargs)
    model._from_checkpoint(device="cpu")
    return model


def test_jax_checkpoint_loads_into_the_port(tmp_path, jax_model):
    """The JAX package's file: every parameter of the port equal to the JAX
    one, and the port's state_dict() gives the file's keys and values back."""
    path = tmp_path / "jax.safetensors"
    written = jax_model.state_dict()
    jax_st.save_file(written, path)
    model = _port_model(path)
    flat = {k: np.asarray(v) for k, v in jnn.flatten_params(jax_model.params).items()}
    own = model.as_module().state_dict()
    assert set(own) == set(flat)
    for key, value in own.items():
        np.testing.assert_array_equal(value.numpy(), flat[key], err_msg=key)
    back = model.state_dict()
    assert set(back) == set(written)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(written[key]), err_msg=key)


def test_port_checkpoint_loads_into_jax(tmp_path, jax_model):
    """The port's file (its state_dict() through its save_file): the JAX
    package's from_checkpoint gives the same parameters, key for key."""
    src = tmp_path / "src.safetensors"
    jax_st.save_file(jax_model.state_dict(), src)
    path = tmp_path / "port.safetensors"
    st.save_file(_port_model(src).state_dict(), path)
    assert sorted(st.read_keys(path)) == sorted(jax_st.read_keys(src))
    config, kwargs = _tiny_kwargs("jax")
    loaded = JaxSDXLModel(config.model_copy(update={"checkpoint_path": str(path)}), **kwargs)
    loaded._from_checkpoint()
    want = jnn.flatten_params(jax_model.params)
    got = jnn.flatten_params(loaded.params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_checkpoint_loads_in_the_model_dtype(tmp_path, jax_model):
    """An fp32 file into a bf16 model: every floating tensor cast on load."""
    path = tmp_path / "jax.safetensors"
    jax_st.save_file(jax_model.state_dict(), path)
    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config.model_copy(update={"checkpoint_path": str(path), "dtype": "bfloat16"}),
                      **kwargs)
    model._from_checkpoint(device="cpu")
    assert {t.dtype for t in model.as_module().state_dict().values()} == {torch.bfloat16}


def test_key_converters_match_jax(jax_model):
    keys = list(jnn.flatten_params(jax_model.params))
    internal = [f"{k}" for k in keys]
    for key in internal:
        original = util.convert_to_original_key(key)
        assert original == jax_util.convert_to_original_key(key)
        assert util.convert_from_original_key(original) == jax_util.convert_from_original_key(original)
        assert util.convert_to_comfy_key(key) == jax_util.convert_to_comfy_key(key)


def test_open_clip_conversion_matches_jax():
    """The qkv split and join, on torch tensors and on numpy arrays."""
    rng = np.random.default_rng(0)
    flat = {
        "transformer.resblocks.0.attn.in_proj_weight": rng.standard_normal((12, 4)).astype(np.float32),
        "transformer.resblocks.0.attn.in_proj_bias": rng.standard_normal((12,)).astype(np.float32),
        "transformer.resblocks.0.ln_1.weight": rng.standard_normal((4,)).astype(np.float32),
        "ln_final.bias": rng.standard_normal((4,)).astype(np.float32),
        "logit_scale": np.ones((), np.float32),
    }
    want = jax_state_dict.convert_open_clip_to_transformers({k: jnp.asarray(v) for k, v in flat.items()})
    for values in (flat, {k: torch.from_numpy(v) for k, v in flat.items()}):
        got = state_dict.convert_open_clip_to_transformers(values)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
        back = state_dict.convert_transformers_to_open_clip(got)
        want_back = jax_state_dict.convert_transformers_to_open_clip(want)
        assert set(back) == set(want_back) == set(flat) - {"logit_scale"}
        for key in want_back:
            np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(want_back[key]))


def test_safetensors_helpers(tmp_path):
    tensors = {"a.weight": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "b.idx": torch.arange(4, dtype=torch.int32)}
    path = tmp_path / "t.safetensors"
    st.save_file(tensors, path, metadata={"format": "pt"})
    assert sorted(st.read_keys(path)) == ["a.weight", "b.idx"]
    loaded = st.load_file(path, dtype=torch.bfloat16)
    assert loaded["a.weight"].dtype == torch.bfloat16 and loaded["b.idx"].dtype == torch.int32
    renamed = st.load_file_with_rename_key_map(path, {"a.": "x."})
    assert sorted(renamed) == ["b.idx", "x.weight"]
    assert torch.equal(renamed["x.weight"], tensors["a.weight"])
    # the JAX package reads what the port writes
    assert np.array_equal(np.asarray(jax_st.load_file(path)["a.weight"]), tensors["a.weight"].numpy())


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_save_file_writes_the_librarys_bytes(tmp_path, metadata):
    """The streaming writer against ``safetensors.torch.save_file``: the
    same file byte for byte over every dtype the port writes, a strided
    view, a 0-d tensor, an empty one and a non-ASCII name."""
    from safetensors.torch import save_file as library_save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "z.weight": torch.randn(3, 5, generator=gen).bfloat16(),
        "a.weight": torch.randn(4, 2, generator=gen),
        "m.half": torch.randn(7, generator=gen).half(),
        "c.idx": torch.arange(5, dtype=torch.int64),
        "b.idx": torch.arange(3, dtype=torch.int32),
        "mask": torch.tensor([True, False, True]),
        "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
        "strided": torch.randn(6, 4, generator=gen)[:, 1],
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
        "é.bias": torch.ones(2),
    }
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    st.save_file(tensors, ours, metadata=metadata)
    library_save_file({k: v.contiguous() for k, v in tensors.items()}, str(theirs), metadata=metadata)
    assert ours.read_bytes() == theirs.read_bytes()
    loaded = st.load_file(ours)
    assert all(torch.equal(loaded[k], v) for k, v in tensors.items())
