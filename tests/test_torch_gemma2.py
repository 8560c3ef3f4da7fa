"""The port's Gemma-2 text tower against the JAX package's, on the CPU in
fp32 at a tiny config: the same parameters (the JAX tree, flattened) and
the same token ids through both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.models.text_encoders import gemma2 as jax_gemma2
from vision_ft_tpu.nn import flatten_params, unflatten_params

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.models.text_encoders import gemma2
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU, three layers of O(1) activations: the two packages sum
# the same products in other orders
TOL = 2e-5

SMALL = dict(
    vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, query_pre_attn_scalar=16.0,
)


def _params(config, seed=0):
    """The JAX init with the norm offsets (zeros at init) and the embedding
    drawn anew, so that every parameter matters; as numpy arrays."""
    model = jax_gemma2.Gemma2Model(jax_gemma2.Gemma2Config(**config))
    flat = {k: np.asarray(v) for k, v in flatten_params(model.init(jax.random.PRNGKey(seed))).items()}
    rng = np.random.default_rng(seed)
    for key, value in flat.items():
        if "norm" in key:
            flat[key] = (0.2 * rng.standard_normal(value.shape)).astype(np.float32)
    return model, flat


def _port(config, flat):
    with torch.device("meta"):
        model = gemma2.Gemma2Model(gemma2.Gemma2Config(**config))
    return tnn.load_flat_params(model, flat).eval()


def test_config_defaults_match_jax():
    assert dataclasses.asdict(gemma2.Gemma2Config()) == dataclasses.asdict(jax_gemma2.Gemma2Config())
    assert gemma2.LUMINA2_GEMMA2_CONFIG == gemma2.Gemma2Config()


def test_state_dict_keys_match_jax():
    jax_model, flat = _params(SMALL)
    with torch.device("meta"):
        model = gemma2.Gemma2Model(gemma2.Gemma2Config(**SMALL))
    assert set(model.state_dict()) == set(flat)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in flat.items()
    }


@pytest.mark.parametrize("softcap", [50.0, 2.0, None], ids=["cap50", "cap2", "nocap"])
@pytest.mark.parametrize("window", [4096, 4], ids=["wide_window", "window4"])
@pytest.mark.parametrize("padded", [True, False], ids=["padding_mask", "no_mask"])
def test_forward_matches_jax(softcap, window, padded):
    """Final and penultimate hidden states at the valid positions: tanh
    soft-capping (at 2 the cap really bends the logits), a sliding window
    shorter than the sequence on the even layers, a right-padding mask."""
    config = dict(SMALL, attn_logit_softcapping=softcap, sliding_window=window)
    jax_model, flat = _params(config, seed=1)
    model = _port(config, flat)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (2, 10))
    mask = np.ones((2, 10), np.int32)
    if padded:
        mask[1, 7:] = 0
    want_final, want_penult = jax_model(
        unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
        jnp.asarray(ids), jnp.asarray(mask) if padded else None,
    )
    with torch.no_grad():
        final, penult = model(torch.from_numpy(ids), torch.from_numpy(mask) if padded else None)
    assert final.shape == penult.shape == (2, 10, 32)
    for got, want in ((final, want_final), (penult, want_penult)):
        want = np.asarray(want)
        for row, valid in enumerate(mask.sum(axis=1)):
            np.testing.assert_allclose(
                got[row, :valid].numpy(), want[row, :valid], atol=TOL * np.abs(want).max(), rtol=TOL
            )


def test_window_and_cap_change_the_output():
    """The two options of the comparison above are not inert at this size."""
    _, flat = _params(SMALL, seed=3)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 10)))
    outs = {}
    for name, extra in (("base", {}), ("window", {"sliding_window": 4}),
                        ("cap", {"attn_logit_softcapping": 2.0})):
        with torch.no_grad():
            outs[name] = _port(dict(SMALL, **extra), flat)(ids)[0]
    assert (outs["base"] - outs["window"]).abs().max() > 1e-4
    assert (outs["base"] - outs["cap"]).abs().max() > 1e-4


def test_penultimate_is_the_last_layers_input():
    _, flat = _params(SMALL, seed=5)
    model = _port(SMALL, flat)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 6)))
    with torch.no_grad():
        final, penult = model(ids)
        last = model.layers["2"](penult, None)
        torch.testing.assert_close(model.norm(last), final, rtol=0, atol=0)


def test_norm_offsets_start_at_zero_and_scale_by_one_plus_weight():
    norm = gemma2.Gemma2RMSNorm(8)
    tnn.init_parameters_(norm, torch.Generator().manual_seed(0))
    assert not norm.weight.any()
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    plain = tnn.RMSNorm(8)
    tnn.init_parameters_(plain, torch.Generator().manual_seed(0))
    torch.testing.assert_close(norm(x), plain(x))
    with torch.no_grad():
        norm.weight.fill_(0.5)
    torch.testing.assert_close(norm(x), 1.5 * plain(x))
