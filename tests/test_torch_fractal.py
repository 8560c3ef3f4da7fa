"""The port's FractalGen modules (``models/fractal``) against the JAX
package's on the same seeded weights (CPU, fp32, the JAX side under
``jax.jit``): state-dict keys, ``predict_mask``, the 5-way shift, the whole
forward with the guiding pixel, the pixel transformer given JAX's labels,
and the masks given JAX's orders and draws. Tolerance 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.models import fractal as jax_fractal
from vision_ft_tpu.nn import flatten_params

from vision_ft_tpu_torch.models import fractal
from vision_ft_tpu_torch.nn import init_parameters_, load_flat_params
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
TINY = dict(patch_size=2, condition_embedding_dim=24, hidden_dim=32, num_blocks=2, num_heads=4,
            in_channels=3, out_channels=3)
B, SIDE = 2, 8  # 16 patches


def _pair(use_guiding_pixel=True):
    jax_model = jax_fractal.FractalMaskedTransformer(**TINY, use_guiding_pixel=use_guiding_pixel)
    params = jax_model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    model = fractal.FractalMaskedTransformer(**TINY, use_guiding_pixel=use_guiding_pixel)
    load_flat_params(model, flat)
    return jax_model, params, model.eval(), flat


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (B, SIDE, SIDE, 3)).astype(np.float32)  # NHWC
    condition = rng.standard_normal((B, 3, TINY["hidden_dim"])).astype(np.float32)
    mask = np.zeros((B, 16), bool)
    mask[0, [1, 5, 7]] = True
    mask[1, [0, 2, 15]] = True
    return image, condition, mask


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), atol=TOL, rtol=TOL, err_msg=msg)


def test_state_dict_keys_and_init():
    """The port's keys are the JAX tree's flattened (the upstream state
    dict's); its seeded init covers every parameter (the mask token at std
    0.02, the heads' separate bias at 0)."""
    jax_model = jax_fractal.FractalMaskedTransformer(**TINY, use_guiding_pixel=True)
    want = set(flatten_params(jax_model.init(jax.random.PRNGKey(0))))
    model = fractal.FractalMaskedTransformer(**TINY, use_guiding_pixel=True)
    assert set(model.state_dict()) == want
    init_parameters_(model, torch.Generator().manual_seed(0))
    assert torch.equal(model.pixel_predictor.red_head.bias, torch.zeros(256))
    assert 0.005 < float(model.mask_token.detach().std()) < 0.05
    plain = fractal.FractalMaskedTransformer(**TINY)
    assert not any(k.startswith(("pixel_predictor.", "guiding_pixel_embedder."))
                   for k in plain.state_dict())


@pytest.mark.parametrize("use_guiding_pixel", [False, True], ids=["plain", "guiding_pixel"])
def test_predict_mask_and_shift_match_jax(use_guiding_pixel):
    jax_model, params, model, _ = _pair(use_guiding_pixel)
    image, condition, mask = _inputs()
    gp = image.mean(axis=(1, 2)) if use_guiding_pixel else None
    j_patches, lh, lw = jax_model.patchify(jnp.asarray(image))
    predict = jax.jit(lambda p, x, m, c, g: jax_model.predict_mask(p, x, m, c, g))
    want = predict(params, j_patches, jnp.asarray(mask), jnp.asarray(condition),
                   None if gp is None else jnp.asarray(gp))
    patches, h, w = model.patchify(torch.from_numpy(image))
    assert (h, w) == (lh, lw) == (4, 4)
    _close(patches, j_patches, "patchify")
    with torch.no_grad():
        got = model.predict_mask(patches, torch.from_numpy(mask), torch.from_numpy(condition),
                                 None if gp is None else torch.from_numpy(gp))
    assert got.shape == (B, 16, TINY["hidden_dim"])
    _close(got, want, "predict_mask")
    shifted = model.get_surrounding_patches(got, h, w)
    assert shifted.shape == (5, B, 16, TINY["hidden_dim"])
    _close(shifted, jax_model.get_surrounding_patches(want, lh, lw), "5-way shift")
    back = model.unpatchify(patches, h, w)
    _close(back, jax_model.unpatchify(j_patches, lh, lw), "unpatchify")
    _close(back, image, "round trip")


# the JAX forward with the guiding pixel hands the (B, S, hidden) condition
# to the pixel transformer, whose condition_proj takes in_channels, and its
# labels are RGB: it runs only with hidden_dim == in_channels == 3
SQUARE = dict(patch_size=2, condition_embedding_dim=3, hidden_dim=3, num_blocks=2, num_heads=1,
              in_channels=3, out_channels=3)


def test_forward_with_the_guiding_pixel_matches_jax():
    """The whole forward where the JAX one runs (hidden width = channels):
    the JAX one draws its dither from the key; the port is given the labels
    that draw makes."""
    jax_model = jax_fractal.FractalMaskedTransformer(**SQUARE, use_guiding_pixel=True)
    params = jax_model.init(jax.random.PRNGKey(2))
    model = fractal.FractalMaskedTransformer(**SQUARE, use_guiding_pixel=True).eval()
    load_flat_params(model, {k: np.asarray(v) for k, v in flatten_params(params).items()})
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (B, SIDE, SIDE, 3)).astype(np.float32)
    condition = rng.standard_normal((B, 3, 3)).astype(np.float32)
    mask = _inputs()[2]
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, x, c, m, k: jax_model(p, x, c, m, k))(
        params, jnp.asarray(image), jnp.asarray(condition), jnp.asarray(mask), key)
    gp = jnp.mean(jnp.asarray(image), axis=(1, 2))
    labels = np.array(jnp.round(gp * 255.0 + 1e-2 * jax.random.normal(key, gp.shape))
                        .astype(jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(condition), torch.from_numpy(mask),
                    pixel_labels=torch.from_numpy(labels))
    _close(got.mask_prediction, want.mask_prediction, "mask_prediction")
    _close(got.surrounding_patches, want.surrounding_patches, "surrounding")
    _close(got.guiding_pixel_loss, want.guiding_pixel_loss, "guiding pixel loss")


def test_forward_branches_of_the_port():
    """At hidden width != channels the guiding-pixel branch fails as the
    JAX forward does; at hidden width = channels it runs with labels drawn
    from a generator; without the guiding pixel the loss is 0."""
    _, _, model, _ = _pair(True)
    image, condition, mask = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(RuntimeError):
        model(image, condition, mask, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        model(image, condition, mask)
    square = fractal.FractalMaskedTransformer(**SQUARE, use_guiding_pixel=True).eval()
    init_parameters_(square, torch.Generator().manual_seed(3))
    with torch.no_grad():
        drawn = square(image, condition[..., :3], mask, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn.guiding_pixel_loss) and float(drawn.guiding_pixel_loss) > 0
    assert drawn.mask_prediction.shape == (B, SIDE * SIDE // 4, SQUARE["hidden_dim"])
    plain = _pair(False)[2]
    with torch.no_grad():
        out = plain(image, condition, mask)
    assert float(out.guiding_pixel_loss) == 0.0


def test_pixel_transformer_given_jax_labels_matches_jax():
    jax_model = jax_fractal.PixelTransformer(channels=3, hidden_dim=32, num_blocks=2, num_heads=4)
    params = jax_model.init(jax.random.PRNGKey(1))
    model = fractal.PixelTransformer(channels=3, hidden_dim=32, num_blocks=2, num_heads=4)
    load_flat_params(model, {k: np.asarray(v) for k, v in flatten_params(params).items()})
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((B, 3, 3)).astype(np.float32)
    gt = rng.integers(0, 256, (B, 3)).astype(np.float32) / 255.0
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, k, c, g: jax_model(p, k, c, g))(params, key, jnp.asarray(cond),
                                                              jnp.asarray(gt))
    with torch.no_grad():
        got = model(torch.from_numpy(cond), torch.from_numpy(gt),
                    labels=torch.from_numpy(np.array(want.labels)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    _close(got.logits, want.logits, "logits")
    # the labels of the same noise, in the port's own rounding
    noise = 1e-2 * np.asarray(jax.random.normal(key, gt.shape))
    np.testing.assert_array_equal(
        fractal.PixelTransformer.labels_of(torch.from_numpy(gt), torch.from_numpy(noise)).numpy(),
        np.asarray(want.labels))


def test_masks_given_jax_orders_and_draws_match_jax():
    """The deterministic part of each generator fed the JAX package's
    orders and draws (k for the uniform one, the truncated-normal z)."""
    s = 16
    orders = jax_fractal.sample_order(jax.random.PRNGKey(0), 4, s)
    patches = jnp.zeros((4, s, 8))
    t_orders = torch.from_numpy(np.array(orders)).long()
    key = jax.random.PRNGKey(1)
    want = jax_fractal.UniformMaskGenerator()(key, patches, orders)
    k = jax.random.randint(key, (4, 1), 1, s + 1)
    got = fractal.UniformMaskGenerator.masks(t_orders, torch.from_numpy(np.array(k)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    generator = jax_fractal.TruncatedNormalMaskGenerator(std=0.25)
    key = jax.random.PRNGKey(2)
    want = generator(key, patches, orders)
    z = jax.random.truncated_normal(key, lower=-4.0, upper=0.0, shape=(4,))
    got = fractal.TruncatedNormalMaskGenerator(std=0.25).masks(t_orders, torch.from_numpy(np.array(z)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_draws_orders_and_masks():
    """The port's own draws: permutations, 1 <= k <= S, rates in [0, 1]
    with mean near 1 - 0.25 sqrt(2 / pi) (about 0.80), reproducible from
    the seed."""
    orders = fractal.sample_order(torch.Generator().manual_seed(0), 64, 16)
    assert all(sorted(row.tolist()) == list(range(16)) for row in orders)
    assert torch.equal(orders, fractal.sample_order(torch.Generator().manual_seed(0), 64, 16))
    counts = fractal.UniformMaskGenerator()(torch.Generator().manual_seed(1), None, orders).sum(1)
    assert ((counts >= 1) & (counts <= 16)).all()
    rates = fractal.TruncatedNormalMaskGenerator(0.25)(
        torch.Generator().manual_seed(2), None, orders).float().mean(1)
    assert 0.7 < float(rates.mean()) < 0.9 and float(rates.min()) >= 0.0
