"""vision-ft-tpu-torch: the PyTorch/CUDA port of ``vision_ft_tpu``.

The JAX package beside it is the reference. This package mirrors its
paths (``vision_ft_tpu/models/sdxl/denoiser.py`` ->
``vision_ft_tpu_torch/models/sdxl/denoiser.py``) and its flattened
parameter keys, so a ported module loads the JAX module's parameters as
they are (``nn.convert.load_flat_params``).

Design stance:

- ``nn.Module``s and plain functions on tensors, an explicit ``device``
  and explicit ``torch.Generator``s.
- No global backend checks: where a kernel exists, dispatch looks at
  ``tensor.is_cuda``. A CUDA tensor gets the hand-written Hopper kernel
  or an error; the plain PyTorch version beside each kernel serves CPU
  tensors (the tests) only.
- Kernel sources live in ``csrc/`` and are built at first use
  (``ops/_build.py``).

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
