"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips without one.
The file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from vision_ft_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_reference,
)
from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# bf16 on the card. Kernel and plain version both take fp32 scores from
# the same bf16 products and cast the softmax weights to bf16 before P·V;
# they differ in where those casts fall (online rescaling) and in the
# bf16 rounding of the output, so a few bf16 ulps of O(1) outputs
BF16_ATTN_TOL = 2e-2
BF16_LN_TOL = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,sk,h,d",
    [(2, 4096, 4096, 10, 64), (2, 988, 988, 20, 64), (1, 300, 77 * 4, 2, 128), (1, 1, 256, 2, 64)],
)
def test_bshd_kernel_matches_plain_on_card(cuda, b, s, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (
        torch.randn(b, n, h * d, device=cuda, generator=g).bfloat16() for n in (s, sk, sk)
    )
    before = flash_attention_bshd.launches
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    assert flash_attention_bshd.launches == before + 1
    plain = flash_attention_bshd_reference(q, k, v, h)
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_ATTN_TOL, rtol=BF16_ATTN_TOL)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float().unflatten(-1, (h, d)), k.float().unflatten(-1, (h, d))
    )
    torch.testing.assert_close(lse, torch.logsumexp(scores * d**-0.5, -1), atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take(cuda):
    q = torch.zeros(1, 256, 4 * 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, q, q, 4)  # head dim 48
    with pytest.raises(ValueError):
        flash_attention_bshd(q.float(), q.float(), q.float(), 3)
    rows_129 = torch.zeros(1, 256, 129, device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError):
        flash_attention_bshd(rows_129, rows_129, rows_129, 2)  # unaligned rows
    w = torch.ones(192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        layer_norm(q[0].float(), w.float())
    with pytest.raises(ValueError):
        layer_norm(torch.zeros(192, 256, device=cuda, dtype=torch.bfloat16).t(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,bias", [(8192, 640, True), (154, 768, True), (154, 1280, False)])
def test_layer_norm_kernel_matches_plain_on_card(cuda, rows, c, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(rows, c, device=cuda, generator=g) * 2 + 0.3).bfloat16()
    weight = (1 + 0.2 * torch.randn(c, device=cuda, generator=g)).bfloat16()
    beta = (0.2 * torch.randn(c, device=cuda, generator=g)).bfloat16() if bias else None
    before = layer_norm.launches
    out = layer_norm(x, weight, beta)
    assert layer_norm.launches == before + 1
    plain = layer_norm_reference(x, weight, beta)
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_LN_TOL, rtol=BF16_LN_TOL)
