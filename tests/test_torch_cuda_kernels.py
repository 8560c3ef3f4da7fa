"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips without one.
The file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import ctypes

import pytest
import torch

from vision_ft_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_backward,
    flash_attention_bshd_dkv,
    flash_attention_bshd_dq,
    flash_attention_bshd_backward_reference,
    flash_attention_bshd_delta,
    flash_attention_bshd_reference,
    flash_attention,
    flash_attention_masked,
    flash_attention_masked_backward,
    flash_attention_masked_backward_reference,
    flash_attention_masked_delta,
    flash_attention_masked_dkv,
    flash_attention_masked_dq,
    flash_attention_reference,
    flash_attention_shortk,
    flash_attention_shortk_backward,
    flash_attention_shortk_backward_reference,
    flash_attention_shortk_bwd,
    flash_attention_shortk_reference,
    set_flash_shortk,
)
from vision_ft_tpu_torch.ops.fused_mlp import (
    down_splits, gated_down, gated_down_reference, gated_mlp, gated_mlp_reference, gated_up,
    gated_up_reference, geglu_mlp,
)
from vision_ft_tpu_torch.modules.quant.nf4 import quantize_4bit
from vision_ft_tpu_torch.ops import _build, nf4_matmul as nf4
from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
from vision_ft_tpu_torch.ops import group_norm as group_norm_module
from vision_ft_tpu_torch.ops.group_norm import (
    gn_plan, group_norm, group_norm_backward, group_norm_reference,
)
from vision_ft_tpu_torch.ops import conv3x3 as conv3x3_module
from vision_ft_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_backward, conv3x3_reference
from vision_ft_tpu_torch.tools import partial_block_probe as probe


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
# The backward kernels and the plain backward round P and dS to bf16 at
# the same points and accumulate in fp32; they differ in the exp (exp2 with
# log2 e folded in), in summation order and in the bf16 rounding of each
# output: a few bf16 ulps (2**-8 each) of the output's largest value
BF16_ATTN_BWD_TOL = 2e-2
# The 4-bit matmul kernels and their plain versions dequantize to the same
# bf16 weight and accumulate in fp32; they differ in the order of the fp32
# sums and so in the output's one bf16 rounding. Relative to the output's
# largest value: forward 2e-2, dx 3e-2 (the JAX package's own tolerances
# for the kernels these replace)
NF4_FWD_TOL, NF4_DX_TOL = 2e-2, 3e-2
# The key-masked attention kernel and the fused gated MLP kernel against
# their plain versions: the same bf16 products summed in fp32 in another
# order, the softmax weights (the gated product) and the output rounded to
# bf16 on both sides: a few bf16 ulps of the output's largest value
BF16_MASKED_ATTN_TOL = 2e-2
BF16_FUSED_MLP_TOL = 2e-2
# The key-masked backward kernels and the plain backward round P and dS to
# bf16 at the same points and accumulate in fp32; they differ in the exp
# (exp2 with log2 e folded in), in summation order (dk and dv sum up to 3
# query heads more) and in each output's bf16 rounding: kernel C's limit
BF16_MASKED_BWD_TOL = 2e-2
# The short-K kernels against their plain versions: the forward as kernel
# E (2e-2 of the output's largest value); the backward rounds P and dS to
# bf16 where the plain backward does and sums dk and dv over q in another
# order (partials per block, then in split order): 3e-2
BF16_SHORTK_TOL, BF16_SHORTK_BWD_TOL = 2e-2, 3e-2
# GroupNorm (kernel J) and the 3x3 conv (kernel K) against their plain
# versions: the same fp32 arithmetic summed in another order (partial sums
# in split order; taps and channels in K steps), the output rounded once
# to bf16 on both sides: a bf16 ulp or two of the output's largest value,
# under the JAX conv test's 2e-2; fp32 GroupNorm to fp32 rounding
BF16_GN_TOL, FP32_GN_TOL, BF16_CONV_TOL = 2e-2, 1e-5, 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,sk,h,d",
    [
        (2, 4096, 4096, 10, 64), (2, 988, 988, 20, 64), (1, 300, 77 * 4, 2, 128), (1, 1, 256, 2, 64),
        (2, 333, 200, 3, 64),     # ragged sk < sq: keys past sk in the one 128-key tile
        (2, 520, 1000, 2, 128),   # the other head dim, ragged 64-key tiles
        (1, 129, 129, 2, 64),     # one row in the last 128-row q tile, one key in the last key tile
        (2, 4360, 4360, 12, 256),  # AuraFlow's joint sequence at 1024 px, CFG: two passes over O
        (1, 300, 520, 2, 256),    # D 256, ragged, sq != sk
        (1, 129, 129, 2, 256),
    ],
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
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bshd_kernel_takes_strided_views_on_card(cuda, d):
    """q, k and v as column slices of one wider (B, S, 3 H*D) tensor, its
    batches padded apart: rows 3 H*D apart, read in place through the
    tensor maps' row and batch strides."""
    g = torch.Generator(device=cuda).manual_seed(6)
    b, s, h = 2, 333, 3
    qkv = torch.randn(b, s + 5, 3 * h * d, device=cuda, generator=g).bfloat16()[:, :s]
    q, k, v = qkv.split(h * d, dim=-1)
    assert q.stride(1) == 3 * h * d and q.stride(0) == (s + 5) * 3 * h * d
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    want = flash_attention_bshd_reference(q.contiguous(), k.contiguous(), v.contiguous(), h)
    torch.testing.assert_close(out.float(), want.float(), atol=BF16_ATTN_TOL, rtol=BF16_ATTN_TOL)
    again, again_lse = flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), h,
                                            return_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,sk,h,d", [(2, 4096, 4096, 10, 64), (1, 300, 520, 2, 128), (2, 1000, 1300, 12, 256)]
)
def test_bshd_kernel_reruns_bit_identical_on_card(cuda, b, s, sk, h, d):
    """A fixed order of sums: a rerun gives the same bits, out and lse."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(b, n, h * d, device=cuda, generator=g).bfloat16() for n in (s, sk, sk))
    first, again = (flash_attention_bshd(q, k, v, h, return_lse=True) for _ in range(2))
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_bshd_kernel_rejects_nonpositive_scale_on_card(cuda, scale):
    """The kernel takes its running max on the raw scores, the max of the
    scaled ones only for scale > 0: anything else raises, launching nothing."""
    q = torch.randn(1, 128, 64, device=cuda).bfloat16()
    before = flash_attention_bshd.launches
    with pytest.raises(ValueError, match="scale > 0"):
        flash_attention_bshd(q, q, q, 1, scale=scale)
    assert flash_attention_bshd.launches == before


def _check_bshd_backward(q, k, v, dout, h):
    """Both backward kernels once each on (q, k, v, dout), against the plain
    backward."""
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    before = (flash_attention_bshd_dkv.launches, flash_attention_bshd_dq.launches)
    got = flash_attention_bshd_backward(q, k, v, out, lse, dout, h)
    torch.cuda.synchronize()
    assert (flash_attention_bshd_dkv.launches, flash_attention_bshd_dq.launches) == (
        before[0] + 1, before[1] + 1
    )
    want = flash_attention_bshd_backward_reference(q, k, v, out, lse, dout, h)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.isfinite(x).all(), name
        err = (x.float() - y.float()).abs().max().item()
        assert err <= BF16_ATTN_BWD_TOL * y.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,sk,h,d",
    [
        (4, 4096, 4096, 10, 64),  # SDXL 1024 px, stage 1
        (4, 1024, 1024, 20, 64),  # SDXL 1024 px, stage 2
        (2, 3952, 3952, 10, 64),  # 832x1216 bucket: ragged tiles
        (2, 988, 988, 20, 64),
        (1, 130, 333, 3, 64),     # odd head count, sq != sk, both ragged
        (1, 1, 256, 2, 64),       # a single q row
        (1, 200, 264, 2, 128),    # the other head dim
        (1, 100, 129, 2, 64),     # one key in the last 128-key tile
        (2, 70, 200, 2, 64),      # a nearly empty last key tile
        (1, 65, 256, 2, 64),      # one row in the last 64-row q tile
        (2, 127, 190, 2, 64),     # one row short of a 128-row q tile
        (3, 333, 333, 3, 64),     # each batch's last tiles border the next batch's rows
        (2, 120, 333, 2, 128),    # the other head dim at a ragged sk
        (1, 4360, 4360, 12, 256),  # AuraFlow's joint sequence at 1024 px, batch 1: column halves
        (2, 4360, 4360, 12, 256),  # the shortcut step's batch 2
        (1, 4216, 4216, 12, 256),  # the 832x1216 bucket
        (1, 300, 520, 2, 256),     # D 256, ragged, sq != sk
        (1, 129, 129, 2, 256),     # one row and one key past a 64-row tile
        (1, 1, 256, 2, 256),       # a single q row
    ],
)
def test_bshd_backward_kernels_match_plain_on_card(cuda, b, s, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, dout = (
        torch.randn(b, n, h * d, device=cuda, generator=g).bfloat16() for n in (s, sk, sk, s)
    )
    _check_bshd_backward(q, k, v, dout, h)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bshd_backward_kernels_take_strided_views_on_card(cuda, d):
    """q, k and v as column slices of one wider (B, S, 3 H*D) tensor: rows
    3 H*D apart, read through the tensor maps' row strides in place."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, s, h = 2, 333, 3
    qkv = torch.randn(b, s, 3 * h * d, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.split(h * d, dim=-1)
    assert q.stride(1) == 3 * h * d and not q.is_contiguous()
    dout = torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16()
    _check_bshd_backward(q, k, v, dout, h)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,d", [(4, 1024, 20, 64), (2, 333, 2, 128), (1, 4360, 12, 256), (2, 333, 2, 256)]
)
def test_bshd_backward_kernels_rerun_bit_identical_on_card(cuda, b, s, h, d):
    """No atomics and a fixed order of sums: a rerun gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, dout = (torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16() for _ in range(4))
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    args = (q, k, v, dout, lse, flash_attention_bshd_delta(out, dout, h), h)
    first, again = ((*flash_attention_bshd_dkv(*args), flash_attention_bshd_dq(*args))
                    for _ in range(2))
    for name, x, y in zip(("dk", "dv", "dq"), first, again):
        assert torch.equal(x, y), name


def _wgmma_forms_probe(a, b, n, form):
    fn = _build.cuda_library("flash_attention_bshd_bwd").hopper_wgmma_forms_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d = torch.empty(64, n, device=a.device, dtype=torch.float32)
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, form,
             torch.cuda.current_stream(a.device).cuda_stream)
    assert err == 0, f"CUDA error {err}"
    torch.cuda.synchronize()
    return d


# the probe's forms: shared-memory A and B K-major (d = a b^T), register A
# with B MN-major (d = a b), shared memory with both MN-major (d = a^T b),
# shared-memory A K-major with B MN-major (d = a b)
WGMMA_FORMS = {"ss": 0, "rs": 1, "ss-mn": 2, "ss-b-mn": 3}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,form",
    [(64, "rs"), (96, "rs"), (128, "rs"), (64, "ss"), (80, "ss"), (96, "ss"), (128, "ss"),
     (160, "ss"), (192, "ss"), (64, "ss-mn"), (80, "ss-mn"), (96, "ss-mn"), (128, "ss-mn"),
     (160, "ss-mn"), (192, "ss-mn"), (64, "ss-b-mn")],
    ids=["rs-n64-mn-major", "rs-n96-mn-major", "rs-n128-mn-major", "ss-n64-k-major",
         "ss-n80-k-major", "ss-n96-k-major", "ss-n128-k-major", "ss-n160-k-major",
         "ss-n192-k-major", "ss-n64-mn-major", "ss-n80-mn-major", "ss-n96-mn-major",
         "ss-n128-mn-major", "ss-n160-mn-major", "ss-n192-mn-major", "ss-n64-b-mn-major"])
def test_hopper_wgmma_forms_one_tile_on_card(cuda, n, form):
    """Each wgmma form kernels C, G, H and I take from hopper_gemm.cuh on one
    64 x n product: a 3-D tensor map's TMA load, A from registers through
    acc_to_a_fragments with B read MN-major (desc_sw128_mn, trans-b; at n =
    128 across two boxes, the leading byte offset; at n = 96, kernel G's
    head dim, the first half of the second box, whose last 32 columns TMA
    filled with zeros), the shared-memory m64nNk16 with both operands
    K-major, B one box of n rows (kernel H's scores over 64 to 192 padded
    keys: 80 for SDXL's 77), the same with both operands MN-major through
    the transpose bits, B in 64-column boxes (kernel I's dV^T = dO^T P and
    dK^T = Q^T dS), and with A K-major and B MN-major at n = 64 (kernel I's
    dQ = dS K). Small integers: every product and sum is exact in fp32, so
    the result must equal the float64 product."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-3, 4, (64, 64), device=cuda, generator=g).bfloat16()
    b = torch.randint(-3, 4, (n, 64) if form == "ss" else (64, n), device=cuda,
                      generator=g).bfloat16()
    got = _wgmma_forms_probe(a, b, n, WGMMA_FORMS[form])
    want = {"ss": lambda: a.double() @ b.double().t(), "ss-mn": lambda: a.double().t() @ b.double()}
    assert torch.equal(got.double(), want.get(form, lambda: a.double() @ b.double())())


@pytest.mark.cuda
def test_bshd_autograd_runs_the_kernels_on_card(cuda):
    """autograd through the wrapper: the backward kernels run once each, on
    a gradient that arrives non-contiguous, and agree with autograd through
    the plain forward."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s, h, d = 2, 520, 4, 64
    leaves = [
        torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16().requires_grad_()
        for _ in range(3)
    ]
    weight = torch.randn(s, b, h * d, device=cuda, generator=g).bfloat16().transpose(0, 1)
    wrappers = (flash_attention_bshd, flash_attention_bshd_dkv, flash_attention_bshd_dq)
    before = [w.launches for w in wrappers]
    got = torch.autograd.grad((flash_attention_bshd(*leaves, h) * weight).sum(), leaves)
    assert [w.launches for w in wrappers] == [n + 1 for n in before]
    want = torch.autograd.grad(
        (flash_attention_bshd_reference(*leaves, h) * weight).sum(), leaves
    )
    for x, y in zip(got, want):
        err = (x.float() - y.float()).abs().max().item()
        assert err <= BF16_ATTN_BWD_TOL * y.float().abs().max().item()


@pytest.mark.cuda
def test_bshd_backward_at_head_dim_256_launches_on_card(cuda):
    """At D 256 the backward runs kernel C's two kernels, once each, whether
    asked directly or through autograd, with no plain fallback on the card,
    and agrees with autograd through the plain forward."""
    g = torch.Generator(device=cuda).manual_seed(9)
    leaves = [torch.randn(1, 300, 512, device=cuda, generator=g).bfloat16().requires_grad_()
              for _ in range(3)]
    wrappers = (flash_attention_bshd, flash_attention_bshd_dkv, flash_attention_bshd_dq)
    before = [w.launches for w in wrappers]
    got = torch.autograd.grad(flash_attention_bshd(*leaves, 2).float().sum(), leaves)
    assert [w.launches for w in wrappers] == [n + 1 for n in before]
    want = torch.autograd.grad(flash_attention_bshd_reference(*leaves, 2).float().sum(), leaves)
    for x, y in zip(got, want):
        err = (x.float() - y.float()).abs().max().item()
        assert err <= BF16_ATTN_BWD_TOL * y.float().abs().max().item()
    with torch.no_grad():
        q, k, v = leaves
        out, lse = flash_attention_bshd(q, k, v, 2, return_lse=True)
        before = [w.launches for w in wrappers[1:]]
        flash_attention_bshd_backward(q, k, v, out, lse, torch.ones_like(out), 2)
        assert [w.launches for w in wrappers[1:]] == [n + 1 for n in before]
        with pytest.raises(ValueError, match="backward kernels take"):
            flash_attention_bshd_dkv(q[..., :480], k[..., :480], v[..., :480], out[..., :480],
                                     lse, lse, 2)


@pytest.mark.cuda
def test_backward_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 256, 128, device=cuda, dtype=torch.bfloat16)
    out, lse = flash_attention_bshd(q, q, q, 2, return_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bshd_backward(q, q, q, out, lse.double(), q, 2)
    with pytest.raises(ValueError):
        flash_attention_bshd_backward(q, q, q, out, lse[:, :, :-1], q, 2)
    with pytest.raises(ValueError):
        flash_attention_bshd_backward(q, q, q, out, lse, q.float(), 2)
    with pytest.raises(ValueError):
        flash_attention_bshd_backward(q, q, q, out[:, :-8], lse, q, 2)


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
    with pytest.raises(ValueError):  # rows 80 apart, then 16: no batch and row axis
        layer_norm(torch.zeros(4, 9, 5, 192, device=cuda, dtype=torch.bfloat16)[:, :, 1:4], w)
    with pytest.raises(ValueError):
        layer_norm(torch.zeros(2, 8200, device=cuda, dtype=torch.bfloat16), torch.ones(8200, device=cuda))


# kernel A: the six (rows, C, beta) of chip_smoke.py's LN_SHAPES (the SDXL request's and
# train step's), then one and 7 rows at C = 8 (one vector), 136 (17 vectors: lanes idle)
# and 8192 (4 warps a row), with and without beta
LN_CARD_SHAPES = [(8192, 640, True), (2048, 1280, True), (154, 768, True), (154, 1280, False),
                  (16384, 640, True), (4096, 1280, True)] + [
    (rows, c, bias) for rows in (1, 7) for c in (8, 136, 8192) for bias in (True, False)]


def _ln_inputs(cuda, rows, c, bias, param_dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(rows, c, device=cuda, generator=g) * 2 + 0.3).bfloat16()
    weight = (1 + 0.2 * torch.randn(c, device=cuda, generator=g)).to(param_dtype)
    beta = (0.2 * torch.randn(c, device=cuda, generator=g)).to(param_dtype) if bias else None
    return x, weight, beta


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,bias", LN_CARD_SHAPES)
def test_layer_norm_kernel_matches_plain_on_card(cuda, rows, c, bias):
    x, weight, beta = _ln_inputs(cuda, rows, c, bias)
    before = layer_norm.launches
    out = layer_norm(x, weight, beta)
    assert layer_norm.launches == before + 1
    plain = layer_norm_reference(x, weight, beta)
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_LN_TOL, rtol=BF16_LN_TOL)
    assert torch.equal(layer_norm(x, weight, beta), out), "a rerun differs"


@pytest.mark.cuda
@pytest.mark.parametrize("c", [640, 1280, 136, 8192])
@pytest.mark.parametrize("view", ["batch of row slices", "nhwc slice", "one row axis", "unaligned"])
def test_layer_norm_kernel_takes_strided_leading_axes_on_card(cuda, c, view):
    """x a view whose leading axes fold into a batch axis and a row axis
    (the 16-byte path), or whose rows start off 16 bytes (the scalar path):
    the same values as the plain version on a contiguous copy, y contiguous,
    fp32 gamma and beta, reruns bit-identical."""
    base, weight, beta = _ln_inputs(cuda, 4 * 9 * 5, c + 8, True, torch.float32)
    base = base.view(4, 9, 5, c + 8)
    x = {"batch of row slices": base[:, 2:7, :, :c], "nhwc slice": base[1:3, 2:5, :, 8:],
         "one row axis": base[:, 3, 2, :c], "unaligned": base[:, :, :, 1:c + 1]}[view]
    weight, beta = weight[:c].contiguous(), beta[:c].contiguous()
    out = layer_norm(x, weight, beta)
    assert out.is_contiguous() and out.shape == x.shape
    plain = layer_norm_reference(x.contiguous(), weight, beta)
    torch.testing.assert_close(out.float(), plain.float(), atol=BF16_LN_TOL, rtol=BF16_LN_TOL)
    assert torch.equal(layer_norm(x, weight, beta), out), "a rerun differs"


def _nf4_weight(cuda, n, k, quant_type, split, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(n, k, device=cuda, generator=g) * 0.02
    packed, state = quantize_4bit(w, quant_type)
    if split:
        packed = nf4.to_split_layout(packed, (n, k))
    return packed, state["quant_map"], state["absmax"]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["bnb", "split"])
@pytest.mark.parametrize(
    "m,k,n,quant_type",
    [
        (4096, 1280, 1280, "nf4"),  # aligned
        (2048, 640, 5120, "nf4"),   # aligned, k % 256 != 0
        (908, 2048, 640, "nf4"),    # ragged m (4 x 227 text keys)
        (154, 2048, 1280, "fp4"),   # ragged m (2 x 77), the other codebook; contraction split
        (1, 128, 128, "nf4"),       # a single row, a single tile
        (300, 1280, 1280, "nf4"),   # ragged m: 2 tiles and 44 rows
        (4097, 640, 1280, "fp4"),   # one row past 32 tiles
        (2048, 640, 640, "nf4"),    # n = k = 640: a split-layout dx tile spans both nibble planes
        (64, 640, 2560, "nf4"),     # few rows: dx split in 5 over n
        (4100, 1280, 10240, "nf4"), # forward on 256-row items, the last one ragged
        (2100, 5120, 640, "fp4"),   # dx on 256-row items, the last one ragged
    ],
)
def test_nf4_matmul_kernels_match_plain_on_card(cuda, m, k, n, quant_type, split):
    packed, code, absmax = _nf4_weight(cuda, n, k, quant_type, split)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    dy = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    before = (nf4.nf4_matmul_forward.launches, nf4.nf4_matmul_dx.launches)
    y = nf4.nf4_matmul_forward(x, packed, code, absmax, (n, k), 64, split)
    dx = nf4.nf4_matmul_dx(dy, packed, code, absmax, (n, k), 64, split)
    torch.cuda.synchronize()
    assert (nf4.nf4_matmul_forward.launches, nf4.nf4_matmul_dx.launches) == (
        before[0] + 1, before[1] + 1
    )
    want_y = nf4.nf4_matmul_reference(x, packed, code, absmax, (n, k), 64, split)
    want_dx = nf4.nf4_matmul_dx_reference(dy, packed, code, absmax, (n, k), 64, split)
    for name, got, want, tol in (("y", y, want_y, NF4_FWD_TOL), ("dx", dx, want_dx, NF4_DX_TOL)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16, name
        assert torch.isfinite(got).all(), name
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["bnb", "split"])
@pytest.mark.parametrize("m,k,n", [(300, 1280, 1280), (154, 2048, 1280), (4100, 1280, 10240)],
                         ids=["whole", "parts", "256-row"])
def test_nf4_matmul_kernels_rerun_bit_identical_on_card(cuda, m, k, n, split):
    """No atomics and a fixed order of the fp32 sums, also where the
    contraction is split into parts and on 256-row items: two calls give
    the same bits."""
    packed, code, absmax = _nf4_weight(cuda, n, k, "nf4", split, seed=4)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    dy = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    args = (packed, code, absmax, (n, k), 64, split)
    for fn, a in ((nf4.nf4_matmul_forward, x), (nf4.nf4_matmul_dx, dy)):
        first, again = fn(a, *args), fn(a, *args)
        torch.cuda.synchronize()
        assert torch.equal(first, again), fn.__name__


@pytest.mark.cuda
def test_nf4_wgmma_mn_form_one_tile_on_card(cuda):
    """The wgmma form kernel D's dx takes from hopper_gemm.cuh on one 64 x
    128 product: A (64 x 64) K-major and B (64 x 128, 128 contiguous) read
    MN-major through the transpose bit, both from shared memory
    (wgmma_m64n128k16_mn, desc_sw128_mn over two 64-column boxes). Small
    integers: every product and sum is exact in fp32, so the result must
    equal the float64 product."""
    fn = _build.cuda_library("nf4_matmul").nf4_wgmma_mn_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randint(-3, 4, (64, 64), device=cuda, generator=g).bfloat16()
    b = torch.randint(-3, 4, (64, 128), device=cuda, generator=g).bfloat16()
    d = torch.empty(64, 128, device=cuda, dtype=torch.float32)
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0, f"CUDA error {err}"
    torch.cuda.synchronize()
    assert torch.equal(d.double(), a.double() @ b.double())


@pytest.mark.cuda
def test_nf4_matmul_autograd_runs_the_kernels_on_card(cuda):
    """autograd through the wrapper on a 3-D, non-contiguous input: one
    forward and one dx launch, gradients close to the plain versions'."""
    n, k = 640, 2048
    packed, code, absmax = _nf4_weight(cuda, n, k, "nf4", True, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(227, 4, k, device=cuda, generator=g).bfloat16().transpose(0, 1).requires_grad_()
    weight = torch.randn(4, 227, n, device=cuda, generator=g).bfloat16()
    wrappers = (nf4.nf4_matmul_forward, nf4.nf4_matmul_dx)
    before = [w.launches for w in wrappers]
    y = nf4.nf4_matmul(x, packed, code, absmax, (n, k), split=True)
    got, = torch.autograd.grad((y * weight).sum(), x)
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    want_y = nf4.nf4_matmul_reference(x, packed, code, absmax, (n, k), split=True)
    want, = torch.autograd.grad((want_y * weight).sum(), x)
    for a, b, tol in ((y, want_y, NF4_FWD_TOL), (got, want, NF4_DX_TOL)):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


@pytest.mark.cuda
def test_nf4_matmul_kernels_reject_what_they_cannot_take(cuda):
    n, k = 128, 256
    packed, code, absmax = _nf4_weight(cuda, n, k, "nf4", False)
    x = torch.zeros(8, k, device=cuda, dtype=torch.bfloat16)
    args = (packed, code, absmax, (n, k))
    with pytest.raises(ValueError):
        nf4.nf4_matmul_forward(x.float(), *args)  # wrong dtype
    with pytest.raises(ValueError):
        nf4.nf4_matmul_forward(x, packed.cpu(), code, absmax, (n, k))  # CPU / CUDA mix
    with pytest.raises(ValueError):
        nf4.nf4_matmul_dx(x[:, :n].cpu().cuda().float(), *args)
    with pytest.raises(ValueError):
        nf4.nf4_matmul_forward(x[:, :192].contiguous(), packed[: 128 * 96], code,
                               absmax[: 128 * 3], (128, 192))  # k % 128 != 0
    with pytest.raises(ValueError):
        nf4.nf4_matmul_forward(x, packed[: 96 * 128], code, absmax[: 96 * 4], (96, k))  # n % 128
    with pytest.raises(ValueError):
        nf4.nf4_matmul_forward(x, packed, code, absmax[::2].contiguous(), (n, k), 128)  # blocksize
    with pytest.raises(ValueError):
        nf4.nf4_matmul_forward(x, packed, code, absmax[:-1], (n, k))  # a short absmax


@pytest.mark.cuda
def test_w8a8_linear_is_exact_on_card(cuda):
    """The int8 x int8 -> int32 product on the card (``torch._int_mm`` where
    it takes the shape, else fp64) equals the CPU's int32 matmul."""
    from vision_ft_tpu_torch.nn.core import _w8a8_linear

    g = torch.Generator().manual_seed(0)
    for rows, k, n in [(64, 640, 1280), (8, 640, 1280), (40, 100, 36), (17, 2048, 640)]:
        x = torch.randn(rows, k, generator=g)
        data = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        scale = torch.rand(n, 1, generator=g) + 0.5
        want = _w8a8_linear(x, data, scale)
        got = _w8a8_linear(x.to(cuda), data.to(cuda), scale.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def _key_mask(cuda, kind, b, sk):
    if kind is None:
        return None
    mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
    if kind == "hole":
        for i in range(b):
            mask[i, 5 + 17 * i:min(256, sk // 2)] = False
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,hk,sq,sk,d,kind,causal",
    [
        (2, 24, 8, 4352, 4352, 96, "hole", False),  # the NextDiT's main stack at 1024 px
        (2, 24, 8, 4096, 4096, 96, "ones", False),  # noise refiner
        (2, 24, 8, 256, 256, 96, "hole", False),    # context refiner
        (1, 6, 2, 300, 1000, 96, "hole", False),    # ragged, sq != sk
        (1, 6, 6, 520, 520, 96, None, True),        # causal
        (1, 4, 2, 333, 333, 64, "hole", True),      # causal and masked, ragged
        (1, 4, 1, 1, 256, 128, None, False),        # a single q row, one kv head
    ],
)
def test_masked_kernel_matches_plain_on_card(cuda, b, h, hk, sq, sk, d, kind, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    # (B, S, heads, D) memory seen as (B, H, S, D); v a slice of a wider buffer
    q = torch.randn(b, sq, h, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    k = torch.randn(b, sk, hk, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    wide = torch.randn(b, sk, 2 * hk * d, device=cuda, generator=g).bfloat16()
    v = wide[..., hk * d:].unflatten(-1, (hk, d)).transpose(1, 2)
    mask = _key_mask(cuda, kind, b, sk)
    before = flash_attention_masked.launches
    out, lse = flash_attention_masked(q, k, v, mask, None, causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_masked.launches == before + 1
    assert out.shape == q.shape and out.stride() == q.stride() and out.dtype == torch.bfloat16
    want, want_lse = flash_attention_reference(q, k, v, mask, None, causal, return_lse=True)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_MASKED_ATTN_TOL * want.float().abs().max().item()
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    # the routing sends the same call to the kernel
    routed = flash_attention(q, k, v, None if mask is None else mask[:, None, None, :], None, causal)
    assert flash_attention_masked.launches == before + 2
    assert torch.equal(routed, out)


@pytest.mark.cuda
def test_masked_kernel_gives_the_mean_of_v_for_a_fully_masked_row_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 2, 320, 96, device=cuda, generator=g).bfloat16() for _ in range(3))
    mask = torch.ones(2, 320, dtype=torch.bool, device=cuda)
    mask[1] = False
    out, lse = flash_attention_masked(q, k, v, mask, return_lse=True)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand_as(v[1])
    assert (out[1].float() - mean_v).abs().max().item() <= BF16_MASKED_ATTN_TOL
    assert (lse[1] < -0.99e30).all() and torch.isfinite(lse).all()


@pytest.mark.cuda
def test_routing_keeps_off_the_masked_kernel_what_it_does_not_take_on_card(cuda):
    """Short keys and a full mask take the plain formula (the JAX package's
    gate); what passes the gate and the kernel does not take (fp32, a head
    dim outside the kernel's, unaligned rows) raises, through the routing as
    through the wrapper; a call that wants gradients runs the backward
    kernels."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, 4, 300, 96, device=cuda, generator=g).bfloat16()
    full = torch.rand(1, 1, 300, 300, device=cuda, generator=g) > 0.3
    leaf = q.clone().requires_grad_()
    before = flash_attention_masked.launches
    flash_attention(q[:, :, :77], q[:, :, :77], q[:, :, :77])              # sk < 256
    flash_attention(q, q, q, mask=full)                                    # not a key mask
    flash_attention(leaf, q, q, mask=full).sum().backward()                # plain route keeps gradients
    assert leaf.grad is not None
    for entry in (flash_attention, flash_attention_masked):
        for bad in (
            lambda: entry(q.float(), q.float(), q.float()),
            lambda: entry(q[..., :48], q[..., :48], q[..., :48]),
            lambda: entry(q, q[:, :3], q[:, :3]),
            lambda: entry(q, q[:, :, :299], q[:, :, :299], is_causal=True),
            lambda: entry(q[..., 1:65], q[..., 1:65], q[..., 1:65]),  # unaligned rows
        ):
            with pytest.raises(ValueError):
                bad()
        grads_before = (flash_attention_masked_dkv.launches, flash_attention_masked_dq.launches)
        leaf.grad = None
        entry(leaf, q, q).float().sum().backward()  # a gradient wanted: kernel E, then kernel G
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
        assert (flash_attention_masked_dkv.launches, flash_attention_masked_dq.launches) == (
            grads_before[0] + 1, grads_before[1] + 1)
        with torch.no_grad():
            entry(leaf, q, q)  # no gradient wanted: the forward kernel alone
    with pytest.raises(ValueError):
        flash_attention_masked(q, q, q, torch.ones(1, 300, device=cuda))
    assert flash_attention_masked.launches == before + 4


def _tile_mask(cuda, kind, b, sk):
    """wide_hole: keys [40 + 7 i, 340) of batch entry i masked, whole 64- and
    128-key tiles and partial ones; empty_entry: the same, and the last
    batch entry keeps no key."""
    mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
    for i in range(b):
        mask[i, 40 + 7 * i:min(sk, 340)] = False
    if kind == "empty_entry":
        mask[-1] = False
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,hk,sq,sk,d,kind,causal",
    [
        (2, 6, 2, 333, 461, 96, "wide_hole", False),    # Sq != Sk, ragged tails
        (2, 6, 2, 461, 461, 96, "empty_entry", False),  # entry 1 keeps no key: no skip there
        (2, 4, 4, 300, 700, 64, "wide_hole", False),    # 128-key tiles
        (2, 4, 1, 129, 383, 128, "empty_entry", False),
        (2, 6, 2, 300, 300, 96, "wide_hole", True),     # causal: nothing skipped
        (1, 24, 8, 4352, 4352, 96, "wide_hole", False),  # the main stack's widths
    ],
)
def test_masked_kernel_skips_whole_masked_key_tiles_on_card(cuda, b, h, hk, sq, sk, d, kind,
                                                            causal):
    """Key tiles masked whole are skipped where the batch entry keeps a key
    and nothing is causally masked; the result is the plain version's either
    way, and reruns give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, sq, h, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    k, v = (torch.randn(b, sk, hk, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
            for _ in "kv")
    mask = _tile_mask(cuda, kind, b, sk)
    out, lse = flash_attention_masked(q, k, v, mask, None, causal, return_lse=True)
    again = flash_attention_masked(q, k, v, mask, None, causal, return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    want, want_lse = flash_attention_reference(q, k, v, mask, None, causal, return_lse=True)
    assert _rel_err(out, want) <= BF16_MASKED_ATTN_TOL
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
def test_masked_fully_masked_row_and_its_gradient_on_card(cuda, d):
    """A batch entry that keeps no key gives the mean of v and an lse of
    about -1e30; kernel G, reading that lse, spreads its gradient over all
    keys as the plain backward does, beside an entry whose whole key tiles
    are skipped."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, 4, 400, d, device=cuda, generator=g).bfloat16() for _ in "qkv")
    mask = _tile_mask(cuda, "empty_entry", 2, 400)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention_masked.launches, flash_attention_masked_dq.launches)
    out, lse = flash_attention_masked(*leaves, mask, return_lse=True)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand_as(v[1])
    assert (out[1].float() - mean_v).abs().max().item() <= BF16_MASKED_ATTN_TOL
    assert (lse[1] < -0.99e30).all() and torch.isfinite(lse).all()
    dout = torch.randn(2, 4, 400, d, device=cuda, generator=g).bfloat16()
    got = torch.autograd.grad(out, leaves, dout)
    assert (flash_attention_masked.launches, flash_attention_masked_dq.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_masked_backward_reference(q, k, v, mask, out.detach(), lse.detach(),
                                                     dout)
    for name, got_, want_ in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(got_, want_) <= BF16_MASKED_BWD_TOL, name
        assert _rel_err(got_[1], want_[1]) <= BF16_MASKED_BWD_TOL, name


def _masked_bwd_inputs(cuda, b, h, hk, sq, sk, d, kind, causal, seed=0):
    """q, k, v in the NextDiT's memory layouts (v a slice of a wider
    buffer), the mask, the forward's out and lse, and dO."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, h, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    k = torch.randn(b, sk, hk, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    wide = torch.randn(b, sk, 2 * hk * d, device=cuda, generator=g).bfloat16()
    v = wide[..., hk * d:].unflatten(-1, (hk, d)).transpose(1, 2)
    if kind == "empty_row":
        mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
        mask[-1] = False
    elif kind == "wide_hole":  # whole 64- and 128-key tiles masked, and partial ones
        mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
        for i in range(b):
            mask[i, 40 + 7 * i:min(sk, 340)] = False
    else:
        mask = _key_mask(cuda, kind, b, sk)
    out, lse = flash_attention_masked(q, k, v, mask, None, causal, return_lse=True)
    dout = torch.randn(b, sq, h, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    return q, k, v, mask, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,hk,sq,sk,d,kind,causal",
    [
        (1, 24, 8, 4352, 4352, 96, "hole", False),  # the NextDiT's main stack at 1024 px
        (1, 24, 8, 4096, 4096, 96, "ones", False),  # noise refiner
        (2, 24, 8, 256, 256, 96, "hole", False),    # context refiner
        (1, 6, 2, 300, 1000, 96, "hole", False),    # ragged, sq != sk
        (1, 6, 6, 520, 520, 96, None, True),        # causal
        (1, 4, 2, 333, 333, 64, "hole", True),      # causal and masked, ragged
        (1, 4, 1, 200, 256, 128, None, False),      # one kv head, head dim 128
        (2, 4, 4, 320, 320, 64, "empty_row", False),  # a batch entry with every key masked
        # ragged Sq and Sk (no multiple of 64 or 128) at each head dim and GQA
        # repeats of 1, 3 and 4; holes over whole key tiles and partial ones
        (1, 6, 2, 333, 461, 96, "wide_hole", False),   # repeats 3, key block [128, 256) masked whole
        (2, 8, 2, 450, 200, 96, "wide_hole", False),   # repeats 4, sq > sk, the ragged last block masked whole
        (2, 4, 1, 197, 331, 64, "wide_hole", False),   # repeats 4, D 64
        (1, 3, 3, 129, 383, 128, "wide_hole", False),  # repeats 1, D 128
        (2, 6, 2, 300, 300, 96, "wide_hole", True),    # causal + a hole over whole tiles: nothing skipped
    ],
)
def test_masked_backward_kernels_match_plain_on_card(cuda, b, h, hk, sq, sk, d, kind, causal):
    q, k, v, mask, out, lse, dout = _masked_bwd_inputs(cuda, b, h, hk, sq, sk, d, kind, causal)
    delta = flash_attention_masked_delta(out, dout)
    before = (flash_attention_masked_dkv.launches, flash_attention_masked_dq.launches)
    dk, dv = flash_attention_masked_dkv(q, k, v, mask, dout, lse, delta, None, causal)
    dq = flash_attention_masked_dq(q, k, v, mask, dout, lse, delta, None, causal)
    again = flash_attention_masked_backward(q, k, v, mask, out, lse, dout, None, causal)
    torch.cuda.synchronize()
    assert (flash_attention_masked_dkv.launches, flash_attention_masked_dq.launches) == (
        before[0] + 2, before[1] + 2)
    for got, rerun in zip((dq, dk, dv), again):
        assert torch.equal(got, rerun)  # no atomics: a fixed summation order
    assert dq.shape == q.shape and dq.stride() == q.stride() and dk.stride() == k.stride()
    assert dk.shape == dv.shape == k.shape and dv.dtype == torch.bfloat16
    want = flash_attention_masked_backward_reference(q, k, v, mask, out, lse, dout, None, causal)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= BF16_MASKED_BWD_TOL * ref.float().abs().max().item(), name


@pytest.mark.cuda
def test_masked_autograd_runs_the_backward_kernels_on_card(cuda):
    """Gradients wanted: kernel E forward, kernel G backward, through the
    wrapper and the routing alike; the lse's gradient shifts delta."""
    q, k, v, mask, _, _, dout = _masked_bwd_inputs(cuda, 2, 6, 2, 512, 512, 96, "hole", False, seed=1)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    dlse = torch.randn(2, 6, 512, device=cuda)
    counts = lambda: (flash_attention_masked.launches, flash_attention_masked_dkv.launches,  # noqa: E731
                      flash_attention_masked_dq.launches)
    before = counts()
    out, lse = flash_attention_masked(*leaves, mask, return_lse=True)
    got = torch.autograd.grad((out.float() * dout.float()).sum() + (lse * dlse).sum(), leaves)
    routed = torch.autograd.grad(
        (flash_attention(*leaves, mask[:, None, None, :]).float() * dout.float()).sum(), leaves)
    assert counts() == (before[0] + 2, before[1] + 2, before[2] + 2)
    with torch.no_grad():
        want = flash_attention_masked_backward_reference(q, k, v, mask, out, lse, dout, dlse=dlse)
        want_routed = flash_attention_masked_backward(q, k, v, mask, out, lse, dout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BF16_MASKED_BWD_TOL * w.float().abs().max().item(), name
    for g, w in zip(routed, want_routed):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_masked_backward_rejects_what_it_cannot_take_on_card(cuda):
    q, k, v, mask, out, lse, dout = _masked_bwd_inputs(cuda, 1, 4, 2, 256, 256, 96, "hole", False)
    delta = flash_attention_masked_delta(out, dout)
    for bad in (
        lambda: flash_attention_masked_dq(q.float(), k.float(), v.float(), mask, dout.float(), lse, delta),
        lambda: flash_attention_masked_dq(q, k, v, mask, dout, lse.double(), delta),
        lambda: flash_attention_masked_dq(q, k, v, mask, dout, lse, delta[:, :, :-1]),
        lambda: flash_attention_masked_dkv(q, k, v, mask, dout[:, :, :-1], lse, delta),
        lambda: flash_attention_masked_dkv(q[..., :48], k[..., :48], v[..., :48], mask, dout[..., :48],
                                           lse, delta),
        lambda: flash_attention_masked_dkv(q, k, v, mask.float(), dout, lse, delta),
    ):
        with pytest.raises(ValueError):
            bad()
    # a dO the kernels cannot read in place is copied first, not refused
    odd = torch.empty(1, 4, 256, 104, device=cuda, dtype=torch.bfloat16)[..., 1:97]
    odd.copy_(dout)
    for got, want in zip(flash_attention_masked_backward(q, k, v, mask, out, lse, odd),
                         flash_attention_masked_backward(q, k, v, mask, out, lse, dout)):
        assert torch.equal(got, want)


def _mlp_tensors(cuda, m, c, inner, biases, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, c, device=cuda, generator=g).bfloat16()
    wa, wg = ((torch.randn(inner, c, device=cuda, generator=g) * c**-0.5).bfloat16() for _ in "ag")
    wd = (torch.randn(c, inner, device=cuda, generator=g) * inner**-0.5).bfloat16()
    bs = [(0.1 * torch.randn(n, device=cuda, generator=g)).bfloat16() if biases else None
          for n in (inner, inner, c)]
    return x, wa, wg, wd, bs


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,c,inner,act,biases",
    [
        (8704, 2304, 9216, "silu", False),    # the NextDiT's main stack at 1024 px, CFG
        (512, 2304, 9216, "silu", False),     # context refiner
        (1001, 2304, 9216, "gelu", True),     # ragged rows, biases
        (333, 1280, 5120, "gelu_tanh", True),
        (100, 3072, 8192, "silu", True),      # 12 output tiles of 256: F-down split in 8
        (33, 4096, 512, "silu", False),       # wider than the 3712 the first design's x tile took
        (64, 4096, 8192, "silu", True),       # half a row tile; F-down split in 8
        (129, 2304, 9216, "gelu", False),     # one row into a second row tile
        (1, 128, 256, "silu", False),         # the smallest shape, a single row
    ],
)
def test_fused_mlp_kernel_matches_plain_on_card(cuda, m, c, inner, act, biases):
    x, wa, wg, wd, bs = _mlp_tensors(cuda, m, c, inner, biases)
    before = gated_mlp.launches
    out = gated_mlp(x, wa, wg, wd, *bs, act=act)
    again = gated_mlp(x, wa, wg, wd, *bs, act=act)
    torch.cuda.synchronize()
    assert gated_mlp.launches == before + 2
    assert out.shape == x.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert torch.equal(out, again)  # no atomics: a fixed summation order
    want = gated_mlp_reference(x, wa, wg, wd, *bs, act=act)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_FUSED_MLP_TOL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,c,inner,act,biases",
    [
        (1001, 2304, 9216, "gelu", True),     # ragged rows, biases
        (512, 2304, 9216, "silu", False),     # context refiner: F-down split in 3
        (300, 640, 2560, "gelu_tanh", True),  # 128-wide F-down tiles
    ],
)
def test_fused_mlp_parts_match_plain_on_card(cuda, m, c, inner, act, biases):
    """F-up against its plain version, F-down against its plain version on
    F-up's own output; each counts its own launches, not the whole call's."""
    x, wa, wg, wd, (ba, bg, bd) = _mlp_tensors(cuda, m, c, inner, biases, seed=6)
    before = (gated_up.launches, gated_down.launches, gated_mlp.launches)
    a = gated_up(x, wa, wg, ba, bg, act)
    out = gated_down(a, wd, bd)
    torch.cuda.synchronize()
    assert (gated_up.launches, gated_down.launches, gated_mlp.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert a.shape == (m, inner) and a.dtype == torch.bfloat16
    for got, want in ((a, gated_up_reference(x, wa, wg, ba, bg, act)),
                      (out, gated_down_reference(a, wd, bd))):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_FUSED_MLP_TOL * want.float().abs().max().item()
    # the whole call runs the same two kernels on the same inputs
    assert torch.equal(gated_mlp(x, wa, wg, wd, ba, bg, bd, act=act), out)


@pytest.mark.cuda
def test_fused_mlp_split_path_reruns_bit_identical_on_card(cuda):
    """At the context refiner's 512 rows F-down sums fp32 partials of inner
    in split order: two launches give the same bits, and the same bits as
    the split path's parts."""
    m, c, inner = 512, 2304, 9216
    assert down_splits(m, c, inner, torch.cuda.get_device_properties(cuda).multi_processor_count) > 1
    x, wa, wg, wd, _ = _mlp_tensors(cuda, m, c, inner, False, seed=7)
    first = gated_mlp(x, wa, wg, wd)
    second = gated_mlp(x, wa, wg, wd)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(gated_down(gated_up(x, wa, wg), wd), first)


@pytest.mark.cuda
def test_geglu_kernel_reads_the_fused_weight_in_place_on_card(cuda):
    m, c, inner = 16384, 640, 2560
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, m // 4, c, device=cuda, generator=g).bfloat16()
    w1 = (torch.randn(2 * inner, c, device=cuda, generator=g) * c**-0.5).bfloat16()
    b1 = (0.1 * torch.randn(2 * inner, device=cuda, generator=g)).bfloat16()
    w2 = (torch.randn(c, inner, device=cuda, generator=g) * inner**-0.5).bfloat16()
    b2 = (0.1 * torch.randn(c, device=cuda, generator=g)).bfloat16()
    before = gated_mlp.launches
    out = geglu_mlp(x, w1, b1, w2, b2)
    assert gated_mlp.launches == before + 1 and out.shape == x.shape
    hidden = torch.nn.functional.linear(x.float(), w1.float(), b1.float())
    gated = (hidden[..., :inner] * torch.nn.functional.gelu(hidden[..., inner:], approximate="tanh"))
    want = torch.nn.functional.linear(gated.bfloat16().float(), w2.float(), b2.float())
    err = (out.float() - want).abs().max().item()
    assert err <= BF16_FUSED_MLP_TOL * want.abs().max().item()


@pytest.mark.cuda
def test_fused_mlp_autograd_runs_the_kernel_forward_and_the_plain_backward_on_card(cuda):
    x, wa, wg, wd, _ = _mlp_tensors(cuda, 300, 256, 512, False, seed=4)
    leaves = [t.clone().requires_grad_() for t in (x, wa, wg, wd)]
    before = gated_mlp.launches
    out = gated_mlp(*leaves)
    got = torch.autograd.grad(out.float().square().sum(), leaves)
    assert gated_mlp.launches == before + 1
    plain = [t.clone().requires_grad_() for t in (x, wa, wg, wd)]
    px, pa, pg, pd = plain
    ref = torch.nn.functional.linear(
        torch.nn.functional.silu(torch.nn.functional.linear(px, pa)) * torch.nn.functional.linear(px, pg), pd)
    want = torch.autograd.grad(ref.float().square().sum(), plain)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max().item() <= 5e-2 * b.float().abs().max().item()


@pytest.mark.cuda
def test_fused_mlp_kernel_rejects_what_it_cannot_take_on_card(cuda):
    x, wa, wg, wd, _ = _mlp_tensors(cuda, 8, 256, 512, False, seed=5)
    for bad in (
        lambda: gated_mlp(x.float(), wa.float(), wg.float(), wd.float()),          # dtype
        lambda: gated_mlp(x, wa.cpu(), wg, wd),                                    # CPU / CUDA mix
        lambda: gated_mlp(x[:, :192].contiguous(), wa[:, :192].contiguous(),
                          wg[:, :192].contiguous(), wd[:192].contiguous()),        # c % 128
        lambda: gated_mlp(x, wa[:384], wg[:384], wd[:, :384].contiguous()),        # inner % 256
        lambda: gated_mlp(x, wa.t().contiguous().t(), wg, wd),                     # strides
        lambda: gated_mlp(x, wa, wg, wd, b_act=torch.zeros(3, device=cuda)),       # bias shape
        lambda: gated_mlp(x, wa, wg, wd, act="relu"),
    ):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_lumina2_block_runs_both_kernels_under_the_gate_on_card(cuda):
    """One NextDiT block at full width: kernel E and kernel F launch once
    each under the default gate, kernel F not at all with the fused
    feed-forward off, and both routes agree."""
    from vision_ft_tpu_torch.models.lumina2.denoiser import TransformerBlock
    from vision_ft_tpu_torch.nn import init_parameters_
    from vision_ft_tpu_torch.ops.fused_mlp import set_fused_ff

    with torch.device("meta"):
        block = TransformerBlock(2304, 24, 8)
    block = block.to(torch.bfloat16).to_empty(device=cuda)
    init_parameters_(block, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 512, 2304, device=cuda, generator=g).bfloat16()
    angles = torch.rand(2, 512, 48, device=cuda, generator=g) * 6.28
    freqs = torch.stack([angles.cos(), angles.sin()], dim=-1)
    t_emb = torch.randn(2, 1024, device=cuda, generator=g).bfloat16()
    mask = torch.ones(2, 512, dtype=torch.bool, device=cuda)
    mask[1, 40:256] = False
    before = (flash_attention_masked.launches, gated_mlp.launches)
    with torch.no_grad():
        fused = block(x, freqs, t_emb, mask)
        assert (flash_attention_masked.launches, gated_mlp.launches) == (before[0] + 1, before[1] + 1)
        set_fused_ff("off")
        try:
            plain = block(x, freqs, t_emb, mask)
        finally:
            set_fused_ff("auto")
    assert (flash_attention_masked.launches, gated_mlp.launches) == (before[0] + 2, before[1] + 1)
    assert torch.isfinite(fused).all()
    err = (fused.float() - plain.float()).abs().max().item()
    assert err <= 5e-2 * plain.float().abs().max().item()


def _shortk_inputs(cuda, b, h, sq, sk, d, zero_batch=False, seed=0):
    """q, k, v as SDXL's cross-attention hands them over: (B, H, S, D) views
    of the (B, S, H*D) projections; with ``zero_batch`` the last batch entry's
    q rows are zeros, as padding would be."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, h * d, device=cuda, generator=g).bfloat16()
    if zero_batch:
        q[-1] = 0
    k, v = (torch.randn(b, sk, h * d, device=cuda, generator=g).bfloat16() for _ in range(2))
    heads = lambda t: t.view(b, t.shape[1], h, d).transpose(1, 2)  # noqa: E731
    dout = torch.randn(b, sq, h * d, device=cuda, generator=g).bfloat16()
    return heads(q), heads(k), heads(v), heads(dout)


SHORTK_SHAPES = [
    (2, 10, 4096, 77, 64, False),   # the 1024 px request's 640-wide stage
    (2, 20, 1024, 77, 64, False),   # and its 1280-wide stage
    (2, 10, 3952, 77, 64, False),   # ragged: 832x1216
    (2, 20, 988, 152, 64, False),   # ragged, 150-token prompts
    (4, 10, 4096, 152, 64, False),  # the batch-4 train step
    (1, 4, 300, 192, 64, False),    # SHORTK_MAX keys
    (1, 4, 300, 5, 128, False),     # head dim 128, few keys
    (2, 4, 200, 77, 64, True),      # a batch entry of zero (padding) q rows
    (1, 2, 1, 1, 64, False),        # one q row, one key: 2 work items, fewer than the SMs
    (1, 3, 63, 33, 64, False),      # 33 keys: 31 pad keys in a 64-key box
    (2, 2, 65, 96, 64, False),      # 96 keys, no pad key
    (1, 4, 129, 97, 128, False),    # one row in the last tile; 97 keys at head dim 128
    (2, 5, 3952, 160, 64, False),   # 160 keys, no pad; 620 items over the SMs
    (1, 3, 200, 191, 128, False),   # 191 keys at head dim 128
    (2, 8, 1024, 192, 128, False),  # SHORTK_MAX keys at head dim 128: one K/V buffer
    # the edges of kernel I's plan (shortk_bwd_plan, 132 SMs)
    (2, 10, 1024, 192, 64, False),  # 2.4 items a block: a unit over about 7 blocks
    (8, 40, 100, 77, 64, False),    # 4.8 items a block of 2-tile units: a block over 3 units
    (2, 3, 65, 2, 64, False),       # Sq 65 (one row in the second tile), two keys (one key
                                    # leaves dq = dk = 0, rounding noise on both sides)
    (1, 2, 1, 77, 128, False),      # one q row at head dim 128: two units of one item
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d,zero_batch", SHORTK_SHAPES)
def test_shortk_kernels_match_plain_on_card(cuda, b, h, sq, sk, d, zero_batch):
    q, k, v, dout = _shortk_inputs(cuda, b, h, sq, sk, d, zero_batch)
    before = (flash_attention_shortk.launches, flash_attention_shortk_bwd.launches)
    out, lse = flash_attention_shortk(q, k, v, return_lse=True)
    grads = flash_attention_shortk_backward(q, k, v, out, lse, dout)
    again = flash_attention_shortk_backward(q, k, v, out, lse, dout)
    out2 = flash_attention_shortk(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention_shortk.launches, flash_attention_shortk_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(out, out2)
    for got, rerun in zip(grads, again):
        assert torch.equal(got, rerun)  # no atomics: partials summed in a fixed order
    assert out.stride() == q.stride() and grads[0].stride() == q.stride()
    assert grads[1].stride() == k.stride() and grads[2].stride() == v.stride()
    want, want_lse = flash_attention_shortk_reference(q, k, v, return_lse=True)
    assert (out.float() - want.float()).abs().max().item() <= (
        BF16_SHORTK_TOL * want.float().abs().max().item())
    assert (lse - want_lse).abs().max().item() <= 1e-3 * want_lse.abs().max().item() + 1e-3
    want_grads = flash_attention_shortk_backward_reference(q, k, v, out, lse, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want_grads):
        assert torch.isfinite(got).all(), name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= BF16_SHORTK_BWD_TOL * ref.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_shortk_kernel_reads_views_of_one_fused_tensor_on_card(cuda, d):
    """Kernel H reads q, k and v as strided views of one (B, S, 3*H*D)
    tensor in place, writes out in q's memory order ((B, S, H, D) dense) and
    reruns bit-identical."""
    b, h, s = 2, 3, 300
    g = torch.Generator(device=cuda).manual_seed(4)
    fused = torch.randn(b, s, 3 * h * d, device=cuda, generator=g).bfloat16()
    q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in fused.chunk(3, -1))
    k, v = k[:, :, :77], v[:, :, :77]  # 77 keys: the first rows of the same tensor
    assert not q.is_contiguous() and q.stride() == (s * 3 * h * d, d, 3 * h * d, 1)
    before = flash_attention_shortk.launches
    out = flash_attention_shortk(q, k, v)
    assert flash_attention_shortk.launches == before + 1
    assert out.stride() == torch.empty_like(q).stride() == (s * h * d, d, h * d, 1)
    assert torch.equal(out, flash_attention_shortk(q, k, v))
    want = flash_attention_shortk_reference(q.contiguous(), k.contiguous(), v.contiguous())
    assert (out.float() - want.float()).abs().max().item() <= (
        BF16_SHORTK_TOL * want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("sk,d", [(77, 64), (152, 64), (40, 128)])
def test_shortk_lse_feeds_kernel_i_on_card(cuda, sk, d):
    """Kernel H's lse (natural log, (B, H, Sq)) is the plain version's, and
    kernel I's gradients from it are those from the plain lse."""
    q, k, v, dout = _shortk_inputs(cuda, 2, 4, 1000, sk, d, seed=6)
    out, lse = flash_attention_shortk(q, k, v, return_lse=True)
    want_out, want_lse = flash_attention_shortk_reference(q, k, v, return_lse=True)
    assert lse.shape == (2, 4, 1000) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert (lse - want_lse).abs().max().item() <= 1e-3 * want_lse.abs().max().item() + 1e-3
    got = flash_attention_shortk_backward(q, k, v, out, lse, dout)
    want = flash_attention_shortk_backward(q, k, v, out, want_lse, dout)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        err = (g_.float() - w.float()).abs().max().item()
        assert err <= BF16_SHORTK_BWD_TOL * w.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_shortk_kernel_rejects_nonpositive_scale_on_card(cuda, scale):
    """Kernel H takes its row max on the raw scores, the max of the scaled
    ones only for scale > 0: anything else raises, launching nothing."""
    q, k, v, _ = _shortk_inputs(cuda, 1, 2, 64, 77, 64)
    before = flash_attention_shortk.launches
    with pytest.raises(ValueError, match="scale > 0"):
        flash_attention_shortk(q, k, v, scale=scale)
    assert flash_attention_shortk.launches == before


@pytest.mark.cuda
def test_shortk_routing_and_autograd_on_card(cuda):
    """With the switch on, a 77-key call without mask takes kernel H forward
    and kernel I backward through the routing; a mask, causal masking or
    193 keys keep the plain formula; off, nothing launches."""
    q, k, v, dout = _shortk_inputs(cuda, 2, 4, 256, 77, 64, seed=1)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    counts = lambda: (flash_attention_shortk.launches, flash_attention_shortk_bwd.launches)  # noqa: E731
    before = counts()
    flash_attention(q, k, v)
    assert counts() == before
    set_flash_shortk(True)
    try:
        got = torch.autograd.grad((flash_attention(*leaves).float() * dout.float()).sum(), leaves)
        assert counts() == (before[0] + 1, before[1] + 1)
        flash_attention(q, k, v, mask=torch.ones(2, 1, 1, 77, dtype=torch.bool, device=cuda))
        q2, k2, v2, _ = _shortk_inputs(cuda, 1, 2, 64, 193, 64)
        flash_attention(q2, k2, v2)
        flash_attention(q[..., :77, :], k, v, is_causal=True)
        assert counts() == (before[0] + 1, before[1] + 1)
    finally:
        set_flash_shortk(False)
    with torch.no_grad():
        out, lse = flash_attention_shortk(q, k, v, return_lse=True)
        want = flash_attention_shortk_backward(q, k, v, out, lse, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_shortk_kernels_reject_what_they_cannot_take_on_card(cuda):
    q, k, v, dout = _shortk_inputs(cuda, 1, 2, 64, 77, 64)
    q96 = torch.randn(1, 2, 64, 96, device=cuda).bfloat16()
    k96 = torch.randn(1, 2, 77, 96, device=cuda).bfloat16()
    lse = torch.zeros(1, 2, 64, device=cuda)
    for bad in (
        lambda: flash_attention_shortk(q96, k96, k96),                    # head dim 96
        lambda: flash_attention_shortk(q.float(), k.float(), v.float()),  # fp32
        lambda: flash_attention_shortk(q, *_shortk_inputs(cuda, 1, 2, 64, 193, 64)[1:3]),
        lambda: flash_attention_shortk_bwd(q96, k96, k96, q96, lse, lse),
    ):
        with pytest.raises(ValueError):
            bad()


def _rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).abs().max() / want.abs().max()).item()


def _gn_inputs(cuda, shape, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    gamma = (1 + 0.1 * torch.randn(c, device=cuda, generator=g)).to(dtype)
    beta = (0.1 * torch.randn(c, device=cuda, generator=g)).to(dtype)
    return x, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups,dtype", [
    ((2, 8, 8, 320), 32, torch.bfloat16),
    ((1, 24, 96), 32, torch.bfloat16),  # S = 24 < a row step, C = 96 in 32-wide blocks
    ((3, 5, 8, 48), 16, torch.bfloat16),  # S = 40, odd H
    ((2, 1, 8, 24), 8, torch.bfloat16),  # C = 24: a masked 32-wide channel block
    ((2, 16, 16, 64), 32, torch.float32),
    ((1, 4096, 128), 32, torch.bfloat16),  # several parts of S
])
def test_group_norm_kernel_matches_plain_on_card(cuda, shape, groups, dtype, act):
    x, gamma, beta = _gn_inputs(cuda, shape, dtype)
    before = group_norm.launches
    got = group_norm(x, gamma, beta, groups, 1e-5, act)
    assert group_norm.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    want = group_norm_reference(x, gamma, beta, groups, 1e-5, act)
    tol = BF16_GN_TOL if dtype == torch.bfloat16 else FP32_GN_TOL
    assert _rel_err(got, want) < tol
    assert torch.equal(got, group_norm(x, gamma, beta, groups, 1e-5, act))  # reruns


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups,dtype,rounds", [
    ((2, 128, 128, 320), 32, torch.bfloat16, 1),    # the UNet at 1024 px: 21 MB
    ((4, 128, 128, 320), 32, torch.bfloat16, 1),    # batch 4: 42 MB
    ((2, 64, 64, 320), 32, torch.float32, 1),
    ((2, 128, 128, 320), 32, torch.float32, 1),
    ((2, 16, 16, 128), 32, torch.bfloat16, 1),      # C / G = 4
    ((1, 32, 32, 2560), 32, torch.bfloat16, 1),     # C / G = 80
    ((2, 8, 8, 96), 24, torch.float32, 1),          # C 96, C / G = 4
    ((1, 256, 256, 512), 32, torch.bfloat16, 1),    # the VAE's 256 x 256 stage
    ((200, 8, 8, 64), 32, torch.bfloat16, 2),       # more batch entries than SMs: rounds
    ((2, 8, 8, 12), 4, torch.bfloat16, 1),          # 24-byte rows: 8-byte vectors
    ((2, 8, 8, 6), 3, torch.float32, 1),            # 24-byte rows, fp32
])
def test_group_norm_kernel_across_sizes_and_rounds_on_card(cuda, shape, groups, dtype, rounds,
                                                           act):
    """Kernel J from a few rows to the VAE's 67 MB, bf16 and fp32, in one
    round of items or several: one launch, the plain version's values,
    reruns bit-identical."""
    x, gamma, beta = _gn_inputs(cuda, shape, dtype, seed=3)
    b, c = shape[0], shape[-1]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gn_plan(b, x.numel() // (b * c), c, groups, x.element_size(), sms)
    assert -(-b * plan.parts // plan.blocks) == rounds
    before = group_norm.launches
    got = group_norm(x, gamma, beta, groups, 1e-5, act)
    assert group_norm.launches == before + 1
    want = group_norm_reference(x, gamma, beta, groups, 1e-5, act)
    tol = BF16_GN_TOL if dtype == torch.bfloat16 else FP32_GN_TOL
    assert _rel_err(got, want) < tol
    assert torch.equal(got, group_norm(x, gamma, beta, groups, 1e-5, act))  # reruns


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid too large", "parts in rounds"])
def test_group_norm_kernel_raises_on_a_grid_that_cannot_be_resident_on_card(cuda, case):
    """The cooperative launch refuses a grid larger than the card holds at
    once, and the C entry a plan that runs a batch entry's parts in
    separate rounds (a block would combine partials not yet written); the
    wrapper raises, and nothing falls back."""
    x, gamma, beta = _gn_inputs(cuda, (2, 8, 8, 64), torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gn_plan(2, 64, 64, 8, 2, sms)
    assert plan.parts > 1
    plan = plan._replace(blocks=64 * sms if case == "grid too large" else plan.parts)
    before = group_norm.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        group_norm_module._launch(x, gamma, beta, 8, 1e-5, None, plan)
    assert group_norm.launches == before


@pytest.mark.cuda
def test_group_norm_autograd_runs_the_kernels_and_the_plain_backward_on_card(cuda):
    x, gamma, beta = _gn_inputs(cuda, (2, 8, 8, 64), torch.bfloat16)
    dy = torch.randn_like(x)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    before = group_norm.launches
    out = group_norm(*leaves, 8, 1e-6, "silu")
    assert group_norm.launches == before + 1
    out.backward(dy)
    want = group_norm_backward(x, gamma, beta, dy, 8, 1e-6, "silu")
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
def test_group_norm_kernels_reject_what_they_cannot_take_on_card(cuda):
    x, gamma, beta = _gn_inputs(cuda, (2, 8, 8, 64), torch.bfloat16)
    for bad in (
        lambda: group_norm(x.half(), gamma, beta, 8, 1e-5),  # fp16
        lambda: group_norm(x.transpose(1, 2), gamma, beta, 8, 1e-5),  # not contiguous
        lambda: group_norm(x[:, :3, :4].contiguous(), gamma, beta, 8, 1e-5),  # S = 12
        lambda: group_norm(x, gamma, beta, 7, 1e-5),  # C % groups
        lambda: group_norm(x.reshape(128, 64), gamma, beta, 8, 1e-5),  # rank 2
        lambda: group_norm(x, gamma, beta, 8, 1e-5, "gelu"),
        lambda: group_norm(x, gamma[:32], beta, 8, 1e-5),
    ):
        with pytest.raises(ValueError):
            bad()


def _conv_inputs(cuda, shape, co, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, device=cuda, generator=g).bfloat16()
    w = (torch.randn(co, shape[-1], 3, 3, device=cuda, generator=g)
         / (3 * shape[-1] ** 0.5)).bfloat16()
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co", [
    ((1, 9, 9, 16), 32),  # odd H and W, C at the 16-wide step's minimum
    ((2, 5, 1, 32), 16),  # W = 1
    ((1, 1, 1, 16), 8),  # one pixel
    ((2, 33, 17, 48), 24),  # C = 48: the last 16 channels of a 64-channel step are TMA's zeros
    ((2, 64, 64, 64), 136),  # pixel tiles over two image rows; CO past one 128 tile
    ((1, 3, 130, 16), 8),  # a tile that ends inside a row
    ((2, 16, 16, 320), 320),  # SDXL's first-stage widths
])
def test_conv3x3_kernel_matches_plain_on_card(cuda, shape, co):
    x, w = _conv_inputs(cuda, shape, co)
    before = conv3x3.launches
    got = conv3x3(x, w)
    assert conv3x3.launches == before + 1
    assert got.shape == (*shape[:3], co) and got.dtype == torch.bfloat16
    assert _rel_err(got, conv3x3_reference(x, w)) < BF16_CONV_TOL
    assert torch.equal(got, conv3x3(x, w))  # reruns


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co,split", [
    ((2, 26, 38, 1280), 1280, False),  # the 832x1216 bucket's third stage: 8 x 16 boxes
    ((2, 52, 76, 640), 640, False),  # its second stage: 16 x 8 boxes
    ((2, 104, 152, 320), 320, False),  # its first stage: 32 x 4 boxes, 160-channel tiles
    ((1, 7, 150, 64), 72, False),  # 32 x 4 boxes overhang W and H; CO inside one tile
    ((2, 32, 32, 640), 640, True),  # 64 tiles of 160 channels: K in parts, fp32 partials
    ((1, 16, 16, 1280), 1280, True),
    ((2, 32, 32, 1280), 1280, False),  # 128 tiles of 160 channels
    ((2, 32, 32, 2560), 1280, False),
])
def test_conv3x3_kernel_ragged_and_split_paths_on_card(cuda, shape, co, split):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (conv3x3_module.conv_plan(shape, co, sms)[2] > 1) is split
    x, w = _conv_inputs(cuda, shape, co, seed=1)
    got = conv3x3(x, w)
    assert got.shape == (*shape[:3], co)
    assert _rel_err(got, conv3x3_reference(x, w)) < BF16_CONV_TOL
    assert torch.equal(got, conv3x3(x, w))  # reruns: partials summed in split order


@pytest.mark.cuda
def test_conv3x3_autograd_runs_the_kernel_and_the_plain_backward_on_card(cuda):
    x, w = _conv_inputs(cuda, (2, 9, 7, 32), 16)
    dy = torch.randn(2, 9, 7, 16, device=cuda).bfloat16()
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = conv3x3.launches
    conv3x3(xl, wl).backward(dy)
    assert conv3x3.launches == before + 1
    dx, dw = conv3x3_backward(x, w, dy)
    assert torch.equal(xl.grad, dx) and torch.equal(wl.grad, dw)


@pytest.mark.cuda
def test_conv3x3_kernel_rejects_what_it_cannot_take_on_card(cuda):
    x, w = _conv_inputs(cuda, (1, 8, 8, 32), 16)
    for bad in (
        lambda: conv3x3(x.float(), w),  # fp32
        lambda: conv3x3(x.transpose(1, 2), w),  # not contiguous
        lambda: conv3x3(x[..., :8].contiguous(), w[:, :8]),  # C = 8
        lambda: conv3x3(x, w[:12]),  # CO = 12
        lambda: conv3x3(x, w[:, :16]),  # w's C is not x's
    ):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_partial_block_probe_passes_on_card(cuda):
    kernels = (probe.partial_block_copy, probe.partial_block_lastaxis, probe.partial_block_tma)
    before = tuple(k.launches for k in kernels)
    result = probe.run("cuda")
    assert result["partial_blocks"], result
    assert tuple(k.launches for k in kernels) == (before[0] + 3, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(1, 64), (8, 128), (127, 256), (128, 64), (129, 192), (4360, 256)])
def test_partial_block_tma_zero_fills_and_clips_on_card(cuda, s, c):
    """TMA with 128-byte swizzle, kernel F's mode: boxes past S stage
    zeros, stores through a map of S rows write nothing past S, and every
    element sits where the swizzle formula puts it."""
    x = torch.randn(s, c, device=cuda).bfloat16()
    out = torch.full((s + probe.TMA_BOX[0], c), probe.SENTINEL, device=cuda, dtype=torch.bfloat16)
    counts = probe.partial_block_tma(x, out)
    torch.cuda.synchronize()
    assert torch.equal(out[:s], x) and (out[s:] == probe.SENTINEL).all()
    assert counts.shape == (-(-s // 128) * (c // 64), 2) and int(counts.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("s,block", [(1, 512), (513, 512), (7, 2), (100, 64)])
def test_partial_block_kernels_mask_ragged_tiles_on_card(cuda, s, block):
    x = torch.randn(s, 8, device=cuda).bfloat16()  # 16 bytes a row
    out = torch.full((s + block, 8), probe.SENTINEL, device=cuda, dtype=torch.bfloat16)
    overhang = probe.partial_block_copy(x, block, out)
    assert torch.equal(out[:s], x) and (out[s:] == probe.SENTINEL).all()
    assert int(overhang.sum()) == 0
    y = torch.randn(3, s, device=cuda)  # columns: element-granular, any S
    out = torch.full((3 * s + block,), probe.SENTINEL, device=cuda)
    overhang = probe.partial_block_lastaxis(y, block, out)
    assert torch.equal(out[: 3 * s].view(3, s), y * 2 + 1)
    assert (out[3 * s:] == probe.SENTINEL).all() and int(overhang.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 512, 1219, 4360, 4608])
@pytest.mark.parametrize("case", ["copy-bf16", "copy-f32", "lastaxis", "tma"])
def test_partial_block_kernels_at_the_probe_widths_on_card(cuda, s, case):
    """Kernel L at the probe's widths: a 512-row tile is a cluster of 16
    CTAs of 32 rows, and the last-axis case's 8 rows a cluster of 8 CTAs, so
    at S = 1, 63 and 4360 the last cluster has CTAs wholly past S, which
    still stage zeros and count them; S = 512 and 4608 leave no overhang. The counts equal the plain version's, the copy is exact,
    nothing lands past S, and a rerun gives the same counts."""
    g = torch.Generator(device=cuda).manual_seed(s)
    if case == "lastaxis":
        x = torch.randn(8, s, device=cuda, generator=g)
        out = torch.full((8 * s + 512,), probe.SENTINEL, device=cuda)
        run = lambda o: probe.partial_block_lastaxis(x, 512, o)  # noqa: E731
        plain = lambda o: probe.partial_block_lastaxis_reference(x, 512, o)  # noqa: E731
        want = x * 2 + 1
    else:
        dtype = torch.float32 if case == "copy-f32" else torch.bfloat16
        x = torch.randn(s, 256, device=cuda, generator=g).to(dtype)
        out = torch.full((s + 512, 256), probe.SENTINEL, device=cuda, dtype=dtype)
        if case == "tma":
            run, plain = (lambda o: probe.partial_block_tma(x, o)), (
                lambda o: probe.partial_block_tma_reference(x, o))
        else:
            run = lambda o: probe.partial_block_copy(x, 512, o)  # noqa: E731
            plain = lambda o: probe.partial_block_copy_reference(x, 512, o)  # noqa: E731
        want = x
    counts = run(out)
    torch.cuda.synchronize()
    assert torch.equal(counts, plain(torch.full_like(out, probe.SENTINEL)))
    assert torch.equal(out.view(-1)[: x.numel()].view(x.shape), want)
    assert (out.view(-1)[x.numel():] == probe.SENTINEL).all()
    assert torch.equal(run(out), counts)


@pytest.mark.cuda
def test_partial_block_kernels_reject_what_they_cannot_take_on_card(cuda):
    x = torch.randn(16, 8, device=cuda)
    out = torch.empty(16 * 8 + 64, device=cuda)
    for bad in (
        lambda: probe.partial_block_copy(x[:, :3].contiguous(), 4, out),  # 12 bytes a row
        lambda: probe.partial_block_copy(x, 4, out[:8]),  # out too short
        lambda: probe.partial_block_lastaxis(x.bfloat16(), 4, out.bfloat16()),  # not fp32
        lambda: probe.partial_block_lastaxis(x, 4096, out),  # a tile past 48 KB
        lambda: probe.partial_block_tma(x.bfloat16(), out.bfloat16()),  # C = 8: not whole boxes
        lambda: probe.partial_block_tma(x.repeat(1, 8), out.repeat(8)),  # fp32
    ):
        with pytest.raises(ValueError):
            bad()


class _WordTokenizer:
    """A tokenizer's call for the tests: each word an id from its letters
    (3 and up), then </s> (1), padded with 0 to ``max_length``."""

    def __call__(self, prompts, max_length, padding="max_length", truncation=True):
        ids, masks = [], []
        for prompt in prompts:
            words = [3 + sum(map(ord, w)) % 1000 for w in prompt.split()][: max_length - 1] + [1]
            ids.append(words + [0] * (max_length - len(words)))
            masks.append([1] * len(words) + [0] * (max_length - len(words)))
        return {"input_ids": ids, "attention_mask": masks}


@pytest.mark.cuda
def test_shortcut_generate_at_reduced_depth_matches_plain_on_card(cuda, monkeypatch):
    """The preview of a shortcut-trained AuraFlow: AuraFlowForShortcut.generate
    (Euler steps of 1 / n, each with that shortcut duration, CFG) at full
    width, 1 double + 2 single layers and 2 UMT5 layers, bf16, seeded random
    weights with the zero-init leaves drawn anew: kernels B (D 256) and F
    launched as the layers give them, and the final latents against the same
    request on their plain versions, within 5e-2 of their largest value
    (bf16 through four guided steps, every layer's few-ulp differences
    carried on; the tolerance of chip_smoke.py's AuraFlow denoise step)."""
    import vision_ft_tpu_torch.ops.fused_mlp as mlp_module
    from vision_ft_tpu_torch.models.auraflow.config import DenoiserConfig
    from vision_ft_tpu_torch.models.auraflow.train_shortcut import (
        AuraFlowForShortcut, AuraFlowForShortcutConfig,
    )
    from vision_ft_tpu_torch.models.text_encoders.umt5 import UMT5Config
    from vision_ft_tpu_torch.ops import flash_attention as flash_module

    depth = dict(num_double_layers=1, num_single_layers=2)
    model = AuraFlowForShortcut(
        AuraFlowForShortcutConfig(checkpoint_path="", dtype="bfloat16", denoiser=DenoiserConfig(**depth)),
        tokenizer=_WordTokenizer(), text_encoder_config=UMT5Config(num_layers=2))
    model.init_params(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for p in model.denoiser.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
    latents = []
    monkeypatch.setattr(model, "decode_image", lambda z: latents.append(z.float().clone()) or [])
    request = dict(prompt="a photo of a cat", negative_prompt="blurry", width=512, height=512,
                   num_inference_steps=4, cfg_scale=4.0, seed=1)
    wrappers = (flash_attention_bshd, gated_mlp)
    before = [w.launches for w in wrappers]
    model.generate(**request)
    steps, layers = request["num_inference_steps"], sum(depth.values())
    assert [w.launches - n for w, n in zip(wrappers, before)] == [
        steps * layers, steps * (2 * depth["num_double_layers"] + depth["num_single_layers"])]

    def plain_forward(q, k, v, num_heads, scale, return_lse):
        out = flash_attention_bshd_reference(q, k, v, num_heads, scale, return_lse=return_lse)
        return out if return_lse else (out, None)

    monkeypatch.setattr(flash_module, "_forward", plain_forward)
    monkeypatch.setattr(mlp_module, "_forward", lambda x2, wa, ba, wg, bg, wd, bd, act: (
        gated_mlp_reference(x2, wa, wg, wd, ba, bg, bd, act)))
    before = [w.launches for w in wrappers]
    model.generate(**request)
    assert [w.launches for w in wrappers] == before
    got, want = latents
    assert got.shape == (1, 64, 64, 4) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err


# -- the serving pool's shapes: 4 CFG slots are batch 8 on the denoisers ------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,d",
    [(8, 4096, 10, 64), (8, 1024, 20, 64),  # the UNet's two transformer stages at 1024 px
     (8, 4360, 12, 256)],                   # the MMDiT's joint sequence at 1024 px
)
def test_bshd_kernel_at_the_pool_batch_on_card(cuda, b, s, h, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16() for _ in "qkv")
    before = flash_attention_bshd.launches
    out = flash_attention_bshd(q, k, v, h)
    assert flash_attention_bshd.launches == before + 1
    want = flash_attention_bshd_reference(q, k, v, h)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_ATTN_TOL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(8 * 4096, 640), (8 * 1024, 1280)])
def test_layer_norm_kernel_at_the_pool_batch_on_card(cuda, rows, c):
    x, weight, beta = _ln_inputs(cuda, rows, c, True, seed=3)
    before = layer_norm.launches
    out = layer_norm(x, weight, beta)
    assert layer_norm.launches == before + 1
    want = layer_norm_reference(x, weight, beta)
    torch.testing.assert_close(out.float(), want.float(), atol=BF16_LN_TOL, rtol=BF16_LN_TOL)


@pytest.mark.cuda
def test_masked_kernel_at_the_pool_batch_on_card(cuda):
    """The NextDiT's main stack at 1024 px for 4 CFG slots: captions padded
    to 256 with holes, then 4096 image tokens."""
    b, h, hk, s, d = 8, 24, 8, 4352, 96
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
    k, v = (torch.randn(b, s, hk, d, device=cuda, generator=g).bfloat16().transpose(1, 2)
            for _ in "kv")
    mask = _key_mask(cuda, "hole", b, s)
    before = flash_attention_masked.launches
    out = flash_attention_masked(q, k, v, mask, None, False)
    assert flash_attention_masked.launches == before + 1
    want = flash_attention_reference(q, k, v, mask, None, False)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_MASKED_ATTN_TOL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,inner", [(8 * 4352, 2304, 9216),   # the NextDiT's joint tokens
                                       (8 * 4360, 3072, 8192)])  # the MMDiT's single layers
def test_fused_mlp_kernel_at_the_pool_batch_on_card(cuda, m, c, inner):
    x, wa, wg, wd, bs = _mlp_tensors(cuda, m, c, inner, False, seed=3)
    before = gated_mlp.launches
    out = gated_mlp(x, wa, wg, wd, *bs, act="silu")
    assert gated_mlp.launches == before + 1
    want = gated_mlp_reference(x, wa, wg, wd, *bs, act="silu")
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_FUSED_MLP_TOL * want.float().abs().max().item()


# -- Flux: kernel B at head dim 128 on its first model path ------------------------------

FLUX_ATTN_SHAPES = [  # (B, S, H, D): 512 T5 tokens before the image's 2x2 patches
    (1, 4608, 24, 128),  # 1024 px
    (2, 4608, 24, 128),  # 1024 px under CFG
    (8, 4608, 24, 128),  # a pool of 4 slots
    (1, 2816, 24, 128),  # 768 px
    (1, 4464, 24, 128),  # the 832x1216 bucket: ragged tiles
    (1, 300, 24, 128),   # just past the 256-key gate
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", FLUX_ATTN_SHAPES)
def test_bshd_kernel_at_flux_shapes_on_card(cuda, b, s, h, d):
    """One launch a call, out and lse against the plain version, a rerun
    bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(28)
    q, k, v = (torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16() for _ in "qkv")
    before = flash_attention_bshd.launches
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    assert flash_attention_bshd.launches == before + 1
    want, want_lse = flash_attention_bshd_reference(q, k, v, h, return_lse=True)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_ATTN_TOL * want.float().abs().max().item(), err
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    again, again_lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4608, 300])
def test_bshd_kernel_takes_flux_single_block_views_on_card(cuda, s):
    """A single block's v is a view of its fused linear1 output (B, S, 3 H*D
    + MLP): rows 3 * 3072 + 12288 = 21504 apart, read in place."""
    g = torch.Generator(device=cuda).manual_seed(29)
    b, h, d, mlp = 2, 24, 128, 12288
    fused = torch.randn(b, s, 3 * h * d + mlp, device=cuda, generator=g).bfloat16()
    q, k, v = (fused[..., i * h * d:(i + 1) * h * d] for i in range(3))
    assert v.stride(1) == 3 * h * d + mlp
    before = flash_attention_bshd.launches
    out = flash_attention_bshd(q, k, v, h)
    assert flash_attention_bshd.launches == before + 1
    want = flash_attention_bshd_reference(q.contiguous(), k.contiguous(), v.contiguous(), h)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_ATTN_TOL * want.float().abs().max().item(), err
    assert torch.equal(out, flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), h))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flux1-dev", "flux1-schnell", "flex1-alpha"])
def test_flux_forward_at_reduced_depth_matches_plain_on_card(cuda, monkeypatch, kind):
    """The Flux denoiser at full width (hidden 3072, 24 heads of 128, MLP
    12288), 1 double + 2 single blocks, bf16, seeded random weights, at
    1024 px under CFG (batch 2, 512 + 4096 tokens): kernel B once a block,
    and the velocity against the same forward on B's plain version within
    5e-2 of its largest value (chip_smoke.py's FLUX_STEP_TOL)."""
    from vision_ft_tpu_torch.models.flux import config as flux_config
    from vision_ft_tpu_torch.models.flux.denoiser import Denoiser as FluxDenoiser
    from vision_ft_tpu_torch.nn import init_parameters_
    from vision_ft_tpu_torch.ops import flash_attention as flash_module

    cls = {"flux1-dev": flux_config.Flux1DevDenoiserConfig,
           "flux1-schnell": flux_config.Flux1SchnellDenoiserConfig,
           "flex1-alpha": flux_config.Flex1AlphaDenoiserConfig}[kind]
    with torch.device("meta"):
        model = FluxDenoiser(cls(depth=1, depth_single_blocks=2, use_flash_attention=True))
    model.to(dtype=torch.bfloat16).to_empty(device=cuda)
    init_parameters_(model, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    latent = torch.randn(2, 128, 128, 16, device=cuda, generator=g).bfloat16()
    t5 = torch.randn(2, 512, 4096, device=cuda, generator=g).bfloat16()
    clip = torch.randn(2, 768, device=cuda, generator=g).bfloat16()
    t = torch.tensor([0.7, 0.7], device=cuda).bfloat16()
    guidance = torch.full((2,), 3.5, device=cuda).bfloat16()
    with torch.inference_mode():
        before = flash_attention_bshd.launches
        got = model(latent, t5, t, clip, guidance=guidance).float()
        assert flash_attention_bshd.launches == before + 3

        def plain_forward(q, k, v, num_heads, scale, return_lse):
            out = flash_attention_bshd_reference(q, k, v, num_heads, scale, return_lse=return_lse)
            return out if return_lse else (out, None)

        monkeypatch.setattr(flash_module, "_forward", plain_forward)
        want = model(latent, t5, t, clip, guidance=guidance).float()
    assert got.shape == latent.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err


# -- CogView4: kernel B at head dim 128 with 32 heads, kernel C at D 128 on a model path ----

COGVIEW4_ATTN_SHAPES = [  # (B, S, H, D): the caption (16 tokens a multiple) before the patches
    (2, 4112, 32, 128),  # 1024 px under CFG: 16 + 64 * 64, not a multiple of 64
    (8, 4112, 32, 128),  # a pool of 4 slots
    (2, 2320, 32, 128),  # 768 px under CFG: 16 + 48 * 48
    (1, 4144, 32, 128),  # a 48-token caption
]
COGVIEW4_BWD_SHAPES = [(2, 4112, 32, 128), (1, 4112, 32, 128), (1, 4144, 32, 128)]
# (M, K, N) of the quant tool's Linears: GLM's at two 16-token prompts, the DiT's at 1024 px
# under CFG (2 x 4112 rows on the joint stream, the feed-forward on each stream alone)
COGVIEW4_NF4_SHAPES = [
    (32, 4096, 4096),     # GLM q_proj, o_proj
    (32, 4096, 256),      # GLM k_proj, v_proj: 2 kv heads of 128
    (32, 4096, 27392),    # GLM gate_up_proj
    (32, 13696, 4096),    # GLM down_proj
    (8224, 4096, 4096),   # the DiT's to_q / to_k / to_v / to_out.0, joint stream
    (8192, 4096, 16384),  # ff.net.0.proj, image stream
    (8192, 16384, 4096),  # ff.net.2, image stream
    (32, 4096, 16384),    # ff.net.0.proj, text stream
    (32, 16384, 4096),    # ff.net.2, text stream
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", COGVIEW4_ATTN_SHAPES)
def test_bshd_kernel_at_cogview4_shapes_on_card(cuda, b, s, h, d):
    """One launch a call, out and lse against the plain version, a rerun
    bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(31)
    q, k, v = (torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16() for _ in "qkv")
    before = flash_attention_bshd.launches
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    assert flash_attention_bshd.launches == before + 1
    want, want_lse = flash_attention_bshd_reference(q, k, v, h, return_lse=True)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= BF16_ATTN_TOL * want.float().abs().max().item(), err
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    again, again_lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", COGVIEW4_BWD_SHAPES)
def test_bshd_backward_at_cogview4_shapes_on_card(cuda, b, s, h, d):
    """Kernel C at D 128 at the CogView4 train step's shape: each kernel
    once, against the plain backward; a rerun bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(32)
    q, k, v, dout = (torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16() for _ in range(4))
    _check_bshd_backward(q, k, v, dout, h)
    out, lse = flash_attention_bshd(q, k, v, h, return_lse=True)
    args = (q, k, v, dout, lse, flash_attention_bshd_delta(out, dout, h), h)
    first, again = ((*flash_attention_bshd_dkv(*args), flash_attention_bshd_dq(*args))
                    for _ in range(2))
    for name, x, y in zip(("dk", "dv", "dq"), first, again):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_bshd_backward_takes_cogview4_strided_views_on_card(cuda):
    """q, k and v as column slices of one (B, S, 3 * 4096) tensor, the
    layout a fused qkv projection gives: rows 12288 apart, read in place."""
    g = torch.Generator(device=cuda).manual_seed(33)
    b, s, h, d = 1, 4112, 32, 128
    qkv = torch.randn(b, s, 3 * h * d, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.split(h * d, dim=-1)
    assert q.stride(1) == 3 * h * d
    dout = torch.randn(b, s, h * d, device=cuda, generator=g).bfloat16()
    _check_bshd_backward(q, k, v, dout, h)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", COGVIEW4_NF4_SHAPES)
def test_nf4_forward_at_cogview4_shapes_on_card(cuda, m, k, n):
    """Kernel D's forward on the split layout (a quantized Linear's on the
    card) at GLM's and the DiT's widths: one launch a call, against the
    plain version, a rerun bit-identical."""
    assert nf4.supports(m, k, n, 64)
    packed, code, absmax = _nf4_weight(cuda, n, k, "nf4", True)
    x = torch.randn(m, k, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    x = x.bfloat16()
    before = nf4.nf4_matmul_forward.launches
    y = nf4.nf4_matmul_forward(x, packed, code, absmax, (n, k), 64, True)
    assert nf4.nf4_matmul_forward.launches == before + 1
    want = nf4.nf4_matmul_reference(x, packed, code, absmax, (n, k), 64, True)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= NF4_FWD_TOL * want.float().abs().max().item(), err
    assert torch.equal(y, nf4.nf4_matmul_forward(x, packed, code, absmax, (n, k), 64, True))


@pytest.mark.cuda
def test_nf4_linear_outside_kernel_d_raises_by_name_on_card(cuda):
    """A packed 4-bit Linear kernel D does not take (CogView4's patch-in
    projection, K = 64) raises naming the layer on the "fused" route with
    a bf16 input on the card, and runs on the "dequant" route."""
    import vision_ft_tpu_torch.nn as tnn
    from vision_ft_tpu_torch.modules import quant

    g = torch.Generator(device=cuda).manual_seed(2)
    holder = torch.nn.ModuleDict({"proj": tnn.Linear(64, 4096)})
    tnn.init_parameters_(holder.to_empty(device=cuda).to(torch.bfloat16), g)
    quant.quantize_params(holder, "bnb_nf4", ["proj"])
    x = torch.randn(2, 4096, 64, device=cuda, generator=g).bfloat16()
    before = nf4.nf4_matmul_forward.launches
    with pytest.raises(ValueError, match="'proj' \\(64 -> 4096"):
        holder["proj"](x)
    tnn.set_nf4_route("dequant")
    try:
        assert holder["proj"](x).shape == (2, 4096, 4096)
    finally:
        tnn.set_nf4_route("fused")
    assert nf4.nf4_matmul_forward.launches == before


def _cogview4_reduced(cuda, layers=2):
    from vision_ft_tpu_torch.models.cogview4.config import DenoiserConfig
    from vision_ft_tpu_torch.models.cogview4.denoiser import Denoiser
    from vision_ft_tpu_torch.nn import init_parameters_

    with torch.device("meta"):
        model = Denoiser(DenoiserConfig(num_layers=layers))
    model.to(dtype=torch.bfloat16).to_empty(device=cuda)
    init_parameters_(model, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    inputs = (torch.randn(2, 128, 128, 16, device=cuda, generator=g).bfloat16(),
              torch.randn(2, 16, 4096, device=cuda, generator=g).bfloat16(),
              torch.tensor([700.0, 300.0], device=cuda).bfloat16(),
              torch.full((2, 2), 1024.0, device=cuda), torch.full((2, 2), 1024.0, device=cuda),
              torch.zeros(2, 2, device=cuda))
    return model, inputs


def _plain_attention(monkeypatch):
    from vision_ft_tpu_torch.ops import flash_attention as flash_module

    def plain_forward(q, k, v, num_heads, scale, return_lse):
        out = flash_attention_bshd_reference(q, k, v, num_heads, scale, return_lse=return_lse)
        return out if return_lse else (out, None)

    monkeypatch.setattr(flash_module, "_forward", plain_forward)
    monkeypatch.setattr(flash_module, "flash_attention_bshd_backward",
                        flash_attention_bshd_backward_reference)


@pytest.mark.cuda
def test_cogview4_forward_at_reduced_depth_matches_plain_on_card(cuda, monkeypatch):
    """The CogView4 DiT at full width (4096, 32 heads of 128, FF 16384), 2
    blocks, bf16, seeded random weights, at 1024 px under CFG (batch 2, 16 +
    4096 tokens): kernel B once a block, and the velocity against the same
    forward on B's plain version within 5e-2 of its largest value
    (chip_smoke.py's COGVIEW4_STEP_TOL)."""
    model, inputs = _cogview4_reduced(cuda)
    with torch.inference_mode():
        before = flash_attention_bshd.launches
        got = model(*inputs).float()
        assert flash_attention_bshd.launches == before + 2
        _plain_attention(monkeypatch)
        want = model(*inputs).float()
    assert got.shape == inputs[0].shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err


@pytest.mark.cuda
def test_cogview4_lora_backward_at_reduced_depth_matches_plain_on_card(cuda, monkeypatch):
    """LoRA rank 8 on attn / ff (configs/cogview4/text_to_image.yml's
    targets, lora_up drawn non-zero) over the 2-block full-width DiT with
    gradient checkpointing: one forward kernel and one launch each of C's
    kernels a block ("kernel" saves: the recomputation reuses the forward's
    out and lse), and the adapters' gradients against the plain forward and
    backward within 5e-2 of their largest value."""
    from vision_ft_tpu_torch.modules.peft import LoRAConfig, replace_to_peft_layer, split_peft_params

    model, inputs = _cogview4_reduced(cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    replace_to_peft_layer(model, ["attn", "ff"], [], LoRAConfig(rank=8, alpha=4.0), g)
    trainable, _ = split_peft_params(model)
    with torch.no_grad():
        for key, value in trainable.items():
            if key.endswith("lora_up.weight"):
                value.normal_(0.0, 0.02, generator=g)
    model.set_gradient_checkpointing(True)
    target = torch.randn(inputs[0].shape, device=cuda, generator=g).bfloat16()

    def grads():
        for value in trainable.values():
            value.grad = None
        loss = (model(*inputs).float() - target.float()).square().mean()
        loss.backward()
        return torch.cat([v.grad.float().flatten() for v in trainable.values()])

    wrappers = (flash_attention_bshd, flash_attention_bshd_dkv, flash_attention_bshd_dq)
    before = [w.launches for w in wrappers]
    got = grads()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [2, 2, 2]
    _plain_attention(monkeypatch)
    want = grads()
    assert torch.isfinite(got).all() and want.abs().max() > 0
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err
