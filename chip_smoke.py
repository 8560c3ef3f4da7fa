#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_ft_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

0. device: needs torch.cuda; prints the card's name and power limit and
   sets fp32 matmuls and convolutions to full fp32 (no TF32).
1. build: compiles the CUDA kernel with nvcc (sm_90a) and the Triton
   kernel, from the sources in this checkout.
2. kernel B, BSHD flash attention, against its plain PyTorch version in
   bf16 at the SDXL self-attention shapes (aligned and ragged).
3. kernel A, fused LayerNorm, the same way.
4. SDXL generate() at full width (default DenoiserConfig, SDXL CLIP and
   VAE configs, bf16, seeded random weights made on the card, a small
   synthetic CLIP vocab): three requests, then checks of the outputs and
   of the kernels' launch counts against the module tree.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. There is no CPU path.
"""

import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# max |kernel - plain| / max |plain|, bf16 outputs at O(1) scale: both
# versions round to bf16 at other places (online rescaling, the output
# cast), a few bf16 ulps (2**-8 relative each)
ATTN_TOL = 2e-2
LN_TOL = 2e-2

ATTN_SHAPES = [  # (B, S, H*D, H): SDXL 1024x1024 and the ragged 832x1216 bucket
    (2, 4096, 640, 10), (2, 1024, 1280, 20), (2, 3952, 640, 10), (2, 988, 1280, 20),
]
LN_SHAPES = [  # (rows, C, beta): UNet 640/1280, CLIP-L 768 and bigG 1280 at B*77
    (8192, 640, True), (2048, 1280, True), (154, 768, True), (154, 1280, False),
]
STEPS = 8


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel, plain, tol):
    """Errors of ``kernel()`` against ``plain()``, in fp32; fails past tol."""
    out, ref = kernel().float(), plain().float()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output not finite")
    abs_err = (out - ref).abs().max().item()
    rel_err = abs_err / ref.abs().max().item()
    if rel_err > tol:
        raise AssertionError(f"{name}: max abs err {abs_err:.3e}, rel {rel_err:.3e} > {tol}")
    return abs_err, rel_err


def write_vocab(path: Path) -> None:
    """A small CLIP BPE vocab: the 26 letters (with and without the
    end-of-word mark), a few merges, and bos/eos at CLIP's own ids, so
    that the towers' pooled token (id vocab_size - 1) is the real eos."""
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for token in ("th", "the</w>", "ca", "cat</w>", "on</w>", "of</w>"):
        vocab[token] = len(vocab)
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    merges = ["#version: 0.2", "t h", "th e</w>", "c a", "ca t</w>", "o n</w>", "o f</w>"]
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("\n".join(merges) + "\n")


def main() -> None:
    phase("0 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available; this script needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda")

    # the port, and so the kernel sources, must be this checkout's
    import vision_ft_tpu_torch
    checkout = Path(__file__).resolve().parent
    if Path(vision_ft_tpu_torch.__file__).resolve().parent.parent != checkout:
        raise SystemExit(f"chip_smoke: vision_ft_tpu_torch comes from "
                         f"{vision_ft_tpu_torch.__file__}, not from {checkout}")
    from vision_ft_tpu_torch.ops import _build
    from vision_ft_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_reference,
    )
    from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference

    phase("1 build")
    start = time.perf_counter()
    _build.cuda_library("flash_attention_bshd")
    nvcc_s = time.perf_counter() - start
    start = time.perf_counter()
    for c, beta in sorted({(c, beta) for _, c, beta in LN_SHAPES}):
        w = torch.ones(c, device=device, dtype=torch.bfloat16)
        layer_norm(torch.ones(4, c, device=device, dtype=torch.bfloat16), w, w if beta else None)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - start
    print(f"nvcc flash_attention_bshd.cu: {nvcc_s:.2f} s; "
          f"triton layer_norm (load + first launches): {triton_s:.2f} s")

    records = {}
    gen = torch.Generator(device=device).manual_seed(0)

    phase("2 kernel B: BSHD flash attention vs plain (bf16)")
    errs, times = [], []
    for b, s, inner, h in ATTN_SHAPES:
        q, k, v = (torch.randn(b, s, inner, device=device, generator=gen).bfloat16() for _ in "qkv")
        abs_err, rel_err = compare(
            f"attention {(b, s, inner, h)}",
            lambda: flash_attention_bshd(q, k, v, h),
            lambda: flash_attention_bshd_reference(q, k, v, h), ATTN_TOL,
        )
        ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, h))
        plain_ms = cuda_ms(lambda: flash_attention_bshd_reference(q, k, v, h), iters=5)
        tflops = 4 * b * s * s * inner / ms / 1e9
        print(f"B={b} S={s} H={h} D={inner // h}: max abs err {abs_err:.3e} rel {rel_err:.3e} "
              f"(tol {ATTN_TOL}); kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms")
        errs.append(abs_err)
        times.append((ms, plain_ms))
    records["flash_attention_bshd"] = dict(
        route="cuda", source="vision_ft_tpu_torch/csrc/flash_attention_bshd.cu",
        replaces="vision_ft_tpu/ops/pallas/flash_attention.py:663",
        max_abs_err=max(errs), ms=times[0][0], plain_ms=times[0][1],
    )
    del q, k, v

    phase("3 kernel A: fused LayerNorm vs plain (bf16)")
    errs, times = [], []
    for rows, c, beta in LN_SHAPES:
        x = (torch.randn(rows, c, device=device, generator=gen) * 2 + 0.3).bfloat16()
        w = (1 + 0.2 * torch.randn(c, device=device, generator=gen)).bfloat16()
        bias = (0.2 * torch.randn(c, device=device, generator=gen)).bfloat16() if beta else None
        abs_err, rel_err = compare(
            f"layer_norm {(rows, c, beta)}",
            lambda: layer_norm(x, w, bias), lambda: layer_norm_reference(x, w, bias), LN_TOL,
        )
        ms = cuda_ms(lambda: layer_norm(x, w, bias), iters=50)
        plain_ms = cuda_ms(lambda: layer_norm_reference(x, w, bias), iters=50)
        gbs = 2 * x.numel() * 2 / ms / 1e6
        print(f"rows={rows} C={c} beta={beta}: max abs err {abs_err:.3e} rel {rel_err:.3e} "
              f"(tol {LN_TOL}); kernel {ms:.4f} ms ({gbs:.0f} GB/s), plain {plain_ms:.4f} ms")
        errs.append(abs_err)
        times.append((ms, plain_ms))
    records["layer_norm"] = dict(
        route="triton", source="vision_ft_tpu_torch/csrc/layer_norm.py",
        replaces="vision_ft_tpu/ops/pallas/layer_norm.py:22",
        max_abs_err=max(errs), ms=times[0][0], plain_ms=times[0][1],
    )

    phase("4 SDXL generate() at full width, bf16, seeded random weights")
    from vision_ft_tpu_torch.models.sdxl.config import SDXLConfig
    from vision_ft_tpu_torch.models.sdxl.denoiser import SelfAttention
    from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
    from vision_ft_tpu_torch.models.text_encoders import CLIPTokenizer
    from vision_ft_tpu_torch.nn import LayerNorm

    class Model(SDXLModel):
        """Keeps the last latents generate() decoded, for the checks."""

        def decode_image(self, latents, use_tiling=False):
            self.last_latents = latents.clone()
            return super().decode_image(latents, use_tiling)

    with tempfile.TemporaryDirectory() as vocab_dir:
        write_vocab(Path(vocab_dir))
        tokenizer = CLIPTokenizer.from_pretrained_dir(vocab_dir)
    model = Model(SDXLConfig(checkpoint_path="", dtype="bfloat16"), tokenizer=tokenizer)
    start = time.perf_counter()
    model.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in model.denoiser.parameters())
    n_te = sum(p.numel() for p in model.text_encoder.parameters())
    print(f"init on the card: {time.perf_counter() - start:.1f} s; UNet {n_unet / 1e9:.3f} B, "
          f"text encoders {n_te / 1e9:.3f} B, VAE "
          f"{sum(p.numel() for p in model.vae.parameters()) / 1e6:.1f} M parameters")

    unet_ln = sum(isinstance(m, LayerNorm) for m in model.denoiser.modules())
    clip_ln = sum(isinstance(m, LayerNorm) for m in model.text_encoder.modules())
    unet_attn = sum(isinstance(m, SelfAttention) for m in model.denoiser.modules())
    requests = [
        ("a", dict(prompt="a photo of a cat sitting on the sofa", negative_prompt="blurry",
                   width=1024, height=1024, cfg_scale=5.0, seed=1234)),
        ("b", dict(prompt=["a red car on the road", "a house in the mountains"],
                   width=832, height=1216, cfg_scale=5.0, seed=99)),
    ]
    requests.append(("c", requests[0][1]))  # (a) again, same seed

    flash_attention_bshd.launches = 0
    layer_norm.launches = 0
    results = {}
    unet_forwards = 0
    for name, kwargs in requests:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start = time.perf_counter()
        images = model.generate(num_inference_steps=STEPS, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        steps = len(model.scheduler.get_timesteps(STEPS))
        unet_forwards += steps
        latents = model.last_latents
        arrays = [np.asarray(im) for im in images]
        print(f"request {name}: {len(images)} image(s) {images[0].size}, {steps} steps, "
              f"{seconds:.3f} s, {seconds / steps:.3f} s per step (whole request), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not torch.isfinite(latents).all():
            raise AssertionError(f"request {name}: latents not finite")
        if any(a.std() == 0 for a in arrays):
            raise AssertionError(f"request {name}: constant image")
        results[name] = (latents, arrays)
    launches = {"flash_attention_bshd": flash_attention_bshd.launches,
                "layer_norm": layer_norm.launches}

    same = torch.equal(results["a"][0], results["c"][0]) and all(
        np.array_equal(x, y) for x, y in zip(results["a"][1], results["c"][1]))
    if not same:
        raise AssertionError("request c (a repeated, same seed) differs from a")
    print("request c == request a, bit for bit")
    want = {"flash_attention_bshd": unet_attn * unet_forwards,
            "layer_norm": unet_ln * unet_forwards + clip_ln * len(requests)}
    print(f"module tree: {unet_attn} UNet self-attentions, {unet_ln} UNet LayerNorms, "
          f"{clip_ln} CLIP LayerNorms; {unet_forwards} UNet forwards; "
          f"launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    # the UNet step alone: one CFG forward (batch 2) at 1024x1024
    b = 2
    args = (
        torch.randn(b, 128, 128, 4, device=device, generator=gen).bfloat16(),
        torch.full((b,), 500.0, device=device),
        torch.randn(b, 77, 2048, device=device, generator=gen).bfloat16(),
        torch.randn(b, 1280, device=device, generator=gen).bfloat16(),
        *(torch.full((b, 2), v, device=device) for v in (1024.0, 1024.0, 0.0)),
    )
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: model.denoiser(*args), warmup=2, iters=5)
    print(f"UNet CFG forward at 1024x1024 (batch {b}): {unet_ms:.1f} ms")

    for name in records:
        records[name]["launches"] = launches[name]
    kernels = [{"name": n, **{k: r[k] for k in ("route", "source", "replaces", "launches",
                                                 "max_abs_err", "ms", "plain_ms")}}
               for n, r in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
