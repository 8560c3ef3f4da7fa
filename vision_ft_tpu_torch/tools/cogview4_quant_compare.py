"""CogView4 quantization comparison of the port (``tools/cogview4_quant_compare.py``
counterpart): generates one prompt with GLM's and / or the DiT's Linears
quantized and writes the image and a JSON report of the card's peak memory,
on the card:

    python3 -m vision_ft_tpu_torch.tools.cogview4_quant_compare \\
        --model_path cogview4-6b.safetensors --tokenizer_path /path/to/glm_tokenizer \\
        --text_encoder bnb_nf4 --denoiser bnb_nf4 --output_dir output

``--text_encoder`` / ``--denoiser``: ``bf16`` (unquantized) or a quant type
of ``modules.quant`` (``bnb_nf4``: the 4-bit matmul kernel on every layer
quantized; on the card's "fused" 4-bit route, ``nn.set_nf4_route``, a
quantized layer the kernel does not take raises by name). The report:
``run``, ``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``),
``bytes_limit`` (the card's total memory), ``seconds`` (the request) and
``nf4_launches`` (the 4-bit kernel's launches in the request).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

# the JAX tool's groups (reference tools/cogview4_quant_compare.py)
TEXT_ENCODER_KEYS = (
    ["q_proj", "k_proj", "v_proj", "o_proj", "mlp.down_proj", "mlp.gate_up_proj"],
    ["denoiser.", "vae."],
)
DENOISER_KEYS = (
    ["to_q", "to_k", "to_v", "to_out.0", "ff.net.0.proj", "ff.net.2"],
    ["time_condition_embed", "patch_embed", "norm_out", "proj_out", "norm1", "text_encoder.",
     "vae."],
)


def quantize_model(model, text_encoder: str, denoiser: str) -> list[str]:
    """Quantize the two groups in place ("bf16" leaves a group as it is);
    returns the quantized layers' names."""
    from ..modules.quant import is_quantized_weight, quantize_params

    module = model.as_module()
    for quant_type, (include, exclude) in ((text_encoder, TEXT_ENCODER_KEYS),
                                           (denoiser, DENOISER_KEYS)):
        if quant_type != "bf16":
            quantize_params(module, quant_type, include_keys=include, exclude_keys=exclude)
    return [name for name, m in module.named_modules()
            if hasattr(m, "in_features") and is_quantized_weight(m.weight)]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_path", default="./models/cogview4-6b.bf16.safetensors")
    parser.add_argument("--tokenizer_path", default=None,
                        help="a local GLM tokenizer (tokenizer.json or a SentencePiece model); "
                             "default: looked for beside the checkpoint")
    parser.add_argument("--text_encoder", default="bf16", type=str)
    parser.add_argument("--denoiser", default="bf16", type=str)
    parser.add_argument("--prompt", default="cute anime girl with fluffy fennec ears, maid outfit, "
                                            "victorian kitchen")
    parser.add_argument("--negative_prompt", default="blurry, low quality, horror")
    parser.add_argument("--height", default=1024, type=int)
    parser.add_argument("--width", default=1024, type=int)
    parser.add_argument("--cfg_scale", default=3.5, type=float)
    parser.add_argument("--num_inference_steps", default=20, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--output_dir", default="output")
    parser.add_argument("--device", default="cuda", help="where the model runs (cuda; cpu for tests)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the tool; returns the report it wrote."""
    import torch

    from ..models.cogview4 import CogView4Config, CogView4Model
    from ..ops.nf4_matmul import nf4_matmul_forward

    args = build_parser().parse_args(argv)
    tokenizer = None
    if args.tokenizer_path is not None:
        from ..models.text_encoders.auto_tokenizer import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer_path, family="glm")
    config = CogView4Config(checkpoint_path=args.model_path, dtype="bfloat16")
    model = CogView4Model.from_checkpoint(config, tokenizer=tokenizer, device=args.device)
    quantized = quantize_model(model, args.text_encoder, args.denoiser)
    on_card = model.device.type == "cuda"
    if on_card:
        from ..ops import _build

        _build.build_cuda_libraries(["flash_attention_bshd", "nf4_matmul"])
        torch.cuda.reset_peak_memory_stats(model.device)
    launches = nf4_matmul_forward.launches
    start = time.perf_counter()
    image = model.generate(
        args.prompt, negative_prompt=args.negative_prompt, height=args.height, width=args.width,
        cfg_scale=args.cfg_scale, num_inference_steps=args.num_inference_steps, seed=args.seed,
    )[0]
    seconds = time.perf_counter() - start

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    run_name = f"text-encoder-{args.text_encoder}_denoiser-{args.denoiser}"
    image.save(out / f"{run_name}.webp")
    report = {
        "run": run_name,
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(model.device) if on_card else None,
        "bytes_limit": torch.cuda.get_device_properties(model.device).total_memory
        if on_card else None,
        "seconds": seconds,
        "quantized_layers": len(quantized),
        "nf4_launches": nf4_matmul_forward.launches - launches,
    }
    (out / f"{run_name}.json").write_text(json.dumps(report, indent=2))
    print(f"Image saved to {out / (run_name + '.webp')}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
