"""Single-file inference CLI of the port (``tools/inference_cli.py``
counterpart): loads a family's single-file checkpoint, optionally quantizes
the denoiser's Linears (``--quant-type``, e.g. ``bnb_nf4``: the 4-bit
matmul kernels), generates and saves webp (wan: an mp4 video), on the card:

    python3 -m vision_ft_tpu_torch.tools.inference_cli --family sdxl \\
        --checkpoint-path sdxl.safetensors --tokenizer-path /path/to/clip_vocab \\
        --width 1024 --height 1024 --quant-type bnb_nf4 --save-path out.webp

Families: sdxl, lumina2, auraflow, cogview4, flux, wan. Tokenizers load
from a local directory (``--tokenizer-path``: CLIP's vocab.json +
merges.txt, or a SentencePiece ``tokenizer.model``; for flux the T5 one,
with CLIP's in a ``clip/`` subfolder). Wan's checkpoint is three files:
``--checkpoint-path`` names the denoiser's, and ``text_encoder.safetensors``
and ``vae.safetensors`` are read from its directory; ``--frames`` and
``--fps`` shape the video.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .inference_server import (
    SERVED_FAMILIES, WAN_DEFAULT_FRAMES, check_family, load_model, prepare_kernels,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint-path", type=str, required=True)
    parser.add_argument("--family", type=str, default="auraflow",
                        help=f"the model family: one of {', '.join(SERVED_FAMILIES)}")
    parser.add_argument("--tokenizer-path", type=str, default=None)
    parser.add_argument("--prompt", type=str, default="photo of a cat")
    parser.add_argument("--negative-prompt", type=str, default="blurry, ugly, low quality")
    parser.add_argument("--width", type=int, default=768)
    parser.add_argument("--height", type=int, default=768)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--num-inference-steps", type=int, default=20)
    parser.add_argument("--cfg-scale", type=float, default=5.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save-path", type=str, default=None,
                        help="where to write (default output.webp; output.mp4 for wan)")
    parser.add_argument("--quant-type", type=str, default=None,
                        help="quantize the denoiser's Linears (modules.quant), e.g. bnb_nf4")
    parser.add_argument("--deep-cache-interval", type=int, default=None,
                        help="a full denoiser pass every N steps, shallow cached passes between")
    parser.add_argument("--frames", type=int, default=WAN_DEFAULT_FRAMES,
                        help="wan only: the number of video frames")
    parser.add_argument("--fps", type=int, default=24,
                        help="wan only: the mp4's frame rate")
    parser.add_argument("--cfg-rescale", type=float, default=None,
                        help="SDXL only: std-matching CFG rescale blend in [0, 1]")
    parser.add_argument("--do-offloading", action="store_true",
                        help="park the text encoder, denoiser and VAE on the host between "
                             "their stages (modules/offload.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model runs (cuda; cpu for tests)")
    return parser


# the denoiser's Linears the JAX tool leaves unquantized
EXCLUDE_KEYS = ["t_embedder", "final_linear", "modF"]
# and those each family leaves unquantized besides: the patch-in and
# patch-out projections (64 or 16 latent channels wide, Wan's head 192) and
# SDXL's 320-wide timestep projections, whose widths the 4-bit kernel does
# not take (such a 4-bit layer raises on the card's "fused" route,
# ``nn.set_nf4_route``)
UNQUANTIZED = {
    "sdxl": ["time_embed.0", "input_blocks.blocks.1.0.emb_layers",
             "input_blocks.blocks.2.0.emb_layers", "output_blocks.blocks.6.0.emb_layers",
             "output_blocks.blocks.7.0.emb_layers", "output_blocks.blocks.8.0.emb_layers"],
    "lumina2": ["x_embedder", "final_layer.linear"],
    "auraflow": ["init_x_linear"],
    "cogview4": ["patch_embed.proj", "proj_out"],
    "flux": ["img_in", "final_layer.linear"],
    "wan": ["head.head"],
}


def model_config(family: str, checkpoint_path: str) -> dict:
    """The ``model`` section the CLI's one path stands for: the file itself,
    or for wan its denoiser file with the two others beside it."""
    if family != "wan":
        return {"checkpoint_path": checkpoint_path}
    base = os.path.dirname(checkpoint_path)
    return {"denoiser_path": checkpoint_path,
            "text_encoder_path": os.path.join(base, "text_encoder.safetensors"),
            "vae_path": os.path.join(base, "vae.safetensors")}


def build_model(family: str, checkpoint_path: str, tokenizer_path: Optional[str],
                quant_type: Optional[str], device=None):
    """The family's pipeline from ``checkpoint_path``, its denoiser's
    Linears quantized to ``quant_type`` where given: all but those of
    ``EXCLUDE_KEYS`` and the family's ``UNQUANTIZED``."""
    model = load_model(family, model_config(family, checkpoint_path), tokenizer_path,
                       device=device)
    if quant_type is not None:
        from ..modules.quant import quantize_params

        print(f"Quantizing denoiser with {quant_type}...")
        quantize_params(model.denoiser, quant_type, include_keys=[""],
                        exclude_keys=[*EXCLUDE_KEYS, *UNQUANTIZED[family]])
    return model


def main(argv: Optional[Sequence[str]] = None) -> list[str]:
    """Runs the CLI; returns the paths it saved."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_family(args.family)
    if args.tokenizer_path is None:
        parser.error("--tokenizer-path (a local tokenizer directory or file) is required")
    extra = {}
    if args.do_offloading:
        extra["do_offloading"] = True
    if args.deep_cache_interval is not None:
        extra["deep_cache_interval"] = args.deep_cache_interval
    if args.cfg_rescale is not None:
        if args.family != "sdxl":
            parser.error("--cfg-rescale is SDXL-only")
        extra["cfg_rescale"] = args.cfg_rescale
    if args.family == "wan":
        extra["frames"] = args.frames
    save_path = args.save_path or ("output.mp4" if args.family == "wan" else "output.webp")

    print("Loading model...")
    model = build_model(args.family, args.checkpoint_path, args.tokenizer_path,
                        args.quant_type, device=args.device)
    prepare_kernels(args.family, args.device)
    print(f"Prompt: {args.prompt}")
    images = model.generate(
        prompt=[args.prompt] * args.batch_size,
        negative_prompt=args.negative_prompt,
        width=args.width,
        height=args.height,
        num_inference_steps=args.num_inference_steps,
        cfg_scale=args.cfg_scale,
        seed=args.seed,
        **extra,
    )
    saved = []
    for i, image in enumerate(images):
        path = save_path if len(images) == 1 else save_path.replace(".", f"_{i}.", 1)
        if isinstance(image, list):  # wan: a video, one image a frame
            from ..utils.video import write_images_as_video

            write_images_as_video(image, path, fps=args.fps)
        else:
            image.save(path)
        print(f"Saved {path}")
        saved.append(path)
    return saved


if __name__ == "__main__":
    main()
