"""Offline checkpoint quantizer of the port (``tools/quantize_model.py``
counterpart): quantizes the targeted tensors of a single-file safetensors
checkpoint into bnb's on-disk format (packed 4-bit codes and their
quant-state tensors), fp8, quanto int4 or int8_w8a8, through
``modules.quant.quantize_state_dict``, on the card unless ``--device cpu``:

    python3 -m vision_ft_tpu_torch.tools.quantize_model \\
        --model-path aura_flow_0.3.safetensors \\
        --save-path aura_flow_0.3.bnb_nf4.safetensors --quant-type bnb_nf4

``--include-keys`` / ``--exclude-keys`` (each repeatable; substrings of the
file's keys) default to the JAX tool's: ``model.`` minus ``t_embedder``,
``final_linear`` and ``modF``. The file is written by the port's streaming
``save_file``, from the device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

INCLUDE_KEYS = ("model.",)
EXCLUDE_KEYS = ("t_embedder", "final_linear", "modF")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--save-path", required=True)
    parser.add_argument("--quant-type", default="bnb_nf4")
    parser.add_argument("--include-keys", action="append", default=None,
                        help=f"repeatable; default {list(INCLUDE_KEYS)}")
    parser.add_argument("--exclude-keys", action="append", default=None,
                        help=f"repeatable; default {list(EXCLUDE_KEYS)}")
    parser.add_argument("--device", default="cuda", help="where to quantize (default: the card)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the tool; returns the quantized state dict (on ``--device``)."""
    from ..modules.quant import quantize_state_dict, validate_quant_type
    from ..utils import safetensors as st

    args = build_parser().parse_args(argv)
    validate_quant_type(args.quant_type)
    include = list(args.include_keys or INCLUDE_KEYS)
    exclude = list(args.exclude_keys or EXCLUDE_KEYS)
    print(f"Include keys: {include}")
    print(f"Exclude keys: {exclude}")
    print(f"Loading checkpoint from {args.model_path}")
    state_dict = st.load_file(args.model_path, device=args.device)
    print(f"Quantizing to {args.quant_type} on {args.device}...")
    quantized = quantize_state_dict(state_dict, args.quant_type, include, exclude)
    print(f"Saving to {args.save_path}")
    st.save_file(quantized, args.save_path)
    print("Done!")
    return quantized


if __name__ == "__main__":
    main()
