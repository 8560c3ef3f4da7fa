"""Checkpoint dtype converter of the port (``tools/checkpoint/convert_dtype.py``
counterpart): casts every floating tensor of a safetensors file to a
target dtype and leaves the others as they are, on the host:

    python3 -m vision_ft_tpu_torch.tools.checkpoint.convert_dtype \\
        --input-path model.safetensors --output-path model.bf16.safetensors --dtype bfloat16
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
    "float32": torch.float32, "fp32": torch.float32,
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the tool; returns the converted state dict."""
    from ...utils import safetensors as st

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--input-path", required=True)
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    args = parser.parse_args(argv)
    state_dict = st.load_file(args.input_path, dtype=DTYPES[args.dtype])
    st.save_file(state_dict, args.output_path)
    print(f"Wrote {args.output_path} ({len(state_dict)} tensors as {args.dtype})")
    return state_dict


if __name__ == "__main__":
    main()
