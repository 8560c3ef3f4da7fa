"""PyTorch pickle checkpoint to safetensors, in the port
(``tools/checkpoint/to_safetensors.py`` counterpart):

    python3 -m vision_ft_tpu_torch.tools.checkpoint.to_safetensors model.ckpt model.safetensors

The file is read with ``torch.load(weights_only=True)`` on the host; a
top-level ``state_dict`` mapping is unwrapped and entries that are not
tensors are dropped. Each tensor keeps its dtype: the JAX tool widens
bf16 to fp32 only because numpy has no bf16, and its values equal these.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the tool; returns the tensors it wrote."""
    from ...utils import safetensors as st

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("input_path", help="a torch .pt / .bin / .ckpt file")
    parser.add_argument("output_path", help="the .safetensors file to write")
    args = parser.parse_args(argv)
    print(f"Converting {args.input_path} to safetensors...")
    state_dict = torch.load(args.input_path, map_location="cpu", weights_only=True)
    if "state_dict" in state_dict and isinstance(state_dict["state_dict"], dict):
        state_dict = state_dict["state_dict"]
    print(f"Loaded {len(state_dict)} tensors.")
    tensors = {k: v.detach() for k, v in state_dict.items() if isinstance(v, torch.Tensor)}
    st.save_file(tensors, args.output_path)
    print(f"Saved to {args.output_path}.")
    return tensors


if __name__ == "__main__":
    main()
