"""Inference client of the port (``tools/inference_client.py``
counterpart): posts one request to the server's /predict with the stdlib's
``urllib``, saves the returned webp and prints the request's latency.

    python3 -m vision_ft_tpu_torch.tools.inference_client --url http://127.0.0.1:8123/predict \\
        --prompt "a photo of a cat" --width 1024 --height 1024 --inference-steps 8
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.request
from typing import Optional, Sequence


def predict(url: str, body: dict, timeout: Optional[float] = None) -> tuple[bytes, float]:
    """POST ``body`` as JSON to ``url``; returns (response bytes, seconds)."""
    request = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"), headers={"Content-Type": "application/json"}
    )
    start = time.perf_counter()
    with urllib.request.urlopen(request, timeout=timeout) as response:
        data = response.read()
    return data, time.perf_counter() - start


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--url", type=str, default="http://127.0.0.1:8123/predict")
    parser.add_argument("--prompt", type=str, required=True)
    parser.add_argument("--negative-prompt", type=str, default=None)
    parser.add_argument("--width", type=int, default=768)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--inference-steps", type=int, default=25)
    parser.add_argument("--cfg-scale", type=float, default=6.5)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--save-path", type=str, default="client_output.webp")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Runs the client; returns the request's seconds."""
    args = build_parser().parse_args(argv)
    body = {"prompt": args.prompt, "width": args.width, "height": args.height,
            "inference_steps": args.inference_steps, "cfg_scale": args.cfg_scale}
    if args.negative_prompt is not None:
        body["negative_prompt"] = args.negative_prompt
    if args.seed is not None:
        body["seed"] = args.seed
    data, elapsed = predict(args.url, body)
    with open(args.save_path, "wb") as f:
        f.write(data)
    print(f"Saved {args.save_path} ({len(data)} bytes) in {elapsed:.2f}s")
    return elapsed


if __name__ == "__main__":
    main()
