"""Peak device memory of the port (``tools/snapshot_max_memory.py``
counterpart): one JSON line a card with ``torch.cuda``'s peak allocated
bytes and the card's memory, and, given ``--snapshot``, the peak of a
``torch.cuda.memory._dump_snapshot`` pickle:

    python3 -m vision_ft_tpu_torch.tools.snapshot_max_memory --snapshot snap.pickle

A snapshot's peak replays its allocator trace backwards from the blocks
allocated when it was taken: before an ``alloc`` of n bytes n fewer were
allocated, before a ``free_completed`` n more. Its peak is the largest of
those sums; a card's own counters are those of this process.
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import Optional, Sequence


def format_bytes(size: float) -> str:
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if size < 1024:
            return f"{size:.2f} {unit}"
        size /= 1024
    return f"{size:.2f} PB"


def snapshot_peak(snapshot: dict) -> dict[int, int]:
    """{device: peak allocated bytes} of a ``_dump_snapshot`` dict."""
    allocated: dict[int, int] = {}
    for segment in snapshot.get("segments", []):
        device = segment["device"]
        active = sum(b["size"] for b in segment["blocks"] if b["state"] == "active_allocated")
        allocated[device] = allocated.get(device, 0) + active
    peaks = {}
    for device, trace in enumerate(snapshot.get("device_traces", [])):
        current = allocated.get(device, 0)
        peak = current
        for entry in reversed(trace):
            if entry["action"] == "alloc":
                current -= entry["size"]
            elif entry["action"] == "free_completed":
                current += entry["size"]
            peak = max(peak, current)
        if trace or device in allocated:
            peaks[device] = peak
    for device, current in allocated.items():
        peaks.setdefault(device, current)
    return peaks


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    """Prints and returns the report's lines."""
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--snapshot", default=None,
                        help="a torch.cuda.memory._dump_snapshot pickle to summarize")
    args = parser.parse_args(argv)
    lines = []
    if args.snapshot:
        with open(args.snapshot, "rb") as f:
            peaks = snapshot_peak(pickle.load(f))
        for device, peak in sorted(peaks.items()):
            lines.append({"snapshot": args.snapshot, "device": device, "peak_bytes_in_use": peak,
                          "peak_human": format_bytes(peak)})
    if torch.cuda.is_available():
        for index in range(torch.cuda.device_count()):
            peak = torch.cuda.max_memory_allocated(index)
            lines.append({
                "device": f"cuda:{index}",
                "peak_bytes_in_use": peak,
                "peak_human": format_bytes(peak),
                "bytes_limit": torch.cuda.get_device_properties(index).total_memory,
            })
    for line in lines:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
