"""What ptxas made of each kernel of one ``csrc/<name>.cu``: registers a
thread, spill bytes and the performance notes it printed (C75xx: wgmma
serialized, warpgroup.arrive injected), from ``nvcc -Xptxas -v`` with the
build's own flags (``ops/_build.NVCC_FLAGS``).

    python -m vision_ft_tpu_torch.tools.ptxas_report flash_attention_bshd

prints one JSON line, {kernel: {"registers", "stack", "spill_stores",
"spill_loads", "notes"}}, keyed by the mangled kernel name. It needs
``nvcc`` (the machine with the card); the library it compiles is thrown
away.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops import _build

_PROPERTIES = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_NOTE = re.compile(r"\((C\d+)\).*function '([^']+)'")


def parse(text: str) -> dict[str, dict]:
    """The per-kernel records of ptxas's verbose output ``text``."""
    kernels: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        if match := _PROPERTIES.search(line):
            current = kernels.setdefault(match.group(1), {"notes": []})
        elif (match := _FRAME.search(line)) and current is not None:
            current.update(stack=int(match.group(1)), spill_stores=int(match.group(2)),
                           spill_loads=int(match.group(3)))
        elif (match := _USED.search(line)) and current is not None:
            current["registers"] = int(match.group(1))
    for line in text.splitlines():
        if match := _NOTE.search(line):
            kernels.setdefault(match.group(2), {"notes": []})["notes"].append(match.group(1))
    return kernels


def ptxas_report(name: str) -> dict[str, dict]:
    """Compile ``csrc/<name>.cu`` as the build does, with ``-Xptxas -v``,
    and return :func:`parse` of what ptxas printed."""
    source = _build.CSRC / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{name}.so"), str(source)],
            capture_output=True, text=True,
        )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return parse(proc.stdout + proc.stderr)


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print("usage: python -m vision_ft_tpu_torch.tools.ptxas_report <csrc name>", file=sys.stderr)
        return 2
    print(json.dumps(ptxas_report(argv[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
