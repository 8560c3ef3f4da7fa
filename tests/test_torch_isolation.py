"""The port stands apart from JAX, and its chip smoke run needs a GPU.

Both run in subprocesses, so this process's imports do not matter.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import vision_ft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vision_ft_tpu_torch.__path__, "vision_ft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "vision_ft_tpu" or m.startswith("vision_ft_tpu."))
assert not leaked, leaked
print(len(names))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_port_imports_without_jax():
    proc = _run(["-c", IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25  # every module of the slice


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Here (no CUDA device) the smoke run exits non-zero and prints no
    result; so it does in a directory that holds it and nothing else."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd in (REPO, alone):
        proc = _run(["chip_smoke.py"], cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
