"""The port stands apart from JAX, and its chip smoke run needs a GPU.

Both run in subprocesses, so this process's imports do not matter.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

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
    # every module of the SDXL generate, train and quantization slices, of the Lumina2
    # generate and train slices, of the SDXL Trainer slice, of the AuraFlow generate
    # and train slices, the GroupNorm and 3x3 conv ops with the ragged-tile probe tool,
    # the serving slice (the continuous batcher, the server, the CLI, the client),
    # the Flux slice (the family, the schedules, the VAE-encode migration), the
    # CogView4 slice (GLM, the family, its train workload and script, the quant tool),
    # the Wan slice (UMT5, the DiT, the 3-D VAE, the pipeline, the video writer)
    # and the single-device remainder (REMAINDER_MODULES)
    assert int(proc.stdout.strip()) >= 175


PORT_SOURCES = sorted((REPO / "vision_ft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
LUMINA2_MODULES = [
    "ops/fused_mlp.py", "modules/patch.py", "models/text_encoders/gemma2.py",
    "models/text_encoders/sentencepiece.py", "models/text_encoders/auto_tokenizer.py",
    "models/lumina2/config.py", "models/lumina2/scheduler.py", "models/lumina2/vae.py",
    "models/lumina2/util.py", "models/lumina2/text_encoder.py", "models/lumina2/denoiser.py",
    "models/lumina2/pipeline.py", "models/lumina2/train_text_to_image.py",
    "modules/loss/flow_match.py", "models/autoencoder/kl.py",
    "ops/flash_attention.py", "train/lumina2/text_to_image.py", "trainer/common.py",
    "training/state_checkpoint.py",
]
# the AuraFlow generate slice: the MMDiT, UMT5, RoPE, the pipeline and its parts
AURAFLOW_MODULES = [
    "models/text_encoders/umt5.py", "modules/positional_encoding/__init__.py",
    "modules/positional_encoding/rope.py", "models/auraflow/__init__.py",
    "models/auraflow/config.py", "models/auraflow/util.py", "models/auraflow/vae.py",
    "models/auraflow/scheduler.py", "models/auraflow/text_encoder.py",
    "models/auraflow/denoiser.py", "models/auraflow/pipeline.py", "tools/ptxas_report.py",
]
# the AuraFlow train slice: the three workloads, their CLIs and the loss
# and migration modules they use
AURAFLOW_TRAIN_MODULES = [
    "models/auraflow/train_text_to_image.py", "models/auraflow/train_shortcut.py",
    "models/auraflow/train_rope_migration.py", "modules/loss/shortcut.py",
    "modules/migration/__init__.py", "modules/migration/scale.py", "train/auraflow/__init__.py",
    "train/auraflow/text_to_image.py", "train/auraflow/shortcut.py",
    "train/auraflow/rope_migration.py",
]
# the modules of the last three kernels: the GroupNorm and 3x3 conv ops (their
# kernels are CUDA C++ sources) and the ragged-tile probe
OPS_SOURCES = [
    "ops/group_norm.py", "ops/conv3x3.py", "tools/__init__.py", "tools/partial_block_probe.py",
]

# the serving slice: the continuous batcher and the server, CLI and client
SERVING_MODULES = [
    "serving/__init__.py", "serving/continuous.py", "tools/inference_server.py",
    "tools/inference_cli.py", "tools/inference_client.py",
]
# the Flux slice: the family, the schedules, the VAE-encode migration and its script
FLUX_MODULES = [
    "models/flux/__init__.py", "models/flux/config.py", "models/flux/vae.py",
    "models/flux/text_encoder.py", "models/flux/denoiser.py", "models/flux/util.py",
    "models/flux/pipeline.py", "modules/timestep/scheduler.py",
    "models/auraflow/train_vae_encode_migration.py", "train/auraflow/vae_encode_migration.py",
]
# the CogView4 slice: GLM, the family, its train workload and script, the quant tool
COGVIEW4_MODULES = [
    "models/text_encoders/glm.py", "models/cogview4/__init__.py", "models/cogview4/config.py",
    "models/cogview4/scheduler.py", "models/cogview4/vae.py", "models/cogview4/text_encoder.py",
    "models/cogview4/denoiser.py", "models/cogview4/pipeline.py",
    "models/cogview4/train_text_to_image.py", "train/cogview4/__init__.py",
    "train/cogview4/text_to_image.py", "tools/cogview4_quant_compare.py",
]
# the Wan slice: the family and the video writer
WAN_MODULES = [
    "models/wan/__init__.py", "models/wan/config.py", "models/wan/util.py",
    "models/wan/scheduler.py", "models/wan/vae.py", "models/wan/text_encoder.py",
    "models/wan/denoiser.py", "models/wan/vae3d.py", "models/wan/pipeline.py", "utils/video.py",
]
# the single-device remainder: the optimizers, trackers, Hub and Discord
# callbacks, the checkpoint tools, offloading and FractalGen
REMAINDER_MODULES = [
    "training/optimizer.py", "utils/logging.py", "saving/__init__.py", "saving/hf_hub.py",
    "preview/__init__.py", "preview/discord.py", "tools/quantize_model.py",
    "tools/checkpoint/__init__.py", "tools/checkpoint/convert_dtype.py",
    "tools/checkpoint/to_safetensors.py", "tools/snapshot_max_memory.py", "modules/offload.py",
    "models/fractal/__init__.py", "models/fractal/order_sampler.py", "models/fractal/mask.py",
    "models/fractal/pixel.py", "models/fractal/generator.py",
]
SLICES = (LUMINA2_MODULES + AURAFLOW_MODULES + AURAFLOW_TRAIN_MODULES + OPS_SOURCES
          + SERVING_MODULES + FLUX_MODULES + COGVIEW4_MODULES + WAN_MODULES + REMAINDER_MODULES)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    """Every import statement of the port and of chip_smoke.py, also those
    inside functions, which importing the modules would not run; the repo
    root's ``tools`` package is the JAX side's too."""
    assert all((REPO / "vision_ft_tpu_torch" / name) in PORT_SOURCES for name in SLICES)
    for path in PORT_SOURCES:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "optax", "vision_ft_tpu", "tools"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


@pytest.mark.parametrize("name", SLICES)
def test_lumina2_module_reads_no_environment_variable(name):
    """The JAX package's VFT_* levers are setters in the port."""
    text = (REPO / "vision_ft_tpu_torch" / name).read_text()
    assert "os.environ" not in text and "getenv" not in text


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
