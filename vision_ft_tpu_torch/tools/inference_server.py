"""Batched inference HTTP server of the port (``tools/inference_server.py``
counterpart): POST /predict with a JSON ``GenerationParams`` body returns
image/webp bytes (video/mp4 for wan); GET /health answers ``{"status":
"ok"}``. It serves the sdxl, lumina2, auraflow, cogview4, flux and wan
families from a TrainConfig YAML (its ``model`` section: for wan the
``denoiser_path``, ``text_encoder_path`` and ``vae_path`` of its three
files) and optional PEFT safetensors, on the card:

    python3 -m vision_ft_tpu_torch.tools.inference_server -C configs/sdxl/x.yml \\
        --family sdxl --tokenizer-path /path/to/clip_vocab --port 8123 \\
        --scheduler continuous --num-slots 4 --pool-width 1024 --pool-height 1024

Two schedulers. ``window`` (the default): a collator thread groups
compatible requests (same size, steps and guidance: ``batch_key``) that
arrive within ``--batch-window-ms`` into one batched ``generate()``, padded
to a power-of-two batch unless ``--no-batch-buckets``; a seeded request runs
alone. ``continuous``: step-level continuous batching
(``vision_ft_tpu_torch.serving``): requests join a fixed pool of latent
slots at denoise-step boundaries, so staggered traffic with mixed step
counts, seeds and guidance shares the card with no window and no lockstep;
it serves the image families (wan runs on the window scheduler, where a
request's ``frames`` defaults to 16).

The kernels of the family's path are built before the worker thread
starts, so no build races a request. Flux takes the T5 tokenizer of
``--tokenizer-path`` and a CLIP tokenizer from its ``clip/`` subfolder.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from typing import Optional, Sequence

from pydantic import BaseModel, field_validator

SERVED_FAMILIES = ("sdxl", "lumina2", "auraflow", "cogview4", "flux", "wan")
TOKENIZER_FAMILY = {
    "sdxl": "clip", "lumina2": "gemma", "auraflow": "t5", "cogview4": "glm", "flux": "t5",
    "wan": "t5",
}
# the CUDA libraries each family's path launches (SDXL's and CogView4's 4-bit
# kernels with a quantized base)
FAMILY_KERNELS = {
    "sdxl": ("flash_attention_bshd", "layer_norm", "nf4_matmul"),
    "lumina2": ("flash_attention_masked", "fused_mlp"),
    "auraflow": ("flash_attention_bshd", "fused_mlp"),
    "cogview4": ("flash_attention_bshd", "nf4_matmul"),
    "flux": ("flash_attention_bshd", "layer_norm"),
    "wan": ("flash_attention_bshd", "layer_norm"),
}
WAN_DEFAULT_FRAMES = 16

DEFAULT_NEGATIVE = (
    "bad quality, worst quality, lowres, bad anatomy, sketch, jpeg artifacts, "
    "ugly, poorly drawn, signature, watermark, bad anatomy, bad hands, bad feet, "
    "retro, old, 2000s, 2010s, 2011s, 2012s, 2013s, multiple views, screencap"
)


def check_family(family: str) -> None:
    """Raise by name unless the port serves ``family``."""
    if family not in SERVED_FAMILIES:
        raise ValueError(f"unsupported server family: {family!r}")


def prepare_kernels(family: str, device) -> None:
    """Build and load the family's CUDA libraries (on a CUDA device only)."""
    import torch

    if torch.device(device).type != "cuda":
        return
    from ..ops import _build

    _build.build_cuda_libraries(FAMILY_KERNELS[family])
    for name in FAMILY_KERNELS[family]:
        _build.cuda_library(name)


class GenerationParams(BaseModel):
    prompt: str
    negative_prompt: str = DEFAULT_NEGATIVE
    inference_steps: int = 25
    cfg_scale: float = 6.5
    cfg_rescale: float = 0.0  # SDXL only (std-matching CFG rescale)
    renorm_cfg: float = 1.0  # Lumina2 only (norm-matching renorm CFG)
    cfg_trunc_ratio: float = 0.0  # Lumina2 only (CFG skipped early in the schedule)
    distilled_guidance: float = 1.0  # Flux only
    frames: Optional[int] = None  # Wan only (default 16)
    fps: int = 24  # Wan only: the mp4 reply's frame rate
    width: int = 768
    height: int = 1024
    seed: Optional[int] = None  # deterministic generation (all families)

    @field_validator("width", "height")
    @classmethod
    def check_divisible_by_64(cls, value):
        if value % 64 != 0:
            raise ValueError(f"{value} is not divisible by 64")
        return value

    @field_validator("cfg_rescale", "cfg_trunc_ratio")
    @classmethod
    def check_unit_range(cls, value):
        if not 0.0 <= value <= 1.0:
            raise ValueError("cfg_rescale / cfg_trunc_ratio must be in [0, 1]")
        return value

    @field_validator("renorm_cfg")
    @classmethod
    def check_renorm_nonnegative(cls, value):
        if value < 0.0:
            raise ValueError("renorm_cfg must be >= 0 (0 disables)")
        return value

    @field_validator("distilled_guidance")
    @classmethod
    def check_distilled_nonnegative(cls, value):
        if value < 0.0:
            raise ValueError("distilled_guidance must be >= 0")
        return value

    @field_validator("frames", "fps")
    @classmethod
    def check_positive(cls, value):
        if value is not None and value < 1:
            raise ValueError("frames / fps must be >= 1")
        return value


def flux_clip_tokenizer(tokenizer_path: Optional[str]):
    """Flux's CLIP tokenizer: the ``clip/`` subfolder of the T5 tokenizer's
    directory where there is one (as the JAX tools look for it), else None."""
    import os

    if tokenizer_path is None or not os.path.isdir(os.path.join(tokenizer_path, "clip")):
        return None
    from ..models.text_encoders.tokenizer import CLIPTokenizer

    return CLIPTokenizer.from_pretrained_dir(os.path.join(tokenizer_path, "clip"))


def load_model(family: str, model_config: dict, tokenizer_path: Optional[str] = None,
               peft_path: Optional[str] = None, device=None):
    """The family's pipeline from its single-file checkpoint (the config's
    ``checkpoint_path``; for wan its three files) on ``device`` (default:
    the card), with the PEFT adapters of ``peft_path`` attached (for wan,
    in the denoiser file's keys, to the denoiser)."""
    check_family(family)
    tokenizer = None
    if tokenizer_path is not None:
        from ..models.text_encoders.auto_tokenizer import load_tokenizer

        tokenizer = load_tokenizer(tokenizer_path, family=TOKENIZER_FAMILY[family])
    if family == "sdxl":
        from ..models.sdxl.config import SDXLConfig
        from ..models.sdxl.pipeline import SDXLModel
        from ..models.sdxl.util import convert_from_original_key

        model = SDXLModel.from_checkpoint(
            SDXLConfig.model_validate(model_config), tokenizer=tokenizer, device=device
        )
    elif family == "lumina2":
        from ..models.lumina2.config import Lumina2Config
        from ..models.lumina2.pipeline import Lumina2
        from ..models.lumina2.util import convert_from_original_key

        model = Lumina2.from_checkpoint(
            Lumina2Config.model_validate(model_config), tokenizer=tokenizer, device=device
        )
    elif family == "auraflow":
        from ..models.auraflow import AuraFlowConig, AuraFlowModel
        from ..models.auraflow.util import convert_from_original_key

        model = AuraFlowModel.from_original_checkpoint(
            AuraFlowConig.model_validate(model_config), tokenizer=tokenizer, device=device
        )
    elif family == "cogview4":
        from ..models.cogview4 import CogView4Config, CogView4Model, convert_from_original_key

        model = CogView4Model.from_checkpoint(
            CogView4Config.model_validate(model_config), tokenizer=tokenizer, device=device
        )
    elif family == "flux":
        from ..models.flux import FluxConfig, FluxModel
        from ..models.flux.util import convert_from_original_key

        model = FluxModel.from_checkpoint(
            FluxConfig.model_validate(model_config), device=device, t5_tokenizer=tokenizer,
            clip_tokenizer=flux_clip_tokenizer(tokenizer_path),
        )
    else:
        from ..models.wan import Wan22, WanConfig
        from ..models.wan.util import peft_convert_from_original_key as convert_from_original_key

        model = Wan22.from_checkpoint(WanConfig.model_validate(model_config), tokenizer=tokenizer,
                                      device=device)
    if peft_path is not None:
        from ..modules.peft import load_peft_weight
        from ..utils import safetensors as st

        print(f"Loading PEFT weights from {peft_path}")
        state = {convert_from_original_key(k): v for k, v in st.load_file(peft_path).items()}
        load_peft_weight(model.as_module(), state)
    return model


class T2IModel:
    """A served pipeline: ``generate_batch`` runs one ``generate()`` over a
    compatible group of requests."""

    def __init__(self, config_path: str, peft_path: Optional[str],
                 tokenizer_path: Optional[str], family: str = "auraflow",
                 deep_cache_interval: Optional[int] = None, device=None):
        if deep_cache_interval is not None and deep_cache_interval < 1:
            raise ValueError("deep_cache_interval must be >= 1")
        check_family(family)
        import yaml

        from ..config import TrainConfig

        with open(config_path) as f:
            config = TrainConfig(**yaml.safe_load(f))
        self.model = load_model(family, config.model, tokenizer_path, peft_path, device)
        self._family = family
        self._extra = {"deep_cache_interval": deep_cache_interval} if deep_cache_interval else {}
        self._lock = threading.Lock()

    def generate_batch(self, batch: "list[GenerationParams]"):
        """One ``generate()`` over a compatible group (same size, steps and
        guidance); one image (for wan, one list of frames) a request, in
        order."""
        with self._lock:  # one generate() at a time on the card
            head = batch[0]
            extra = dict(self._extra)
            if head.cfg_rescale:
                if self._family != "sdxl":
                    raise ValueError("cfg_rescale is SDXL-only")
                extra["cfg_rescale"] = head.cfg_rescale
            if self._family == "lumina2":
                extra["renorm_cfg_scale"] = head.renorm_cfg
                extra["cfg_truncation_ratio"] = head.cfg_trunc_ratio
            else:
                if head.renorm_cfg != 1.0:
                    raise ValueError("renorm_cfg is Lumina2-only")
                if head.cfg_trunc_ratio != 0.0:
                    raise ValueError("cfg_trunc_ratio is Lumina2-only")
            if self._family == "flux":
                extra["distilled_guidance_scale"] = head.distilled_guidance
            elif head.distilled_guidance != 1.0:
                raise ValueError("distilled_guidance is Flux-only")
            if self._family == "wan":
                extra["frames"] = head.frames if head.frames is not None else WAN_DEFAULT_FRAMES
            elif head.frames is not None:
                raise ValueError("frames is Wan-only (video)")
            if head.seed is not None:  # the seed is in batch_key: the group shares it
                extra["seed"] = head.seed
            return self.model.generate(
                prompt=[p.prompt for p in batch],
                negative_prompt=[p.negative_prompt for p in batch],
                num_inference_steps=head.inference_steps,
                cfg_scale=head.cfg_scale,
                width=head.width,
                height=head.height,
                **extra,
            )


def batch_key(params: GenerationParams) -> tuple:
    """Requests batch together when everything but the prompts matches."""
    return (
        params.width, params.height, params.inference_steps,
        params.cfg_scale, params.cfg_rescale,
        params.renorm_cfg, params.cfg_trunc_ratio,
        params.distilled_guidance, params.frames, params.seed,
    )


class _Pending:
    __slots__ = ("params", "event", "image", "error")

    def __init__(self, params: GenerationParams):
        self.params = params
        self.event = threading.Event()
        self.image = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Collates concurrent requests into batched ``generate()`` calls.

    One worker drains the queue: it takes the oldest request, waits up to
    ``window_ms`` (by ``clock``, in seconds) for more with the same
    ``batch_key``, then runs them as one ``generate()``. Incompatible
    requests stay queued for the next round. ``submit`` blocks the calling
    (HTTP handler) thread until its image is ready. ``wake()`` makes the
    worker look at the queue and the clock again (a caller that moved an
    injected clock)."""

    def __init__(self, model, max_batch: int = 4, window_ms: float = 25.0,
                 pad_to_bucket: bool = True, clock=time.monotonic):
        self.model = model
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        # a group padded to a power-of-two batch (its last request
        # repeated): few distinct batch shapes, at most 2x the work
        self.pad_to_bucket = pad_to_bucket
        self.clock = clock
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, params: GenerationParams):
        item = _Pending(params)
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.image

    def queued(self) -> int:
        with self._cv:
            return len(self._queue)

    def wake(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _take_group(self) -> "list[_Pending]":
        with self._cv:
            while not self._queue:
                self._cv.wait()
            head = self._queue[0]
            if head.params.seed is not None:
                # a seeded request runs alone: row i of a batch draws from
                # seed + i, so sharing a batch would change its image
                self._queue.remove(head)
                return [head]
            key = batch_key(head.params)
            deadline = self.clock() + self.window_s
            while True:
                group = [p for p in self._queue if batch_key(p.params) == key]
                if len(group) >= self.max_batch:
                    group = group[: self.max_batch]
                    break
                remaining = deadline - self.clock()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            for p in group:
                self._queue.remove(p)
            return group

    def _run(self):
        import torch

        with torch.inference_mode():
            while True:
                group = self._take_group()
                try:
                    batch = [p.params for p in group]
                    if self.pad_to_bucket:
                        bucket = 1
                        while bucket < len(batch):
                            bucket *= 2
                        batch = batch + [batch[-1]] * (bucket - len(batch))
                    images = self.model.generate_batch(batch)
                    for p, image in zip(group, images):
                        p.image = image
                except Exception as e:
                    for p in group:
                        p.error = e
                finally:
                    for p in group:
                        p.event.set()


class ContinuousScheduler:
    """Step-level continuous batching behind the server's ``submit``
    contract (``serving.ContinuousBatcher``). The pool's latent size is
    fixed at construction; a request of another size is refused (serve it
    from a second server or the window scheduler)."""

    def __init__(self, model: T2IModel, height: int, width: int,
                 num_slots: int = 4, max_steps: int = 50):
        from ..serving import (
            AuraFlowSlotAdapter,
            CogView4SlotAdapter,
            ContinuousBatcher,
            FluxSlotAdapter,
            Lumina2SlotAdapter,
            SDXLSlotAdapter,
        )

        adapters = {
            "sdxl": SDXLSlotAdapter,
            "lumina2": Lumina2SlotAdapter,
            "auraflow": AuraFlowSlotAdapter,
            "cogview4": CogView4SlotAdapter,
            "flux": FluxSlotAdapter,
        }
        if model._family not in adapters:
            raise ValueError(
                f"--scheduler continuous currently serves {sorted(adapters)} "
                f"(got {model._family!r})"
            )
        self._family = model._family
        self.height, self.width = height, width
        self._engine = ContinuousBatcher(
            adapters[model._family](model.model, height=height, width=width),
            num_slots=num_slots, max_steps=max_steps,
        )

    def submit(self, params: GenerationParams):
        from ..serving import SlotRequest

        if (params.width, params.height) != (self.width, self.height):
            raise ValueError(
                f"continuous pool is fixed at {self.width}x{self.height}; "
                f"got {params.width}x{params.height}"
            )
        family_only = (
            ("cfg_rescale", 0.0, "SDXL", "sdxl"),
            ("renorm_cfg", 1.0, "Lumina2", "lumina2"),
            ("cfg_trunc_ratio", 0.0, "Lumina2", "lumina2"),
            ("distilled_guidance", 1.0, "Flux", "flux"),
        )
        for name, neutral, owner, allowed in family_only:
            if getattr(params, name) != neutral and self._family != allowed:
                raise ValueError(f"{name} is {owner}-only")
        if params.frames is not None:
            raise ValueError("frames is Wan-only (video)")
        return self._engine.submit(SlotRequest(
            prompt=params.prompt,
            negative_prompt=params.negative_prompt,
            num_inference_steps=params.inference_steps,
            cfg_scale=params.cfg_scale,
            cfg_rescale=params.cfg_rescale,
            renorm_cfg=params.renorm_cfg,
            cfg_trunc_ratio=params.cfg_trunc_ratio,
            distilled_guidance=params.distilled_guidance,
            seed=params.seed,
        ))

    def close(self):
        self._engine.close()


def mp4_bytes(frames, fps: int) -> bytes:
    """The frames as the bytes of an mp4 file (OpenCV's mp4v writer)."""
    import os

    from ..utils.video import write_images_as_temp_video

    path = write_images_as_temp_video(frames, fps=fps)
    try:
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def make_handler(batcher):
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path not in ("/predict", "/"):
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                params = GenerationParams(**body)
            except Exception as e:  # a request that does not validate: 422
                self.send_error(422, str(e))
                return
            try:
                image = batcher.submit(params)
            except Exception as e:
                self.send_error(500, str(e))
                return
            if isinstance(image, list):  # wan: a video, one image a frame
                ctype, data = "video/mp4", mp4_bytes(image, params.fps)
            else:
                buffered = BytesIO()
                image.save(buffered, format="WEBP")
                ctype, data = "image/webp", buffered.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b'{"status": "ok"}')
            else:
                self.send_error(404)

        def log_message(self, fmt, *args):
            print(f"[server] {fmt % args}")

    return Handler


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", "-C", type=str, required=True)
    parser.add_argument("--peft_path", type=str, default=None)
    parser.add_argument("--tokenizer-path", type=str, default=None)
    parser.add_argument("--family", type=str, default="auraflow",
                        help=f"the model family: one of {', '.join(SERVED_FAMILIES)}")
    parser.add_argument("--deep-cache-interval", type=int, default=None,
                        help="DeepCache full-pass interval (window scheduler)")
    parser.add_argument("--port", type=int, default=8123)
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--batch-window-ms", type=float, default=25.0)
    parser.add_argument("--no-batch-buckets", action="store_true",
                        help="run each group at its own size instead of padding it to a "
                             "power-of-two batch")
    parser.add_argument("--scheduler", choices=["window", "continuous"], default="window",
                        help="window: collate compatible requests arriving within "
                             "--batch-window-ms; continuous: a step-level slot pool of fixed "
                             "--pool-width x --pool-height")
    parser.add_argument("--num-slots", type=int, default=4,
                        help="continuous scheduler: latent slots in the pool")
    parser.add_argument("--pool-width", type=int, default=768)
    parser.add_argument("--pool-height", type=int, default=1024)
    parser.add_argument("--max-steps", type=int, default=50,
                        help="continuous scheduler: the schedule tables' length")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model runs (cuda; cpu for tests)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    print("Loading model...")
    model = T2IModel(args.config_path, args.peft_path, args.tokenizer_path, family=args.family,
                     deep_cache_interval=args.deep_cache_interval, device=args.device)
    prepare_kernels(args.family, args.device)
    if args.scheduler == "continuous":
        batcher = ContinuousScheduler(model, height=args.pool_height, width=args.pool_width,
                                      num_slots=args.num_slots, max_steps=args.max_steps)
        print(f"Serving on :{args.port} (POST /predict, continuous batching, "
              f"{args.num_slots} slots @ {args.pool_width}x{args.pool_height})")
    else:
        batcher = MicroBatcher(model, max_batch=args.max_batch, window_ms=args.batch_window_ms,
                               pad_to_bucket=not args.no_batch_buckets)
        print(f"Serving on :{args.port} (POST /predict, micro-batch <= {args.max_batch})")
    ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(batcher)).serve_forever()


if __name__ == "__main__":
    main()
