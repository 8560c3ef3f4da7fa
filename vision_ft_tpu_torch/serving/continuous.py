"""Step-level continuous batching for diffusion serving
(``vision_ft_tpu/serving/continuous.py`` counterpart).

The window micro-batcher (``tools/inference_server.py`` ``MicroBatcher``)
collates concurrent requests of one shape into one batched ``generate()``;
it wins only when requests arrive together and share their step count.
Continuous batching schedules at step granularity instead: every denoise
step of every request is one slot step over a fixed pool of S latent rows,
each request's state reduced to per-slot vectors (timestep, sigma, step
index, guidance scales, active flag). A request joins the pool at any step
boundary by overwriting a free row and leaves the same way, so requests
with other step counts, seeds and guidance scales share one batch.

The engine is family-agnostic; what is family-specific sits behind an
adapter (duck-typed):

  latent_shape, dtype, device    one slot's latent row shape, its dtype and device
  schedule(req)                  -> (timesteps (n,), sigmas (n+1,)) numpy
  encode(reqs)                   -> one context row per request
  blank_context(num_slots)       -> a dict of tensors holding all slots' rows
  write_slot(ctx, j, row)        -> ctx with slot j's row written
  scalar_fields()                -> {name: (default, numpy dtype)} per-slot tables
  request_scalars(req)           -> {name: value} of an admitted request
  init_latents(req, seed, sigmas)-> one latent row
  slot_step(latents, ctx, t, sigma, next_sigma, idx, total, scalars,
            active, host)        -> the pool's new latents
  decode(latent_row)             -> image

The per-slot tables live on the device; ``slot_step`` also gets ``host``,
the same step indices and scalars as numpy arrays (SDXL seeds a
``torch.Generator`` a slot from them, so a tick needs no copy from the
card). Each tick reads the weights through the model's live modules, so a
weight swap after the batcher is built reaches the next tick. The worker
thread enters ``torch.inference_mode()`` itself (the mode is thread-local).

SDXL's per-slot noise is batch-1 ``generate()``'s stream (slot j at step i:
a generator seeded ``(seed_j + 7919 * (i + 1)) & 0x7FFFFFFF``), so a slot's
result is the same request's through ``generate()``, up to the batch's
effect on the kernels' summation order.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils import tensor as tensor_utils


@dataclass
class SlotRequest:
    """One generation request, the unit of continuous batching. A superset
    of the families' knobs: an adapter reads the fields it owns
    (``cfg_rescale``: SDXL's std-matching rescale; ``renorm_cfg`` /
    ``cfg_trunc_ratio``: Lumina2's norm-matching renorm and early CFG skip;
    ``distilled_guidance``: Flux's)."""

    prompt: str
    negative_prompt: str = ""
    num_inference_steps: int = 20
    cfg_scale: float = 3.5
    cfg_rescale: float = 0.0
    renorm_cfg: float = 1.0
    cfg_trunc_ratio: float = 0.0
    distilled_guidance: float = 1.0
    seed: Optional[int] = None


@dataclass
class _Pending:
    request: SlotRequest
    event: threading.Event = field(default_factory=threading.Event)
    image: object = None
    error: Optional[Exception] = None


def _encode_rows(output, n: int, dtype, with_masks: bool):
    """Per-request (positive, negative[, positive mask, negative mask]) rows
    of a text encoding of n prompts and their n negatives."""
    pos = output.positive_embeddings.to(dtype)
    neg = output.negative_embeddings.to(dtype)
    if not with_masks:
        return [(pos[i], neg[i]) for i in range(n)]
    pos_m, neg_m = output.positive_attention_mask, output.negative_attention_mask
    return [(pos[i], neg[i], pos_m[i], neg_m[i]) for i in range(n)]


def _write_pair(tensor: torch.Tensor, j: int, positive, negative) -> None:
    """Slot j's positive row at j, its negative at S + j ([positives; negatives])."""
    s = tensor.shape[0] // 2
    tensor[j] = positive
    tensor[s + j] = negative


class SDXLSlotAdapter:
    """Binds the engine to an SDXL pipeline: Euler-ancestral CFG with
    rescale, per-slot noise seeds. Context rows follow ``_denoise_step``'s
    CFG split: positives [0:S], negatives [S:2S]."""

    def __init__(self, model, height: int, width: int, max_token_length: int = 75):
        self.model = model
        self.height, self.width = height, width
        self.max_token_length = max_token_length
        ratio = int(model.vae.compression_ratio)
        self.latent_shape = (height // ratio, width // ratio, model.denoiser.config.in_channels)
        self.dtype = model.dtype
        self.device = model.device
        with torch.inference_mode():
            emb, pooled = self._encode(["x"], ["y"])
        self.emb_shape, self.pooled_shape = tuple(emb.shape[1:]), tuple(pooled.shape[1:])

    def _encode(self, prompts, negatives):
        out = self.model.text_encoder.encode_prompts(
            prompts, negatives, use_negative_prompts=True, max_token_length=self.max_token_length
        )
        emb, pooled = self.model.prepare_encoder_hidden_states(out, True)
        return emb.to(self.dtype), pooled.to(self.dtype)

    def schedule(self, request: SlotRequest):
        timesteps = self.model.scheduler.get_timesteps(request.num_inference_steps)
        sigmas = self.model.scheduler.get_sigmas(timesteps)
        return np.asarray(timesteps, np.float32), np.asarray(sigmas, np.float32)

    def scalar_fields(self):
        return {"cfg_scale": (1.0, np.float32), "cfg_rescale": (0.0, np.float32),
                "seed": (0, np.int64)}

    def request_scalars(self, request: SlotRequest):
        # the engine fills the seed (it draws one if the request has none)
        return {"cfg_scale": request.cfg_scale, "cfg_rescale": request.cfg_rescale}

    def encode(self, requests: list[SlotRequest]):
        """(emb_pos, emb_neg, pooled_pos, pooled_neg) a request, one encode
        for the whole admission group."""
        emb, pooled = self._encode([r.prompt for r in requests],
                                   [r.negative_prompt or "" for r in requests])
        n = len(requests)
        return [(emb[i], emb[n + i], pooled[i], pooled[n + i]) for i in range(n)]

    def blank_context(self, num_slots: int):
        s = num_slots
        size = torch.tensor([self.height, self.width], dtype=torch.float32, device=self.device)
        return {
            "emb": torch.zeros((2 * s, *self.emb_shape), dtype=self.dtype, device=self.device),
            "pooled": torch.zeros((2 * s, *self.pooled_shape), dtype=self.dtype, device=self.device),
            "original_size": size.expand(2 * s, 2).clone(),
            "target_size": size.expand(2 * s, 2).clone(),
            "crop_coords": torch.zeros((2 * s, 2), dtype=torch.float32, device=self.device),
        }

    def write_slot(self, ctx, j: int, row):
        e_pos, e_neg, p_pos, p_neg = row
        _write_pair(ctx["emb"], j, e_pos, e_neg)
        _write_pair(ctx["pooled"], j, p_pos, p_neg)
        return ctx

    def init_latents(self, request: SlotRequest, seed: int, sigmas: np.ndarray) -> torch.Tensor:
        """Batch-1 ``prepare_latents``' row: noise from ``seed``, scaled to
        the schedule's largest sigma."""
        noise = tensor_utils.incremental_seed_randn(
            (1, *self.latent_shape), seed, self.dtype, self.device
        )[0]
        return noise * self.model.scheduler.get_max_noise_sigma(sigmas)

    def slot_step(self, latents, ctx, t, sigma, next_sigma, idx, total, scalars, active, host):
        return self.model._slot_step(
            latents, t, sigma, next_sigma, ctx["emb"], ctx["pooled"], ctx["original_size"],
            ctx["target_size"], ctx["crop_coords"], scalars["cfg_scale"], scalars["cfg_rescale"],
            host["seed"], host["idx"], active,
        )

    def decode(self, latent_row: torch.Tensor):
        # tiled at 1536 px and up, as generate() decodes
        tiled = max(self.height, self.width) >= 1536
        return self.model.decode_image(latent_row[None], use_tiling=tiled)[0]


class Lumina2SlotAdapter:
    """Binds the engine to a Lumina2 (NextDiT) pipeline: flow matching, a
    deterministic Euler update, renorm CFG and CFG truncation as per-slot
    vectors. The captions are refined again each tick (no caption cache in
    a pool: the refinement depends on neither the latents nor the time, so
    the arithmetic is generate()'s)."""

    def __init__(self, model, height: int, width: int, max_token_length: Optional[int] = None):
        from ..models.lumina2.text_encoder import DEFAULT_MAX_TOKEN_LENGTH

        self.model = model
        self.height, self.width = height, width
        self.max_token_length = max_token_length or DEFAULT_MAX_TOKEN_LENGTH
        ratio = int(model.vae.compression_ratio)
        self.latent_shape = (height // ratio, width // ratio, model.denoiser.config.in_channels)
        self.dtype = model.dtype
        self.device = model.device
        with torch.inference_mode():
            out = self._encode(["x"], ["y"])
        self.emb_shape = tuple(out.positive_embeddings.shape[1:])
        self.mask_dtype = out.positive_attention_mask.dtype

    def _encode(self, prompts, negatives):
        return self.model.text_encoder.encode_prompts(
            prompts, negatives, use_negative_prompts=True, max_token_length=self.max_token_length
        )

    def schedule(self, request: SlotRequest):
        n = request.num_inference_steps
        timesteps = self.model.scheduler.get_timesteps(n)
        sigmas = self.model.scheduler.get_sigmas(n)
        return np.asarray(timesteps, np.float32), np.asarray(sigmas, np.float32)

    def scalar_fields(self):
        return {"cfg_scale": (1.0, np.float32), "renorm_cfg": (1.0, np.float32),
                "cfg_trunc_ratio": (0.0, np.float32)}

    def request_scalars(self, request: SlotRequest):
        return {"cfg_scale": request.cfg_scale, "renorm_cfg": request.renorm_cfg,
                "cfg_trunc_ratio": request.cfg_trunc_ratio}

    def encode(self, requests: list[SlotRequest]):
        out = self._encode([r.prompt for r in requests], [r.negative_prompt or "" for r in requests])
        return _encode_rows(out, len(requests), self.dtype, with_masks=True)

    def blank_context(self, num_slots: int):
        s = num_slots
        return {
            "features": torch.zeros((2 * s, *self.emb_shape), dtype=self.dtype, device=self.device),
            "mask": torch.zeros((2 * s, *self.emb_shape[:-1]), dtype=self.mask_dtype,
                                device=self.device),
        }

    def write_slot(self, ctx, j: int, row):
        e_pos, e_neg, m_pos, m_neg = row
        _write_pair(ctx["features"], j, e_pos, e_neg)
        _write_pair(ctx["mask"], j, m_pos, m_neg)
        return ctx

    def init_latents(self, request: SlotRequest, seed: int, sigmas: np.ndarray) -> torch.Tensor:
        """Batch-1 ``prepare_latents``' row (pure noise: flow matching
        starts at sigma 1)."""
        return tensor_utils.incremental_seed_randn(
            (1, *self.latent_shape), seed, self.dtype, self.device
        )[0]

    def slot_step(self, latents, ctx, t, sigma, next_sigma, idx, total, scalars, active, host):
        return self.model._slot_step(
            latents, t, sigma, next_sigma, ctx["features"], ctx["mask"], scalars["cfg_scale"],
            scalars["renorm_cfg"], scalars["cfg_trunc_ratio"], idx, total, active,
        )

    def decode(self, latent_row: torch.Tensor):
        return self.model.decode_image(latent_row[None])[0]


class AuraFlowSlotAdapter:
    """Binds the engine to an AuraFlow (MMDiT) pipeline: flow matching with
    plain CFG (no renorm, no truncation). The denoiser's time is the
    per-slot sigma, so the engine's ``t`` goes unused; UMT5's features come
    padded to ``max_token_length``, with no mask."""

    def __init__(self, model, height: int, width: int, max_token_length: Optional[int] = None):
        from ..models.auraflow.text_encoder import DEFAULT_MAX_TOKEN_LENGTH

        self.model = model
        self.height, self.width = height, width
        self.max_token_length = max_token_length or DEFAULT_MAX_TOKEN_LENGTH
        ratio = int(model.vae.compression_ratio)
        self.latent_shape = (height // ratio, width // ratio, model.denoiser.config.in_channels)
        self.dtype = model.dtype
        self.device = model.device
        with torch.inference_mode():
            out = self._encode(["x"], ["y"])
        self.emb_shape = tuple(out.positive_embeddings.shape[1:])

    def _encode(self, prompts, negatives):
        return self.model.text_encoder.encode_prompts(
            prompts, negatives, use_negative_prompts=True, max_token_length=self.max_token_length
        )

    def schedule(self, request: SlotRequest):
        # a pure accessor: the scheduler's own tables are not rewritten
        timesteps, sigmas = self.model.scheduler.schedule_tables(request.num_inference_steps)
        return np.asarray(timesteps, np.float32), np.asarray(sigmas, np.float32)

    def scalar_fields(self):
        return {"cfg_scale": (1.0, np.float32)}

    def request_scalars(self, request: SlotRequest):
        return {"cfg_scale": request.cfg_scale}

    def encode(self, requests: list[SlotRequest]):
        out = self._encode([r.prompt for r in requests], [r.negative_prompt or "" for r in requests])
        return _encode_rows(out, len(requests), self.dtype, with_masks=False)

    def blank_context(self, num_slots: int):
        return {"emb": torch.zeros((2 * num_slots, *self.emb_shape), dtype=self.dtype,
                                   device=self.device)}

    def write_slot(self, ctx, j: int, row):
        _write_pair(ctx["emb"], j, *row)
        return ctx

    def init_latents(self, request: SlotRequest, seed: int, sigmas: np.ndarray) -> torch.Tensor:
        """Batch-1 ``prepare_latents``' row (pure noise: the shifted schedule
        starts at sigma 1)."""
        return tensor_utils.incremental_seed_randn(
            (1, *self.latent_shape), seed, self.dtype, self.device
        )[0]

    def slot_step(self, latents, ctx, t, sigma, next_sigma, idx, total, scalars, active, host):
        return self.model._slot_step(
            latents, t, sigma, next_sigma, ctx["emb"], scalars["cfg_scale"], active
        )

    def decode(self, latent_row: torch.Tensor):
        return self.model.decode_image(latent_row[None])[0]


class FluxSlotAdapter:
    """Binds the engine to a Flux pipeline: flow matching whose Euler delta
    is the constant 1/n of ``generate()`` (from the engine's per-slot
    ``total``, not a sigma difference), the distilled guidance a per-slot
    vector into the denoiser's guidance embedding (gated per row, so a slot
    of guidance 0 beside others equals its batch-1 ``generate()``), plain
    CFG per slot. The context is the pair of encoders: T5's padded sequence
    and CLIP's pooled vector."""

    def __init__(self, model, height: int, width: int, max_token_length: Optional[int] = None):
        from ..models.flux.text_encoder import DEFAULT_T5_MAX_TOKEN_LENGTH

        self.model = model
        self.height, self.width = height, width
        self.max_token_length = max_token_length or DEFAULT_T5_MAX_TOKEN_LENGTH
        ratio = int(model.vae.compression_ratio)
        self.latent_shape = (height // ratio, width // ratio, model.vae.config.latent_channels)
        self.dtype = model.dtype
        self.device = model.device
        with torch.inference_mode():
            out = self._encode(["x"], ["y"])
        self.t5_shape = tuple(out.t5.positive_embeddings.shape[1:])
        self.clip_shape = tuple(out.clip.positive_embeddings.shape[1:])

    def _encode(self, prompts, negatives):
        return self.model.text_encoder.encode_prompts(
            prompts, negatives, use_negative_prompts=True,
            t5_max_token_length=self.max_token_length,
        )

    def schedule(self, request: SlotRequest):
        from ..modules.timestep.scheduler import get_linear_schedule

        timesteps = get_linear_schedule(request.num_inference_steps)
        # the slot step takes its delta from the total; the sigma table is
        # bookkeeping (the engine wants n + 1 rows)
        sigmas = np.concatenate([timesteps, [0.0]]).astype(np.float32)
        return np.asarray(timesteps, np.float32), sigmas

    def scalar_fields(self):
        return {"cfg_scale": (1.0, np.float32), "distilled_guidance": (1.0, np.float32)}

    def request_scalars(self, request: SlotRequest):
        return {"cfg_scale": request.cfg_scale, "distilled_guidance": request.distilled_guidance}

    def encode(self, requests: list[SlotRequest]):
        """(t5_pos, t5_neg, clip_pos, clip_neg) a request, one encode for the
        whole admission group."""
        out = self._encode([r.prompt for r in requests], [r.negative_prompt or "" for r in requests])
        t5 = _encode_rows(out.t5, len(requests), self.dtype, with_masks=False)
        clip = _encode_rows(out.clip, len(requests), self.dtype, with_masks=False)
        return [t + c for t, c in zip(t5, clip)]

    def blank_context(self, num_slots: int):
        s = num_slots
        return {
            "t5": torch.zeros((2 * s, *self.t5_shape), dtype=self.dtype, device=self.device),
            "clip": torch.zeros((2 * s, *self.clip_shape), dtype=self.dtype, device=self.device),
        }

    def write_slot(self, ctx, j: int, row):
        t5_pos, t5_neg, clip_pos, clip_neg = row
        _write_pair(ctx["t5"], j, t5_pos, t5_neg)
        _write_pair(ctx["clip"], j, clip_pos, clip_neg)
        return ctx

    def init_latents(self, request: SlotRequest, seed: int, sigmas: np.ndarray) -> torch.Tensor:
        """Batch-1 ``prepare_latents``' row (pure noise: the flow starts at
        t = 1)."""
        return tensor_utils.incremental_seed_randn(
            (1, *self.latent_shape), seed, self.dtype, self.device
        )[0]

    def slot_step(self, latents, ctx, t, sigma, next_sigma, idx, total, scalars, active, host):
        return self.model._slot_step(
            latents, t, total, ctx["t5"], ctx["clip"], scalars["distilled_guidance"],
            scalars["cfg_scale"], active,
        )

    def decode(self, latent_row: torch.Tensor):
        return self.model.decode_image(latent_row[None])[0]


class CogView4SlotAdapter(AuraFlowSlotAdapter):
    """Binds the engine to a CogView4 (DiT) pipeline: AuraFlow's flow
    matching with plain CFG, each slot's timestep its own row of the time
    embedding, and the size conditioning, whose original / target / crop
    rows (the pool's image size, no crop) ride the context beside the GLM
    features. The schedule is the pipeline's ``prepare_timesteps``, shifted
    by the pool's fixed image size. GLM's features are as long as the
    pool's probe encoding (prompts padded to the longest, then to a
    multiple of 16); a longer request raises."""

    def __init__(self, model, height: int, width: int, max_token_length: Optional[int] = None):
        from ..models.cogview4.text_encoder import DEFAULT_MAX_TOKEN_LENGTH

        super().__init__(model, height, width, max_token_length or DEFAULT_MAX_TOKEN_LENGTH)

    def schedule(self, request: SlotRequest):
        timesteps, sigmas = self.model.prepare_timesteps(
            request.num_inference_steps, self.height, self.width
        )
        return np.asarray(timesteps, np.float32), np.asarray(sigmas, np.float32)

    def encode(self, requests: list[SlotRequest]):
        rows = super().encode(requests)
        if tuple(rows[0][0].shape) != self.emb_shape:
            raise ValueError(f"CogView4 pool: prompt features {tuple(rows[0][0].shape)} do not "
                             f"fit the pool's {self.emb_shape}")
        return rows

    def blank_context(self, num_slots: int):
        size = torch.tensor([self.height, self.width], dtype=torch.float32, device=self.device)
        return {
            **super().blank_context(num_slots),
            "original_size": size.expand(2 * num_slots, 2).contiguous(),
            "target_size": size.expand(2 * num_slots, 2).contiguous(),
            "crop_coords": torch.zeros((2 * num_slots, 2), dtype=torch.float32, device=self.device),
        }

    def slot_step(self, latents, ctx, t, sigma, next_sigma, idx, total, scalars, active, host):
        return self.model._slot_step(
            latents, t, sigma, next_sigma, ctx["emb"], ctx["original_size"], ctx["target_size"],
            ctx["crop_coords"], scalars["cfg_scale"], active,
        )


class ContinuousBatcher:
    """Fixed-slot step-level scheduler.

    One worker thread owns the pool; ``submit`` blocks the calling (HTTP
    handler) thread until its image is ready, the ``MicroBatcher``
    contract, so the server swaps schedulers with a flag. Each loop: admit
    queued requests into free slots (one text encode a group), run one
    slot step over the pool, retire finished slots (a batch-1 VAE decode
    each)."""

    def __init__(self, adapter, num_slots: int = 4, max_steps: int = 50):
        self.adapter = adapter
        self.num_slots = num_slots
        self.max_steps = max_steps
        s, device = num_slots, adapter.device
        self._latents = torch.zeros((s, *adapter.latent_shape), dtype=adapter.dtype, device=device)
        self._ctx = adapter.blank_context(s)

        # host mirrors for admission and retirement
        self._step_idx = np.zeros(s, np.int64)
        self._total = np.zeros(s, np.int64)
        self._active = np.zeros(s, bool)
        self._pending_by_slot: list[Optional[_Pending]] = [None] * s
        fields = adapter.scalar_fields()
        self._h_scalars = {name: np.full(s, default, dtype)
                           for name, (default, dtype) in fields.items()}

        # per-slot tables on the device: a tick copies nothing from the host
        self._d_t = torch.zeros((s, max_steps), dtype=torch.float32, device=device)
        self._d_sig = torch.zeros((s, max_steps + 1), dtype=torch.float32, device=device)
        self._d_idx = torch.zeros(s, dtype=torch.int64, device=device)
        self._d_total = torch.ones(s, dtype=torch.int64, device=device)
        self._d_active = torch.zeros(s, dtype=torch.bool, device=device)
        self._d_scalars = {name: torch.from_numpy(v.copy()).to(device)
                           for name, v in self._h_scalars.items()}
        self._rows = torch.arange(s, device=device)

        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self.ticks = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API -------------------------------------------------------------

    def submit(self, request: SlotRequest):
        if request.num_inference_steps > self.max_steps:
            raise ValueError(
                f"num_inference_steps {request.num_inference_steps} exceeds "
                f"engine max_steps {self.max_steps}"
            )
        item = _Pending(request)
        with self._cv:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            self._queue.append(item)
            self._cv.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.image

    def close(self, timeout: float = 5.0):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=timeout)

    # -- worker -------------------------------------------------------------------

    def _admit(self):
        """Move queued requests into free slots (one text encode a group)."""
        free = [j for j in range(self.num_slots) if not self._active[j]]
        with self._cv:
            take = min(len(free), len(self._queue))
            group = self._queue[:take]
            del self._queue[:take]
        if not group:
            return
        rows = self.adapter.encode([p.request for p in group])
        admitted = False
        for pending, row in zip(group, rows):
            r = pending.request
            t_row, sig_row = self.adapter.schedule(r)
            n = len(t_row)
            if n > self.max_steps:
                # a schedule may have more rows than num_inference_steps
                # (SDXL's integer step ratio gives n + 1 for counts that do
                # not divide 1000): this request fails, not the pool
                pending.error = ValueError(
                    f"schedule length {n} exceeds engine max_steps {self.max_steps} "
                    f"(num_inference_steps={r.num_inference_steps})"
                )
                pending.event.set()
                continue
            j = free.pop(0)
            row_t = np.zeros(self.max_steps, np.float32)
            row_t[:n] = t_row
            row_sig = np.zeros(self.max_steps + 1, np.float32)
            row_sig[: n + 1] = sig_row
            self._d_t[j] = torch.from_numpy(row_t)
            self._d_sig[j] = torch.from_numpy(row_sig)
            self._step_idx[j] = 0
            self._total[j] = n
            scalars = dict(self.adapter.request_scalars(r))
            seed = r.seed if r.seed is not None else int(np.random.randint(0, 2**31 - 1))
            if "seed" in self._h_scalars:
                scalars["seed"] = seed
            for name, value in scalars.items():
                self._h_scalars[name][j] = value
            self._latents[j] = self.adapter.init_latents(r, seed, sig_row[: n + 1])
            self._ctx = self.adapter.write_slot(self._ctx, j, row)
            self._active[j] = True
            self._pending_by_slot[j] = pending
            admitted = True
        if admitted:  # one copy of each small table for the group
            self._sync_tables()

    def _sync_tables(self):
        """The host mirrors of index, length, activity and scalars to the
        card (the index advances on the card between admissions, in step
        with the host's)."""
        self._d_idx.copy_(torch.from_numpy(self._step_idx))
        self._d_total.copy_(torch.from_numpy(self._total))
        self._d_active.copy_(torch.from_numpy(self._active))
        for name, values in self._h_scalars.items():
            self._d_scalars[name].copy_(torch.from_numpy(values))

    def _tick(self):
        """One slot step over the pool, then retire the finished slots."""
        total = self._d_total.clamp_min(1)
        cidx = torch.minimum(self._d_idx, total - 1)
        t = self._d_t[self._rows, cidx]
        sigma = self._d_sig[self._rows, cidx]
        next_sigma = self._d_sig[self._rows, cidx + 1]
        host = {"idx": np.minimum(self._step_idx, np.maximum(self._total, 1) - 1),
                **self._h_scalars}
        self._latents = self.adapter.slot_step(
            self._latents, self._ctx, t, sigma, next_sigma, cidx, total, self._d_scalars,
            self._d_active, host,
        )
        self._d_idx = torch.where(self._d_active, self._d_idx + 1, self._d_idx)
        self.ticks += 1
        self._step_idx[self._active] += 1
        done = self._active & (self._step_idx >= self._total)
        for j in np.nonzero(done)[0].tolist():
            pending = self._pending_by_slot[j]
            try:  # the slot still names its request while it decodes
                pending.image = self.adapter.decode(self._latents[j])
            except Exception as exc:  # deliver it, keep the worker
                pending.error = exc
            self._pending_by_slot[j] = None
            self._active[j] = False
            self._d_active[j] = False
            pending.event.set()

    def _run(self):
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._active.any():
                    if self._closed:
                        return
                    self._cv.wait()
            try:
                self._admit()
                if self._active.any():
                    self._tick()
            except Exception as exc:
                # a failed step fails every request in flight and in the
                # queue, rather than leaving their submitters waiting
                for j in range(self.num_slots):
                    pending = self._pending_by_slot[j]
                    if pending is not None:
                        pending.error = exc
                        pending.event.set()
                        self._pending_by_slot[j] = None
                    self._active[j] = False
                self._d_active.zero_()
                with self._cv:
                    for item in self._queue:
                        item.error = exc
                        item.event.set()
                    self._queue.clear()
                time.sleep(0.01)
