"""Trainer: the training run (``vision_ft_tpu/trainer/common.py``
counterpart) on one device.

Config -> dataloaders, saving and preview strategies, PEFT, optimizer and
schedule, then the epoch/step loop with gradient accumulation and the
saving and preview cadence. The loop body is ``training.make_train_step``
over the workload's ``loss_fn``: with ``gradient_accumulation_steps`` N,
N successive loader batches (possibly of different bucket shapes) make one
optimizer step, and a remainder carries over into the next epoch, as in
the JAX package. The base model is frozen by ``requires_grad``: only the
trainable split (the adapters under PEFT) gets gradients.

Evaluation weights: with ``trainer.ema_decay`` d an fp32 EMA of the
trainable parameters (``ema * d + x * (1 - d)`` after every optimizer
step; for a schedule-free optimizer x is its evaluation point), else for a
schedule-free optimizer its average x in place of the trained y. Saving
and previews see them, cast to each parameter's dtype, and the live
parameters come back bit for bit afterwards; after the last step the
model keeps them.

``trainer.state_checkpoint_dir``: {step, trainable, optimizer state, EMA}
every ``state_checkpoint_every_steps`` loader steps
(``training/state_checkpoint.py``); with ``resume_from_state_checkpoint``
the newest is restored before the first epoch. As in the JAX package only
the state is recovered: the data stream and the generator restart from the
seed. ``trainer.profile``: ``torch.profiler`` from ``profile_start_step``
to ``profile_stop_step`` (synchronized at the stop), a Chrome trace under
``profile_dir``. ``trainer.debug_mode``: "dataset" prints the loader's
batch shapes and returns, "sanity_check" returns after the model's sanity
check, "1step" stops after one loader step; ``trainer.debug_nans`` runs the
steps under ``torch.autograd.detect_anomaly(check_nan=True)`` and raises
``FloatingPointError`` at the first non-finite loss or gradient.

The run is on the card unless the caller names another device
(``device="cpu"``, as the tests do). A mesh of more than one device is not
ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional

import torch

from ..config import DEBUG_MODE_TYPE, TrainConfig
from ..dataloader import DataLoader, get_dataloader_for_bucketing, get_dataloader_for_preview
from ..dataset.util import DatasetConfig
from ..models.for_training import ModelForTraining
from ..modules.peft import split_peft_params
from ..nn import set_remat_group, set_remat_saves
from ..preview import PreviewStrategy, get_preview_callback
from ..saving import ModelSavingStrategy, get_saving_callback
from ..training import Microbatches, get_optimizer, get_schedule, init_train_state, make_train_step
from ..training.optimizer import eval_params, is_schedule_free
from ..training.state_checkpoint import restore_train_state, save_train_state
from ..utils.logging import Trackers, get_trackers


def _check_ported(config: TrainConfig) -> None:
    """Raise ``NotImplementedError`` on a mesh of more than one device."""
    mesh = config.trainer.mesh
    if mesh.data not in (-1, 1) or (mesh.fsdp, mesh.tensor, mesh.pipe) != (1, 1, 1):
        raise NotImplementedError(f"a mesh of more than one device ({mesh}) is not ported")


def _fp32_copies(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    # x.float() of an fp32 tensor is x itself: an EMA made so would track
    # the live weights, so copy explicitly
    return {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}


class Trainer:
    model: ModelForTraining

    def __init__(
        self, config: TrainConfig, seed: Optional[int] = None,
        device: Optional[torch.device | str] = None,
    ) -> None:
        _check_ported(config)
        self.config = config
        self.peft_config = config.peft
        self.seed = seed if seed is not None else config.seed
        self.device = torch.device("cuda" if device is None else device)
        self.debug_mode: DEBUG_MODE_TYPE = config.trainer.debug_mode
        self.gradient_accumulation_steps = config.trainer.gradient_accumulation_steps

        set_remat_saves(config.trainer.remat_saves)
        set_remat_group(config.trainer.remat_group)

        self.trackers: Optional[Trackers] = None
        tracker_names = get_trackers(config)
        if tracker_names:
            self.trackers = Trackers(tracker_names, config.tracker.project_name, config.model_dump())

        self.preview_dataset_config = None
        self.preview_dataloader: Optional[DataLoader] = None
        self.ema: Optional[dict[str, torch.Tensor]] = None  # set by prepare_optimizer
        self.profile_trace: Optional[str] = None  # the last trace the profiler wrote

    # -- registration ------------------------------------------------------------

    def register_model_class(self, model_cls: type[ModelForTraining], *args, **kwargs):
        self.model_cls = model_cls
        self.model = model_cls(self, self.config, *args, **kwargs)

    def register_train_dataset_class(self, dataset_config_class: type[DatasetConfig], *a, **k):
        self.dataset_config = dataset_config_class.model_validate(self.config.dataset)

    def register_preview_dataset_class(self, dataset_config_class, *a, **k):
        if self.config.preview is not None:
            self.preview_dataset_config = dataset_config_class.model_validate(
                self.config.preview.data
            )

    # -- preparation ---------------------------------------------------------------

    def get_saving_callbacks(self):
        if (saving := self.config.saving) is not None:
            if len(saving.callbacks) == 0:
                warnings.warn("No saving callbacks found in the config")
            return [get_saving_callback(cb) for cb in saving.callbacks]
        self.print("No saving config. Model will not be saved.")
        return []

    def get_preview_callbacks(self):
        if (preview := self.config.preview) is not None:
            if len(preview.callbacks) == 0:
                warnings.warn("No preview callbacks found in the config")
            return [get_preview_callback(cb) for cb in preview.callbacks]
        self.print("No preview config. Preview will not be generated.")
        return []

    def prepare_dataloaders(self) -> None:
        train_ds = self.dataset_config.get_dataset()
        self.train_dataloader = get_dataloader_for_bucketing(
            train_ds,
            shuffle=self.dataset_config.shuffle,
            seed=self.seed,
            num_workers=getattr(self.dataset_config, "num_workers", 0),
        )
        if self.config.preview is not None and self.preview_dataset_config is not None:
            self.print("Preview config found. Preparing preview dataloader...")
            self.preview_dataloader = get_dataloader_for_preview(
                self.preview_dataset_config.get_dataset()
            )

    def prepare_saving_strategy(self) -> None:
        steps_per_epoch = len(self.train_dataloader)
        if (saving := self.config.saving) is not None:
            self.saving_strategy = ModelSavingStrategy.from_config(
                config=saving.strategy, steps_per_epoch=steps_per_epoch,
                total_epochs=self.config.num_train_epochs,
            )
        else:
            self.saving_strategy = ModelSavingStrategy(
                steps_per_epoch=steps_per_epoch, total_epochs=self.config.num_train_epochs,
                per_epochs=None, per_steps=None, save_last=False,
            )
        self.saving_callbacks = self.get_saving_callbacks()

    def prepare_preview_strategy(self) -> None:
        steps_per_epoch = len(self.train_dataloader)
        if (preview := self.config.preview) is not None:
            self.preview_strategy = PreviewStrategy.from_config(
                config=preview.strategy, steps_per_epoch=steps_per_epoch,
                total_epochs=self.config.num_train_epochs,
            )
        else:
            self.preview_strategy = PreviewStrategy(
                steps_per_epoch=steps_per_epoch, total_epochs=self.config.num_train_epochs,
                per_epochs=None, per_steps=None,
            )
        self.preview_callbacks = self.get_preview_callbacks()

    def setup_peft_if_needed(self) -> None:
        if self.peft_config is None:
            self.model._set_is_peft(False)
            return
        self.print("Applying PEFT")
        self.model._set_is_peft(True)
        targets = self.peft_config if isinstance(self.peft_config, list) else [self.peft_config]
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        module = self.model.get_params()
        for target_config in targets:
            target_config.replace_to_peft_layer(module, generator)
        self.print("Loading PEFT weights")
        self.model.load_peft_weights()

    def split_trainable(self) -> tuple[dict, dict]:
        """(trainable, frozen), each keyed like the model's ``state_dict()``;
        sets ``requires_grad`` to match, so the frozen part gets no
        gradient."""
        module = self.model.get_params()
        if self.model._is_peft:
            trainable, frozen = split_peft_params(module)
            for key in [k for k in frozen if self.model.peft_extra_trainable_filter(k)]:
                value = frozen.pop(key)
                value.requires_grad_(True)
                trainable[key] = value
            return trainable, frozen
        trainable, frozen = {}, {}
        for key, value in module.state_dict(keep_vars=True).items():
            train = self.model.trainable_filter(key) and isinstance(value, torch.nn.Parameter)
            if isinstance(value, torch.nn.Parameter):
                value.requires_grad_(train)
            (trainable if train else frozen)[key] = value
        return trainable, frozen

    def prepare_model(self) -> None:
        self.model.before_setup_model()
        self.model.setup_model()
        self.setup_peft_if_needed()
        self.model.after_setup_model()
        trainable, frozen = self.split_trainable()
        n_train = sum(t.numel() for t in trainable.values())
        n_all = n_train + sum(t.numel() for t in frozen.values())
        self.print(
            f"Trainable params: {n_train:,}, All params: {n_all:,}, "
            f"Trainable%: {100.0 * n_train / max(n_all, 1):.4f}%"
        )

    def prepare_optimizer(self) -> None:
        args = dict(self.config.optimizer.args)
        lr = args.pop("lr", 1e-3)
        steps_per_epoch = max(len(self.train_dataloader), 1)
        total_steps = steps_per_epoch * self.config.num_train_epochs
        if (sched_cfg := self.config.scheduler) is not None:
            name = sched_cfg.name
            # torch scheduler strings: the constant one is no schedule
            if name.startswith("torch.optim.lr_scheduler"):
                name = None if "Constant" in name else name.rsplit(".", 1)[-1].lower()
            self.schedule = get_schedule(name, lr, num_training_steps=total_steps, args=sched_cfg.args)
        else:
            self.schedule = get_schedule(None, lr)

        self.optimizer_name = self.config.optimizer.name
        self.optimizer = get_optimizer(
            self.optimizer_name, self.schedule, args,
            max_grad_norm=self.config.trainer.clip_grad_norm,
            max_grad_value=self.config.trainer.clip_grad_value,
        )
        self.trainable, self.frozen = self.split_trainable()
        self.state = init_train_state(self.optimizer, self.trainable)
        if self.config.trainer.ema_decay is not None:
            self.ema = _fp32_copies(self.trainable)
        self._step = make_train_step(
            self.model.loss_fn, self.optimizer, grad_accum=self.gradient_accumulation_steps,
            check_finite=self.config.trainer.debug_nans,
        )

    # -- lifecycle -------------------------------------------------------------------

    def before_train(self) -> None:
        self.torch_configuration()
        if self.debug_mode is not False:
            self.print(f"Debug mode is enabled: {self.debug_mode}")
        self.print("before_train()")
        self.print(f"Seed: {self.seed}")
        self.print("Setting up dataloaders")
        self.prepare_dataloaders()
        self.print("Setting up saving strategy")
        self.prepare_saving_strategy()
        self.print("Setting up preview strategy")
        self.prepare_preview_strategy()

        if self.debug_mode == "dataset":
            self.debug_dataset()
            self.print("Dataset check done. Exiting...")
            return

        self.print("Setting up model")
        self.prepare_model()
        self.print("Setting up optimizer")
        self.prepare_optimizer()

    def after_train(self) -> None:
        self.print("after_train()")

    def training_loop(self) -> None:
        self.print("training_loop()")
        tcfg = self.config.trainer
        current_step = 0
        if tcfg.state_checkpoint_dir and tcfg.resume_from_state_checkpoint:
            current_step = self.restore_state_checkpoint() or 0
        accum = self.gradient_accumulation_steps
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        pending: list[dict] = []
        profiler = None

        try:
            for epoch in range(1, self.config.num_train_epochs + 1):
                self.model.before_train_epoch()
                self.train_dataloader.set_epoch(epoch - 1)

                for batch in self.train_dataloader:
                    current_step += 1
                    if tcfg.profile and current_step == tcfg.profile_start_step:
                        profiler = self._start_profiler()
                    self.model.before_train_step()
                    pending.append(self.model.preprocess_batch(batch))

                    self.model.before_backward()
                    if len(pending) == accum:
                        step_batch = pending[0] if accum == 1 else Microbatches(pending)
                        with self._nan_checks():
                            self.state, metrics = self._step(self.state, step_batch, generator)
                        pending = []
                        if self.ema is not None:
                            self._update_ema()
                        self.model.log("train/loss", float(metrics.pop("train/loss")),
                                       on_step=True, on_epoch=True)
                        for name, value in metrics.items():
                            self.model.log(name, value, on_step=True)
                    self.model.after_backward()
                    self._log_metadata(current_step)

                    self.call_saving_callbacks(epoch, current_step)
                    self.call_preview_callbacks(epoch, current_step)
                    self.model.after_train_step()

                    if profiler is not None and current_step == tcfg.profile_stop_step:
                        self._stop_profiler(profiler)
                        profiler = None
                    if (tcfg.state_checkpoint_dir
                            and current_step % tcfg.state_checkpoint_every_steps == 0):
                        self.save_state_checkpoint(current_step)

                    if self.debug_mode == "1step":
                        break

                self.model.after_train_epoch()
                self.model.log("epoch", epoch)
                if self.debug_mode == "1step":
                    break
        finally:
            if profiler is not None:  # the run ended inside the window
                self._stop_profiler(profiler)

    # -- EMA, state checkpoints, profiler, NaN checks --------------------------------

    @torch.no_grad()
    def _update_ema(self) -> None:
        """ema = ema * d + x * (1 - d) in fp32, x the parameters or, for a
        schedule-free optimizer, its evaluation point."""
        decay = self.config.trainer.ema_decay
        target = self.trainable
        if is_schedule_free(self.optimizer_name):
            target = eval_params(self.optimizer_name, self.state.opt_state, target)
        ema = list(self.ema.values())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [target[k].float() for k in self.ema], alpha=1.0 - decay)

    def save_state_checkpoint(self, step: int) -> str:
        """Write {step, trainable, optimizer state, EMA} for loader step
        ``step`` under ``trainer.state_checkpoint_dir``."""
        opt_state = {"optimizer": self.state.opt_state.state_dict(), "updates": self.state.step}
        return save_train_state(self.config.trainer.state_checkpoint_dir, step, self.trainable,
                                opt_state, ema=self.ema)

    def restore_state_checkpoint(self) -> Optional[int]:
        """Restore the newest state checkpoint into the trainable
        parameters, the optimizer and the EMA, in place; returns its loader
        step, or None when there is none."""
        restored = restore_train_state(self.config.trainer.state_checkpoint_dir, self.device,
                                       with_ema=self.ema is not None)
        if restored is None:
            return None
        step, trainable, opt_state = restored[:3]
        if set(trainable) != set(self.trainable):
            raise KeyError(f"the state checkpoint's trainable keys differ from the model's: "
                           f"{sorted(set(trainable) ^ set(self.trainable))[:5]}")
        with torch.no_grad():
            for key, param in self.trainable.items():
                param.copy_(trainable[key])
            if self.ema is not None:
                for key, value in self.ema.items():
                    value.copy_(restored[3][key])
        self.state.opt_state.load_state_dict(opt_state["optimizer"])
        self.state = self.state._replace(step=opt_state["updates"])
        self.print(f"Resumed train state from step {step}")
        return step

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        tcfg = self.config.trainer
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(tcfg.profile_dir, exist_ok=True)
        path = os.path.join(
            tcfg.profile_dir, f"trace_steps_{tcfg.profile_start_step}-{tcfg.profile_stop_step}.json"
        )
        profiler.export_chrome_trace(path)
        self.profile_trace = path
        self.print(f"Profiler trace written to {path}")

    @contextlib.contextmanager
    def _nan_checks(self):
        """With ``trainer.debug_nans``, anomaly mode over the step: a
        non-finite gradient raises ``FloatingPointError`` naming the
        backward function that made it (the step itself checks the loss
        and the gradients' norm)."""
        if not self.config.trainer.debug_nans:
            yield
            return
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                yield
        except RuntimeError as error:
            if "nan values" not in str(error):
                raise
            raise FloatingPointError(str(error)) from error

    # -- callbacks -----------------------------------------------------------------

    def _evaluation_values(self) -> Optional[dict[str, torch.Tensor]]:
        """The trainable parameters' values as saving, previews and the
        model after training see them: the EMA cast to each parameter's
        dtype, else for a schedule-free optimizer its average x; None where
        they are the live parameters."""
        if self.ema is not None:
            return {k: e.to(self.trainable[k].dtype) for k, e in self.ema.items()}
        if is_schedule_free(self.optimizer_name):
            return eval_params(self.optimizer_name, self.state.opt_state, self.trainable)
        return None

    @contextlib.contextmanager
    def _evaluation_weights(self):
        """The evaluation weights in place of the live ones, which come back
        afterwards bit for bit."""
        values = self._evaluation_values()
        if values is None:
            yield
            return
        with torch.no_grad():
            live = {k: p.detach().clone() for k, p in self.trainable.items()}
            for key, value in values.items():
                self.trainable[key].copy_(value)
        try:
            yield
        finally:
            with torch.no_grad():
                for key, value in live.items():
                    self.trainable[key].copy_(value)

    def call_saving_callbacks(self, epoch: int, steps: int) -> None:
        if not self.saving_strategy.should_save(epoch, steps):
            return
        self.model.before_save_model()
        if len(self.saving_callbacks) > 0:
            with self._evaluation_weights():
                # copies: on the CPU .to("cpu") would hand out the parameters'
                # own storage, which the live weights refill on the way out
                state_dict = {
                    k: v.detach().to("cpu", copy=True).contiguous()
                    for k, v in self.model.get_state_dict_to_save().items()
                }
            metadata = self.model.get_metadata_to_save()
            self.print("Saving model...")
            for callback in self.saving_callbacks:
                callback.save_state_dict(state_dict, epoch, steps, metadata=metadata)
            self.print("Model saved.")
        self.model.after_save_model()

    def call_preview_callbacks(self, epoch: int, steps: int) -> None:
        if not self.preview_strategy.should_preview(epoch, steps):
            return
        self.model.before_preview()
        if len(self.preview_callbacks) > 0:
            if self.preview_dataloader is None:
                raise RuntimeError("preview callbacks are configured but there is no preview data")
            self.print("Generating preview images...")
            with self._evaluation_weights():
                for i, batch in enumerate(self.preview_dataloader):
                    self.model.before_preview_step()
                    preview = self.model.preview_step(batch, preview_index=i)
                    for callback in self.preview_callbacks:
                        callback.preview_image(preview, epoch, steps, i, metadata=batch)
                    self.model.after_preview_step()
            self.print("Preview done.")
        self.model.after_preview()

    def debug_dataset(self) -> None:
        self.print("debugging train_dataloader...")
        for batch in self.train_dataloader:
            self.print({k: getattr(v, "shape", v) for k, v in batch.items()})

    def torch_configuration(self) -> None:
        precision = self.config.trainer.fp32_matmul_precision
        if precision is not None:
            torch.set_float32_matmul_precision(precision)

    # -- entry ---------------------------------------------------------------------

    def train(self) -> None:
        self.before_train()
        if self.debug_mode == "dataset":
            return

        self.model.sanity_check()
        if self.debug_mode == "sanity_check":
            self.print("Sanity check done. Exiting...")
            return

        try:
            self.training_loop()
        finally:
            if self.trackers is not None:
                self.trackers.finish()
        values = self._evaluation_values()
        if values is not None:
            # training is over: the model keeps the evaluation weights
            with torch.no_grad():
                for key, value in values.items():
                    self.trainable[key].copy_(value)
        self.after_train()

    # -- logging ---------------------------------------------------------------------

    def print(self, *args, **kwargs) -> None:
        print(*args, **kwargs)

    def log_dict(self, values: dict, step: Optional[int] = None) -> None:
        if self.trackers is not None and values:
            self.trackers.log(values, step=step)

    def _log_metadata(self, current_step: int) -> None:
        self.model.log("lr/group_0", float(self.schedule(current_step)), on_step=True, on_epoch=False)
