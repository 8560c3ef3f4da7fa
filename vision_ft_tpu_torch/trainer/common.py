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

Schedule-free optimizers train the interpolation y and evaluate at the
average x: saving and previews see x, and the live parameters go back to
y afterwards; after the last step the model keeps x.

The run is on the card unless the caller names another device
(``device="cpu"``, as the tests do). Not ported, each raising
``NotImplementedError`` by name when configured: a mesh of more than one
device, EMA (``trainer.ema_decay``), state checkpoints
(``trainer.state_checkpoint_dir``), the profiler (``trainer.profile``) and
the debug modes (``trainer.debug_mode``, ``trainer.debug_nans``).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch

from ..config import TrainConfig
from ..dataloader import DataLoader, get_dataloader_for_bucketing, get_dataloader_for_preview
from ..dataset.util import DatasetConfig
from ..models.for_training import ModelForTraining
from ..modules.peft import split_peft_params
from ..nn import set_remat_group, set_remat_saves
from ..preview import PreviewStrategy, get_preview_callback
from ..saving import ModelSavingStrategy, get_saving_callback
from ..training import Microbatches, get_optimizer, get_schedule, init_train_state, make_train_step
from ..training.optimizer import eval_params, is_schedule_free
from ..utils.logging import Trackers, get_trackers


def _check_ported(config: TrainConfig) -> None:
    """Raise ``NotImplementedError`` on the trainer options whose subsystems
    are not ported."""
    tcfg = config.trainer
    mesh = tcfg.mesh
    if mesh.data not in (-1, 1) or (mesh.fsdp, mesh.tensor, mesh.pipe) != (1, 1, 1):
        raise NotImplementedError(f"a mesh of more than one device ({mesh}) is not ported")
    if tcfg.ema_decay is not None:
        raise NotImplementedError("EMA of the trainable parameters (trainer.ema_decay) is not ported")
    if tcfg.state_checkpoint_dir is not None:
        raise NotImplementedError("state checkpoints (trainer.state_checkpoint_dir) are not ported")
    if tcfg.profile:
        raise NotImplementedError("the profiler (trainer.profile) is not ported")
    if tcfg.debug_mode is not False or tcfg.debug_nans:
        raise NotImplementedError(
            f"the debug modes (trainer.debug_mode={tcfg.debug_mode!r}, "
            f"trainer.debug_nans={tcfg.debug_nans}) are not ported"
        )


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
        self.gradient_accumulation_steps = config.trainer.gradient_accumulation_steps

        set_remat_saves(config.trainer.remat_saves)
        set_remat_group(config.trainer.remat_group)

        self.trackers: Optional[Trackers] = None
        tracker_names = get_trackers(config)
        if tracker_names:
            self.trackers = Trackers(tracker_names, config.tracker.project_name, config.model_dump())

        self.preview_dataset_config = None
        self.preview_dataloader: Optional[DataLoader] = None

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
        self._step = make_train_step(
            self.model.loss_fn, self.optimizer, grad_accum=self.gradient_accumulation_steps
        )

    # -- lifecycle -------------------------------------------------------------------

    def before_train(self) -> None:
        self.torch_configuration()
        self.print("before_train()")
        self.print(f"Seed: {self.seed}")
        self.print("Setting up dataloaders")
        self.prepare_dataloaders()
        self.print("Setting up saving strategy")
        self.prepare_saving_strategy()
        self.print("Setting up preview strategy")
        self.prepare_preview_strategy()
        self.print("Setting up model")
        self.prepare_model()
        self.print("Setting up optimizer")
        self.prepare_optimizer()

    def after_train(self) -> None:
        self.print("after_train()")

    def training_loop(self) -> None:
        self.print("training_loop()")
        current_step = 0
        accum = self.gradient_accumulation_steps
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        pending: list[dict] = []

        for epoch in range(1, self.config.num_train_epochs + 1):
            self.model.before_train_epoch()
            self.train_dataloader.set_epoch(epoch - 1)

            for batch in self.train_dataloader:
                current_step += 1
                self.model.before_train_step()
                pending.append(self.model.preprocess_batch(batch))

                self.model.before_backward()
                if len(pending) == accum:
                    step_batch = pending[0] if accum == 1 else Microbatches(pending)
                    self.state, metrics = self._step(self.state, step_batch, generator)
                    pending = []
                    self.model.log("train/loss", float(metrics.pop("train/loss")),
                                   on_step=True, on_epoch=True)
                    for name, value in metrics.items():
                        self.model.log(name, value, on_step=True)
                self.model.after_backward()
                self._log_metadata(current_step)

                self.call_saving_callbacks(epoch, current_step)
                self.call_preview_callbacks(epoch, current_step)
                self.model.after_train_step()

            self.model.after_train_epoch()
            self.model.log("epoch", epoch)

    # -- callbacks -----------------------------------------------------------------

    @contextlib.contextmanager
    def _evaluation_weights(self):
        """The trainable parameters as saving and previews see them: for a
        schedule-free optimizer its average x in place of the live y, which
        comes back afterwards bit for bit."""
        if not is_schedule_free(self.optimizer_name):
            yield
            return
        with torch.no_grad():
            live = {k: p.detach().clone() for k, p in self.trainable.items()}
            for key, value in eval_params(self.optimizer_name, self.state.opt_state,
                                          self.trainable).items():
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
                state_dict = {
                    k: v.detach().to("cpu").contiguous()
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

    def torch_configuration(self) -> None:
        precision = self.config.trainer.fp32_matmul_precision
        if precision is not None:
            torch.set_float32_matmul_precision(precision)

    # -- entry ---------------------------------------------------------------------

    def train(self) -> None:
        self.before_train()
        self.model.sanity_check()
        try:
            self.training_loop()
        finally:
            if self.trackers is not None:
                self.trackers.finish()
        if is_schedule_free(self.optimizer_name):
            # training is over: the model keeps the evaluation weights
            with torch.no_grad():
                for key, value in eval_params(self.optimizer_name, self.state.opt_state,
                                              self.trainable).items():
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
