"""Training loop: prefetched data, checkpoint/resume, straggler accounting.

Counterpart of ``repro.train.trainer``. The loop runs eagerly on the card
(``device=None`` means ``cuda``; without a card it raises unless the
caller asks for ``"cpu"``). Every butterfly site goes through
:class:`repro_torch.kernels.sandwich.SandwichFn`: the forward and backward
kernels on the card, their plain twins on the CPU. Checkpoints use the
reference's layout (:mod:`repro_torch.checkpoint.checkpointing`), params
under the reference's keys; the optimizer state round-trips between port
runs only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, for_model
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.train import steps as steps_lib


@dataclass
class TrainResult:
    steps_run: int
    losses: List[float]
    resumed_from: Optional[int]
    step_times: List[float] = field(default_factory=list)
    # the straggler monitor's step-time EMA (seconds) after the last step
    step_time_ema: float = 0.0


def _like(template, host):
    """``host`` (numpy, the template's structure) as tensors shaped like
    ``template``'s leaves, on their devices."""
    if isinstance(template, dict):
        return {k: _like(template[k], host[k]) for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_like(t, h) for t, h in zip(template, host)])
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, h) for t, h in zip(template, host))
    if template is None:
        return None
    return torch.as_tensor(np.asarray(host)).to(template.device,
                                                template.dtype)


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 seq_len: int, global_batch: int,
                 data: Optional[SyntheticLM] = None, *,
                 device: Union[str, torch.device, None] = None):
        self.cfg = model_cfg
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.data = data or for_model(model_cfg, seq_len, global_batch,
                                      seed=train_cfg.seed)
        self.tx = steps_lib.make_optimizer(train_cfg)
        self.step_fn = steps_lib.make_train_step(model_cfg, self.tx,
                                                 train_cfg.microbatches)
        self.ckpt = (CheckpointManager(train_cfg.checkpoint_dir,
                                       keep=train_cfg.keep_checkpoints)
                     if train_cfg.checkpoint_dir else None)
        self.straggler = StragglerMonitor(["host0"])

    def init_state(self, seed: int = 0):
        """A model initialised from ``torch.Generator().manual_seed(seed)``
        on the trainer's device, and its optimizer state."""
        gen = torch.Generator().manual_seed(seed)
        model = LM(self.cfg, generator=gen).to(self.device)
        return model, self.tx.init(steps_lib.trainable(model))

    def _batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in raw.items()}

    def _restore(self, model, opt_state):
        params = steps_lib.trainable(model)
        tmpl = {"params": convert.to_jax_params(params), "opt": opt_state}
        step, tree, _ = self.ckpt.restore(tmpl)
        if step is None:
            return None, opt_state
        convert.load_jax_params(model, tree["params"])
        return step, _like(opt_state, tree["opt"])

    def run(self, steps: int, model: Optional[LM] = None, opt_state=None,
            resume: bool = True) -> TrainResult:
        """``steps`` train steps from ``model``/``opt_state`` (fresh from
        ``tc.seed`` when ``model`` is None; a fresh optimizer state when
        ``opt_state`` is None), or from the newest valid checkpoint."""
        if model is None:
            model, opt_state = self.init_state(self.tc.seed)
        elif opt_state is None:
            opt_state = self.tx.init(steps_lib.trainable(model))

        start_step = 0
        resumed_from = None
        if self.ckpt is not None and resume:
            s, opt_state = self._restore(model, opt_state)
            if s is not None:
                start_step = resumed_from = s

        prefetch = Prefetcher(self.data, start_step=start_step)
        losses: List[float] = []
        step_times: List[float] = []
        try:
            for i in range(start_step, start_step + steps):
                _, raw = next(prefetch)
                batch = self._batch(raw)
                t0 = time.monotonic()
                opt_state, metrics = self.step_fn(model, opt_state, batch)
                loss = float(metrics["loss"])      # waits for the device
                dt = time.monotonic() - t0
                self.straggler.record({"host0": dt})
                losses.append(loss)
                step_times.append(dt)
                if (self.ckpt is not None and self.tc.checkpoint_every
                        and (i + 1) % self.tc.checkpoint_every == 0):
                    params = steps_lib.trainable(model)
                    self.ckpt.save(i + 1, {
                        "params": convert.to_jax_params(params),
                        "opt": opt_state}, extra={"loss": loss},
                        async_=True)
        finally:
            prefetch.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        self.model = model
        self.opt_state = opt_state
        return TrainResult(steps_run=steps, losses=losses,
                           resumed_from=resumed_from, step_times=step_times,
                           step_time_ema=self.straggler.ema["host0"])
