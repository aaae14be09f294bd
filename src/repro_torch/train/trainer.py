"""Training loop: prefetched data, checkpoint/resume, straggler accounting.

Counterpart of ``repro.train.trainer``. The loop runs eagerly on the card
(``device=None`` means ``cuda``; without a card it raises unless the
caller asks for ``"cpu"``). Every butterfly site goes through
:class:`repro_torch.kernels.sandwich.SandwichFn`: the forward and backward
kernels on the card, their plain twins on the CPU or under a ``torch``
execution context.

The ``Trainer`` resolves one
:class:`~repro_torch.kernels.context.ExecutionContext` at construction
(this thread's ambient ``use_execution`` block over the arch's
``ButterflyConfig``), turns ``"auto"`` into its device's route
(``"cuda"`` or ``"torch"``) and freezes it: every step runs inside
``use_execution`` of it and passes it to every kernel call, and
:attr:`TrainResult.execution` reports it. A model without butterfly sites
records ``"dense"``.

With ``ButterflyConfig.mesh_shape`` set, the context carries the mesh
(built at construction, where a mesh larger than the world fails loudly
rather than mid-step), the steps run under the sharding context too, and
every butterfly site shards its rows over the mesh's data axes
(:mod:`repro_torch.runtime.butterfly_sharding`). Every rank runs the whole
step on the whole global batch, from the same seed and the same batches,
as the reference's module does under its mesh: only the sites' rows are
split, and the weight gradients they all-reduce leave every rank's
parameters the same. Only rank 0 writes checkpoints; every rank restores.

Checkpoints use the reference's layout
(:mod:`repro_torch.checkpoint.checkpointing`): params and the optimizer
state under the reference's keys, layers stacked as ``unit``
(:func:`repro_torch.convert.opt_state_to_jax`), so a run resumes from a
checkpoint that the reference's ``Trainer`` wrote, and the reference from
one of the port's.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, for_model
from repro_torch.kernels import context as exctx
from repro_torch.kernels import tuning
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM
from repro_torch.runtime import dist as rdist
from repro_torch.runtime import sharding as rsh
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.train import steps as steps_lib


@dataclass(frozen=True)
class ExecutionRecord:
    """How the butterfly sites of a run executed.

    * ``context`` — the finalized :class:`ExecutionContext` the steps ran
      under (``None`` when the model has no butterfly sites).
    * ``backend`` — its backend, ``"cuda"`` or ``"torch"`` (``"dense"``
      without butterfly sites).
    * ``tuning`` — the tile choices of the run
      (:mod:`repro_torch.kernels.tuning`): the summaries of the choices the
      run's launches added, or, where an earlier run in the process had
      asked for them all, ``"process-wide: "`` and every choice; ``""``
      where the plain twins ran (a CPU run, or a dense model): nothing was
      queried.
    * ``mesh_layout`` — e.g. ``"data=2"`` or ``"pod=2,data=2"``; ``""``
      on one device.
    """

    backend: str = "dense"
    tuning: str = ""
    mesh_layout: str = ""
    context: Optional[exctx.ExecutionContext] = None

    def describe(self) -> str:
        return (self.context.describe() if self.context is not None
                else "dense")


@dataclass
class TrainResult:
    steps_run: int
    losses: List[float]
    resumed_from: Optional[int]
    step_times: List[float] = field(default_factory=list)
    # the straggler monitor's step-time EMA (seconds) after the last step
    step_time_ema: float = 0.0
    # each step's metrics as floats: loss, grad_norm and, unless
    # microbatched, the loss's ce and aux (the MoE's aux losses)
    metrics: List[Dict[str, float]] = field(default_factory=list)
    # the resolved execution policy of the run
    execution: ExecutionRecord = field(default_factory=ExecutionRecord)

    @property
    def kernel_backend(self) -> str:
        """Alias for ``execution.backend`` (the reference's older name)."""
        return self.execution.backend

    @property
    def kernel_tuning(self) -> str:
        """Alias for ``execution.tuning`` (the reference's older name)."""
        return self.execution.tuning

    @property
    def mesh_layout(self) -> str:
        """Alias for ``execution.mesh_layout`` (the reference's older
        name)."""
        return self.execution.mesh_layout


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
        self.tx = steps_lib.make_optimizer(train_cfg, model_cfg)
        bc = model_cfg.butterfly
        if bc is not None:
            self.exec_ctx = exctx.resolve_for_device(
                None, self.device,
                default=exctx.ExecutionContext.from_butterfly_config(bc))
            self.kernel_backend = self.exec_ctx.backend
            self.mesh = self.exec_ctx.mesh
        else:
            self.exec_ctx = None
            self.kernel_backend = "dense"
            self.mesh = None
        self.step_fn = steps_lib.make_train_step(
            model_cfg, self.tx, train_cfg.microbatches, self.exec_ctx)
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
        """``raw`` on the trainer's device, with the frontends' stub inputs
        the reference's trainer adds to every batch: ``frontend_embeds``
        (B, frontend_tokens, E) for a ``vision`` config, then ``frames``
        (B, enc_seq, E) for an encoder one, float32 normals from
        ``np.random.default_rng(1234)``, drawn anew (the same) each batch."""
        out = dict(raw)
        cfg, B = self.cfg, raw["tokens"].shape[0]
        rng = np.random.default_rng(1234)
        if cfg.frontend == "vision":
            out["frontend_embeds"] = rng.normal(
                size=(B, cfg.frontend_tokens, cfg.d_model)).astype(
                    np.float32)
        if cfg.n_enc_layers:
            out["frames"] = rng.normal(
                size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in out.items()}

    def _restore(self, model, opt_state):
        params = steps_lib.trainable(model)
        tmpl = {"params": convert.to_jax_params(params, self.cfg),
                "opt": convert.opt_state_to_jax(opt_state, self.cfg)}
        step, tree, _ = self.ckpt.restore(tmpl)
        if step is None:
            return None, opt_state
        convert.load_jax_params(model, tree["params"])
        return step, convert.load_jax_opt_state(self.cfg, opt_state,
                                                tree["opt"])

    def _scope(self):
        """The run's frozen context as the ambient one, and the sharding
        context when it has a mesh (no-op for dense models)."""
        stack = contextlib.ExitStack()
        if self.exec_ctx is not None:
            stack.enter_context(exctx.use_execution(self.exec_ctx))
        if self.mesh is not None:
            stack.enter_context(rsh.use_sharding(self.mesh))
        return stack

    def _barrier(self) -> None:
        """Wait for every rank that runs this trainer (the mesh's, or the
        world's without a mesh), so that none reads a checkpoint rank 0 is
        still writing."""
        if self.mesh is not None:
            if self.mesh.size > 1:
                torch.distributed.barrier(
                    group=self.mesh.group(self.mesh.axis_names))
        elif rdist.world_size() > 1:
            torch.distributed.barrier()

    def run(self, steps: int, model: Optional[LM] = None, opt_state=None,
            resume: bool = True) -> TrainResult:
        """``steps`` train steps from ``model``/``opt_state`` (fresh from
        ``tc.seed`` when ``model`` is None; a fresh optimizer state when
        ``opt_state`` is None), or from the newest valid checkpoint. Under
        a mesh, every rank of it calls this; a rank outside it raises."""
        if self.mesh is not None and self.mesh.coordinate is None:
            raise RuntimeError(f"rank {rdist.rank()} is not in the mesh "
                               f"{self.mesh.describe()}; it trains nothing")
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

        tuning_before = set(tuning.cache_entries())
        prefetch = Prefetcher(self.data, start_step=start_step)
        losses: List[float] = []
        step_times: List[float] = []
        step_metrics: List[Dict[str, float]] = []
        try:
            for i in range(start_step, start_step + steps):
                _, raw = next(prefetch)
                batch = self._batch(raw)
                t0 = time.monotonic()
                with self._scope():
                    opt_state, metrics = self.step_fn(model, opt_state,
                                                      batch)
                loss = float(metrics["loss"])      # waits for the device
                dt = time.monotonic() - t0
                step_metrics.append({k: float(v) for k, v in metrics.items()})
                self.straggler.record({"host0": dt})
                losses.append(loss)
                step_times.append(dt)
                if (self.ckpt is not None and self.tc.checkpoint_every
                        and (i + 1) % self.tc.checkpoint_every == 0
                        and rdist.rank() == 0):
                    params = steps_lib.trainable(model)
                    self.ckpt.save(i + 1, {
                        "params": convert.to_jax_params(params, self.cfg),
                        "opt": convert.opt_state_to_jax(opt_state,
                                                        self.cfg)},
                        extra={"loss": loss}, async_=True)
        finally:
            prefetch.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        if self.ckpt is not None:
            self._barrier()
        self.model = model
        self.opt_state = opt_state
        # the choices are made at the launches: report those this run
        # added, or the whole registry, marked, where another run in the
        # process had made them all; the plain twins query nothing
        tuning_summary = ""
        if self.kernel_backend == "cuda":
            entries = tuning.cache_entries()
            fresh = sorted(v for k, v in entries.items()
                           if k not in tuning_before)
            if fresh:
                tuning_summary = "; ".join(fresh)
            elif entries:
                tuning_summary = "process-wide: " + tuning.describe()
        return TrainResult(steps_run=steps, losses=losses,
                           resumed_from=resumed_from, step_times=step_times,
                           step_time_ema=self.straggler.ema["host0"],
                           metrics=step_metrics,
                           execution=ExecutionRecord(
                               backend=self.kernel_backend,
                               tuning=tuning_summary,
                               mesh_layout=(self.exec_ctx.mesh_layout()
                                            if self.exec_ctx else ""),
                               context=self.exec_ctx))
