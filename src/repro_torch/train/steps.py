"""The train step, with microbatched gradient accumulation.

Counterpart of ``repro.train.steps.make_optimizer`` and
``make_train_step``. The reference's step is a pure function that jit
compiles; here it runs eagerly and updates the model's parameters in place
(:func:`repro_torch.optim.optimizer.apply_updates`), returning the new
optimizer state and the metrics.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import lm
from repro_torch.optim import optimizer as opt


def make_optimizer(tc: TrainConfig) -> opt.GradientTransformation:
    """Clip, Adam, decoupled weight decay and the warmup-cosine schedule,
    as the reference builds them. Gradient compression is not ported."""
    if tc.grad_compression:
        raise NotImplementedError(
            f"grad_compression={tc.grad_compression!r}: gradient compression "
            f"is not ported; use ''")
    schedule = opt.warmup_cosine_schedule(tc.learning_rate, tc.warmup_steps,
                                          tc.total_steps)
    parts = []
    if tc.max_grad_norm:
        parts.append(opt.clip_by_global_norm(tc.max_grad_norm))
    parts.append(opt.scale_by_adam())
    if tc.weight_decay:
        parts.append(opt.add_decayed_weights(tc.weight_decay))
    parts.append(opt.scale_by_schedule(schedule))
    return opt.chain(*parts)


def trainable(model: lm.LM) -> Dict[str, torch.Tensor]:
    """The model's parameters by name (the truncation indices are buffers
    and never appear)."""
    return dict(model.named_parameters())


def loss_and_grads(model: lm.LM, batch: Mapping[str, torch.Tensor],
                   microbatches: int = 1, backend: str = "auto"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean loss and gradients of ``lm.loss_fn`` over ``batch``. With
    ``microbatches > 1`` the batch is split along its first axis and the
    float32 sums of the microbatches' gradients and losses are averaged,
    as the reference's scan does; peak activation memory follows the
    microbatch."""
    params = trainable(model)
    names = list(params)
    if microbatches == 1:
        loss, _ = lm.loss_fn(model, batch, backend)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    size = B // microbatches
    gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
    lsum = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    for i in range(microbatches):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, _ = lm.loss_fn(model, mb, backend)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        for n, g in zip(names, grads):
            gsum[n] += g.float()
        lsum = lsum + loss.detach()
    inv = 1.0 / microbatches
    return lsum * inv, {n: g * inv for n, g in gsum.items()}


def make_train_step(cfg: ModelConfig, tx: opt.GradientTransformation,
                    microbatches: int = 1) -> Callable:
    """Returns ``step(model, opt_state, batch) -> (opt_state, metrics)``,
    metrics ``{"loss", "grad_norm"}`` as 0-d tensors; the model's
    parameters are updated in place."""

    def step(model: lm.LM, opt_state, batch):
        loss, grads = loss_and_grads(model, batch, microbatches)
        grad_norm = opt.global_norm(grads)
        params = trainable(model)
        updates, opt_state = tx.update(grads, opt_state, params)
        opt.apply_updates(params, updates)
        return opt_state, {"loss": loss, "grad_norm": grad_norm}

    return step
