"""The train step, with microbatched gradient accumulation.

Counterpart of ``repro.train.steps.make_optimizer`` and
``make_train_step``. The reference's step is a pure function that jit
compiles; here it runs eagerly and updates the model's parameters in place
(:func:`repro_torch.optim.optimizer.apply_updates`), returning the new
optimizer state and the metrics.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels.context import ContextLike
from repro_torch.models import lm
from repro_torch.optim import optimizer as opt
from repro_torch.optim.compression import compress_gradients


def make_optimizer(tc: TrainConfig, cfg: ModelConfig
                   ) -> opt.GradientTransformation:
    """Clip, gradient compression, Adam, decoupled weight decay and the
    warmup-cosine schedule, chained in the reference's order (each only
    where the config asks for it), so the optimizer state is a tuple in the
    reference's order too."""
    schedule = opt.warmup_cosine_schedule(tc.learning_rate, tc.warmup_steps,
                                          tc.total_steps)
    parts = []
    if tc.max_grad_norm:
        parts.append(opt.clip_by_global_norm(tc.max_grad_norm))
    if tc.grad_compression:
        # a layer's leaves share the statistics of the reference's stacked
        # unit leaf
        parts.append(compress_gradients(tc.grad_compression,
                                        tc.grad_compression_ratio,
                                        group=functools.partial(
                                            convert.reference_key,
                                            cfg=cfg)))
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
                   microbatches: int = 1, context: ContextLike = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean loss and gradients of ``lm.loss_fn`` over ``batch``. With
    ``microbatches > 1`` the batch is split along its first axis and the
    float32 sums of the microbatches' gradients and losses are averaged,
    as the reference's scan does; peak activation memory follows the
    microbatch."""
    loss, grads, _ = _loss_grads_metrics(model, batch, microbatches, context)
    return loss, grads


def _grad(loss: torch.Tensor, leaves) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``loss`` for each leaf; zeros for a leaf the loss
    does not reach (an ``audio`` config's ``frontend_proj``), as
    ``jax.grad`` gives, so that Adam's weight decay still moves it as the
    reference's step does."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads))


def _loss_grads_metrics(model, batch, microbatches, context):
    """:func:`loss_and_grads` and the loss's metrics (``{"ce", "aux"}``,
    detached; empty when microbatched, as in the reference's step)."""
    params = trainable(model)
    names = list(params)
    if microbatches == 1:
        loss, metrics = lm.loss_fn(model, batch, context)
        grads = _grad(loss, [params[n] for n in names])
        return (loss.detach(), dict(zip(names, grads)),
                {k: v.detach() for k, v in metrics.items()})
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
        loss, _ = lm.loss_fn(model, mb, context)
        grads = _grad(loss, [params[n] for n in names])
        for n, g in zip(names, grads):
            gsum[n] += g.float()
        lsum = lsum + loss.detach()
    inv = 1.0 / microbatches
    return lsum * inv, {n: g * inv for n, g in gsum.items()}, {}


def make_train_step(cfg: ModelConfig, tx: opt.GradientTransformation,
                    microbatches: int = 1,
                    context: ContextLike = None) -> Callable:
    """Returns ``step(model, opt_state, batch) -> (opt_state, metrics)``,
    metrics ``{"loss", "grad_norm"}`` and, unless microbatched, the loss's
    ``{"ce", "aux"}``, as 0-d tensors (the reference's keys); the model's
    parameters are updated in place. ``context`` is every kernel call's
    explicit execution context (the ``Trainer`` passes its finalized
    one)."""

    def step(model: lm.LM, opt_state, batch):
        loss, grads, metrics = _loss_grads_metrics(model, batch,
                                                   microbatches, context)
        grad_norm = opt.global_norm(grads)
        params = trainable(model)
        updates, opt_state = tx.update(grads, opt_state, params)
        opt.apply_updates(params, updates)
        return opt_state, {"loss": loss, "grad_norm": grad_norm, **metrics}

    return step
