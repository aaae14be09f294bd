"""Optimizers, schedules and gradient transformations on dicts of tensors.

Counterpart of ``repro.optim.optimizer``: the same ``(init, update)``
transformation protocol and the same arithmetic (not ``torch.optim``'s),
with a flat ``{name: tensor}`` dict in place of the reference's pytree and
``None`` marking a frozen leaf. States are NamedTuples of tensors and such
dicts. Leaves that are not floating point (the butterfly index buffers,
should a caller pass them) are never updated.

:func:`apply_updates` adds the updates to the parameters **in place** (the
reference returns new arrays): the parameters are the model's own
``nn.Parameter`` tensors, and an out-of-place copy would double their
memory for nothing.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, Optional[torch.Tensor]]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], object]
    update: Callable[..., Tuple[Tree, object]]


def _map(f, *trees: Tree) -> Tree:
    return {k: f(*(t[k] for t in trees)) for k in trees[0]}


def _is_trainable(x) -> bool:
    return x is not None and torch.is_floating_point(x)


def _count(device=None) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device(tree: Tree):
    return next((t.device for t in tree.values() if t is not None), None)


# ---------------------------------------------------------------------------
# Schedules: step (int or tensor) -> float32 learning rate
# ---------------------------------------------------------------------------

def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, final_frac: float = 0.1
                           ) -> Callable:
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def linear_warmup_schedule(peak_lr: float, warmup_steps: int) -> Callable:
    def schedule(step):
        step = _f32(step)
        return peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    return schedule


# ---------------------------------------------------------------------------
# Core transforms
# ---------------------------------------------------------------------------

class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
    def init(params):
        def zeros():
            return _map(lambda p: torch.zeros_like(p) if _is_trainable(p)
                        else None, params)
        return ScaleByAdamState(count=_count(_device(params)), mu=zeros(),
                                nu=zeros())

    def update(grads, state, params=None):
        count = state.count + 1
        mu = _map(lambda g, m: None if m is None else b1 * m + (1 - b1) * g,
                  grads, state.mu)
        nu = _map(lambda g, v: None if v is None
                  else b2 * v + (1 - b2) * g * g, grads, state.nu)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        updates = _map(lambda m, v: None if m is None
                       else (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


class ClipState(NamedTuple):
    pass


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values() if g is not None))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ClipState()

    def update(grads, state, params=None):
        scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12),
                            max=1.0)
        return _map(lambda g: None if g is None else g * scale,
                    grads), state

    return GradientTransformation(init, update)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


def scale_by_schedule(schedule) -> GradientTransformation:
    def init(params):
        return ScaleByScheduleState(count=_count(_device(params)))

    def update(grads, state, params=None):
        lr = schedule(state.count).to(state.count.device)
        return (_map(lambda g: None if g is None else -lr * g, grads),
                ScaleByScheduleState(count=state.count + 1))

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Decoupled weight decay on matrices and higher (``ndim > 1``) only."""
    def init(params):
        return ClipState()

    def update(grads, state, params=None):
        if weight_decay == 0.0 or params is None:
            return grads, state
        return _map(lambda g, p: None if g is None
                    else g + weight_decay * (p.to(g.dtype) if p.ndim > 1
                                             else torch.zeros_like(g)),
                    grads, params), state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# User-facing optimizers
# ---------------------------------------------------------------------------

def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: float = 0.0) -> GradientTransformation:
    schedule = (learning_rate if callable(learning_rate)
                else constant_schedule(learning_rate))
    parts = []
    if max_grad_norm:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts.append(scale_by_adam(b1, b2, eps))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale_by_schedule(schedule))
    return chain(*parts)


class MomentumState(NamedTuple):
    count: torch.Tensor
    trace: Tree


def sgd(learning_rate, momentum: float = 0.0) -> GradientTransformation:
    schedule = (learning_rate if callable(learning_rate)
                else constant_schedule(learning_rate))

    def init(params):
        trace = _map(lambda p: torch.zeros_like(p) if _is_trainable(p)
                     else None, params)
        return MomentumState(count=_count(_device(params)), trace=trace)

    def update(grads, state, params=None):
        lr = schedule(state.count).to(state.count.device)
        if momentum:
            trace = _map(lambda g, t: None if t is None
                         else momentum * t + g, grads, state.trace)
            updates = _map(lambda t: None if t is None else -lr * t, trace)
        else:
            trace = state.trace
            updates = _map(lambda g: None if g is None else -lr * g, grads)
        return updates, MomentumState(count=state.count + 1, trace=trace)

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p += u`` in place for every trainable leaf with an update; returns
    ``params``."""
    for k, p in params.items():
        u = updates.get(k)
        if u is not None and _is_trainable(p):
            p.add_(u.to(p.dtype))
    return params
