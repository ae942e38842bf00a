"""First-order optimizers as (init, update) pairs over plain dicts of
tensors, as the reference writes them: SGD (+momentum), Adam, AdamW,
global-norm clipping and lr schedules. State is a plain nested dict of
tensors. `adam` keeps the reference's update, u = (m mhat) / (sqrt(v
vhat) + eps) with mhat, vhat the bias-correction scales;
`torch.optim.Adam` places eps differently, so it is not used.

Updates are pure (new tensors, no in-place change), so a caller may keep
the old parameters; nothing here reads a device value on the host.
`adam` lets go of each gradient leaf once it has formed that leaf's
moments: a caller that hands over its only reference to the gradient
tree (as `repro_torch.models.lm.make_train_step` does) gets each leaf's
memory back during the update.

Dtypes follow the reference's. Its lr and bias-correction scales (and
the clip scale) are fp32 0-dim arrays, and JAX promotes a bf16 leaf
multiplied by one to fp32; torch keeps ``bf16 * fp32-0-dim`` in bf16. So
every leaf is brought to ``promote_types(dtype, float32)`` (`_f32`)
before it meets such a scale: a bf16 parameter comes out of its first
update in fp32, with its moments still bf16, and from then on the
gradients, and so the moments, are fp32 too.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "Optimizer",
    "adam",
    "adamw",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "grad_like",
    "sgd",
    "tree_leaves",
    "tree_map",
    "value_and_grad",
]

Params = Any
Grads = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Grads, Any, Params], tuple[Params, Any]]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts / lists / tuples of
    tensors (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def value_and_grad(loss_fn, params) -> tuple[torch.Tensor, Any]:
    """(loss, gradients shaped and typed like ``params``) of
    ``loss_fn(params)``, by `torch.autograd.grad` over detached views of
    the leaves (the caller's tensors are not touched); a leaf the loss
    does not reach gets zeros, as `jax.grad` gives."""
    leaves = [grad_like(p.detach().requires_grad_(True)) for p in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves))
    return loss.detach(), tree_map(lambda _: next(it), params)


def grad_like(t: torch.Tensor) -> torch.Tensor:
    """``t``, its gradient laid out like it as soon as it is formed, when
    ``t`` is a DTensor that requires grad: a partial sum is reduced and a
    replicated one sharded at once, as GSPMD gives a gradient its
    parameter's sharding, where DTensor would keep the whole unreduced
    gradient on every rank until it is used. A plain tensor is returned
    untouched."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor) and t.requires_grad:
        mesh, placements = t.device_mesh, t.placements
        t.register_hook(lambda g: g.redistribute(mesh, placements))
    return t


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def sched(step):
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * warm * cos

    return sched


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype JAX gives it against an fp32 array: bf16 (and
    fp16) go to fp32, fp32 and fp64 stay."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def clip_by_global_norm(grads: Grads, max_norm: float) -> Grads:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: _f32(g) * scale, grads)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new_p = tree_map(lambda p, m: p - lr_t * _f32(m), params, mu)
            return new_p, {"step": step, "mu": mu}
        new_p = tree_map(lambda p, g: p - lr_t * _f32(g), params, grads)
        return new_p, {"step": step, "mu": None}

    return Optimizer(init=init, update=update)


def adam(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moments_dtype: torch.dtype | None = None,
) -> Optimizer:
    """Adam; weight_decay > 0 gives AdamW (decoupled). moments_dtype
    overrides the m / v storage type."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def _zeros(p):
        return torch.zeros(p.shape, dtype=moments_dtype or p.dtype, device=p.device)

    def init(params):
        return {
            "step": _step0(params),
            "m": tree_map(_zeros, params),
            "v": tree_map(_zeros, params),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        t = step.to(torch.float32)
        mhat_scale = 1.0 / (1.0 - torch.pow(torch.full((), b1, device=t.device), t))
        vhat_scale = 1.0 / (1.0 - torch.pow(torch.full((), b2, device=t.device), t))

        # [p, g, m, v] per leaf, matched by key; from here ``rows`` holds
        # this frame's only references to the gradients
        rows = []
        tree_map(lambda *x: rows.append(list(x)), params, grads, state["m"], state["v"])
        del grads
        new_p, new_m, new_v = [], [], []
        # one leaf at a time (p, m, v together), so the temporaries are one leaf's
        for row in rows:
            p, g, m_, v_ = row
            row[1] = None
            m = b1 * m_ + (1 - b1) * g
            v = b2 * v_ + (1 - b2) * g * g
            del g
            # u = (m mhat) / (sqrt(v vhat) + eps); the in-place steps act on
            # this leaf's own temporaries (the same values, fewer live copies)
            denom = torch.sqrt(_f32(v) * vhat_scale).add_(eps)
            u = (_f32(m) * mhat_scale).div_(denom)
            del denom
            if weight_decay:
                u = u + weight_decay * p
            new_p.append(p - u.mul_(lr_t))
            new_m.append(m)
            new_v.append(v)
            del u

        def unflatten(leaves):
            it = iter(leaves)
            return tree_map(lambda _: next(it), params)

        return unflatten(new_p), {"step": step, "m": unflatten(new_m), "v": unflatten(new_v)}

    return Optimizer(init=init, update=update)


def adamw(lr: float | Callable = 1e-3, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr=lr, weight_decay=weight_decay, **kw)
