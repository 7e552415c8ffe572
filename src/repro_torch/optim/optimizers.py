"""Mixed-precision optimizers: AdamW and Adafactor.

The port of the JAX package's ``optim/optimizers.py``: parameters live in their model dtype (bf16), the state
carries the float32 master copy and the moments, and a step's numbers are
the reference's — gradients clipped to a global norm, the same moment and
bias-correction formulas, the new parameters cast from the master.

Unlike the reference's functional update, ``update`` works in place: each
state tensor is overwritten with its new value and the same state dict is
returned, and the gradients are clipped a tensor at a time inside the
update (the same numbers without a whole float32 copy of the gradients).
A leaf's update runs the reference's ops in its order through two float32
buffers of the leaf's size, so the largest leaf (an embedding) sets the
optimizer's working memory.
Keys of the state other than the optimizer's own (the gradient codec's
``_ef`` buffer) are carried through, where the reference's AdamW and
Adafactor return only their own keys and so drop it (ROADMAP Queue 3).
``state_specs(param_specs, params)`` is the reference's spec tree of the
state (the parameters' specs for the master and AdamW's moments;
Adafactor's factored moments drop the last or the second-to-last entry);
a sharded step places the state by it (``launch.steps.place_train_state``)
and the update runs on the DTensors as on tensors.
Leaves are visited in the reference's order (``repro_torch.tree``), so the
global norm sums them in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.sharding.partitioning import P


class Schedule(NamedTuple):
    fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, step):
        return self.fn(step)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine to ``floor * peak_lr``;
    a float32 tensor of the step (an int or a tensor)."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return Schedule(fn)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, step) -> (state, info); the state is updated in place
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    # (param specs, params or their shapes) -> the state's spec tree
    state_specs: Callable[..., Any] = None


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in _tree.leaves(grads)))


def _clip_scale(grads, max_norm: float):
    norm = _global_norm(grads)
    # the bound filled on the device (no host copy, so a captured step
    # holds it), and divided as a tensor: a Python scalar numerator
    # becomes a reciprocal times it, which can round differently
    scale = torch.minimum(torch.ones_like(norm),
                          torch.full((), max_norm, dtype=torch.float32,
                                     device=norm.device) / (norm + 1e-9))
    return scale, norm


def clip_by_global_norm(grads, max_norm: float):
    """(float32 gradients scaled to a global norm of at most ``max_norm``,
    the norm before scaling)."""
    scale, norm = _clip_scale(grads, max_norm)
    return _tree.map(lambda g: g.to(torch.float32) * scale, grads), norm


def _step_terms(step, device):
    """(the step as a tensor, t = step + 1 in float32).  A tensor step is
    used as it is: ``launch.steps.TrainGraph`` hands in a static one on
    the device, filled before each replay."""
    step = torch.as_tensor(step, device=device)
    return step, (step + 1).to(torch.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        master = _tree.map(lambda p: p.detach().to(torch.float32).clone(),
                           params)
        return {"master": master,
                "m": _tree.map(torch.zeros_like, master),
                "v": _tree.map(torch.zeros_like, master)}

    def update(grads, state, step):
        scale, gnorm = _clip_scale(grads, clip_norm)
        step, t = _step_terms(step, gnorm.device)
        lr = schedule(step)
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        with torch.no_grad():
            for g, mst, m, v in zip(*(_tree.leaves(x) for x in (
                    grads, state["master"], state["m"], state["v"]))):
                # the reference's ops in its order, in two float32
                # buffers a leaf (a and b)
                a = g.to(torch.float32) * scale
                b = torch.mul(a, 1 - b1)
                m.mul_(b1).add_(b)                       # m
                torch.mul(a, 1 - b2, out=b).mul_(a)
                v.mul_(b2).add_(b)                       # v
                torch.div(v, c2, out=b).sqrt_().add_(eps)
                torch.div(m, c1, out=a).div_(b)          # mhat / (...)
                a.add_(torch.mul(mst, weight_decay, out=b)).mul_(lr)
                mst.sub_(a)
        return state, {"grad_norm": gnorm, "lr": lr}

    def state_specs(param_specs, params=None):
        return {"master": param_specs, "m": param_specs, "v": param_specs}

    return Optimizer(init=init, update=update, state_specs=state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------

def adafactor(schedule: Schedule, eps: float = 1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0,
              min_dim_factored: int = 128) -> Optimizer:
    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_factored
                and shape[-2] >= min_dim_factored)

    def init(params):
        master = _tree.map(lambda p: p.detach().to(torch.float32).clone(),
                           params)

        def moments(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"master": master, "v": _tree.map(moments, master)}

    def update(grads, state, step):
        scale, gnorm = _clip_scale(grads, clip_norm)
        step, t = _step_terms(step, gnorm.device)
        lr = schedule(step)
        beta2 = 1.0 - t ** -0.8
        with torch.no_grad():
            for g, mst, mom in zip(_tree.leaves(grads),
                                   _tree.leaves(state["master"]),
                                   _moment_dicts(state["v"])):
                # the reference's ops in its order, in two float32
                # buffers a leaf (g, then u)
                g = g.to(torch.float32) * scale
                u = torch.mul(g, g).add_(eps)            # g2
                if "vr" in mom:
                    mom["vr"].copy_(beta2 * mom["vr"]
                                    + (1 - beta2) * u.mean(dim=-1))
                    mom["vc"].copy_(beta2 * mom["vc"]
                                    + (1 - beta2) * u.mean(dim=-2))
                    vr, vc = mom["vr"], mom["vc"]
                    denom = torch.clamp(vr.mean(dim=-1, keepdim=True),
                                        min=eps)
                    torch.mul(vr[..., None] / denom[..., None],
                              vc[..., None, :], out=u)   # pre
                    u.add_(eps)
                else:
                    mom["v"].mul_(beta2).add_(u.mul_(1 - beta2))
                    torch.add(mom["v"], eps, out=u)
                u.rsqrt_().mul_(g)                       # g * rsqrt(...)
                del g
                # relative step clipping (RMS(u) <= 1)
                rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u.div_(torch.clamp(rms_u, min=1.0))
                mst.sub_(u.add_(weight_decay * mst).mul_(lr))
        return state, {"grad_norm": gnorm, "lr": lr}

    def state_specs(param_specs, params):
        def moments_spec(spec, p):
            if _factored(p.shape):
                axes = tuple(spec)
                # pad spec to rank (specs may be shorter than the shape)
                axes = axes + (None,) * (len(p.shape) - len(axes))
                return {"vr": P(*axes[:-1]),
                        "vc": P(*(axes[:-2] + axes[-1:]))}
            return {"v": spec}

        return {"master": param_specs,
                "v": _tree.map(moments_spec, param_specs, params)}

    return Optimizer(init=init, update=update, state_specs=state_specs)


def _moment_dicts(v_tree):
    """The moment dicts of an Adafactor ``v`` tree ({"vr", "vc"} or {"v"}
    at each parameter's place), in leaf order of the parameters."""
    if isinstance(v_tree, dict) and (set(v_tree) <= {"vr", "vc", "v"}) \
            and v_tree and all(isinstance(x, torch.Tensor)
                               for x in v_tree.values()):
        return [v_tree]
    if isinstance(v_tree, dict):
        return [m for k in sorted(v_tree) for m in _moment_dicts(v_tree[k])]
    if isinstance(v_tree, (list, tuple)):
        return [m for x in v_tree for m in _moment_dicts(x)]
    return []


def cast_like_params(master, params):
    """New parameters: each master leaf cast to its parameter's dtype."""
    return _tree.map(lambda m, p: m.to(p.dtype), master, params)
