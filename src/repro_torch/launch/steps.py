"""Step-function builders: train, prefill and one decode step.

The port of the JAX package's ``launch/steps.py``.  PyTorch runs eagerly,
so a step is a plain function.  The spec utilities are the reference's
(``batch_specs``, ``decode_state_specs``, ``sanitize_specs``,
``shardings_of``), over ``sharding.partitioning.PartitionSpec`` leaves
(``decode_state_specs`` lives in ``sharding.partitioning``, where the
models place their decode state, and is re-exported here); a
model built with a policy runs its steps on DTensors placed by them
(``place_batch``, ``place_train_state``, ``Model.place``).

train_step = gradient accumulation over microbatches in float32 (the
reference's scan), the optional gradient codec, the optimizer update and
the parameter refresh from the float32 master.  The step updates its
parameters and optimizer state in place (the reference donates them) and
returns them.
"""
from __future__ import annotations

from typing import Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import sharded
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.partitioning import (  # noqa: F401 (re-exported)
    P, PartitionSpec, ShardingPolicy, decode_state_specs, placements_of)


# ---------------------------------------------------------------------------
# spec utilities
# ---------------------------------------------------------------------------

def batch_specs(model: Model, shape: ShapeSpec, policy: ShardingPolicy):
    """PartitionSpec tree matching ``model.input_specs(shape)``."""
    dp = policy.dp_axes
    specs = {}
    for name, t in model.input_specs(shape).items():
        if name == "positions":            # (3, B, S)
            specs[name] = P(None, dp, None)
        else:
            specs[name] = P(dp, *([None] * (t.dim() - 1)))
    return specs


def sanitize_specs(specs, abstract, mesh):
    """Drop spec entries whose dimension does not divide the mesh axes —
    the safety net that lets odd sizes (vocab 51865, batch 1) run
    replicated instead of erroring.  ``abstract``: tensors (or anything
    with ``.shape``) of ``specs``' structure; a single spec takes one."""
    if mesh is None:
        return specs
    pol = ShardingPolicy(mesh=mesh)
    if isinstance(specs, PartitionSpec):
        return pol._sanitize(specs, tuple(abstract.shape))
    return _tree.map(lambda s, a: pol._sanitize(s, tuple(a.shape)), specs,
                     abstract)


def shardings_of(tree_specs, mesh):
    """Spec tree -> tree of DTensor placements on ``mesh`` (None without
    one)."""
    if mesh is None:
        return None
    return _tree.map(lambda s: placements_of(s, mesh), tree_specs)


def place_batch(model: Model, batch, shape: ShapeSpec = None):
    """A batch of whole tensors (the same on every rank) as DTensors placed
    by ``batch_specs`` (each rank keeps its rows); unchanged without a
    policy or mesh."""
    pol = model.policy
    if pol is None or not pol.places:
        return batch
    dp = pol.dp_axes
    return {k: pol.distribute(v, P(None, dp, None) if k == "positions"
                              else P(dp, *([None] * (v.dim() - 1))))
            for k, v in batch.items()}


def place_train_state(model: Model, optimizer: opt_lib.Optimizer, params,
                      opt_state, specs=None):
    """(params, optimizer state) of whole tensors placed as DTensors by
    the model's parameter specs and ``optimizer.state_specs``; unchanged
    without a policy or mesh."""
    pol = model.policy
    if pol is None or not pol.places:
        return params, opt_state
    specs = model.param_specs() if specs is None else specs
    st_specs = optimizer.state_specs(specs, params)
    st = {k: v for k, v in opt_state.items() if k in st_specs}
    placed = pol.param_sharding(st_specs, st)
    placed.update({k: v for k, v in opt_state.items() if k not in st_specs})
    return pol.param_sharding(specs, params), placed


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def loss_and_grads(model: Model, params, batch):
    """(loss, aux, gradients): the loss of ``batch`` and its gradient with
    respect to every parameter leaf, in the parameters' dtypes and tree."""
    live = _tree.map(lambda p: p.detach().requires_grad_(True), params)
    leaves = _tree.leaves(live)
    with torch.enable_grad():
        loss, aux = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    # a DTensor parameter's gradient is placed as the parameter is (a
    # partial sum reduced, a shard of another dimension moved), so the
    # optimizer's in-place update meets one placement a leaf
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) and g.placements != p.placements
             else g for p, g in zip(leaves, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, _tree.unflatten(params, grads)


def batch_axis(name: str) -> int:
    """The batch axis of a batch entry: 1 for the vlm's (3, B, S)
    ``positions``, 0 for every other.  Chosen by name: the reference tests
    ``shape[0] == 3`` (ROADMAP Queue 3), which a global batch of 3 would
    also meet."""
    return 1 if name == "positions" else 0


def build_train_step(model: Model, optimizer: opt_lib.Optimizer,
                     shape: ShapeSpec, microbatch: int = 1,
                     accum_dtype=torch.float32, grad_compressor=None):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)``.  ``batch``: ``{"tokens", "labels"}`` tensors on the
    model's device (and ``frames``, or ``vision_embeds`` and ``positions``,
    where the family takes them); ``microbatch`` splits each entry along
    its batch axis (``batch_axis``) and
    accumulates the gradients in ``accum_dtype``; ``grad_compressor`` is a
    codec's ``apply`` (``optim.grad_compress.make_compressor``)."""
    del shape          # the reference's shardings: the DTensors' placements

    policy = getattr(model, "policy", None)     # any object with loss()

    def train_step(params, opt_state, step, batch):
        with sharded(policy):
            return _train_step(params, opt_state, step, batch)

    def _train_step(params, opt_state, step, batch):
        if microbatch > 1:
            b = batch["tokens"].shape[0]
            if b % microbatch:
                raise ValueError(f"a batch of {b} does not split into "
                                 f"{microbatch} microbatches")
            per = b // microbatch
            gsum, lsum = None, 0.0
            for j in range(microbatch):
                mb = {k: v.narrow(batch_axis(k), j * per, per)
                      for k, v in batch.items()}
                loss, _, grads = loss_and_grads(model, params, mb)
                if gsum is None:
                    gsum = _tree.map(lambda g: g.to(accum_dtype), grads)
                else:
                    gsum = _tree.map(lambda a, g: a.add_(g.to(accum_dtype)),
                                     gsum, grads)        # in place
                del grads          # not held through the next microbatch
                lsum = lsum + loss
            grads = _tree.map(lambda g: g.to(torch.float32).div_(microbatch),
                              gsum)                      # in place if float32
            del gsum
            loss = lsum / microbatch
        else:
            loss, _, grads = loss_and_grads(model, params, batch)
        if grad_compressor is not None:
            grads, opt_state = grad_compressor(grads, opt_state)
        opt_state, info = optimizer.update(grads, opt_state, step)
        with torch.no_grad():
            for p, m in zip(_tree.leaves(params),
                            _tree.leaves(opt_state["master"])):
                p.copy_(m)           # the master cast to the param dtype
        return params, opt_state, {"loss": loss, **info}

    return train_step


def make_train_step(model: Model, cfg: ModelConfig, shape: ShapeSpec,
                    optimizer_name: str = "adamw", microbatch: int = 1,
                    peak_lr: float = 3e-4, total_steps: int = 10000,
                    accum_dtype=torch.float32, grad_compressor=None):
    """(train_step, optimizer): the reference's cosine schedule (warmup
    ``min(500, total_steps // 10)``) under AdamW or Adafactor."""
    sched = opt_lib.cosine_schedule(peak_lr,
                                    warmup=min(500, total_steps // 10),
                                    total=total_steps)
    optimizer = (opt_lib.adafactor(sched) if optimizer_name == "adafactor"
                 else opt_lib.adamw(sched))
    fn = build_train_step(model, optimizer, shape, microbatch=microbatch,
                          accum_dtype=accum_dtype,
                          grad_compressor=grad_compressor)
    return fn, optimizer


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model, shape: ShapeSpec):
    """``prefill_step(params, batch) -> (last logits, decode state)``: the
    whole batch goes to the model (``tokens``, and ``frames`` /
    ``vision_embeds`` / ``positions`` where the family takes them)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=shape.seq_len)
    return prefill_step


def make_serve_step(model: Model, shape: ShapeSpec, sample_topk: int = 0):
    """One decode step: token -> logits -> (sampled) next token + new state.

    With ``sample_topk > 0`` the next token comes from top-k sampling
    through the port's ``repro_torch.sort.topk`` front door
    (``cfg.sort_method``, default ``"auto"``, so the planner may route it to
    K4's selection or K5's bitonic top-k), then the Gumbel-max trick over
    the k candidates.  ``rng`` is a ``torch.Generator`` on the model's
    device, or a tensor of uniforms of shape (B, k) for the noise; the
    global RNG state is never read.  With ``sample_topk == 0`` the step is
    greedy and ``rng`` is ignored.
    """
    method = model.cfg.sort_method

    def serve_step(params, token, state,
                   rng: Union[torch.Generator, torch.Tensor, None] = None):
        logits, new_state = model.decode_step(params, token, state)
        pol = getattr(model, "policy", None)
        if pol is not None and pol.places:
            # the sampling runs on each rank's rows, with whole
            # vocabularies; the uniforms are drawn whole, as without a
            # policy, and split by rows
            rows = pol._sanitize(P(pol.dp_axes, None), logits.shape)
            if sample_topk and isinstance(rng, torch.Generator):
                rng = torch.rand((logits.shape[0], sample_topk),
                                 generator=rng, device=rng.device)
            if sample_topk and isinstance(rng, torch.Tensor):
                nxt = pol.run_local(_sample, (logits, rng), (rows, rows),
                                    rows)
            else:
                nxt = pol.run_local(lambda lg: _sample(lg, rng), (logits,),
                                    (rows,), rows)
            return nxt, new_state
        return _sample(logits, rng), new_state

    def _sample(logits, rng):
        if sample_topk:
            from repro_torch import sort as sorting
            v, i = sorting.topk(logits, sample_topk, method=method,
                                device=logits.device)
            if isinstance(rng, torch.Tensor):
                u = rng.to(device=v.device, dtype=torch.float32)
                if u.shape != v.shape:
                    raise ValueError(f"serve_step: uniforms of shape "
                                     f"{tuple(u.shape)}, need "
                                     f"{tuple(v.shape)}")
            elif isinstance(rng, torch.Generator):
                u = torch.rand(v.shape, generator=rng, device=v.device)
            else:
                raise TypeError("serve_step: sampling needs a "
                                "torch.Generator or a tensor of uniforms")
            gumbel = -torch.log(-torch.log(u + 1e-9) + 1e-9)
            choice = torch.argmax(v + gumbel, dim=-1)
            nxt = torch.gather(i, -1, choice[..., None])
        else:
            nxt = torch.argmax(logits, dim=-1)[..., None]
        return nxt.to(torch.int32)

    return serve_step
