"""Step-function builders: train, prefill and one decode step.

The port of the JAX package's ``launch/steps.py``.  PyTorch runs eagerly,
so a step is a plain function; the steps that serving and training run
are ``DecodeGraph`` and ``TrainGraph``, each the step at static addresses
captured as one CUDA graph on the card (where the reference jits it).
The spec utilities are the reference's (``batch_specs``,
``decode_state_specs``, ``sanitize_specs``, ``shardings_of``), over
``sharding.partitioning.PartitionSpec`` leaves (``decode_state_specs``
lives in ``sharding.partitioning``, where the models place their decode
state, and is re-exported here); a model built with a policy runs its
steps on DTensors placed by them (``place_batch``, ``place_train_state``,
``Model.place``).

train_step = gradient accumulation over microbatches in float32 (the
reference's scan), the optional gradient codec, the optimizer update and
the parameter refresh from the float32 master.  The step updates its
parameters and optimizer state in place (the reference donates them) and
returns them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels import _build
from repro_torch.models.attention import KVCache
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


def abstract_init(model: Model, generator: torch.Generator):
    """(params, partition specs) without allocating anything: the params
    are fake tensors, with the shapes and dtypes ``model.init`` gives, of
    the active ``FakeTensorMode`` (a fresh one where none is active)."""
    active = detect_fake_mode() is not None
    with contextlib.nullcontext() if active else FakeTensorMode():
        params = model.init(generator)
    return params, model.param_specs()


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


def make_sampler(model: Model, sample_topk: int = 0):
    """``sample(logits, rng) -> (B, 1) int32``: the serve step's choice of
    the next token.  With ``sample_topk > 0`` top-k sampling through the
    port's ``repro_torch.sort.topk`` front door (``cfg.sort_method``,
    default ``"auto"``, so the planner may route it to K4's selection or
    K5's bitonic top-k), then the Gumbel-max trick over the k candidates;
    ``rng`` is a ``torch.Generator`` on the model's device, or a tensor of
    uniforms of shape (B, k).  With ``sample_topk == 0`` greedy, and
    ``rng`` is ignored.  Under a placing policy each rank samples its
    rows."""
    method = model.cfg.sort_method

    def sample(logits, rng):
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
                return pol.run_local(_sample, (logits, rng), (rows, rows),
                                     rows)
            return pol.run_local(lambda lg: _sample(lg, rng), (logits,),
                                 (rows,), rows)
        return _sample(logits, rng)

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

    return sample


def make_serve_step(model: Model, shape: ShapeSpec, sample_topk: int = 0):
    """One decode step: token -> logits -> (sampled) next token + new state,
    eagerly, on whatever tensors it is handed (``make_sampler`` says how
    the next token is chosen; the global RNG state is never read).  The
    served path runs ``DecodeGraph``, the same step at static addresses;
    this one is its yardstick."""
    del shape
    sample = make_sampler(model, sample_topk)

    def serve_step(params, token, state,
                   rng: Union[torch.Generator, torch.Tensor, None] = None):
        logits, new_state = model.decode_step(params, token, state)
        return sample(logits, rng), new_state

    return serve_step


# eager decode steps run on a side stream before a capture: they plan every
# top-k of the step (so the capture meets only plan-cache hits), load the
# kernels and settle the allocator
GRAPH_WARMUP = 2


_SIDE_STREAMS: Dict[torch.device, Any] = {}


def _side_stream(device: torch.device):
    """The one side stream of a device on which every captured step warms
    up and is captured: cuBLAS keeps a workspace for each stream it has run
    on for the process's life, and blocks cached on one stream serve no
    other."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[device]


@dataclasses.dataclass
class _Slot:
    """The static buffers of one batch size: the graph reads the token,
    the state and the uniforms, and writes the state, the logits and the
    next token, each at one address for the slot's life."""
    state: Any
    token: torch.Tensor                       # (B, 1) int32
    uniforms: Optional[torch.Tensor]          # (B, k) float32
    logits: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None
    params: Any = None                        # what the graph was captured on
    graph: Any = None                         # torch.cuda.CUDAGraph
    tally: Dict[str, int] = dataclasses.field(default_factory=dict)


def _rewound_leaves(state) -> List[torch.Tensor]:
    """The tensors of a decode state that one decode step changes in a way
    the next step reads: ``t`` and every recurrent state.  Attention
    caches are left out: a step writes slot ``t`` before it reads it."""
    if isinstance(state, KVCache) or state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [x for v in state.values() for x in _rewound_leaves(v)]
    return [x for v in state for x in _rewound_leaves(v)]


class DecodeGraph:
    """The serve step at static addresses: on the card one CUDA graph a
    batch size, the port's counterpart of the reference's
    ``jax.jit(make_serve_step(...))``.

    The graph holds the whole step: the embedding, every layer's mixer
    and FFN with its state written in place (the MoE routers' K5 among
    them), the final norm and the logits, the sampling top-k (K5, or the
    backend the plan picks), the Gumbel-max choice and the advance of
    ``t``.  :meth:`prefill` runs eagerly, into one decode state a batch
    size (the first prefill's state; later ones fill it in place).
    Calling the object is one decode step from that state: the token is
    copied into the static token when it is another tensor, the (B, k)
    uniforms are drawn from ``rng`` into a static buffer outside the
    graph (the eager step's draws, in its order), and the graph is
    replayed; the next token comes back as a copy, and the state advances
    in place.  The first call at a batch size runs ``GRAPH_WARMUP`` eager
    steps on a side stream (rewound: ``t`` and the recurrent states are
    put back) and captures the step.  A failed capture raises, naming the
    model and batch; it never falls back to the eager step.  A kernel
    wrapper's launches inside the graph are counted once a replay
    (``_build.count_replay``).

    Off the card the same static step runs without a graph (``capture``
    False).  ``captures``, ``replays`` and ``warmup_steps`` count what
    ran."""

    def __init__(self, model: Model, shape: ShapeSpec, sample_topk: int = 0):
        self.model = model
        self.max_len = shape.seq_len
        self.sample_topk = sample_topk
        self.capture = model.device.type == "cuda"
        self._sample = make_sampler(model, sample_topk)
        self._slots: Dict[int, _Slot] = {}
        self.captures = self.replays = self.warmup_steps = 0

    def prefill(self, params, batch):
        """``model.prefill`` of ``batch`` into this batch size's static
        state -> (last logits, the static state)."""
        b = batch["tokens"].shape[0]
        slot = self._slots.get(b)
        if slot is not None:
            return self.model.prefill(params, batch, max_len=self.max_len,
                                      state=slot.state)
        logits, state = self.model.prefill(params, batch,
                                           max_len=self.max_len)
        dev = self.model.device
        self._slots[b] = _Slot(
            state=state, token=torch.zeros((b, 1), dtype=torch.int32,
                                           device=dev),
            uniforms=torch.zeros((b, self.sample_topk), dtype=torch.float32,
                                 device=dev) if self.sample_topk else None)
        return logits, state

    def logits(self, batch_size: int) -> torch.Tensor:
        """The last step's logits at ``batch_size`` (a static buffer: the
        next step overwrites it)."""
        return self._slots[batch_size].logits

    def __call__(self, params, token, state,
                 rng: Union[torch.Generator, torch.Tensor, None] = None):
        slot = self._slots.get(token.shape[0])
        if slot is None or state is not slot.state:
            raise ValueError("DecodeGraph: decode from the state its "
                             "prefill returned for this batch size")
        if token.data_ptr() != slot.token.data_ptr():
            slot.token.copy_(token)
        if self.sample_topk:
            self._draw(slot, rng)
        if not self.capture:
            return self._step(params, slot), state
        if slot.graph is None:
            self._capture(params, slot)
        elif params is not slot.params:
            raise ValueError("DecodeGraph: the step was captured on other "
                             "parameters")
        slot.graph.replay()
        _build.count_replay(slot.tally)
        self.replays += 1
        return slot.out.clone(), state

    def _draw(self, slot: _Slot, rng) -> None:
        u = slot.uniforms
        if isinstance(rng, torch.Generator):
            torch.rand(u.shape, generator=rng, device=u.device, out=u)
        elif isinstance(rng, torch.Tensor):
            if rng.shape != u.shape:
                raise ValueError(f"serve_step: uniforms of shape "
                                 f"{tuple(rng.shape)}, need "
                                 f"{tuple(u.shape)}")
            u.copy_(rng)
        else:
            raise TypeError("serve_step: sampling needs a torch.Generator "
                            "or a tensor of uniforms")

    def _step(self, params, slot: _Slot):
        logits, new = self.model.decode_step(params, slot.token, slot.state)
        slot.state["t"].copy_(new["t"])
        slot.logits = logits
        return self._sample(logits, slot.uniforms)

    def _capture(self, params, slot: _Slot) -> None:
        dev = self.model.device
        rewind = _rewound_leaves(slot.state)
        keep = [x.clone() for x in rewind]
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                self._step(params, slot)
                for x, k in zip(rewind, keep):
                    x.copy_(k)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warmup_steps += GRAPH_WARMUP
        del keep
        slot.graph, slot.tally, slot.out = _captured(
            side, lambda: self._step(params, slot),
            f"DecodeGraph: capturing the decode step of "
            f"{self.model.cfg.name} at batch {slot.token.shape[0]}")
        slot.params = params
        self.captures += 1


def _captured(side, step, what: str):
    """(graph, tally, out): ``step()`` captured as one CUDA graph on the
    stream ``side``, the kernel wrappers' launches inside it counted into
    the tally (``_build.capture_tally``), ``out`` what ``step`` returned
    (static buffers).  A failed capture raises, naming ``what`` and the
    cause; nothing falls back to running ``step`` eagerly."""
    graph = torch.cuda.CUDAGraph()
    try:
        with _build.capture_tally() as tally, \
                torch.cuda.graph(graph, stream=side):
            out = step()
    except Exception as e:
        raise RuntimeError(f"{what} failed: {e}") from e
    return graph, dict(tally), out


@dataclasses.dataclass
class _TrainSlot:
    """The static buffers of one batch shape: the graph reads the batch
    and the step, updates the parameters and optimizer state in place and
    writes the metrics, each at one address for the slot's life."""
    batch: Dict[str, torch.Tensor]
    step: torch.Tensor                        # () int64
    leaves: List[torch.Tensor]                # the state it is bound to
    warmed: int = 0                           # eager warm-up steps run
    out: Optional[Dict[str, torch.Tensor]] = None
    graph: Any = None                         # torch.cuda.CUDAGraph
    tally: Dict[str, int] = dataclasses.field(default_factory=dict)


def _state_leaves(params, opt_state) -> List[torch.Tensor]:
    return _tree.leaves(params) + _tree.leaves(opt_state)


class TrainGraph:
    """The train step at static addresses: on the card one CUDA graph a
    batch shape, the port's counterpart of the reference's
    ``jax.jit(train_step, donate_argnums=(0, 1))``.

    Called as the eager step is, ``(params, opt_state, step, batch) ->
    (params, opt_state, metrics)``; ``train_step`` is what
    ``build_train_step`` / ``make_train_step`` return, and stays the
    eager yardstick.  Each batch entry is copied into a static buffer
    keyed by the batch's names, shapes and dtypes (a new shape gets its
    own slot and graph), and ``step`` is filled into a static int64
    tensor before the step runs.  The parameters and the optimizer state
    (the codec's ``_ef`` buffer among it) are updated in place, the
    port's counterpart of donation: the graph holds the gradients (the
    forward, the remat recompute and the backward, the MoE routers' K5
    among them), the codec, the clip, the optimizer update and the
    parameter refresh from the float32 master.  A slot is bound to the
    parameter and state tensors of its first call, on the card and off
    it; other tensors raise, naming the first leaf that differs.

    At a new shape the first ``GRAPH_WARMUP`` calls are real steps, run
    eagerly on the device's side stream (``_side_stream``; the cached
    blocks of the current stream are given back first): they plan every
    top-k (so the capture meets only plan-cache hits), load the kernels
    and settle the allocator.
    They are not rewound, which would take a copy of the whole optimizer
    state.  The next call captures the step (``torch.cuda.graph`` frees
    the cached eager blocks first; capture runs nothing) and replays it;
    each later call is a replay.  A failed capture raises, naming the
    model, the batch shapes and the cause; nothing falls back to the
    eager step.  The metrics (``loss``, ``grad_norm``, ``lr``) live in
    static buffers and come back as copies.  A kernel wrapper's launches
    inside the graph are counted once a replay (``_build.count_replay``).

    Off the card the same static step runs without a graph (``capture``
    False).  ``captures``, ``replays``, ``warmup_steps`` and
    ``capture_seconds`` count what ran."""

    def __init__(self, model: Model, train_step):
        self.model = model
        self.train_step = train_step
        self.capture = model.device.type == "cuda"
        self._slots: Dict[tuple, _TrainSlot] = {}
        self.captures = self.replays = self.warmup_steps = 0
        self.capture_seconds = 0.0

    def __call__(self, params, opt_state, step, batch):
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _TrainSlot(
                batch={k: v.clone() for k, v in batch.items()},
                step=torch.zeros((), dtype=torch.int64,
                                 device=self.model.device),
                leaves=_state_leaves(params, opt_state))
        else:
            self._check_bound(params, opt_state, slot)
            for k, v in batch.items():
                if v is not slot.batch[k]:
                    slot.batch[k].copy_(v)
        slot.step.fill_(step)
        if not self.capture:
            return params, opt_state, self._step(params, opt_state, slot)
        if slot.graph is None and slot.warmed < GRAPH_WARMUP:
            return params, opt_state, self._warm_up(params, opt_state, slot)
        if slot.graph is None:
            self._capture(params, opt_state, slot)
        slot.graph.replay()
        _build.count_replay(slot.tally)
        self.replays += 1
        return params, opt_state, {k: v.clone() for k, v in slot.out.items()}

    def _step(self, params, opt_state, slot: _TrainSlot):
        return self.train_step(params, opt_state, slot.step, slot.batch)[2]

    def _warm_up(self, params, opt_state, slot: _TrainSlot):
        dev = self.model.device
        if not slot.warmed:
            # blocks the current stream cached (the optimizer's init
            # temporaries) serve no other stream: give them back first
            torch.cuda.empty_cache()
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            met = self._step(params, opt_state, slot)
        torch.cuda.current_stream(dev).wait_stream(side)
        slot.warmed += 1
        self.warmup_steps += 1
        return met

    def _check_bound(self, params, opt_state, slot: _TrainSlot) -> None:
        got = _state_leaves(params, opt_state)
        if len(got) == len(slot.leaves) and \
                all(a is b for a, b in zip(got, slot.leaves)):
            return
        paths = ([f"params{p}" for p, _ in _tree.leaves_with_path(params)]
                 + [f"opt_state{p}" for p, _ in
                    _tree.leaves_with_path(opt_state)])
        bad = next((p for p, a, b in zip(paths, got, slot.leaves)
                    if a is not b), "the number of leaves")
        raise ValueError(f"TrainGraph: the step is bound to other "
                         f"parameters and optimizer state ({bad} differs)")

    def _capture(self, params, opt_state, slot: _TrainSlot) -> None:
        side = _side_stream(self.model.device)
        side.wait_stream(torch.cuda.current_stream(self.model.device))
        shapes = ", ".join(f"{k} {tuple(v.shape)}"
                           for k, v in slot.batch.items())
        t0 = time.perf_counter()
        slot.graph, slot.tally, slot.out = _captured(
            side, lambda: self._step(params, opt_state, slot),
            f"TrainGraph: capturing the train step of {self.model.cfg.name} "
            f"at batch {shapes}")
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
