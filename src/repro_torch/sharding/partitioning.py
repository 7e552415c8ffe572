"""Sharding policy: logical placement rules -> DTensor placements.

The port of the JAX package's ``sharding/partitioning.py``.  One object
carries every distribution decision:

  * mesh axes: optional ``pod`` (pure DP), ``data`` (FSDP batch +
    parameter shard), ``model`` (TP/EP), the names of a
    ``torch.distributed.device_mesh.DeviceMesh``'s dimensions;
  * parameters: 2-D sharded per the specs each module emits (FSDP on
    ``data``, TP on ``model``); the ``pod`` axis never shards parameters;
  * activations: batch on (pod, data); attention heads on ``model`` when
    the head count divides, else replicated (the KV cache falls back to
    head_dim);
  * KV cache: kv heads optionally repeated up to the TP degree so the cache
    shards instead of replicating (``kv_repeat``).

Specs keep the reference's form: a :class:`PartitionSpec` with one entry a
tensor dimension, each ``None``, an axis name or a tuple of axis names
(``P("data", "model")``, ``P(None, ("data", "model"))``).  It is a leaf of
``repro_torch.tree`` (not a tuple), so spec trees map like parameter
trees.  :func:`placements_of` turns a spec into DTensor placements at a
mesh: an axis named in entry d becomes ``Shard(d)`` on that mesh
dimension, every other mesh dimension ``Replicate()``.  A tuple entry
shards its dimension on each axis, the first the most significant: DTensor
splits a dimension sharded on several mesh dimensions in mesh order, so a
tuple must name its axes in mesh order (``("data", "model")`` on a
``(data, model)`` mesh is data-major, the reference's row order; the
reverse raises).

The policy's mesh is a ``DeviceMesh`` (``launch.mesh``: the host's cards,
or the production 16 x 16 / 2 x 16 x 16 meshes over a ``fake`` process
group for the dry run), or an :class:`AbstractMesh` (axis names and
sizes only) for the spec functions, which read nothing but the axis
sizes.  ``core.mesh.Mesh`` is the sort tier's single-controller mesh and
is not one of these.

What the hooks do here:

  * ``_constrain`` is ``DTensor.redistribute`` to the spec's placements
    (a plain tensor enters as replicated), and the identity without a
    mesh.  The spec is sanitized against the tensor's shape first
    (``_sanitize``: axes the mesh lacks, or that do not divide the
    dimension, are dropped, and so are those of a dimension of size 1),
    so no hook makes an uneven shard, which DTensor would accept and the
    reference never makes.
  * ``run_local`` is the port's ``shard_map``: the inputs are
    redistributed to their specs and ``fn`` runs on each rank's local
    tensors (``torch.distributed.tensor.experimental.local_map``); its
    outputs come back as DTensors of the given placements, a ``Partial``
    one (a rank's partial sum) reduced at once (``settle``).  Autograd
    goes through it.
  * ``run_sharded_flash`` runs K6 (``kernels.flash_attention``) on each
    rank's (batch, head) shard; ``_run_cp_flash`` on each rank's block of
    queries against replicated K/V, passing the block's global origin as
    K6's ``q_offset``.  Forward only, as the reference's: K6 refuses a
    tensor that requires grad, and training takes the einsum path.  Where
    a sanitized q spec does not shard the sequence (its length does not
    divide the TP degree) the offset is 0: the reference would pass
    ``rank * local_s`` against a whole sequence there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch import tree as _tree


class PartitionSpec:
    """The reference's ``PartitionSpec``: one entry a tensor dimension
    (``None``, an axis name, or a tuple of axis names); trailing
    dimensions past its length are replicated."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        # as the reference's: a one-axis tuple is that axis, an empty one
        # no axis
        self._entries = tuple(
            (e[0] if len(e) == 1 else e if e else None)
            if isinstance(e, tuple) else e for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"P{self._entries!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or a process group: what the
    spec functions read (``mesh_dim_names``, ``shape``)."""
    sizes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, shape, axis_names) -> "AbstractMesh":
        return cls(tuple(zip(axis_names, shape)))

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.sizes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(n for _, n in self.sizes)

    @property
    def ndim(self) -> int:
        return len(self.sizes)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or an AbstractMesh (the
    reference's ``mesh.shape``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements_of(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension an entry d names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its axes out of "
                             f"the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


class _PinGrad(torch.autograd.Function):
    """Identity forward; the gradient leaves as ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def partial_grads(rows_pl, weight_pl) -> tuple:
    """The placements of the gradient of a weight (placed ``weight_pl``)
    used inside a local region on rows placed ``rows_pl``: ``Partial``
    where the rows are split and the weight whole, the weight's own
    placement elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if r.is_shard() and w.is_replicate() else w
                 for r, w in zip(rows_pl, weight_pl))


def pin_grad(x):
    """``x`` (a DTensor), whose gradient is placed as ``x`` is before it
    flows on: the backward of a view that merged a dimension DTensor
    cannot split back unevenly (24 heads over a 16-way shard) then meets
    the placement its forward had.  Anything else unchanged."""
    if not is_dtensor(x):
        return x
    return _PinGrad.apply(x, tuple(x.placements))


def settle(x):
    """A DTensor with ``Partial`` placements (a rank's partial sum) reduced
    to ``Replicate`` there; its gradient arrives replicated, the one
    placement a partial sum's gradient may take back.  Anything else
    unchanged."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return _PinGrad.apply(x.redistribute(x.device_mesh, pl), pl)


def splittable(x, dim: int, lead: int):
    """``x`` ready to have dimension ``dim`` split into (``lead``, rest)
    by a view: DTensor refuses a view that splits a sharded dimension
    unevenly (n_kv = 8 heads of a 16-way 'model' shard), where the
    reference's compiler reshards.  So the mesh dimensions that shard
    ``dim`` beyond what ``lead`` divides (the last ones, in mesh order) are
    gathered.  A plain tensor, or a DTensor that splits evenly, is
    returned as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return x
    dim = dim % x.ndim
    pl = list(x.placements)
    size = 1
    changed = False
    for i, p in enumerate(pl):
        if p == Shard(dim):
            n = x.device_mesh.size(i)
            if lead % (size * n) == 0:
                size *= n
            else:
                pl[i] = Replicate()
                changed = True
    return x.redistribute(x.device_mesh, pl) if changed else x


def even_shards(x):
    """``x`` (a DTensor) with every dimension that its placements split
    unevenly gathered there (its ``Shard`` placements of that dimension
    made ``Replicate``), as ``_sanitize`` keeps a spec from making one:
    a ``local_map`` region rebuilds each output's global shape as its
    local shape times the mesh size, so an uneven shard (1500 frames over
    16 ranks: 94 a rank) would come back 1504 long.  Anything else
    unchanged."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    pl = list(x.placements)
    for d in {p.dim for p in pl if p.is_shard()}:
        idx = [i for i, p in enumerate(pl) if p.is_shard(d)]
        if x.shape[d] % math.prod(mesh.size(i) for i in idx):
            for i in idx:
                pl[i] = Replicate()
    if pl == list(x.placements):
        return x
    return x.redistribute(mesh, pl)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full_tensor(x):
    """The whole tensor of a DTensor (gathered on every rank); any other
    value unchanged."""
    return x.full_tensor() if is_dtensor(x) else x


def local_tensor(x):
    """A DTensor's local shard; any other value unchanged."""
    return x.to_local() if is_dtensor(x) else x


def shard_offset(placements, dim: int, mesh, size: int) -> int:
    """The global index of this rank's first entry along tensor dimension
    ``dim`` (``size`` entries in all) under ``placements``: the mesh
    dimensions that shard ``dim`` split it in mesh order, the first the
    most significant (data-major, the reference's row order), as DTensor
    does.  0 where nothing shards ``dim``."""
    from torch.distributed.tensor import Shard
    chunk, n = 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            chunk = chunk * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return chunk * (size // n)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: object = None            # DeviceMesh | AbstractMesh | None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq_shard: bool = False       # sequence parallelism on the residual stream
    cp_layout: bool = False       # context-parallel prefill: activations
    # sequence-sharded over 'model' end to end; flash q blocks stay local
    # against gathered K/V
    serve_layout: bool = False    # DP-heavy inference layout: layer weights
    # FSDP-sharded over (data x model), activations replicated over
    # 'model', KV cache sequence-sharded

    # ------------------------------------------------------------- helpers
    @property
    def places(self) -> bool:
        """Whether the policy places tensors: its mesh is a DeviceMesh
        (an AbstractMesh, or none, gives specs only)."""
        from torch.distributed.device_mesh import DeviceMesh
        return isinstance(self.mesh, DeviceMesh)

    @property
    def axes(self) -> dict:
        return mesh_axes(self.mesh)

    @property
    def tp_size(self) -> int:
        return self.axes.get(self.tp_axis, 1)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.axes.get(a, 1)
        return n

    def _device_mesh(self):
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"placing a tensor needs a DeviceMesh, not "
                            f"{type(self.mesh).__name__}")
        return self.mesh

    def as_dtensor(self, x):
        """``x`` as a DTensor on the policy's mesh: a plain tensor is taken
        as replicated (every rank holds the whole of it)."""
        from torch.distributed.tensor import DTensor, Replicate
        if isinstance(x, DTensor):
            return x
        mesh = self._device_mesh()
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    def placements(self, spec: PartitionSpec, shape) -> tuple:
        """The placements of ``spec`` sanitized against ``shape``."""
        return placements_of(self._sanitize(spec, shape), self.mesh)

    def _constrain(self, x, spec: PartitionSpec):
        if not self.places:
            return x
        x = self.as_dtensor(x)
        want = self.placements(spec, x.shape)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    def run_local(self, fn, args, in_specs, out_specs, grad_partial=()):
        """``fn(*args)`` on each rank's local tensors (the port's
        ``shard_map``).  ``in_specs``: a spec or a tuple of placements per
        argument (``None`` for a non-tensor); ``out_specs``: a spec or a
        tuple of placements per output (one value if ``fn`` returns one
        tensor).  ``grad_partial``:
        the indices of arguments (weights, whole on every rank) whose
        gradient each rank computes from its own rows only: a partial sum
        over the mesh dimensions that shard the first argument.  Without a
        mesh, ``fn(*args)``."""
        if not self.places:
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map
        mesh = self._device_mesh()
        in_pl, moved = [], []
        for a, s in zip(args, in_specs):
            if s is None:
                in_pl.append(None)
                moved.append(a)
                continue
            if isinstance(s, PartitionSpec):
                a = self._constrain(a, s)
            else:
                a = self.as_dtensor(a)
                if tuple(a.placements) != tuple(s):
                    a = a.redistribute(mesh, s)
            in_pl.append(tuple(a.placements))
            moved.append(a)

        def out_pl(s):
            return tuple(s) if not isinstance(s, PartitionSpec) \
                else placements_of(s, mesh)

        outs = ((out_pl(out_specs),) if not isinstance(out_specs, list)
                else tuple(out_pl(s) for s in out_specs))
        grad_pl = list(in_pl)
        for i in grad_partial:
            grad_pl[i] = partial_grads(moved[0].placements, in_pl[i])
        out = local_map(fn, out_placements=outs, in_placements=tuple(in_pl),
                        in_grad_placements=tuple(grad_pl),
                        device_mesh=mesh)(*moved)
        if isinstance(out_specs, list):
            return tuple(settle(o) for o in out)
        return settle(out)

    def run_summed(self, fn, x, dim: int, others=(), others_pl=None,
                   out_pl=None):
        """``fn(start, x_local, *others_local)`` on each rank, where ``x``
        (a DTensor) may shard dimension ``dim``: ``start`` is the global
        index of the rank's first entry there (``shard_offset``), and the
        ranks' results are a partial sum over the mesh dimensions that
        shard ``dim``, reduced.  ``others`` are placed as ``x`` with
        ``dim``'s shards replicated (or by ``others_pl``); the output as
        ``x`` with ``dim``'s shards ``Partial`` (or by ``out_pl``)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        pl = tuple(x.placements)
        split = Shard(dim % x.ndim)
        if others_pl is None:
            others_pl = tuple(Replicate() if p == split else p for p in pl)
        if out_pl is None:
            out_pl = tuple(Partial() if p == split else p for p in pl)
        start = shard_offset(pl, split.dim, x.device_mesh,
                             x.shape[split.dim])
        return self.run_local(lambda xl, *rest: fn(start, xl, *rest),
                              (x, *others), (pl, *[others_pl] * len(others)),
                              out_pl)

    def run_rows(self, fn, params, x, state, state_type):
        """``fn(params, x, state) -> (out, new state)`` of a recurrent
        mixer (the SSD or RG-LRU scan), run on each rank's batch rows
        (``run_local``) with the mixer's parameters gathered whole: DTensor
        has no rules for the scans' loops.  ``state`` (or None) and the new
        state are ``state_type`` NamedTuples of batch-first tensors."""
        act = self._sanitize(P(self.dp_axes, None, None), x.shape)
        rows = P(act[0])
        leaves = _tree.leaves(params)
        n = len(leaves)
        st = [] if state is None else list(state)

        def local(xl, *rest):
            p = _tree.unflatten(params, list(rest[:n]))
            s0 = None if state is None else state_type(*rest[n:])
            out, new = fn(p, xl, s0)
            return (out, *new)

        res = self.run_local(
            local, (x, *leaves, *st),
            (act, *([P()] * n), *([rows] * len(st))),
            [act] + [rows] * len(state_type._fields),
            grad_partial=range(1, n + 1))
        return res[0], state_type(*res[1:])

    def kv_repeat(self, n_kv: int, n_heads: int) -> int:
        """Repeat factor R/n_kv for the stored KV heads (repeat-to-TP)."""
        if self.serve_layout:
            return 1              # cache shards on sequence, not heads
        tp = self.tp_size
        if (n_kv < tp <= n_heads and n_heads % tp == 0 and tp % n_kv == 0):
            return tp // n_kv
        return 1

    def _heads_spec(self, n_heads: int, head_dim: int) -> PartitionSpec:
        """Attention ACTIVATIONS (B,S,N,H): shard heads if they divide, else
        replicate (sharding head_dim would split RoPE's rotation pairs)."""
        dp = self.dp_axes
        tp = self.tp_size
        if not self.serve_layout and tp > 1 and n_heads % tp == 0:
            return P(dp, None, self.tp_axis, None)
        return P(dp, None, None, None)

    def _cache_spec(self, n_heads: int, head_dim: int) -> PartitionSpec:
        """KV-cache STORAGE: persistent and large, so fall back to sharding
        head_dim when the (repeated) kv-head count does not divide TP."""
        dp = self.dp_axes
        tp = self.tp_size
        if tp > 1 and n_heads % tp == 0:
            return P(dp, None, self.tp_axis, None)
        if tp > 1 and head_dim % tp == 0:
            return P(dp, None, None, self.tp_axis)
        return P(dp, None, None, None)

    # ------------------------------------------------------------ act hooks
    def shard_activations(self, x):
        """Residual stream (B, S, D): batch over DP axes; with seq_shard the
        sequence dim also shards over the TP axis (Megatron-style SP)."""
        if (self.seq_shard and self.tp_size > 1 and x.ndim == 3
                and x.shape[1] % self.tp_size == 0 and x.shape[1] > 1):
            return self._constrain(x, P(self.dp_axes, self.tp_axis, None))
        return self._constrain(x, P(self.dp_axes, None, None))

    def sp_gather(self, x):
        """Megatron-SP all-gather point: norm outputs enter the matmuls with
        the FULL sequence (replicated over TP)."""
        if self.seq_shard and self.tp_size > 1 and x.ndim == 3:
            return self._constrain(x, P(self.dp_axes, None, None))
        return x

    def sp_scatter(self, y):
        """Megatron-SP reduce-scatter point: block outputs return to the
        seq-sharded layout."""
        if (self.seq_shard and self.tp_size > 1 and y.ndim == 3
                and y.shape[1] % self.tp_size == 0 and y.shape[1] > 1):
            return self._constrain(y, P(self.dp_axes, self.tp_axis, None))
        return y

    def shard_logits(self, x):
        """(B, S, V): vocab over the TP axis."""
        if self.tp_size > 1 and x.shape[-1] % self.tp_size == 0:
            return self._constrain(x, P(self.dp_axes, None, self.tp_axis))
        return self._constrain(x, P(self.dp_axes, None, None))

    def shard_heads(self, x):
        """(B, S, N, H) attention activations."""
        return self._constrain(x, self._heads_spec(x.shape[2], x.shape[3]))

    def shard_cache(self, x):
        return self._constrain(x, self._cache_spec(x.shape[2], x.shape[3]))

    def shard_scores(self, x):
        """Attention scores (B, R, G, S_q, S_k) float32: batch on DP and
        the kv-head axis (leading head factor, blocked grouping) on TP."""
        tp = self.tp_size
        r = x.shape[1]
        if tp > 1 and r % tp == 0:
            return self._constrain(x, P(self.dp_axes, self.tp_axis, None,
                                        None, None))
        return self._constrain(x, P(self.dp_axes, None, None, None, None))

    def batch_spec(self, ndim: int = 2) -> PartitionSpec:
        return P(self.dp_axes, *([None] * (ndim - 1)))

    def replicated(self) -> PartitionSpec:
        return P()

    def _sanitize(self, spec: PartitionSpec, shape) -> PartitionSpec:
        axes_of = self.axes
        out = []
        for i, entry in enumerate(tuple(spec)):
            if entry is None or i >= len(shape):
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            axes = tuple(a for a in axes if a in axes_of)
            size = 1
            for a in axes:
                size *= axes_of[a]
            # a dimension of size 1 is never sharded, not even one way on
            # a mesh axis of size 1: DTensor refuses a view that drops it
            # (a batch of one on a (1, tp) mesh)
            ok = axes and shape[i] > 1 and shape[i] % size == 0
            out.append((axes if len(axes) > 1 else axes[0]) if ok else None)
        return P(*out)

    def run_sharded_flash(self, q, k, v, *, causal: bool = True,
                          window: int = 0):
        """Flash attention with each rank running K6 on its local (batch,
        head) shard.  Forward only (prefill / serving)."""
        from repro_torch.kernels.flash_attention import flash_attention
        if self.cp_layout and self.places:
            return self._run_cp_flash(q, k, v, causal=causal, window=window)
        if not self.places:
            return flash_attention(q, k, v, causal=causal, window=window)
        qspec = self._sanitize(self._heads_spec(q.shape[2], q.shape[3]),
                               q.shape)
        kspec = self._sanitize(self._heads_spec(k.shape[2], k.shape[3]),
                               k.shape)
        # heads must shard consistently: if q shards on heads but k cannot
        # (r < tp), fall back to replicated heads for both
        if qspec[2] != kspec[2]:
            qspec = self._sanitize(P(self.dp_axes, None, None, None),
                                   q.shape)
            kspec = self._sanitize(P(self.dp_axes, None, None, None),
                                   k.shape)
        return self.run_local(
            lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                            window=window),
            (q, k, v), (qspec, kspec, kspec), qspec)

    def _run_cp_flash(self, q, k, v, *, causal: bool, window: int):
        """Context-parallel flash: q stays SEQUENCE-sharded over the TP
        axis (each rank owns a contiguous block of queries and passes its
        global origin to K6's causal mask); K/V are replicated."""
        from repro_torch.kernels.flash_attention import flash_attention
        dp, tp = self.dp_axes, self.tp_axis
        qspec = self._sanitize(P(dp, tp, None, None), q.shape)
        kspec = self._sanitize(P(dp, None, None, None), k.shape)
        mesh = self._device_mesh()
        off = shard_offset(placements_of(qspec, mesh), 1, mesh, q.shape[1])

        def inner(a, b_, c):
            return flash_attention(a, b_, c, causal=causal, window=window,
                                   q_offset=off)

        return self.run_local(inner, (q, k, v), (qspec, kspec, kspec), qspec)

    # ----------------------------------------------------- param spec tools
    def serve_param_specs(self, specs_tree, keep_data: bool = False):
        """Per-layer weight specs for the DP-heavy serve layout: 'model' is
        removed and 'data' becomes ('data', 'model') (every layer weight
        FSDP-sharded across all ranks), or stays 'data' with
        ``keep_data``.  The caller passes only the layer subtrees."""
        def tx(spec):
            if not isinstance(spec, PartitionSpec):
                return spec
            out = []
            for entry in tuple(spec):
                if entry is None:
                    out.append(None)
                elif entry == "data" or entry == ("data",):
                    out.append("data" if keep_data else ("data", "model"))
                elif entry == "model":
                    out.append(None)
                else:
                    out.append(entry)   # a tuple: already combined
            return P(*out)

        return _tree.map(tx, specs_tree)

    def layout_param_specs(self, specs):
        """A model's ``param_specs()`` tree as the serve layouts place it:
        its layer subtrees (``prefix``, ``body``, ``enc``, ``dec``) through
        ``serve_param_specs``, 'data' kept under ``cp_layout``, as the
        reference's dry run transforms them; ``specs`` unchanged without
        ``serve_layout``."""
        if not self.serve_layout:
            return specs
        return {k: self.serve_param_specs(v, keep_data=self.cp_layout)
                if k in ("prefix", "body", "enc", "dec") else v
                for k, v in specs.items()}

    def param_sharding(self, specs_tree, params=None):
        """Without ``params``: the tree of DTensor placements of
        ``specs_tree`` (None without a mesh).  With ``params`` (a tree of
        whole tensors of the specs' structure, the same on every rank):
        the tree of DTensors placed by the specs, each rank keeping its
        own shard (a compact copy, never a view of the whole)."""
        if self.mesh is None:
            return params
        if params is None:
            return _tree.map(lambda s: placements_of(s, self.mesh),
                             specs_tree)
        return _tree.map(lambda s, p: self.distribute(p, s), specs_tree,
                         params)

    def zeros(self, shape, dtype, spec: PartitionSpec, device):
        """A DTensor of zeros of global ``shape`` placed by ``spec``
        (sanitized), each rank making only its own shard on ``device``."""
        from torch.distributed.tensor import DTensor
        mesh = self._device_mesh()
        pl = self.placements(spec, shape)
        local = list(shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(i)
        z = torch.zeros(local, dtype=dtype, device=device)
        stride = torch.empty(shape, dtype=dtype, device="meta").stride()
        return DTensor.from_local(z, mesh, pl, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def distribute(self, t: torch.Tensor, spec: PartitionSpec):
        """``t`` (whole, the same on every rank) as a DTensor placed by
        ``spec`` (sanitized against its shape), split locally."""
        from torch.distributed.tensor import DTensor
        mesh = self._device_mesh()
        pl = self.placements(spec, t.shape)
        local = t
        for d in sorted({p.dim for p in pl if p.is_shard()}):
            n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                          if p.is_shard(d))
            local = local.narrow(d, shard_offset(pl, d, mesh, t.shape[d]),
                                 t.shape[d] // n)
        if not local.is_contiguous():
            local = local.contiguous()
        elif local.untyped_storage().nbytes() > \
                local.numel() * local.element_size():
            local = local.clone()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())


# ---------------------------------------------------------------------------
# decode-state specs
# ---------------------------------------------------------------------------

def _state_leaf_spec(path_str: str, leaf, policy: ShardingPolicy
                     ) -> PartitionSpec:
    dp = policy.dp_axes
    body = "body" in path_str
    nd = leaf.dim() - (1 if body else 0)   # strip stacked-layer axis
    lead = (None,) if body else ()
    if nd == 4:                            # KV cache (B, S, R, H)
        s, r, h = leaf.shape[-3], leaf.shape[-2], leaf.shape[-1]
        tp = policy.tp_size
        if policy.serve_layout and tp > 1 and s % tp == 0:
            # DP-heavy serve layout: cache shards on SEQUENCE
            return P(*lead, dp, policy.tp_axis, None, None)
        if tp > 1 and r % tp == 0:
            return P(*lead, dp, None, policy.tp_axis, None)
        if tp > 1 and h % tp == 0:
            return P(*lead, dp, None, None, policy.tp_axis)
        return P(*lead, dp, None, None, None)
    if nd == 0:
        return P()
    return P(*lead, dp, *([None] * (nd - 1)))


def decode_state_specs(state, policy: ShardingPolicy):
    """The spec of every leaf of a decode state (paths as the reference's
    ``keystr``: a stacked ``body`` leaf leads with ``None``).  The
    reference keeps it in ``launch/steps.py``, which re-exports it here:
    the models place their decode state by it."""
    specs = [_state_leaf_spec(path, leaf, policy)
             for path, leaf in _tree.leaves_with_path(state)]
    return _tree.unflatten(state, specs)



NO_SHARDING = ShardingPolicy(mesh=None, dp_axes=())
