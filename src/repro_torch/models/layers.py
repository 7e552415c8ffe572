"""Shared neural building blocks, as plain functions on tensors.

The port of the JAX package's ``models/layers.py``.  Parameters are nested
dicts of tensors in the JAX package's layout — a matmul weight is
``(d_in, d_out)`` and applied as ``x @ w`` — so a JAX parameter tree
carries over leaf for leaf (``repro_torch.convert.params_from_jax``).  Every
``*_init`` takes an explicit ``torch.Generator`` and makes its tensors on
that generator's device.  The partition specs the reference's ``*_init``
returns beside its parameters come from the matching ``*_specs`` here
(``sharding.partitioning.PartitionSpec`` leaves): 2-D "FSDP x TP", matmul
weights sharded on both mesh axes ('data' on the input dim, 'model' on the
output dim, or transposed for down-projections), vectors replicated.

Numerics follow the reference: norms compute in float32 and cast back, the
norm scale is ``1 + scale``, ``rope_freqs`` is ``1 / theta ** (arange(half)
/ half)`` in float32, logits are cast to float32 after the product and
padded vocabulary slots are set to -1e30.  ``apply_mrope`` is Qwen2-VL's
multimodal rotary embedding, a position stream a section of the spectrum.
On DTensors (a policy with a mesh) the embedding gather and the
cross-entropy's true logit run on each rank's shard of the table or the
logits (``policy.run_summed``): a vocab-sharded one contributes a partial
sum, so neither the table nor the (B, S, V) logits are gathered.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.partitioning import (P, is_dtensor, partial_grads,
                                               settle)


# elements a float32 draw covers at once: a larger leaf (a stacked expert
# weight of a full-size MoE, 8.7 G elements) is drawn a slice at a time, so
# its float32 temporary never holds more than 4 GiB; smaller leaves are
# drawn whole, as they always were
_DRAW_CHUNK = 1 << 30


def truncnorm_init(gen: torch.Generator, shape, std: float,
                   dtype: torch.dtype) -> torch.Tensor:
    """A normal of ``std`` truncated to two standard deviations (the
    reference's ``truncated_normal(-2, 2)``), drawn in float32 on the
    generator's device by the inverse CDF and cast to ``dtype``; leaves of
    more than 2^30 elements are drawn in slices of that many (the same
    distribution, element by element)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))

    def draw(n: int) -> torch.Tensor:
        u = torch.empty((n,), dtype=torch.float32, device=gen.device)
        u.uniform_(lo, 1.0 - lo, generator=gen)
        x = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
        return x.clamp_(-2.0, 2.0).mul_(std)

    n = math.prod(shape)
    if n <= _DRAW_CHUNK:
        return draw(n).to(dtype).reshape(shape)
    out = torch.empty((n,), dtype=dtype, device=gen.device)
    for i in range(0, n, _DRAW_CHUNK):
        m = min(_DRAW_CHUNK, n - i)
        out[i:i + m] = draw(m)
    return out.reshape(shape)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, std: Optional[float] = None,
               lead=()) -> torch.Tensor:
    """A ``(*lead, d_in, d_out)`` weight; ``lead`` stacks layers."""
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    return truncnorm_init(gen, (*lead, d_in, d_out), std, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(norm_type: str):
    """The reference's specs of a norm: replicated vectors."""
    if norm_type == "rmsnorm":
        return {"scale": P(None)}
    return {"scale": P(None), "bias": P(None)}


def rmsnorm_init(d: int, dtype, device, lead=()):
    return {"scale": torch.zeros((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    nx = x32 * torch.rsqrt(var + eps)
    return (nx * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype, device, lead=()):
    return {"scale": torch.zeros((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)    # jnp.var: ddof=0
    nx = (x32 - mu) * torch.rsqrt(var + eps)
    out = nx * (1.0 + params["scale"].float()) + params["bias"].float()
    return out.to(x.dtype)


def make_norm(norm_type: str, d: int, dtype, device, lead=()):
    """(params, apply) of the configured norm."""
    if norm_type == "rmsnorm":
        return rmsnorm_init(d, dtype, device, lead), rmsnorm
    return layernorm_init(d, dtype, device, lead), layernorm


def norm_fn(norm_type: str):
    return rmsnorm if norm_type == "rmsnorm" else layernorm


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, N, H); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # (half,)
    ang = positions[..., None].float() * freqs                 # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL §3): the rotary spectrum is split into
    (temporal, height, width) sections, each rotated by its own position
    id.  x: (B, S, N, H); positions: (3, B, S) int (text: t = h = w)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"half the head dim {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # (half,)
    # position stream i drives frequency band i; the bounds are Python ints,
    # so nothing here waits on the card
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    ang = torch.cat([positions[i, ..., None].float() * freqs[lo:hi]
                     for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))],
                    dim=-1)                                    # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# the recurrent mixers' pieces (ssm, rglru)
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` with no linear cut-off (``jax.nn.softplus``;
    torch's ``F.softplus`` returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def conv1d(params, x, conv_width: int, conv_state=None):
    """Causal depthwise conv1d over (B, S, C) plus its bias; returns (out,
    the last ``conv_width - 1`` inputs: the next call's ``conv_state``)."""
    w = params["conv_w"].to(x.dtype)                       # (W, C)
    pad = conv_width - 1
    if conv_state is None:
        padded = F.pad(x, (0, 0, pad, 0))
    else:
        padded = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = padded[:, 0:s, :] * w[0]
    for i in range(1, conv_width):
        out = out + padded[:, i:i + s, :] * w[i]
    return out + params["conv_b"].to(x.dtype), padded[:, -pad:, :]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

_ACTS = {
    "swiglu": F.silu,
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_init(gen: torch.Generator, d: int, f: int, mlp_type: str, dtype,
             lead=()):
    params = {"wi": dense_init(gen, d, f, dtype, lead=lead)}
    if mlp_type in ("swiglu", "geglu"):
        params["wg"] = dense_init(gen, d, f, dtype, lead=lead)
    params["wo"] = dense_init(gen, f, d, dtype, lead=lead)
    return params


def mlp_specs(mlp_type: str):
    specs = {"wi": P("data", "model")}
    if mlp_type in ("swiglu", "geglu"):
        specs["wg"] = P("data", "model")
    specs["wo"] = P("model", "data")
    return specs


def matmul(x, w, local: bool = False):
    """``x @ w``.  A DTensor ``x`` with more than one sharded leading
    dimension (a batch- and sequence-sharded activation: the context-
    parallel layout, sequence-parallel blocks), or any DTensor ``x`` with
    ``local``, runs on each rank's block (``local_map``): DTensor's matmul
    flattens the leading dimensions and cannot place two sharded ones
    flattened, nor, in the backward, such a flattened gradient.  On each
    mesh dimension: rows of ``x`` split there keep ``w`` whole there; a
    contraction split there takes ``w``'s matching rows and leaves a
    partial sum, reduced at once; an ``x`` whole there keeps ``w``'s
    column shard (the output's columns split alike) or gathers it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not is_dtensor(x):
        return x @ w
    last = x.ndim - 1
    lead = [p for p in x.placements
            if isinstance(p, Shard) and p.dim < last]
    if not local and len({p.dim for p in lead}) < 2:
        return x @ w
    from torch.distributed.tensor.experimental import local_map
    x = settle(x)                            # a partial sum, reduced
    w_pl, out_pl, x_grad = [], [], []
    for p, q in zip(x.placements, w.placements):
        if p == Shard(last):
            w_pl.append(Shard(0))
            out_pl.append(Partial())
            x_grad.append(p)
        elif isinstance(p, Shard):
            w_pl.append(Replicate())
            out_pl.append(p)
            x_grad.append(p)
        elif q == Shard(1):
            # each rank's columns: its share of x's gradient
            w_pl.append(q)
            out_pl.append(Shard(last))
            x_grad.append(Partial())
        else:
            w_pl.append(Replicate())
            out_pl.append(Replicate())
            x_grad.append(p)
    w = w.redistribute(w.device_mesh, w_pl)
    w_grad = partial_grads(x.placements, w_pl)
    return settle(local_map(lambda a, b: a @ b, out_placements=(tuple(out_pl),),
                            in_placements=(tuple(x.placements), tuple(w_pl)),
                            in_grad_placements=(tuple(x_grad), w_grad),
                            device_mesh=x.device_mesh)(x, w))


def mlp_apply(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    act = _ACTS[mlp_type]
    h = matmul(x, params["wi"])
    if "wg" in params:
        h = act(matmul(x, params["wg"])) * h
    else:
        h = act(h)
    return matmul(h, params["wo"])


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype):
    """Input embedding table (V, D)."""
    return {"embedding": truncnorm_init(gen, (vocab, d), 0.02, dtype)}


def embedding_specs(tied: bool = False):
    """Untied tables shard D over BOTH mesh axes (the token gather then
    partitions trivially); tied tables keep V on 'model' so the logits
    product stays vocab-sharded."""
    return {"embedding": P("model", "data") if tied
            else P(None, ("data", "model"))}


def _gather_rows(table, tokens: torch.Tensor, policy) -> torch.Tensor:
    """``table[tokens]`` of a DTensor table: each rank gathers from its
    shard with every token (the tokens are replicated); a vocab-sharded
    table's rank contributes its own rows and zeros for the rest, a
    ``Partial`` sum over the mesh dimensions that shard the vocabulary."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = tuple(table.placements)
    out_pl = tuple(Partial() if p == Shard(0) else
                   Shard(2) if p == Shard(1) else Replicate() for p in pl)

    def local(start, tab, tok):
        rows = tab.shape[0]
        idx = tok.long() - start
        hit = (idx >= 0) & (idx < rows)
        out = tab[idx.clamp(0, rows - 1)]
        return torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))

    return policy.run_summed(local, table, 0, (tokens,),
                             others_pl=(Replicate(),) * len(pl),
                             out_pl=out_pl)


def embed(params, tokens: torch.Tensor, scale: bool, d: int,
          policy=None) -> torch.Tensor:
    table = params["embedding"]
    if is_dtensor(table):
        x = _gather_rows(table, tokens, policy)
    else:
        x = table[tokens.long()]
    if scale:
        # the scale rounded to x's dtype, made on x's device (a fill, no
        # host copy: capturable in a CUDA graph)
        x = x * torch.full((), math.sqrt(d), dtype=x.dtype, device=x.device)
    return x


def unembed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return {"unembedding": truncnorm_init(gen, (d, vocab),
                                          1.0 / math.sqrt(d), dtype)}


def unembed_specs():
    return {"unembedding": P("data", "model")}


def _true_logit(logits, safe: torch.Tensor, policy) -> torch.Tensor:
    """``logits[..., safe]`` of DTensor logits: each rank reads the labels
    in its vocabulary shard, a ``Partial`` sum over the mesh dimensions
    that shard the vocabulary (the reference's one-hot contraction, which
    reduces over V locally + one all-reduce)."""
    def local(start, lg, lab):
        cols = lg.shape[-1]
        idx = lab - start
        hit = (idx >= 0) & (idx < cols)
        got = lg.gather(-1, idx.clamp(0, cols - 1)[..., None])[..., 0]
        return torch.where(hit, got, torch.zeros((), dtype=got.dtype,
                                                 device=got.device))

    return policy.run_summed(local, logits, -1, (safe,))


def batch_major(x):
    """A DTensor (B, ..., D) with its inner dimensions gathered (the
    sequence of a sequence-parallel residual): DTensor's matmul flattens
    the leading dimensions, and cannot place two sharded ones flattened.
    Only the batch (dimension 0) and the last dimension stay sharded."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
          else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _sum_exp(logits, m, policy):
    """``exp(logits - m).sum(-1)`` of DTensor logits, each rank over its
    vocabulary shard (a ``Partial`` sum, reduced): only (B, S) tensors
    cross the mesh, forward and backward."""
    return policy.run_summed(
        lambda _, lg, mm: torch.exp(lg - mm[..., None]).sum(dim=-1),
        logits, -1, (m,))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       policy=None) -> torch.Tensor:
    """Masked mean cross-entropy over (B, S, V) float32 logits; labels < 0
    are masked.  The reference's formulation: ``z = max + log(sum(exp(
    logits - max)))`` and the true logit taken by index (the reference's
    one-hot contraction gives the same value).  With a policy the logits
    are vocab-sharded (``shard_logits``) and never gathered."""
    if policy is not None:
        logits = policy.shard_logits(logits)
        labels = policy.as_dtensor(labels) if policy.places \
            else labels
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp(min=0).to(torch.int64)
    if is_dtensor(logits):
        # the max only steadies the exponentials: its gradient cancels (z's
        # is the softmax whatever m is), and DTensor's backward of a max
        # over a sharded vocabulary gathers the whole (B, S, V) gradient
        m = logits.detach().amax(dim=-1)
        z = m + torch.log(_sum_exp(logits, m, policy))
    else:
        m = logits.amax(dim=-1)
        z = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    if is_dtensor(logits):
        true_logit = _true_logit(logits, safe, policy)
    else:
        true_logit = logits.gather(-1, safe[..., None])[..., 0]
    ll = true_logit - z
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def logits_from_hidden(x: torch.Tensor, emb_params, unemb_params, tie: bool,
                       softcap: float = 0.0,
                       true_vocab: int = 0) -> torch.Tensor:
    if is_dtensor(x):
        # each rank's rows against its vocabulary columns
        x = batch_major(x)
        w = emb_params["embedding"].T if tie else \
            unemb_params["unembedding"]
        logits = matmul(x, w, local=True)
    elif tie:
        logits = x @ emb_params["embedding"].T          # (V_pad, D)
    else:
        logits = x @ unemb_params["unembedding"]
    logits = logits.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if true_vocab and true_vocab < logits.shape[-1]:
        if is_dtensor(logits):
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) >= true_vocab
            logits = torch.where(pad, -1e30, logits)
        else:
            logits[..., true_vocab:] = -1e30
    return logits
