"""Mamba-2 mixer via SSD (state-space duality), chunked-scan formulation.

The port of the JAX package's ``models/ssm.py`` (Dao & Gu, arXiv:2405.21060):
the sequence is split into chunks of length Q; within a chunk the output is
the "attention-like" dual form (quadratic in Q only), and a (H, P, N)
recurrent state passes *between* chunks with a linear scan — O(S·Q) work
and S/Q sequential steps.  Prefill runs the chunked path; decode is the
O(1) recurrent update on a persistent float32 state.

The reference's three-operand einsums are pairwise products here, in an
order whose largest intermediate is the (B, nc, Q, Q, H) decay-weighted
score tensor: a (B, nc, Q, Q, H, P) product never exists (34 GB at
mamba2-1.3b's width for one (8, 1024) prefill).  The inter-chunk scan is a
loop over the chunks that emits the state before each one.

Scalar-A parameterisation (one decay per head), conv1d front, gated RMSNorm
and D skip as in the reference; ``a_log``, ``d_skip`` and ``dt_bias`` stay
float32 in every model dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers
from repro_torch.sharding.partitioning import P


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    conv_width: int
    chunk: int

    @staticmethod
    def from_config(d_model: int, cfg: SSMConfig) -> "SSMDims":
        d_inner = cfg.expand * d_model
        return SSMDims(d_model=d_model, d_inner=d_inner,
                       n_heads=d_inner // cfg.head_dim,
                       head_dim=cfg.head_dim, d_state=cfg.d_state,
                       conv_width=cfg.conv_width, chunk=cfg.chunk)


class SSMState(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) float32
    conv: torch.Tensor       # (B, conv_width - 1, conv_channels)


def init(gen: torch.Generator, dims: SSMDims, dtype, lead=()):
    d, di, h, n = dims.d_model, dims.d_inner, dims.n_heads, dims.d_state
    conv_ch = di + 2 * n
    dev = gen.device
    u = torch.empty((*lead, h), dtype=torch.float32, device=dev)
    u.uniform_(0.0, 1.0, generator=gen)
    lo, hi = math.log(0.001), math.log(0.1)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    return {
        # fused input projection: [z, xBC, dt]
        "in_proj": layers.dense_init(gen, d, di + conv_ch + h, dtype,
                                     lead=lead),
        "conv_w": layers.dense_init(gen, dims.conv_width, conv_ch, dtype,
                                    lead=lead),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "a_log": a_log.expand(*lead, h).clone(),
        "d_skip": torch.ones((*lead, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))),
        "norm": layers.rmsnorm_init(di, dtype, dev, lead),
        "out_proj": layers.dense_init(gen, di, d, dtype, lead=lead),
    }


def specs():
    """The reference's specs of ``init``'s tree."""
    return {"in_proj": P("data", "model"), "conv_w": P(None, "model"),
            "conv_b": P("model"),
            "a_log": P(None), "d_skip": P(None), "dt_bias": P(None),
            "norm": {"scale": P(None)}, "out_proj": P("model", "data")}


def _split(params, x, dims: SSMDims):
    di, n = dims.d_inner, dims.d_state
    conv_ch = di + 2 * n
    zxbcdt = x @ params["in_proj"]
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_ch],
            zxbcdt[..., di + conv_ch:])


def _ssd_chunked(xh, dt, bmat, cmat, a, dims: SSMDims, init_state=None):
    """Chunked SSD. xh: (B,S,H,P); dt: (B,S,H) float32; bmat/cmat: (B,S,N);
    a: (H,) negative decay rates. Returns (y (B,S,H,P) float32, final
    state (B,H,P,N))."""
    b, s_orig, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(dims.chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        # zero-pad to a chunk multiple: padded steps carry dt = 0, so they
        # neither update the state nor reach a real output
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q

    xq = xh.reshape(b, nc, q, h, p).float()
    dtq = dt.reshape(b, nc, q, h)
    bq = bmat.reshape(b, nc, q, n).float()
    cq = cmat.reshape(b, nc, q, n).float()

    da = dtq * a                                            # (B,nc,Q,H) <= 0
    cum = torch.cumsum(da, dim=2)                           # within-chunk
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=xh.device).tril()[None, None, :, :, None]
    # -inf above the diagonal before the exp: there seg > 0 can overflow
    # to inf, and the backward of a where over inf is 0 * inf = NaN
    seg.masked_fill_(~causal, float("-inf"))
    l_mat = torch.where(causal, seg.exp_(), 0.0)
    del seg

    # intra-chunk (dual / attention-like form): the decay-weighted scores
    # (B,nc,Q,Q,H), then one product over j per (chunk, head)
    scores = torch.einsum("bcin,bcjn->bcij", cq, bq)        # (B,nc,Q,Q)
    wdt = l_mat.mul_(dtq[:, :, None, :, :])                 # decay * dt_j
    wdt.mul_(scores[..., None])
    y = torch.einsum("bcijh,bcjhp->bcihp", wdt, xq)
    del wdt, l_mat, scores

    # per-chunk contribution to the recurrent state
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    xw = xq * (decay_to_end * dtq)[..., None]               # (B,nc,Q,H,P)
    chunk_states = torch.einsum("bcjhp,bcjn->bchpn", xw, bq)
    del xw

    # inter-chunk scan over nc: the state before each chunk
    chunk_decay = torch.exp(da.sum(dim=2))                  # (B,nc,H)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xh.device) if init_state is None
             else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk (state -> outputs)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cq, prev_states)
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(b, s, h, p)[:, :s_orig], carry


def apply(params, x, dims: SSMDims, init_state: SSMState = None,
          policy=None) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence mixer. x: (B,S,D) -> (out, final state).  With a
    policy on a mesh the whole mixer runs on each rank's batch rows
    (``policy.run_rows``)."""
    if policy is not None and policy.places:
        return policy.run_rows(lambda p, xl, st: apply(p, xl, dims, st),
                               params, x, init_state, SSMState)
    bsz, s, _ = x.shape
    h, p, n = dims.n_heads, dims.head_dim, dims.d_state
    z, xbc, dt = _split(params, x, dims)
    xbc, conv_tail = layers.conv1d(
        params, xbc, dims.conv_width,
        None if init_state is None else init_state.conv)
    xbc = F.silu(xbc)
    xh = xbc[..., :dims.d_inner].reshape(bsz, s, h, p)
    bmat = xbc[..., dims.d_inner:dims.d_inner + n]
    cmat = xbc[..., dims.d_inner + n:]
    dt = layers.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, final = _ssd_chunked(
        xh, dt, bmat, cmat, a, dims,
        None if init_state is None else init_state.state)
    y = y + params["d_skip"][:, None] * xh.float()
    y = y.reshape(bsz, s, dims.d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = layers.rmsnorm(params["norm"], y)
    return y @ params["out_proj"], SSMState(state=final, conv=conv_tail)


def init_state(dims: SSMDims, batch: int, dtype, device) -> SSMState:
    conv_ch = dims.d_inner + 2 * dims.d_state
    return SSMState(
        state=torch.zeros((batch, dims.n_heads, dims.head_dim,
                           dims.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, dims.conv_width - 1, conv_ch), dtype=dtype,
                         device=device))


def decode_step(params, x, dims: SSMDims, st: SSMState
                ) -> Tuple[torch.Tensor, SSMState]:
    """Single-token recurrent update. x: (B,1,D) -> (out, new state)."""
    bsz = x.shape[0]
    h, p, n = dims.n_heads, dims.head_dim, dims.d_state
    z, xbc, dt = _split(params, x, dims)
    xbc, conv_tail = layers.conv1d(params, xbc, dims.conv_width, st.conv)
    xbc = F.silu(xbc)
    xh = xbc[..., :dims.d_inner].reshape(bsz, h, p).float()
    bmat = xbc[..., dims.d_inner:dims.d_inner + n].reshape(bsz, n).float()
    cmat = xbc[..., dims.d_inner + n:].reshape(bsz, n).float()
    dt = layers.softplus(dt.float() + params["dt_bias"])[:, 0]   # (B,H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)                             # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :]
    new_state = st.state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat, new_state)
    y = y + params["d_skip"][:, None] * xh
    y = y.reshape(bsz, 1, dims.d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = layers.rmsnorm(params["norm"], y)
    return y @ params["out_proj"], SSMState(state=new_state, conv=conv_tail)
