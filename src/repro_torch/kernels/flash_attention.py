"""K6 — flash attention (forward): the CUDA kernel and its plain version.

The prefill's attention without the S x S scores in device memory: each
query block streams the key/value tiles up to its causal bound with the
online-softmax recurrence (running max ``m``, normaliser ``l`` and an
accumulator, all float32).  Rows layout, as the reference's ``flash_rows``:
q2 ``(RQ, S, H)``, k2/v2 ``(RK, T, H)`` with ``RQ = RK * G``; row r of q2
reads kv row ``r // G`` (blocked GQA, matching ``attention._attend``).

* :func:`flash_rows_plain` — the same recurrence in PyTorch ops, one
  ``(rows, S, k_block)`` score block at a time, so it never holds S x S.
* :func:`flash_rows` — on a CUDA tensor it launches K6
  (``csrc/flash_attention.cu``); on a CPU tensor it runs the plain version.
  Both go through one ``torch.library`` custom op,
  ``repro_torch::flash_rows``, whose fake implementation gives the output's
  shape and dtype only: under ``FakeTensorMode`` (the dry run) neither
  route runs, and a flop formula registered for the op counts the
  attention's products (4 H flops a query-key pair it sees).
* :func:`flash_attention` — the ``(B, S, N, H)`` wrapper of the reference,
  with its reshapes to and from rows.

Positions are absolute from ``q_offset`` (query i sits at ``i +
q_offset``), not aligned to the end of T.  Masking uses -1e30 as the
reference does, so a query that sees no key in the tiles it visits (only
possible with a window or an offset) averages the values of those tiles,
keys past T counting as zero vectors: the tiles are the query's
``q_block`` bound clipped to ``k_block`` multiples, the kernels' fixed
``Q_BLOCK`` and ``K_BLOCK`` (128 and 128; only the plain version takes other
block sizes).  Forward only: a tensor that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["Q_BLOCK", "K_BLOCK", "HEAD_DIMS", "NEG_INF", "flash_rows",
           "flash_rows_plain", "flash_attention"]

NEG_INF = -1e30
Q_BLOCK = 128         # csrc/flash_attention.cu kQBlock
K_BLOCK = 128         # csrc/flash_attention.cu kKBlock (a slot)
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _offset(q_offset) -> int:
    return 0 if q_offset is None else int(q_offset)


def _check(q2, k2, v2, what: str):
    for name, t in (("q", q2), ("k", k2), ("v", v2)):
        if t.requires_grad:
            raise RuntimeError(
                f"{what}: {name} requires grad; the kernel is forward-only "
                f"(the reference's too) and has no backward")
        if t.dim() != 3:
            raise ValueError(f"{what}: {name} must be (rows, len, H), got "
                             f"{tuple(t.shape)}")
    if k2.shape != v2.shape:
        raise ValueError(f"{what}: k {tuple(k2.shape)} and v "
                         f"{tuple(v2.shape)} differ")
    rq, _, h = q2.shape
    rk = k2.shape[0]
    if k2.shape[2] != h or rk == 0 or rq % rk:
        raise ValueError(f"{what}: q {tuple(q2.shape)} does not group over "
                         f"kv {tuple(k2.shape)}")
    if not (q2.dtype == k2.dtype == v2.dtype):
        raise TypeError(f"{what}: q/k/v dtypes differ: {q2.dtype}, "
                        f"{k2.dtype}, {v2.dtype}")
    return rq // rk


def flash_rows_plain(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
                     q_offset=None, *, causal: bool = True, window: int = 0,
                     q_block: int = Q_BLOCK,
                     k_block: int = K_BLOCK) -> torch.Tensor:
    """Plain version of the kernel: the reference's online-softmax
    recurrence over kv blocks of ``k_block`` keys (zero-padded past T), each
    query visiting the blocks below its ``q_block``'s causal bound."""
    g = _check(q2, k2, v2, "flash_rows_plain")
    rq, s, h = q2.shape
    rk, t, _ = k2.shape
    dev = q2.device
    off = _offset(q_offset)
    q = (q2.float() * (1.0 / math.sqrt(h))).view(rk, g, s, h)
    qpos = torch.arange(s, device=dev) + off
    if causal:
        q_start = torch.div(torch.arange(s, device=dev), q_block,
                            rounding_mode="floor") * q_block + off
        hi = torch.clamp(q_start + q_block, max=t)
    else:
        hi = torch.full((s,), t, device=dev)
    n_kv = torch.where(hi > 0, torch.div(hi + k_block - 1, k_block,
                                         rounding_mode="floor"), 0)
    m = torch.full((rk, g, s), NEG_INF, device=dev)
    l = torch.zeros((rk, g, s), device=dev)
    acc = torch.zeros((rk, g, s, h), device=dev)
    for c in range(int(n_kv.max()) if s else 0):
        kpos = c * k_block + torch.arange(k_block, device=dev)
        kc = torch.zeros((rk, k_block, h), device=dev)
        vc = torch.zeros((rk, k_block, h), device=dev)
        n = max(0, min(k_block, t - c * k_block))
        kc[:, :n] = k2[:, c * k_block:c * k_block + n].float()
        vc[:, :n] = v2[:, c * k_block:c * k_block + n].float()
        sc = torch.einsum("rgsh,rkh->rgsk", q, kc)
        mask = (kpos < t)[None, :].expand(s, k_block)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("rgsk,rkh->rgsh",
                                                       p, vc)
        live = c < n_kv                                  # (s,)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[:, None], acc_new, acc)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(rq, s, h).to(q2.dtype)


_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("flash_attention")
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.flash_attention_fwd.argtypes = [i, i, vp, vp, vp, vp, ll, i, i,
                                            i, i, i, i, f, vp]
        lib.flash_attention_fwd.restype = i
        _lib_handle = lib
    return _lib_handle


def flash_rows(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
               q_offset=None, *, causal: bool = True,
               window: int = 0) -> torch.Tensor:
    """q2: (RQ, S, H); k2/v2: (RK, T, H); RQ = RK * G -> (RQ, S, H) in q2's
    dtype.  ``q_offset``: the absolute position of q2's first query.  The
    kernel for CUDA tensors (float32, bfloat16 or float16, H in
    ``HEAD_DIMS``, contiguous; ``Q_BLOCK``-query blocks over the
    ``K_BLOCK``-key slots below their causal bound), the plain version for
    CPU tensors.  Which kernel serves which H (``csrc/flash_attention.cu``):

    * bf16 / fp16 at every H: warp-specialised, TMA into a ring of K/V
      tiles, ``wgmma`` products.  The ring fits the 227 KB of shared
      memory a CTA may have: 128-key tiles in 3 stages at H = 64 / 128
      (224 KB at 128); at 192 / 256 a 128-key stage alone is 96 / 128 KB
      beside a 48 / 64 KB Q tile, so 64-key tiles (two a slot) in 3 / 2
      stages, 192 KB each; at 16 / 32 a row of 32 / 64 bytes is one
      region in 32- / 64-byte swizzle, and two CTAs run on an SM, each
      with 64-key tiles in 4 stages, to hide the latency of each
      warpgroup's chain of products and softmax.
    * float32 at every H: plain FMA over 64-key tiles (TF32 tensor cores
      would miss its 1e-4 limit).

    The first version's ``mma.sync`` kernel (bf16 / fp16 at H = 16 / 32
    until the wgmma kernel took them) is reached from no route; it is the
    baseline of ``scripts/k6_ablation.py``'s ``mma_sync`` variant."""
    _check(q2, k2, v2, "flash_rows")
    return torch.ops.repro_torch.flash_rows(q2, k2, v2, _offset(q_offset),
                                            bool(causal), int(window))


@torch.library.custom_op("repro_torch::flash_rows", mutates_args=())
def _flash_rows_op(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
                   q_offset: int, causal: bool,
                   window: int) -> torch.Tensor:
    """K6 on a CUDA tensor, its plain version on a CPU one."""
    return _flash_rows_device(q2, k2, v2, q_offset, causal=causal,
                              window=window)


@_flash_rows_op.register_fake
def _flash_rows_fake(q2, k2, v2, q_offset, causal, window):
    return q2.new_empty(q2.shape)


def visible_pairs(s: int, t: int, q_offset: int = 0, causal: bool = True,
                  window: int = 0) -> int:
    """The (query, key) pairs a row of ``s`` queries at ``q_offset`` sees
    among ``t`` keys: key j for query position p when j < t, j <= p
    (causal) and j > p - window (a window)."""
    total = 0
    if not causal and not window:
        return s * t
    if not window:
        # sum of min(p + 1, t) over p in [q_offset, q_offset + s)
        lo, hi = q_offset + 1, q_offset + s
        top = min(hi, t)
        if top >= lo:
            total += (lo + top) * (top - lo + 1) // 2
        return total + t * max(0, hi - max(lo - 1, t))
    for p in range(q_offset, q_offset + s):
        hi = min(p + 1, t) if causal else t
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_rows)
    def _flops(q_shape, k_shape, v_shape, q_offset, causal, window, *args,
               out_shape=None, **kwargs):
        rq, s, h = q_shape
        return 4 * h * rq * visible_pairs(s, k_shape[1], q_offset, causal,
                                          window)


_register_flops()


def _flash_rows_device(q2: torch.Tensor, k2: torch.Tensor,
                       v2: torch.Tensor, q_offset, *, causal: bool,
                       window: int) -> torch.Tensor:
    if not q2.is_cuda:
        if q2.device.type != "cpu" or k2.device != q2.device \
                or v2.device != q2.device:
            raise ValueError(f"flash_rows: unsupported devices {q2.device}, "
                             f"{k2.device}, {v2.device}")
        return flash_rows_plain(q2, k2, v2, q_offset, causal=causal,
                                window=window)
    g = q2.shape[0] // k2.shape[0]
    if k2.device != q2.device or v2.device != q2.device:
        raise ValueError("flash_rows: q/k/v on different devices")
    if q2.dtype not in _DTYPES:
        raise TypeError(f"flash_rows: no kernel for {q2.dtype}")
    rq, s, h = q2.shape
    rk, t, _ = k2.shape
    if h not in HEAD_DIMS:
        raise ValueError(f"flash_rows: head dim {h} not in {HEAD_DIMS}")
    for name, x in (("q", q2), ("k", k2), ("v", v2)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_rows: {name} must be contiguous and "
                             f"16-byte aligned")
    out = torch.empty_like(q2)
    n_qb = (s + Q_BLOCK - 1) // Q_BLOCK
    if rq == 0 or s == 0:
        return out
    if n_qb > 65535:
        raise ValueError(f"flash_rows: {s} queries exceed the grid")
    with torch.cuda.device(q2.device):
        status = _lib().flash_attention_fwd(
            _build.KEY_CODES[q2.dtype], h, _build.ptr(q2), _build.ptr(k2),
            _build.ptr(v2), _build.ptr(out), rq, s, t, g,
            _offset(q_offset), int(causal), int(window),
            1.0 / math.sqrt(h), _build.stream_of(q2))
    _build.check(status, "flash_attention_fwd")
    _build.count_launch("flash_attention_fwd")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset=None) -> torch.Tensor:
    """q: (B, S, N, H); k/v: (B, T, R, H) with N = R * G (blocked groups).
    ``q_offset``: the absolute position of q[:, 0].  Returns (B, S, N, H)."""
    b, s, n, h = q.shape
    t, r = k.shape[1], k.shape[2]
    # rows: (B, S, N, H) -> (B, N, S, H) -> (B*N, S, H); N = R*G blocked,
    # so q row b*n + i reads kv row b*r + i // g
    q2 = q.transpose(1, 2).reshape(b * n, s, h).contiguous()
    k2 = k.transpose(1, 2).reshape(b * r, t, h).contiguous()
    v2 = v.transpose(1, 2).reshape(b * r, t, h).contiguous()
    out = flash_rows(q2, k2, v2, q_offset, causal=causal, window=window)
    return out.reshape(b, n, s, h).transpose(1, 2)
