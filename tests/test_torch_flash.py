"""K6's plain version (the port's flash-attention entry on the CPU) against
the JAX package's einsum attention ``models.attention._attend`` under an
explicit causal / windowed / offset mask — the function the reference's
Pallas flash kernel computes (that kernel does not run under this jax).

Tolerances: float32 ``atol=3e-5`` (the reference's own flash test);
bfloat16 inputs ``atol=3e-2`` against the float32 oracle on the same
(bf16-rounded) values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa

from _torch_parity import to_torch


def _inputs(b, s, t, n, r, h, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, n, h)).astype(np.float32)
    k = rng.standard_normal((b, t, r, h)).astype(np.float32)
    v = rng.standard_normal((b, t, r, h)).astype(np.float32)
    if dtype != np.float32:
        q, k, v = (x.astype(dtype).astype(np.float32) for x in (q, k, v))
    return q, k, v


def _mask(s, t, causal, window, q_offset):
    qpos = np.arange(s)[:, None] + q_offset
    kpos = np.arange(t)[None, :]
    m = np.ones((s, t), bool)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def _oracle(q, k, v, causal, window, q_offset=0):
    """JAX's ``_attend`` (float32) under the explicit mask."""
    b, s, n, h = q.shape
    cfg = jattn.AttentionConfig(d_model=n * h, n_heads=n,
                                n_kv_heads=k.shape[2], head_dim=h)
    mask = jnp.asarray(_mask(s, k.shape[1], causal, window,
                             q_offset))[None, None]
    return np.asarray(jattn._attend(cfg, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask))


# (b, s, g, r, h, causal, window): S = T, every G in 1..4, every H, one
# block and ragged lengths past it (1.5 and 1.5 blocks + 4 keys are not
# multiples of the kernels' K_BLOCK, so the recurrence spans two tiles)
_B1, _B15, _B15R = tfa.K_BLOCK, tfa.K_BLOCK * 3 // 2, tfa.K_BLOCK * 3 // 2 + 4
CASES = [
    (1, _B1, 1, 2, 16, True, 0),
    (2, _B1, 2, 2, 32, True, 24),
    (1, _B15, 3, 2, 128, True, 0),
    (2, _B15R, 4, 1, 16, True, 0),
    (1, _B15R, 2, 3, 32, False, 0),
    (2, _B15, 1, 4, 16, False, 24),
    (1, _B15R, 3, 1, 32, True, 24),
    (2, _B1, 4, 2, 128, False, 0),
    (1, _B15, 2, 1, 128, True, 24),
    (2, _B15R, 1, 2, 128, True, 24),
]
# the wide heads: nemotron-4-340b's H = 192 at its G = 12, gemma-2b's 256
# with one kv head (MQA); a window of 100 whose lower edge falls inside a
# 64-key tile, as the kernel walks these widths
WIDE = [
    (1, _B15R, 12, 1, 192, True, 0),
    (1, _B15R, 12, 2, 192, True, 100),
    (2, _B15R, 8, 1, 256, True, 0),
    (1, _B15R, 8, 1, 256, True, 100),
]


def _plain_blocks(q, k, v, **kw):
    """K6's plain version in the (B, S, N, H) layout, with block sizes
    other than the kernels' ``Q_BLOCK`` / ``K_BLOCK``."""
    b, s, n, h = q.shape
    t, r = k.shape[1], k.shape[2]
    q2, k2, v2 = (to_torch(x).transpose(1, 2).reshape(b * m, ln, h)
                  for x, m, ln in ((q, n, s), (k, r, t), (v, r, t)))
    out = tfa.flash_rows_plain(q2, k2, v2, **kw)
    return out.reshape(b, n, s, h).transpose(1, 2)


@pytest.mark.parametrize("b,s,g,r,h,causal,window", CASES + WIDE)
def test_plain_matches_jax_attend_fp32(b, s, g, r, h, causal, window):
    q, k, v = _inputs(b, s, s, g * r, r, h, seed=s * 7 + g * 3 + h)
    got = tfa.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, causal, window),
                               atol=3e-5, rtol=0)


@pytest.mark.parametrize("q_block,k_block", [(32, 32), (16, 48), (64, 16)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_plain_blocks_smaller_than_s(q_block, k_block, causal, window):
    """Blocks below S (and not dividing it): the recurrence spans several
    kv blocks and the causal bound of each query block."""
    q, k, v = _inputs(2, 100, 100, 4, 2, 32, seed=q_block + k_block)
    got = _plain_blocks(q, k, v, causal=causal, window=window,
                        q_block=q_block, k_block=k_block)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, causal, window),
                               atol=3e-5, rtol=0)


@pytest.mark.parametrize("s,t,q_offset,window", [
    (32, 96, 64, 0),        # the last 32 queries of a 96-long sequence
    (40, 100, 60, 24),      # ... windowed
    (64, 128, 64, 0),
    (50, 70, 20, 0),        # a middle shard: keys past the queries masked
])
def test_plain_q_offset_matches_the_offset_mask(s, t, q_offset, window):
    """Causal positions are absolute from q_offset (context-parallel
    shards), not aligned to the end of T."""
    q, k, v = _inputs(1, s, t, 6, 2, 16, seed=s + t)
    got = _plain_blocks(q, k, v, causal=True, window=window,
                        q_offset=q_offset, q_block=32, k_block=32)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, True, window, q_offset),
                               atol=3e-5, rtol=0)


@pytest.mark.parametrize("s,t,q_offset,window", [
    (200, 330, 130, 0),          # offset and T past whole 128-key tiles
    (200, 330, 130, 150),        # a window edge inside the tiles
    (300, 300, 0, 100),
])
def test_plain_at_the_kernel_blocks_matches_jax_attend(s, t, q_offset,
                                                       window):
    """The plain version at the kernels' own blocks (``Q_BLOCK`` queries
    over ``K_BLOCK``-key tiles), the queries' causal bounds, windows and
    offsets crossing tile edges, G = 3 (minitron's grouping)."""
    q, k, v = _inputs(1, s, t, 6, 2, 64, seed=s + t + window)
    got = _plain_blocks(q, k, v, causal=True, window=window,
                        q_offset=q_offset, q_block=tfa.Q_BLOCK,
                        k_block=tfa.K_BLOCK)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, True, window, q_offset),
                               atol=3e-5, rtol=0)


@pytest.mark.parametrize("b,s,g,r,h,causal,window", CASES[:6] + WIDE)
def test_plain_bf16_matches_fp32_oracle(b, s, g, r, h, causal, window):
    q, k, v = _inputs(b, s, s, g * r, r, h, seed=s + h,
                      dtype=jnp.bfloat16)
    bf = [to_torch(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tfa.flash_attention(*bf, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(q, k, v, causal, window),
                               atol=3e-2, rtol=0)


def test_rows_form_reads_kv_row_r_over_g():
    """flash_rows: q row r attends kv row r // G (blocked GQA)."""
    rng = np.random.default_rng(3)
    q2 = torch.from_numpy(rng.standard_normal((6, 20, 16)).astype(np.float32))
    k2 = torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32))
    v2 = torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32))
    out = tfa.flash_rows(q2, k2, v2, causal=True)
    for r in range(6):
        one = tfa.flash_rows(q2[r:r + 1], k2[r // 3:r // 3 + 1],
                             v2[r // 3:r // 3 + 1], causal=True)
        torch.testing.assert_close(out[r:r + 1], one, atol=1e-6, rtol=0)


def test_a_query_that_sees_no_key_averages_its_visited_tiles():
    """The reference's -1e30 arithmetic, kept: a query whose window holds
    no key (here: offset past T + window) gets p = 1 on every key of the
    tiles it visits, keys past T counting as zero vectors, so its output is
    sum(v over visited keys < T) / (visited tiles x k_block)."""
    rng = np.random.default_rng(5)
    t, kb = 40, 16
    q2 = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    k2 = torch.from_numpy(rng.standard_normal((1, t, 16)).astype(np.float32))
    v2 = torch.from_numpy(rng.standard_normal((1, t, 16)).astype(np.float32))
    out = tfa.flash_rows_plain(q2, k2, v2, q_offset=100, causal=True,
                               window=8, q_block=4, k_block=kb)
    visited = -(-t // kb) * kb                  # 3 tiles, 48 key slots
    want = v2[0].sum(0) / visited
    torch.testing.assert_close(out[0], want.expand(4, 16), atol=1e-6,
                               rtol=0)
    assert torch.isfinite(out).all()


def test_wrapper_refuses_inputs_that_require_grad():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa.flash_rows(torch.zeros(2, 8, 16), k[0].transpose(0, 1),
                       torch.zeros(1, 8, 16, requires_grad=True))


def test_wrapper_rejects_bad_grouping_and_dtypes():
    with pytest.raises(ValueError, match="group"):
        tfa.flash_rows(torch.zeros(3, 8, 16), torch.zeros(2, 8, 16),
                       torch.zeros(2, 8, 16))
    with pytest.raises(TypeError, match="dtypes differ"):
        tfa.flash_rows(torch.zeros(2, 8, 16), torch.zeros(1, 8, 16),
                       torch.zeros(1, 8, 16, dtype=torch.float64))
