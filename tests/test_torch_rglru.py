"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's on the same inputs: the associative scan, the full block with and
without a passed state, and the decode step, weights from the reference's
init.

Tolerances: float32 ``atol=rtol=1e-5``.  The port's scan is the
reference's ``associative_scan`` recursion, so its products and sums come
in the same order; only XLA's fusion of ``a2 * b1 + b2`` into one rounding
(and the matmuls' blocking) can move a last bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RGLRUConfig as JRGLRUConfig
from repro.models import rglru as jrglru
from repro_torch.configs.base import RGLRUConfig
from repro_torch.models import rglru as trglru

from _torch_parity import to_numpy, to_torch

F32 = dict(atol=1e-5, rtol=1e-5)
D, W = 24, 16


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(to_numpy(torch_out).astype(np.float32),
                               np.asarray(jax_out, dtype=np.float32),
                               **(tol or F32))


def _pair(seed=0):
    cfg, jcfg = RGLRUConfig(lru_width=W), JRGLRUConfig(lru_width=W)
    jp, _ = jrglru.init(jax.random.PRNGKey(seed), D, W, jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_associative_scan_matches(s):
    """Odd and even lengths at every level of the recursion."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = trglru.associative_scan(to_torch(a), to_torch(b))
    _close(ja, ta, atol=1e-6, rtol=1e-6)
    _close(jb, tb, atol=1e-6, rtol=1e-6)
    # and the plain loop
    h = np.zeros((2, 5), np.float64)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(tb[:, -1].numpy(), h, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [12, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches(s, with_state):
    cfg, jcfg, jp, tp = _pair(seed=s)
    rng = np.random.default_rng(s + 1)
    x = (rng.standard_normal((2, s, D)) * 0.5).astype(np.float32)
    jst = tst = None
    if with_state:
        h = rng.standard_normal((2, W)).astype(np.float32)
        conv = rng.standard_normal((2, 3, W)).astype(np.float32)
        jst = jrglru.RGLRUState(h=jnp.asarray(h), conv=jnp.asarray(conv))
        tst = trglru.RGLRUState(h=to_torch(h), conv=to_torch(conv))
    jout, jfin = jrglru.apply(jp, jnp.asarray(x), W, jcfg, init_state=jst)
    tout, tfin = trglru.apply(tp, to_torch(x), W, cfg, init_state=tst)
    _close(jout, tout)
    _close(jfin.h, tfin.h)
    _close(jfin.conv, tfin.conv)
    if tst is not None:      # the passed state is not written
        np.testing.assert_array_equal(tst.h.numpy(), np.asarray(jst.h))


def test_rglru_decode_step_matches():
    cfg, jcfg, jp, tp = _pair(seed=5)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 6, D)) * 0.5).astype(np.float32)
    _, jst = jrglru.apply(jp, jnp.asarray(x), W, jcfg)
    _, tst = trglru.apply(tp, to_torch(x), W, cfg)
    for _ in range(6):
        xt = (rng.standard_normal((2, 1, D)) * 0.5).astype(np.float32)
        jo, jst = jrglru.decode_step(jp, jnp.asarray(xt), W, jcfg, jst)
        to, tst = trglru.decode_step(tp, to_torch(xt), W, cfg, tst)
        _close(jo, to)
        _close(jst.h, tst.h)
        _close(jst.conv, tst.conv)


def test_rglru_init_matches_the_reference_layout():
    """Names, shapes and dtypes of the reference's leaves (b_a, b_i and lam
    float32 in a bf16 block), and lam's values."""
    cfg, jcfg = RGLRUConfig(lru_width=W), JRGLRUConfig(lru_width=W)
    jp, _ = jrglru.init(jax.random.PRNGKey(0), D, W, jcfg, jnp.bfloat16)
    tp = trglru.init(torch.Generator().manual_seed(0), D, W, cfg,
                     torch.bfloat16)
    assert set(jp) == set(tp)
    for k, v in jp.items():
        assert tuple(v.shape) == tuple(tp[k].shape), k
        assert (v.dtype == jnp.float32) == (tp[k].dtype == torch.float32), k
    _close(jp["lam"], tp["lam"], atol=1e-5, rtol=1e-5)
    st = trglru.init_state(W, cfg, 3, torch.bfloat16, "cpu")
    jst = jrglru.init_state(W, jcfg, 3, jnp.bfloat16)
    assert tuple(st.h.shape) == jst.h.shape and st.h.dtype == torch.float32
    assert tuple(st.conv.shape) == jst.conv.shape
