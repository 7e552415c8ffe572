"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's on the same inputs: the chunked SSD, the full mixer with and
without a passed state, and the recurrent decode step; then the three
checks of ``tests/test_ssm_oracle.py`` on the port (chunked SSD equals the
naive recurrence, decode continues prefill, the RG-LRU scan equals its
step loop).

Tolerances: float32 ``atol=rtol=1e-4``.  The port writes the reference's
three-operand einsums as pairwise products in another order (so that no
(B, nc, Q, Q, H, P) product exists) and sums the inter-chunk scan in a
loop, so the float32 sums differ in order: a few ulp of values of order
1-10.  The oracle checks keep the reference test's own limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as jssm
from repro_torch.configs.base import RGLRUConfig, SSMConfig
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm

from _torch_parity import to_numpy, to_torch

F32 = dict(atol=1e-4, rtol=1e-4)


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(to_numpy(torch_out).astype(np.float32),
                               np.asarray(jax_out, dtype=np.float32),
                               **(tol or F32))


def _dims(chunk=8, d=32):
    cfg = SSMConfig(d_state=8, head_dim=16, expand=2, conv_width=4,
                    chunk=chunk)
    jcfg = JSSMConfig(d_state=8, head_dim=16, expand=2, conv_width=4,
                      chunk=chunk)
    return (tssm.SSMDims.from_config(d, cfg),
            jssm.SSMDims.from_config(d, jcfg))


def _params(jdims, seed=0, dtype=jnp.float32):
    jp, _ = jssm.init(jax.random.PRNGKey(seed), jdims, dtype)
    jp = jax.tree.map(np.asarray, jp)
    # dt_bias and a_log stay float32 (as convert.params_from_jax keeps them)
    tp = jax.tree.map(to_torch, jp)
    return jax.tree.map(jnp.asarray, jp), tp


def _ssd_inputs(rng, b, s, h=4, p=16, n=8):
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32))


@pytest.mark.parametrize("s", [32, 29, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches(s, with_state):
    """Chunk multiples, a length off the chunk (zero-padded steps), one
    shorter than a chunk, and a passed initial state."""
    tdims, jdims = _dims()
    rng = np.random.default_rng(s)
    xh, dt, bm, cm, a = _ssd_inputs(rng, 2, s)
    s0 = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
          if with_state else None)
    jy, jfin = jssm._ssd_chunked(
        jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(bm), jnp.asarray(cm),
        jnp.asarray(a), jdims, None if s0 is None else jnp.asarray(s0))
    ty, tfin = tssm._ssd_chunked(
        to_torch(xh), to_torch(dt), to_torch(bm), to_torch(cm), to_torch(a),
        tdims, None if s0 is None else to_torch(s0))
    assert tuple(ty.shape) == (2, s, 4, 16)
    _close(jy, ty)
    _close(jfin, tfin)


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8), (16, 256)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_apply_matches(s, chunk, with_state):
    tdims, jdims = _dims(chunk)
    jp, tp = _params(jdims, seed=s)
    rng = np.random.default_rng(100 + s)
    x = (rng.standard_normal((2, s, 32)) * 0.5).astype(np.float32)
    jst = tst = None
    if with_state:
        st = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
        conv = rng.standard_normal((2, 3, tdims.d_inner + 16)).astype(
            np.float32)
        jst = jssm.SSMState(state=jnp.asarray(st), conv=jnp.asarray(conv))
        tst = tssm.SSMState(state=to_torch(st), conv=to_torch(conv))
    jout, jfin = jssm.apply(jp, jnp.asarray(x), jdims, init_state=jst)
    tout, tfin = tssm.apply(tp, to_torch(x), tdims, init_state=tst)
    _close(jout, tout)
    _close(jfin.state, tfin.state)
    _close(jfin.conv, tfin.conv)


def test_ssm_decode_step_matches():
    """Eight steps from the state a prefill leaves, every state leaf
    compared after each."""
    tdims, jdims = _dims()
    jp, tp = _params(jdims, seed=3)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 11, 32)) * 0.5).astype(np.float32)
    _, jst = jssm.apply(jp, jnp.asarray(x), jdims)
    _, tst = tssm.apply(tp, to_torch(x), tdims)
    for _ in range(8):
        xt = (rng.standard_normal((2, 1, 32)) * 0.5).astype(np.float32)
        jo, jst = jssm.decode_step(jp, jnp.asarray(xt), jdims, jst)
        to, tst = tssm.decode_step(tp, to_torch(xt), tdims, tst)
        _close(jo, to)
        _close(jst.state, tst.state)
        _close(jst.conv, tst.conv)


def test_ssm_init_state_matches():
    tdims, jdims = _dims()
    j = jssm.init_state(jdims, 3, jnp.bfloat16)
    t = tssm.init_state(tdims, 3, torch.bfloat16, "cpu")
    for a, b in zip(j, t):
        assert tuple(a.shape) == tuple(b.shape)
        assert to_numpy(b).dtype.itemsize == np.asarray(a).dtype.itemsize
    assert t.state.dtype == torch.float32 and t.conv.dtype == torch.bfloat16


def test_ssm_init_layout_matches():
    """The port's init draws the reference's leaves: names, shapes and
    dtypes (a bf16 model keeps a_log, d_skip and dt_bias float32)."""
    tdims, jdims = _dims()
    jp, _ = jssm.init(jax.random.PRNGKey(0), jdims, jnp.bfloat16)
    tp = tssm.init(torch.Generator().manual_seed(0), tdims, torch.bfloat16)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat = {jax.tree_util.keystr(k): v for k, v in jl}
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    tflat = {jax.tree_util.keystr(k): v for k, v in tl}
    assert set(flat) == set(tflat)
    for k, v in flat.items():
        assert tuple(v.shape) == tuple(tflat[k].shape), k
        assert (v.dtype == jnp.float32) == (tflat[k].dtype == torch.float32), k
    np.testing.assert_allclose(to_numpy(tp["a_log"]),
                               np.asarray(jp["a_log"]), rtol=1e-6)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt > 0.00099) & (dt < 0.101)).all())


# ---------------------------------------------------------------------------
# tests/test_ssm_oracle.py's checks on the port
# ---------------------------------------------------------------------------

def test_ssd_chunked_equals_naive_recurrence():
    tdims, _ = _dims()
    rng = np.random.default_rng(0)
    b, s = 2, 32
    xh, dt, bm, cm, a = _ssd_inputs(rng, b, s)
    y, final = tssm._ssd_chunked(to_torch(xh), to_torch(dt), to_torch(bm),
                                 to_torch(cm), to_torch(a), tdims)
    state = np.zeros((b, 4, 16, 8), np.float64)
    ys = np.zeros((b, s, 4, 16), np.float64)
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], xh[:, t], bm[:, t])
        state = state * decay[:, :, None, None] + upd
        ys[:, t] = np.einsum("bn,bhpn->bhp", cm[:, t], state)
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), state, rtol=2e-4, atol=2e-4)


def test_ssd_decode_continues_prefill():
    tdims, _ = _dims()
    params = tssm.init(torch.Generator().manual_seed(0), tdims,
                       torch.float32)
    x = torch.randn((2, 17, 32), generator=torch.Generator().manual_seed(1)) \
        * 0.3
    full, _ = tssm.apply(params, x, tdims)
    _, st = tssm.apply(params, x[:, :16], tdims)
    step, _ = tssm.decode_step(params, x[:, 16:17], tdims, st)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 16].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_rglru_scan_equals_loop():
    cfg = RGLRUConfig(lru_width=16, conv_width=4)
    params = trglru.init(torch.Generator().manual_seed(0), 24, 16, cfg,
                         torch.float32)
    x = torch.randn((2, 12, 24), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    full, final = trglru.apply(params, x, 16, cfg)
    st = trglru.init_state(16, cfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(12):
        o, st = trglru.decode_step(params, x[:, t:t + 1], 16, cfg, st)
        outs.append(o)
    seq = torch.cat(outs, dim=1)
    np.testing.assert_allclose(seq.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(st.h.numpy(), final.h.numpy(), rtol=2e-3,
                               atol=2e-3)
