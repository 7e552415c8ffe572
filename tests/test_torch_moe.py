"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same inputs (float32, smoke widths),
parameters carried over leaf for leaf.

Routing is held exactly: the top-k expert ids, each pair's rank within its
expert, ``keep`` and the slots are equal integer for integer (a near tie
in the two frameworks' softmax would flip an expert; the tests report the
smallest gap between the k-th and the (k+1)-th probability of the inputs
when the ids differ, and use no other seed).  Floats: the forward output
and the aux losses within ``atol=rtol=1e-5``, gradients within
``atol=rtol=2e-5`` (both packages run float32 products on the CPU; only
the summation order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.relational as jrel
import repro.sort as jsort
from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import moe as tmoe

from _torch_parity import to_numpy, to_torch

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=2e-5)

# (name, MoEConfig kwargs, mlp_type, (B, S, D))
CASES = [
    ("ample", dict(n_experts=8, top_k=2, d_ff_expert=32,
                   capacity_factor=8.0), "swiglu", (2, 12, 16)),
    ("drops", dict(n_experts=4, top_k=1, d_ff_expert=8,
                   capacity_factor=1.0), "swiglu", (1, 64, 8)),
    ("drops_k2_shared", dict(n_experts=8, top_k=2, d_ff_expert=16,
                             n_shared_experts=1, capacity_factor=0.5),
     "swiglu", (2, 40, 16)),
    ("decode_t1", dict(n_experts=8, top_k=2, d_ff_expert=16,
                       n_shared_experts=1), "swiglu", (3, 1, 16)),
    ("decode_t_le_e", dict(n_experts=8, top_k=3, d_ff_expert=16,
                           capacity_factor=0.25), "swiglu", (2, 6, 16)),
    ("relu2_ungated", dict(n_experts=4, top_k=2, d_ff_expert=24,
                           capacity_factor=1.25), "relu2", (2, 10, 12)),
]
ROUTER_METHODS = ["auto", "torch", "merge", "bitonic", "cuda"]
JAX_METHOD = {"torch": "xla", "cuda": "pallas"}


def _setup(kw, mlp_type, shape, method="auto", seed=0):
    jcfg = JMoE(**kw, router_method=JAX_METHOD.get(method, method))
    tcfg = TMoE(**kw, router_method=method)
    jp, _ = jmoe.init(jax.random.PRNGKey(seed), shape[-1], jcfg, mlp_type,
                      jnp.float32)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    x = (np.random.default_rng(seed + 1).standard_normal(shape)
         * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _jax_routing(p, x, cfg):
    """The reference's routing steps, written out from ``moe.apply``."""
    b, s, _ = x.shape
    cap = jmoe.capacity(s, cfg)

    @jax.jit
    def route(p, x):
        rl = jnp.einsum("bsd,de->bse", x, p["router"])
        probs = jax.nn.softmax(rl, axis=-1)
        _, gate_i = jsort.topk(probs, cfg.top_k, method=cfg.router_method)
        flat_e = gate_i.reshape(b, s * cfg.top_k)
        pos = jrel.group_ranks(flat_e, cfg.n_experts).ranks
        keep = pos < cap
        slot = jnp.where(keep, flat_e * cap + pos, cfg.n_experts * cap)
        return probs, flat_e, slot, keep

    return tuple(np.asarray(a) for a in route(p, x)) + (cap,)


def _tie_margin(probs, k):
    """Smallest gap between the k-th and (k+1)-th probability of a row."""
    s = -np.sort(-probs, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) \
        if probs.shape[-1] > k else float("inf")


@pytest.mark.parametrize("name,kw,mlp_type,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_routing_matches_reference_exactly(name, kw, mlp_type, shape):
    jcfg, tcfg, jp, tp, x = _setup(kw, mlp_type, shape)
    probs, e_ids, slot, keep, cap = _jax_routing(jp, jnp.asarray(x), jcfg)
    _, t_ids, t_slot, t_keep, t_cap, _ = tmoe.route(tp, to_torch(x), tcfg)
    margin = _tie_margin(probs, jcfg.top_k)
    np.testing.assert_array_equal(
        to_numpy(t_ids), e_ids,
        err_msg=f"expert ids differ; smallest top-k gap {margin:.3g}")
    np.testing.assert_array_equal(to_numpy(t_slot), slot)
    np.testing.assert_array_equal(to_numpy(t_keep), keep)
    assert t_cap == cap
    if name.startswith("drops"):
        assert not keep.all()        # the case really drops pairs
    if name.startswith("decode"):
        assert cap == shape[1] and keep.all()    # capacity T: no drop


@pytest.mark.parametrize("name,kw,mlp_type,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_and_aux_match_reference(name, kw, mlp_type, shape):
    jcfg, tcfg, jp, tp, x = _setup(kw, mlp_type, shape)
    jout, jaux = jax.jit(lambda p, xx: jmoe.apply(p, xx, jcfg, mlp_type,
                                                  None))(jp, jnp.asarray(x))
    tout, taux = tmoe.apply(tp, to_torch(x), tcfg, mlp_type)
    np.testing.assert_allclose(to_numpy(tout), np.asarray(jout), **FWD)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **FWD)


def _grads(jcfg, tcfg, jp, tp, x, mlp_type):
    def jloss(p, xx):
        out, aux = jmoe.apply(p, xx, jcfg, mlp_type, None)
        return (jnp.sum(out * out) + 0.01 * aux["moe_lb_loss"]
                + 1e-3 * aux["moe_z_loss"])

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves, names = [], []
    for k in sorted(tp):
        sub = tp[k] if isinstance(tp[k], dict) else {"": tp[k]}
        for kk in sorted(sub):
            names.append((k, kk))
            leaves.append(sub[kk].requires_grad_(True))
    tx = to_torch(x).requires_grad_(True)
    out, aux = tmoe.apply(tp, tx, tcfg, mlp_type)
    loss = (out * out).sum() + 0.01 * aux["moe_lb_loss"] \
        + 1e-3 * aux["moe_z_loss"]
    got = torch.autograd.grad(loss, leaves + [tx])
    want = [jgp[k] if kk == "" else jgp[k][kk] for k, kk in names]
    return names, want + [jgx], list(got)


@pytest.mark.parametrize("method", ROUTER_METHODS)
@pytest.mark.parametrize("name,kw,mlp_type,shape",
                         [CASES[0], CASES[2], CASES[3]],
                         ids=[CASES[i][0] for i in (0, 2, 3)])
def test_gradients_match_jax_grad(name, kw, mlp_type, shape, method):
    """Router, wi, wg, wo, the shared experts and the input, through every
    router backend whose top-k carries a gradient."""
    jcfg, tcfg, jp, tp, x = _setup(kw, mlp_type, shape, method)
    names, want, got = _grads(jcfg, tcfg, jp, tp, x, mlp_type)
    for n, w, g in zip(names + [("x", "")], want, got):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), **GRAD,
                                   err_msg=f"{method} {n}")
    assert float(np.abs(np.asarray(want[names.index(("router", ""))])).sum()
                 ) > 0


@pytest.mark.parametrize("method", ["select", "radix"])
def test_select_and_radix_gates_carry_no_gradient(method):
    """A pinned divergence of the reference: its ``select`` and ``radix``
    top-k give the gate values a zero gradient, the port's return values
    without a ``grad_fn``.  The layer's gradients agree all the same, and
    the router still learns through ``probs`` in the aux losses."""
    kw, mlp_type, shape = CASES[0][1], CASES[0][2], CASES[0][3]
    jcfg, tcfg, jp, tp, x = _setup(kw, mlp_type, shape, method)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    jg = jax.grad(lambda p: jnp.sum(
        jsort.topk(p, 2, method=method)[0]))(probs)
    assert float(jnp.abs(jg).sum()) == 0.0
    tprobs = to_torch(np.asarray(probs)).requires_grad_(True)
    import repro_torch.sort as tsort
    v, _ = tsort.topk(tprobs, 2, method=method, device="cpu")
    assert v.grad_fn is None
    names, want, got = _grads(jcfg, tcfg, jp, tp, x, mlp_type)
    for n, w, g in zip(names + [("x", "")], want, got):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), **GRAD,
                                   err_msg=f"{method} {n}")
    router = got[names.index(("router", ""))]
    assert float(router.abs().sum()) > 0


def test_capacity_matches_reference():
    for kw in (dict(n_experts=64, top_k=6, d_ff_expert=8),
               dict(n_experts=8, top_k=2, d_ff_expert=8,
                    capacity_factor=4.0),
               dict(n_experts=4, top_k=4, d_ff_expert=8,
                    capacity_factor=0.1)):
        for t in (1, 3, 4, 8, 9, 64, 65, 1024, 4096):
            assert tmoe.capacity(t, TMoE(**kw)) == \
                jmoe.capacity(t, JMoE(**kw)), (kw, t)


def test_init_shapes_and_dtypes_match_reference():
    kw = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=2)
    jp, _ = jmoe.init(jax.random.PRNGKey(0), 16, JMoE(**kw), "swiglu",
                      jnp.bfloat16)
    tp = tmoe.init(torch.Generator().manual_seed(0), 16, TMoE(**kw),
                   "swiglu", torch.bfloat16, lead=(3,))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    from repro_torch import tree as ttree
    got = dict(ttree.leaves_with_path(tp))
    assert {jax.tree_util.keystr(k) for k in flat_j} == set(got)
    for k, a in flat_j.items():
        t = got[jax.tree_util.keystr(k)]
        assert tuple(t.shape) == (3,) + tuple(a.shape)
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
    assert got["['router']"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_moe_configs_match_the_reference(arch):
    import dataclasses
    from repro.configs import get_config as jcfg, get_smoke_config as jsmoke
    from repro_torch.configs import get_config as tcfg
    from repro_torch.configs import get_smoke_config as tsmoke
    for mine, ref in ((tcfg(arch), jcfg(arch)), (tsmoke(arch), jsmoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.n_params() == ref.n_params()
        assert mine.n_active_params() == ref.n_active_params()
    if arch.startswith("moonshot"):
        # 28.39 B parameters as configured (56.8 GB in bf16), 4.80 B active
        assert round(tcfg(arch).n_params() / 1e9, 2) == 28.39
        assert round(tcfg(arch).n_active_params() / 1e9, 2) == 4.80
