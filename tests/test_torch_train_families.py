"""Training every family: loss, gradients and remat, the port against
the JAX package on the CPU.

Loss and gradients in float32 against ``jax.value_and_grad`` of the
reference's ``Model.loss`` for the eight architectures the MoE slice did
not cover, both packages built with remat on (the reference's default),
from the same weights (``convert.params_from_jax``); remat on against off
for all ten; remat only while a gradient is taken.  The train steps,
microbatch split and feeds are ``tests/test_torch_train_family_steps.py``.

Tolerances as ``tests/test_torch_train.py``: float32 loss ``rtol=1e-6``;
gradients ``atol=rtol=2e-5`` (float32 products on both sides, only the
summation order differs); remat on against off within 1e-6 (the same ops
run again).  Each reference model is jitted once an architecture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import ssm as jssm
from repro_torch import tree as ttree
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.configs.base import ALIASES
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer

from _torch_family_pairs import (both, close_trees, family_batch,
                                 jit_value_and_grad, pair, port_params)

GRAD = dict(atol=2e-5, rtol=2e-5)
REMAT_TOL = 1e-6
NEW_ARCHS = ["mamba2-1.3b", "recurrentgemma-2b", "whisper-tiny",
             "qwen2-vl-72b", "gemma-2b", "deepseek-67b", "nemotron-4-340b",
             "dbrx-132b"]


# ---------------------------------------------------------------------------
# loss and gradients, remat on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_gradients_match_reference_with_remat(arch):
    jc, tc, jm, tm, jp = pair(arch)
    jb, tb = both(family_batch(tc, 2, 16, 1))
    (jl, jaux), jg = jit_value_and_grad(arch)(jp, jb)
    tl, taux, tg = tsteps.loss_and_grads(tm, port_params(arch), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6, err_msg=k)
    close_trees(jg, tg, GRAD, f"{arch} grad")


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_remat_gradients_equal_no_remat(arch):
    """The same float32 gradients with and without remat, and remat does
    run each layer's forward again (more counted flops)."""
    tc = tsmoke(arch)
    tc = dataclasses.replace(tc, dtype="float32")
    data = SyntheticLM(DataConfig(vocab_size=tc.vocab_size, seq_len=16,
                                  global_batch=2, seed=4))
    batch = {k: torch.from_numpy(v)
             for k, v in ttrain.train_batch(data, tc, 0, 4).items()}
    on = tzoo.build(tc, device="cpu", remat=True)
    off = tzoo.build(tc, device="cpu", remat=False)
    params = on.init(torch.Generator().manual_seed(1))
    flops = {}
    grads = {}
    for name, model in (("on", on), ("off", off)):
        with FlopCounterMode(display=False) as fc:
            loss, _, g = tsteps.loss_and_grads(model, params, batch)
        flops[name], grads[name] = fc.get_total_flops(), (loss, g)
    assert float(grads["on"][0]) == float(grads["off"][0])
    for a, b in zip(ttree.leaves(grads["on"][1]),
                    ttree.leaves(grads["off"][1])):
        assert float((a - b).abs().max()) <= REMAT_TOL
    assert flops["on"] > flops["off"]


def test_remat_is_off_without_a_gradient(monkeypatch):
    """Prefill, decode and a no-grad forward never checkpoint: only a
    forward whose parameters take a gradient does."""
    calls = []

    def spy(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(transformer, "checkpoint", spy)
    cfg = dataclasses.replace(tsmoke("minitron-4b"), dtype="float32")
    model = tzoo.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 8), dtype=torch.int32)
    model.prefill(params, {"tokens": toks}, max_len=16)
    model.impl.forward(params, toks)
    with torch.no_grad():
        model.impl.forward(params, toks)
    assert calls == []
    assert not transformer.remat_active(True, params)
    live = ttree.map(lambda p: p.detach().requires_grad_(True), params)
    assert transformer.remat_active(True, live)
    assert not transformer.remat_active(False, live)
    model.impl.forward(live, toks)
    assert len(calls) == cfg.n_layers


def test_ssd_gradient_stays_finite_where_a_chunk_decay_overflows():
    """Mamba-2 at full width (decay rates up to 16, dt up to 0.1, chunks of
    256) makes a chunk's segment sums pass float32's exp range above the
    diagonal.  The port sets them to -inf before the exp: the same outputs
    as the reference, and finite gradients.  The reference takes the exp
    first and masks after, so its gradient is NaN there (a pinned
    divergence, ROADMAP Queue 3)."""
    b, s, h, p, n = 1, 16, 2, 4, 4
    rng = np.random.default_rng(7)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 1.0, np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    a = np.float32([-16.0, -1.0])
    kw = dict(d_model=4, d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
              conv_width=4, chunk=s)
    jd, td = jssm.SSMDims(**kw), tssm.SSMDims(**kw)

    def jloss(xh, dt):
        return jssm._ssd_chunked(xh, dt, bm, cm, a, jd)[0].sum()

    jy = jssm._ssd_chunked(xh, dt, bm, cm, a, jd)[0]
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(dt))
    txh = torch.from_numpy(xh).requires_grad_(True)
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty = tssm._ssd_chunked(txh, tdt, torch.from_numpy(bm),
                           torch.from_numpy(cm), torch.from_numpy(a), td)[0]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    gx, gdt = torch.autograd.grad(ty.sum(), (txh, tdt))
    assert bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gdt).all())
    assert not np.isfinite(np.asarray(jg[1])).all()
