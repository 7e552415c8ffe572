"""The port's whisper encoder-decoder (``repro_torch.models.encdec``)
against the JAX package's on whisper-tiny's smoke model: the sinusoids, the
encoder, the loss, and prefill plus four decode steps (logits and every
decode-state leaf), weights carried over by ``convert.params_from_jax``.

Tolerances: float32 ``atol=rtol=2e-5`` (both packages run float32 matmuls
on the CPU; only summation order differs); bf16 logits ``atol=0.1`` as in
``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import encdec as jencdec
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import encdec as tencdec
from repro_torch.models import model_zoo as tzoo

from _torch_parity import to_numpy, to_torch

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "whisper-tiny"


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(to_numpy(torch_out).astype(np.float32),
                               np.asarray(jax_out, dtype=np.float32),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    jmodel = jzoo.build(jcfg, policy=None)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(torch_smoke(ARCH), dtype="float32")
    model = tzoo.build(cfg, device="cpu")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return cfg, jmodel, jparams, model, params


def _frames(cfg, b, seed):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)


def _state_leaves(state):
    out = []
    for i, st in enumerate(state["layers"]):
        for part in ("self", "cross"):
            out += [(f"{i}.{part}.k", st[part].k), (f"{i}.{part}.v",
                                                    st[part].v)]
    return out + [("t", state["t"])]


@pytest.mark.parametrize("length,channels,atol", [(16, 64, 1e-5),
                                                  (1500, 384, 2e-4)])
def test_sinusoids_match(length, channels, atol):
    """The same float32 angles; at whisper's 1500 frames an angle reaches
    1499 rad, where XLA's and torch's sin differ by up to one ulp of the
    angle (1.2e-4)."""
    _close(jencdec.sinusoids(length, channels),
           tencdec.sinusoids(length, channels), atol=atol, rtol=0)


def test_encode_matches(pair):
    cfg, jmodel, jparams, model, params = pair
    assert model.is_encdec and jmodel.is_encdec
    fr = _frames(cfg, 2, 1)
    _close(jmodel.impl.encode(jparams, jnp.asarray(fr)),
           model.impl.encode(params, to_torch(fr)))


def test_loss_matches(pair):
    cfg, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    labels[0, :3] = -100
    fr = _frames(cfg, 2, 3)
    jl, jaux = jmodel.loss(jparams, {"frames": jnp.asarray(fr),
                                     "tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    tl, taux = model.loss(params, {"frames": to_torch(fr),
                                   "tokens": to_torch(toks),
                                   "labels": to_torch(labels)})
    _close(jl, tl)
    assert set(taux) == set(jaux) == {"ce_loss"}


def test_prefill_and_four_decode_steps_match(pair):
    cfg, jmodel, jparams, model, params = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    fr = _frames(cfg, 2, 5)
    jl, jst = jmodel.prefill(jparams, {"frames": jnp.asarray(fr),
                                       "tokens": jnp.asarray(toks)},
                             max_len=16)
    tl, tst = model.prefill(params, {"frames": to_torch(fr),
                                     "tokens": to_torch(toks)}, max_len=16)
    _close(jl, tl)
    for (name, a), (tname, b) in zip(_state_leaves(jst), _state_leaves(tst)):
        assert name == tname and tuple(a.shape) == tuple(b.shape), name
        _close(a, b)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        tl, tst = model.decode_step(params, to_torch(tok), tst)
        _close(jl, tl)
        for (name, a), (_, b) in zip(_state_leaves(jst), _state_leaves(tst)):
            _close(a, b)
    assert int(tst["t"]) == 11


def test_bf16_prefill_and_decode_match():
    jcfg = jax_smoke(ARCH)
    jmodel = jzoo.build(jcfg, policy=None)
    jparams, _ = jmodel.init(jax.random.PRNGKey(1))
    cfg = torch_smoke(ARCH)
    model = tzoo.build(cfg, device="cpu")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    fr = _frames(cfg, 2, 7)
    jl, jst = jmodel.prefill(jparams, {"frames": jnp.asarray(fr),
                                       "tokens": jnp.asarray(toks)},
                             max_len=8)
    tl, tst = model.prefill(params, {"frames": to_torch(fr),
                                     "tokens": to_torch(toks)}, max_len=8)
    _close(jl, tl, atol=0.1, rtol=0)
    jl, _ = jmodel.decode_step(jparams, jnp.asarray(toks[:, :1]), jst)
    tl, _ = model.decode_step(params, to_torch(toks[:, :1]), tst)
    _close(jl, tl, atol=0.1, rtol=0)


def test_encdec_facade():
    """Encoder-decoder inputs in ``input_specs``; the decode state comes
    from prefill only, as in the reference."""
    from repro_torch.configs import base as tbase
    cfg = torch_smoke(ARCH)
    model = tzoo.build(cfg, device="cpu")
    specs = model.input_specs(tbase.SHAPES["train_4k"])
    assert specs["frames"].shape == (256, cfg.enc_seq, cfg.d_model)
    assert specs["frames"].dtype == torch.bfloat16
    assert set(specs) == {"tokens", "labels", "frames"}
    assert set(model.input_specs(tbase.SHAPES["decode_32k"])) == {"token"}
    with pytest.raises(NotImplementedError, match="prefill"):
        model.decode_state(2, 16)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(params, {"frames": torch.zeros(1, cfg.enc_seq,
                                                     cfg.d_model),
                               "tokens": torch.zeros(1, 9,
                                                     dtype=torch.int32)},
                      max_len=8)
