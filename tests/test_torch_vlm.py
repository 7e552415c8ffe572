"""The port's vlm pieces against the JAX package's: M-RoPE
(``layers.apply_mrope``) over several section splits, attention with M-RoPE
and cross-attention (``attention.apply(kv=)``), and qwen2-vl-72b's smoke
model prefilled with ``vision_embeds`` and explicit (3, B, S) positions of
a patch grid, then decoded (logits and every decode-state leaf), weights
carried over by ``convert.params_from_jax``.

Tolerances: float32 ``atol=2e-5`` on the rotary (the same float32 angles;
cos/sin of angles up to a few thousand rad differ by an ulp of the angle
between XLA and torch) and ``atol=rtol=2e-5`` on the model (only summation
order differs); the K6 path (the plain version on the CPU) against the
reference's einsum attention ``atol=3e-5``, as in
``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo

from _torch_parity import to_numpy, to_torch

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "qwen2-vl-72b"


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(to_numpy(torch_out).astype(np.float32),
                               np.asarray(jax_out, dtype=np.float32),
                               **(tol or TOL))


def grid_positions(b, s, prefix, side):
    """(3, B, S) M-RoPE ids: a side x side patch grid at t = 0 over the
    first ``prefix`` positions (h = row, w = column), then text from
    ``side`` on with t = h = w (Qwen2-VL's layout)."""
    pos = np.zeros((3, b, s), np.int32)
    i = np.arange(prefix)
    pos[1, :, :prefix] = i // side
    pos[2, :, :prefix] = i % side
    text = side + np.arange(s - prefix)
    pos[:, :, prefix:] = text
    return pos


@pytest.mark.parametrize("sections,h", [((16, 24, 24), 128), ((2, 3, 3), 16),
                                        ((8, 0, 0), 16), ((1, 1, 6), 16)])
def test_apply_mrope_matches(sections, h):
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 9, 3, h)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 9)).astype(np.int32)
    _close(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections),
           tlayers.apply_mrope(to_torch(x), to_torch(pos), 1e6, sections),
           atol=2e-5, rtol=0)


def test_apply_mrope_text_positions_equal_rope():
    """t = h = w: M-RoPE is the standard rotary."""
    rng = np.random.default_rng(1)
    x = to_torch(rng.standard_normal((2, 7, 3, 16)).astype(np.float32))
    pos = torch.arange(7, dtype=torch.int32).expand(2, 7)
    np.testing.assert_array_equal(
        tlayers.apply_mrope(x, pos.expand(3, 2, 7), 1e4, (2, 3, 3)).numpy(),
        tlayers.apply_rope(x, pos, 1e4).numpy())
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(x, pos.expand(3, 2, 7), 1e4, (2, 3, 2))


def _attn_pair(**kw):
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, **kw)
    jcfg, tcfg = jattn.AttentionConfig(**cfg), tattn.AttentionConfig(**cfg)
    params, _ = jattn.init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, params, {k: to_torch(np.asarray(v))
                                for k, v in params.items()}


@pytest.mark.parametrize("use_flash", [False, True])
def test_mrope_attention_and_decode_match(use_flash):
    jcfg, tcfg, jp, tp = _attn_pair(rope_type="mrope",
                                    mrope_sections=(2, 3, 3))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    pos = grid_positions(2, 12, 4, 2)
    jout, jkv = jattn.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tout, tkv = tattn.apply(tp, tcfg, to_torch(x), to_torch(pos),
                            use_flash=use_flash)
    _close(jout, tout, **(dict(atol=3e-5, rtol=0) if use_flash else TOL))
    _close(jkv.k, tkv.k)
    # decode: positions broadcast from t to (3, B, 1)
    jc = jattn.init_cache(jcfg, 2, 16, jnp.float32)
    tc = tattn.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    for t in range(5):
        xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jo, jc = jattn.decode_step(jp, jcfg, jnp.asarray(xt), jc,
                                   jnp.asarray(t, jnp.int32))
        to, tc = tattn.decode_step(tp, tcfg, to_torch(xt), tc,
                                   torch.tensor(t, dtype=torch.int32))
        _close(jo, to)
        _close(jc.k, tc.k)


def test_cross_attention_matches():
    """``kv=``: keys and values from another sequence, no rotary, no mask,
    and never K6 (``use_flash`` is ignored, as the reference ignores it)."""
    jcfg, tcfg, jp, tp = _attn_pair(causal=False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    src = rng.standard_normal((2, 11, 32)).astype(np.float32)
    jout, jkv = jattn.apply(jp, jcfg, jnp.asarray(x), kv=jnp.asarray(src))
    tout, tkv = tattn.apply(tp, tcfg, to_torch(x), kv=to_torch(src),
                            use_flash=True)
    _close(jout, tout)
    _close(jkv.v, tkv.v)
    assert tuple(tkv.k.shape) == (2, 11, 2, 16)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    jmodel = jzoo.build(jcfg, policy=None)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(torch_smoke(ARCH), dtype="float32")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return cfg, jmodel, jparams, params


def _leaves(state):
    out = []
    for i, c in enumerate(state["prefix"]):
        out += [(f"prefix{i}.{f}", x) for f, x in zip(c._fields, c)]
    if state["body"] is not None:
        out += [(f"body.{f}", x) for f, x in zip(state["body"]._fields,
                                                state["body"])]
    return out + [("t", state["t"])]


@pytest.mark.parametrize("flash", [False, True])
def test_vision_prefill_and_decode_match(pair, flash):
    """A 2 x 2 patch grid in the vision prefix, text after it; the
    reference runs its einsum attention (its Pallas flash does not run
    under this jax), the port K6's plain version with ``flash``."""
    cfg, jmodel, jparams, params = pair
    model = tzoo.build(dataclasses.replace(cfg, flash_prefill=flash),
                       device="cpu")
    rng = np.random.default_rng(4)
    b, s = 2, 11
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vis = (rng.standard_normal((b, cfg.vision_prefix, cfg.d_model))
           * 0.1).astype(np.float32)
    pos = grid_positions(b, s, cfg.vision_prefix, 2)
    jbatch = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis),
              "positions": jnp.asarray(pos)}
    tbatch = {"tokens": to_torch(toks), "vision_embeds": to_torch(vis),
              "positions": to_torch(pos)}
    jl, jst = jmodel.prefill(jparams, jbatch, max_len=16)
    tl, tst = model.prefill(params, tbatch, max_len=16)
    tol = dict(atol=3e-5, rtol=0) if flash else TOL
    _close(jl, tl, **tol)
    for (name, a), (tname, bb) in zip(_leaves(jst), _leaves(tst)):
        assert name == tname and tuple(a.shape) == tuple(bb.shape), name
        _close(a, bb, **tol)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        tl, tst = model.decode_step(params, to_torch(tok), tst)
        _close(jl, tl, **tol)
    # the prefix really replaced the token embeddings
    other = dict(tbatch, vision_embeds=tbatch["vision_embeds"] + 1.0)
    lo, _ = model.prefill(params, other, max_len=16)
    assert not torch.allclose(lo, model.prefill(params, tbatch, 16)[0])


def test_vlm_loss_and_specs_match(pair):
    cfg, jmodel, jparams, params = pair
    model = tzoo.build(cfg, device="cpu")
    rng = np.random.default_rng(5)
    b, s = 2, 9
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vis = (rng.standard_normal((b, cfg.vision_prefix, cfg.d_model))
           * 0.1).astype(np.float32)
    pos = grid_positions(b, s, cfg.vision_prefix, 2)
    jl, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(toks),
                                  "vision_embeds": jnp.asarray(vis),
                                  "positions": jnp.asarray(pos)})
    tl, _ = model.loss(params, {"tokens": to_torch(toks),
                                "labels": to_torch(toks),
                                "vision_embeds": to_torch(vis),
                                "positions": to_torch(pos)})
    _close(jl, tl)
    specs = model.input_specs(tbase.SHAPES["prefill_32k"])
    assert specs["positions"].shape == (3, 32, 32768)
    assert specs["vision_embeds"].shape == (32, cfg.vision_prefix,
                                            cfg.d_model)
    assert specs["vision_embeds"].device.type == "meta"
