"""The port's model stack (``repro_torch.models``) against the JAX
package's on the same inputs: layers, attention (einsum, q-chunked, flash,
decode, ring buffer) and minitron-4b's smoke model (prefill + decode,
logits and every decode-state leaf), parameters carried over by
``repro_torch.convert.params_from_jax``.

Tolerances: float32 ``atol=rtol=1e-5`` for single layers and ``2e-5`` for
the three-layer model (both packages run float32 matmuls on the CPU, so
only the summation order differs); bfloat16 model logits ``atol=0.1``
(bf16 keeps 8 bits, and the two frameworks round intermediates at other
places); flash (the port's K6 path) against the reference's einsum
attention ``atol=3e-5`` in float32, as the reference's flash test.
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
from repro_torch.configs import minitron_4b
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo

from _torch_parity import to_numpy, to_torch

F32 = dict(atol=1e-5, rtol=1e-5)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(to_numpy(torch_out).astype(np.float32),
                               _np(jax_out), **(tol or F32))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_minitron_configs_match_the_reference():
    from repro.configs import get_config as jax_config
    for mine, ref in ((tbase.get_config("minitron-4b"),
                       jax_config("minitron-4b")),
                      (torch_smoke("minitron-4b"), jax_smoke("minitron-4b"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.n_params() == ref.n_params()
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.resolved_head_dim == ref.resolved_head_dim
        assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
            [ref.layer_kind(i) for i in range(ref.n_layers)]
    assert minitron_4b.CONFIG.param_dtype() == torch.bfloat16
    assert tbase.SHAPES["prefill_32k"].tokens == 32768 * 32
    with pytest.raises(ModuleNotFoundError):
        tbase.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(norm, dtype):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 5, 64, scale=3.0) + 1.0
    p = {"scale": _rand(rng, 64, scale=0.1), "bias": _rand(rng, 64)}
    if norm == "rmsnorm":
        p.pop("bias")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    want = getattr(jlayers, norm)(jp, jx)
    got = getattr(tlayers, norm)({k: to_torch(v) for k, v in jp.items()},
                                 to_torch(jx))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(want, got)
    else:       # float32 inside, one rounding to bf16 at the end
        _close(want, got, atol=0.0, rtol=2 ** -7)


@pytest.mark.parametrize("h,theta", [(128, 10000.0), (16, 10000.0),
                                     (64, 500000.0)])
def test_rope_matches(h, theta):
    rng = np.random.default_rng(h)
    x = _rand(rng, 2, 7, 3, h)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    _close(jlayers.rope_freqs(h, theta), tlayers.rope_freqs(h, theta))
    _close(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tlayers.apply_rope(to_torch(x), to_torch(pos), theta),
           atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("mlp_type", ["relu2", "swiglu", "geglu", "gelu"])
def test_mlp_matches(mlp_type):
    rng = np.random.default_rng(2)
    params, _ = jlayers.mlp_init(jax.random.PRNGKey(0), 32, 96, mlp_type,
                                 jnp.float32)
    x = _rand(rng, 2, 5, 32)
    tp = {k: to_torch(np.asarray(v)) for k, v in params.items()}
    assert ("wg" in tp) == (mlp_type in ("swiglu", "geglu"))
    _close(jlayers.mlp_apply(params, jnp.asarray(x), mlp_type),
           tlayers.mlp_apply(tp, to_torch(x), mlp_type))


@pytest.mark.parametrize("scale", [False, True])
def test_embed_matches(scale):
    rng = np.random.default_rng(3)
    table = _rand(rng, 50, 16)
    tok = rng.integers(0, 50, (3, 9)).astype(np.int32)
    _close(jlayers.embed({"embedding": jnp.asarray(table)}, jnp.asarray(tok),
                         scale, 16),
           tlayers.embed({"embedding": to_torch(table)}, to_torch(tok),
                         scale, 16))


@pytest.mark.parametrize("tie,softcap", [(False, 0.0), (True, 0.0),
                                         (False, 30.0)])
def test_logits_from_hidden_masks_padded_vocab(tie, softcap):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, 16)
    emb = {"embedding": _rand(rng, 512, 16)}
    unemb = {"unembedding": _rand(rng, 16, 512)}
    want = jlayers.logits_from_hidden(
        jnp.asarray(x), {"embedding": jnp.asarray(emb["embedding"])},
        {"unembedding": jnp.asarray(unemb["unembedding"])}, tie, softcap,
        true_vocab=500)
    got = tlayers.logits_from_hidden(
        to_torch(x), {"embedding": to_torch(emb["embedding"])},
        {"unembedding": to_torch(unemb["unembedding"])}, tie, softcap,
        true_vocab=500)
    assert got.dtype == torch.float32
    assert (got[..., 500:] == -1e30).all()
    _close(want, got)


def test_truncnorm_init_is_seeded_and_truncated():
    g = torch.Generator().manual_seed(0)
    a = tlayers.truncnorm_init(g, (4096,), 0.5, torch.float32)
    b = tlayers.truncnorm_init(torch.Generator().manual_seed(0), (4096,),
                               0.5, torch.float32)
    assert torch.equal(a, b)
    assert a.abs().max() <= 1.0 and 0.4 < a.std() < 0.5


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_pair(d, n, r, h, window=0, seed=0):
    cfg = dict(d_model=d, n_heads=n, n_kv_heads=r, head_dim=h, window=window)
    jcfg, tcfg = jattn.AttentionConfig(**cfg), tattn.AttentionConfig(**cfg)
    params, _ = jattn.init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = {k: to_torch(np.asarray(v)) for k, v in params.items()}
    return jcfg, tcfg, params, tp


@pytest.mark.parametrize("s,window", [(12, 0), (40, 0), (40, 8)])
@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_apply_matches(s, window, use_flash):
    """The einsum path, and K6's path (flash on the port, the reference's
    einsum on the JAX side), with the repeated K/V for the cache."""
    jcfg, tcfg, jp, tp = _attn_pair(32, 4, 2, 8, window, seed=s)
    rng = np.random.default_rng(s)
    x = _rand(rng, 2, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jout, jkv = jattn.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tout, tkv = tattn.apply(tp, tcfg, to_torch(x), to_torch(pos.copy()),
                            use_flash=use_flash)
    tol = dict(atol=3e-5, rtol=0) if use_flash else F32
    _close(jout, tout, **tol)
    _close(jkv.k, tkv.k)
    _close(jkv.v, tkv.v)


def test_attention_q_chunked_path_matches():
    """S = 3072 > 2048 and a multiple of 1024: both packages take the
    q-chunked path (three 1024-query blocks)."""
    jcfg, tcfg, jp, tp = _attn_pair(16, 2, 1, 8, seed=7)
    rng = np.random.default_rng(7)
    x = _rand(rng, 1, 3072, 16)
    pos = np.arange(3072, dtype=np.int32)[None]
    jout, _ = jattn.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tout, _ = tattn.apply(tp, tcfg, to_torch(x), to_torch(pos))
    _close(jout, tout)


def test_causal_mask_matches():
    for s, off, w in ((5, 0, 0), (6, 3, 0), (7, 2, 3)):
        np.testing.assert_array_equal(
            np.asarray(jattn.causal_mask(s, off, w)),
            tattn.causal_mask(s, off, w).numpy())


@pytest.mark.parametrize("window,max_len,steps", [(0, 24, 20), (5, 24, 14)])
def test_attention_decode_matches(window, max_len, steps):
    """Token-by-token decode from an empty cache; the windowed layer's
    ring buffer wraps (14 steps through 5 slots)."""
    jcfg, tcfg, jp, tp = _attn_pair(32, 4, 2, 8, window, seed=window)
    rng = np.random.default_rng(window + 1)
    jc = jattn.init_cache(jcfg, 2, max_len, jnp.float32)
    tc = tattn.init_cache(tcfg, 2, max_len, torch.float32, "cpu")
    assert tc.k.shape == jc.k.shape
    for t in range(steps):
        x = _rand(rng, 2, 1, 32)
        jout, jc = jattn.decode_step(jp, jcfg, jnp.asarray(x), jc,
                                     jnp.asarray(t, jnp.int32))
        tout, tc = tattn.decode_step(tp, tcfg, to_torch(x), tc,
                                     torch.tensor(t, dtype=torch.int32))
        _close(jout, tout)
        _close(jc.k, tc.k)
        _close(jc.v, tc.v)


# ---------------------------------------------------------------------------
# minitron-4b smoke: prefill + decode
# ---------------------------------------------------------------------------

def _leaves(state):
    """(name, array) of every decode-state leaf."""
    out = []
    for i, c in enumerate(state["prefix"]):
        out += [(f"prefix{i}.k", c.k), (f"prefix{i}.v", c.v)]
    if state["body"] is not None:
        out += [("body.k", state["body"].k), ("body.v", state["body"].v)]
    return out + [("t", state["t"])]


@pytest.fixture(scope="module")
def jax_minitron():
    cfg = dataclasses.replace(jax_smoke("minitron-4b"), dtype="float32")
    model = jzoo.build(cfg, policy=None)
    params, _ = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


@pytest.mark.parametrize("flash", [False, True])
def test_minitron_smoke_prefill_and_decode_match_fp32(jax_minitron, flash):
    jcfg, jmodel, jparams = jax_minitron
    cfg = dataclasses.replace(torch_smoke("minitron-4b"), dtype="float32",
                              flash_prefill=flash)
    model = tzoo.build(cfg, device="cpu")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    assert model.impl.scan_body and params["body"]["mixer"]["wq"].shape[0] \
        == cfg.n_layers
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    tol = dict(atol=2e-5, rtol=2e-5)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                             max_len=32)
    tl, tst = model.prefill(params, {"tokens": to_torch(tokens)}, max_len=32)
    _close(jl, tl, **tol)
    for (name, a), (tname, b) in zip(_leaves(jst), _leaves(tst)):
        assert name == tname and tuple(a.shape) == tuple(b.shape), name
        _close(a, b, **tol)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        tl, tst = model.decode_step(params, to_torch(tok), tst)
        _close(jl, tl, **tol)
        for (name, a), (_, b) in zip(_leaves(jst), _leaves(tst)):
            _close(a, b, **tol)


def test_minitron_smoke_hidden_states_and_logits_match_fp32(jax_minitron):
    """The full-sequence forward: final hidden states and every position's
    logits."""
    jcfg, jmodel, jparams = jax_minitron
    cfg = dataclasses.replace(torch_smoke("minitron-4b"), dtype="float32")
    model = tzoo.build(cfg, device="cpu")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    tokens = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (3, 11)).astype(np.int32)
    jh, _ = jmodel.impl.hidden_states(jparams, jnp.asarray(tokens))
    th = model.impl.hidden_states(params, to_torch(tokens))
    tol = dict(atol=2e-5, rtol=2e-5)
    _close(jh, th, **tol)
    _close(jmodel.impl.logits(jparams, jh), model.impl.logits(params, th),
           **tol)


@pytest.mark.parametrize("flash", [False, True])
def test_minitron_smoke_logits_match_bf16(flash):
    jcfg = jax_smoke("minitron-4b")
    jmodel = jzoo.build(jcfg, policy=None)
    jparams, _ = jmodel.init(jax.random.PRNGKey(1))
    cfg = dataclasses.replace(torch_smoke("minitron-4b"), flash_prefill=flash)
    model = tzoo.build(cfg, device="cpu")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    assert params["embed"]["embedding"].dtype == torch.bfloat16
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                             max_len=16)
    tl, tst = model.prefill(params, {"tokens": to_torch(tokens)}, max_len=16)
    _close(jl, tl, atol=0.1, rtol=0)
    tok = tokens[:, :1]
    jl, _ = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
    tl, _ = model.decode_step(params, to_torch(tok), tst)
    _close(jl, tl, atol=0.1, rtol=0)


def test_model_facade():
    cfg = torch_smoke("minitron-4b")
    model = tzoo.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    st = model.decode_state(2, 16)
    assert st["body"].k.shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                  cfg.resolved_head_dim)
    assert int(st["t"]) == 0
    specs = model.input_specs(tbase.SHAPES["prefill_32k"])
    assert specs["tokens"].shape == (32, 32768)
    assert specs["tokens"].device.type == "meta"
    toks = torch.zeros((2, 8), dtype=torch.int32)
    loss, aux = model.loss(params, {"tokens": toks, "labels": toks})
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    assert set(aux) == {"ce_loss"}
    with pytest.raises(ValueError, match="family"):
        # an ssm family needs its SSM config
        tzoo.build(dataclasses.replace(cfg, family="ssm"), device="cpu")
    with pytest.raises(ValueError, match="family"):
        # a moe family needs its MoE config
        tzoo.build(dataclasses.replace(cfg, family="moe"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tzoo.build(cfg)
