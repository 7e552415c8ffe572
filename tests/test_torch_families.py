"""All ten architectures in the port against the JAX package: every config
and its smoke reduction field for field; a float32 smoke prefill plus
decode of each family this port added (ssm, hybrid, encdec, vlm) and of
the dense gemma-2b, deepseek-67b and nemotron-4-340b, with K6's path
(its plain version on the CPU) on and off; the loss; ``serve.serve`` on
the CPU for each of those seven, and the encoder-decoder's greedy serving
token for token against a JAX oracle loop; ``params_from_jax`` keeping the
reference's float32 leaves.

The reference runs its einsum attention (``flash_prefill=False``): its
Pallas flash kernel does not run under jax 0.9.0.

Tolerances: float32 logits and state leaves ``atol=rtol=1e-4`` (both
packages run float32 on the CPU; the SSD's pairwise products and chunk
loop, and K6's plain online softmax, sum in another order than the
reference's einsums: a few ulp of logits of order 1-10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model_zoo as tzoo

from _torch_parity import to_numpy, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ("mamba2-1.3b", "recurrentgemma-2b", "whisper-tiny", "qwen2-vl-72b",
       "gemma-2b", "deepseek-67b", "nemotron-4-340b")


def _close(jax_out, torch_out, what=""):
    np.testing.assert_allclose(to_numpy(torch_out).astype(np.float32),
                               np.asarray(jax_out, dtype=np.float32),
                               err_msg=what, **TOL)


def _leaves(tree, path=""):
    """(path, leaf) of a decode state: dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}.{k}")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in _leaves(v, f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


@pytest.mark.parametrize("mod", ARCH_IDS)
def test_configs_match_the_reference(mod):
    arch = next(k for k, v in tbase.ALIASES.items() if v == mod)
    for mine, ref in ((torch_config(arch), jax_config(arch)),
                      (torch_smoke(arch), jax_smoke(arch)),
                      (torch_config(mod), jax_config(mod))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.n_params() == ref.n_params()
        assert mine.n_active_params() == ref.n_active_params()
        assert mine.padded_vocab == ref.padded_vocab
        assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
            [ref.layer_kind(i) for i in range(ref.n_layers)]
    assert tbase.ARCH_IDS == ARCH_IDS


def _inputs(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.vision_prefix:
        batch["vision_embeds"] = (rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)) * 0.1).astype(np.float32)
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return batch


_JAX = {}


def _jax_model(arch):
    if arch not in _JAX:
        jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
        jmodel = jzoo.build(jcfg, policy=None)
        jparams, _ = jmodel.init(jax.random.PRNGKey(0))
        _JAX[arch] = (jmodel, jparams,
                      jax.tree.map(np.asarray, jparams))
    return _JAX[arch]


def _port(arch, flash=False):
    jmodel, jparams, nparams = _jax_model(arch)
    cfg = dataclasses.replace(torch_smoke(arch), dtype="float32",
                              flash_prefill=flash)
    model = tzoo.build(cfg, device="cpu")
    return cfg, jmodel, jparams, model, convert.params_from_jax(
        nparams, cfg, device="cpu")


_RUNS = {}


def _numpy_leaves(state):
    return [(p, np.asarray(x)) for p, x in _leaves(state)]


def _jax_run(arch):
    """The reference's prefill of a 13-token prompt and six decode steps
    (jitted), with their inputs: the same for both of the port's flash
    settings, so it runs once an architecture."""
    if arch not in _RUNS:
        jmodel, jparams, _ = _jax_model(arch)
        cfg = torch_smoke(arch)
        rng = np.random.default_rng(len(arch))
        batch = _inputs(cfg, rng, 2, 13)
        prefill = jax.jit(jmodel.prefill, static_argnames="max_len")
        step = jax.jit(jmodel.decode_step)
        jl, jst = prefill(jparams, jax.tree.map(jnp.asarray, batch),
                          max_len=24)
        outs = [(np.asarray(jl), _numpy_leaves(jst))]
        toks = []
        for _ in range(6):
            toks.append(rng.integers(0, cfg.vocab_size, (2, 1)).astype(
                np.int32))
            jl, jst = step(jparams, jnp.asarray(toks[-1]), jst)
            outs.append((np.asarray(jl), _numpy_leaves(jst)))
        _RUNS[arch] = batch, toks, outs
    return _RUNS[arch]


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_smoke_prefill_and_decode_match_fp32(arch, flash):
    """A prompt longer than recurrentgemma's window (8) and mamba2's chunk
    (8), not a multiple of either; then six decode steps, every
    decode-state leaf compared after each."""
    cfg, _, _, model, params = _port(arch, flash)
    batch, toks, outs = _jax_run(arch)
    tl, tst = model.prefill(params, jax.tree.map(to_torch, batch),
                            max_len=24)
    for step, (jl, jleaves) in enumerate(outs):
        if step:
            tl, tst = model.decode_step(params, to_torch(toks[step - 1]),
                                        tst)
        _close(jl, tl, f"{arch} step {step} logits")
        jl_by, tl_by = dict(jleaves), dict(_leaves(tst))
        assert set(jl_by) == set(tl_by)          # jit sorts dict keys
        for p, a in jl_by.items():
            assert tuple(a.shape) == tuple(tl_by[p].shape), p
            _close(a, tl_by[p], f"{arch} step {step} state {p}")


@pytest.mark.parametrize("arch", NEW)
def test_smoke_loss_matches(arch):
    cfg, jmodel, jparams, model, params = _port(arch)
    rng = np.random.default_rng(3)
    batch = _inputs(cfg, rng, 2, 10)
    labels = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    labels[1, :4] = -100
    batch["labels"] = labels
    jl, jaux = jax.jit(jmodel.loss)(jparams,
                                    jax.tree.map(jnp.asarray, batch))
    tl, taux = model.loss(params, jax.tree.map(to_torch, batch))
    _close(jl, tl, f"{arch} loss")
    _close(jaux["ce_loss"], taux["ce_loss"], f"{arch} ce")


@pytest.mark.parametrize("arch", NEW)
def test_serve_runs_on_the_cpu(arch):
    done, stats = tserve.serve(arch, smoke=True, n_requests=4, batch_size=2,
                               decode_steps=4, topk=10, max_len=64,
                               device="cpu", flash_prefill=True)
    cfg = torch_smoke(arch)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert stats["batches"] == 2
    for r in done:
        assert r.out.shape == (4,)
        assert ((r.out >= 0) & (r.out < cfg.vocab_size)).all()
    assert sum(c for _, c, _ in stats["length_groups"]) == 4


def test_encdec_greedy_serving_matches_jax_oracle():
    """whisper's serve feed: the frames come from the request stream's
    numpy generator after the prompts (the reference's order); greedy
    tokens equal the JAX model's on the same frames and batches."""
    cfg, jmodel, jparams, model, params = _port("whisper-tiny")
    n_req, bsz, steps, max_len = 4, 2, 5, 64
    rng = np.random.default_rng(0)
    reqs = tserve.make_requests(cfg.vocab_size, n_req, max_len, steps, rng)
    sched = tserve.LengthSortedScheduler(bsz, device="cpu")
    ref = tserve.LengthSortedScheduler(bsz, device="cpu")
    for r in reqs:
        sched.submit(r)
        ref.submit(dataclasses.replace(r))
    state_rng = np.random.default_rng(0)
    tserve.make_requests(cfg.vocab_size, n_req, max_len, steps, state_rng)
    jstep = jax.jit(jsteps.make_serve_step(
        jmodel, JShapeSpec("serve", max_len, bsz, "decode"), sample_topk=0))
    want = {}
    while ref.queue:
        batch = ref.next_batch()
        frames = jnp.asarray(state_rng.standard_normal(
            (len(batch), cfg.enc_seq, cfg.d_model)) * 0.1, jnp.float32)
        logits, st = jmodel.prefill(
            jparams, {"tokens": jnp.asarray(tserve.left_pad(batch)),
                      "frames": frames}, max_len=max_len)
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        outs = [nxt]
        for i in range(steps - 1):
            nxt, st = jstep(jparams, nxt, st, jax.random.PRNGKey(i))
            outs.append(nxt)
        gen = np.concatenate([np.asarray(o) for o in outs], axis=1)
        for i, r in enumerate(batch):
            want[r.rid] = gen[i]
    step = tsteps.make_serve_step(model, tbase.ShapeSpec(
        "serve", max_len, bsz, "decode"), sample_topk=0)
    done = []
    stats = {"batches": 0, "padding_waste": [], "prefill_ms": [],
             "decode_tps": []}
    tserve._serve_loop(sched, model, params, step, None, steps, max_len,
                       done, stats, rng=rng)
    assert sorted(r.rid for r in done) == list(range(n_req))
    for r in done:
        np.testing.assert_array_equal(r.out, want[r.rid], err_msg=str(r.rid))


def test_params_from_jax_keeps_the_float32_leaves():
    """A bf16 mamba2 and recurrentgemma: the reference keeps a_log, d_skip,
    dt_bias, b_a, b_i and lam float32; so does the port, bit for bit, and
    every other leaf is bf16."""
    seen = set()
    for arch in ("mamba2-1.3b", "recurrentgemma-2b"):
        jcfg = jax_smoke(arch)
        jparams, _ = jzoo.build(jcfg, policy=None).init(
            jax.random.PRNGKey(0))
        nparams = jax.tree.map(np.asarray, jparams)
        params = convert.params_from_jax(nparams, torch_smoke(arch),
                                         device="cpu")
        jl = dict(_leaves(nparams))
        for path, t in _leaves(params):
            name = path.rsplit(".", 1)[-1]
            if name in convert.FLOAT32_LEAVES:
                seen.add(name)
                assert t.dtype == torch.float32, path
                np.testing.assert_array_equal(t.numpy(), jl[path], path)
            else:
                assert t.dtype == torch.bfloat16, path
    assert seen == {"a_log", "d_skip", "dt_bias", "b_a", "b_i", "lam"}


def test_long_context_decode_state_is_bounded():
    """The long_500k shape at full size: a 524288-deep decode state of the
    sub-quadratic families keeps no sequence axis past recurrentgemma's
    2048-slot window (mamba2 has none at all)."""
    for arch, want in (("mamba2-1.3b", set()), ("recurrentgemma-2b",
                                                 {2048})):
        cfg = torch_config(arch)
        st = tzoo.build(cfg, device="cpu").decode_state(1, 524288)
        seq = {x.shape[-3] for p, x in _leaves(st)
               if p.endswith((".k", ".v"))}
        assert seq == want, (arch, seq)
        assert max(max(x.shape) for _, x in _leaves(st) if x.dim()) < 8192
