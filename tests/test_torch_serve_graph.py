"""The decode step at static addresses (``launch.steps.DecodeGraph``), run
uncaptured on the CPU, against the eager ``make_serve_step`` and the JAX
package's jitted serve step, for all ten smoke configs; a reused static
state against a fresh one; ``serve(device="cpu")`` against the eager loop;
``serve``'s host mesh: its topology persisted beside the profile and the
distributed queue against the local sort.

Float32 smoke models, parameters carried over by ``convert.params_from_
jax``, as ``tests/test_torch_serve.py`` does.  Greedy tokens are compared
with the reference's; sampled tokens (the same uniforms, given or drawn
from the same generator) and logits with the eager step's, bit for bit:
both paths run the same ops on the same tensors.  The card's captured
step is held to the eager step in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_smoke_config as torch_smoke
from repro_torch.core import topology, tuning
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import _build
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model_zoo as tzoo

import _torch_parity  # noqa: F401  (each xdist worker's thread pool)

ARCHS = ("minitron-4b", "gemma-2b", "deepseek-67b", "nemotron-4-340b",
         "moonshot-v1-16b-a3b", "dbrx-132b", "mamba2-1.3b",
         "recurrentgemma-2b", "whisper-tiny", "qwen2-vl-72b")
B, K, MAX_LEN, STEPS = 2, 10, 32, 5

_PAIRS = {}


def _pair(arch):
    """(JAX model, JAX params, port model, port params), float32."""
    if arch not in _PAIRS:
        jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
        jmodel = jzoo.build(jcfg, policy=None)
        jparams, _ = jmodel.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(torch_smoke(arch), dtype="float32")
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _PAIRS[arch] = (jmodel, jparams, tzoo.build(cfg, device="cpu"),
                        params)
    return _PAIRS[arch]


def _feed(cfg, s, seed, b=B):
    rng = np.random.default_rng(seed)
    feed = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        feed["frames"] = (rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
                          * 0.1).astype(np.float32)
    return feed


def _torch_feed(feed):
    return {k: torch.from_numpy(v) for k, v in feed.items()}


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _static_run(model, params, feed, uniforms=None, graph=None, k=K):
    """Prefill ``feed`` into ``graph``'s state (a new DecodeGraph when
    None) and decode: (tokens (B, steps), each step's logits, graph)."""
    if graph is None:
        graph = tsteps.DecodeGraph(model, ShapeSpec("serve", MAX_LEN, B,
                                                    "decode"),
                                   sample_topk=k if uniforms is not None
                                   else 0)
    logits, st = graph.prefill(params, feed)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    outs, lgs = [], []
    for i in range(STEPS):
        tok, st = graph(params, tok, st,
                        None if uniforms is None else uniforms[i])
        outs.append(tok)
        lgs.append(graph.logits(tok.shape[0]).clone())
    return torch.cat(outs, 1), lgs, graph


def _eager_run(model, params, feed, uniforms=None, k=K):
    step = tsteps.make_serve_step(model, ShapeSpec("serve", MAX_LEN, B,
                                                   "decode"),
                                  sample_topk=k if uniforms is not None
                                  else 0)
    logits, st = model.prefill(params, feed, max_len=MAX_LEN)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    outs, lgs = [], []
    for i in range(STEPS):
        lgs.append(model.decode_step(params, tok, _clone(st))[0])
        tok, st = step(params, tok, st,
                       None if uniforms is None else uniforms[i])
        outs.append(tok)
    return torch.cat(outs, 1), lgs


def _jax_greedy(jmodel, jparams, feed):
    step = jax.jit(jsteps.make_serve_step(
        jmodel, JShapeSpec("serve", MAX_LEN, B, "decode"), sample_topk=0))
    logits, st = jmodel.prefill(jparams, jax.tree.map(jnp.asarray, feed),
                                max_len=MAX_LEN)
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    outs = []
    for i in range(STEPS):
        tok, st = step(jparams, tok, st, jax.random.PRNGKey(i))
        outs.append(np.asarray(tok))
    return np.concatenate(outs, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_step_matches_the_eager_step_and_the_reference(arch):
    """Greedy: the uncaptured static step's tokens equal the eager step's
    and the reference's jitted step's; its logits equal the eager step's
    bit for bit.  Sampled under given uniforms: tokens and logits equal
    the eager step's."""
    jmodel, jparams, model, params = _pair(arch)
    feed = _feed(model.cfg, 9, len(arch))
    tfeed = _torch_feed(feed)
    got, got_l, _ = _static_run(model, params, tfeed)
    want, want_l = _eager_run(model, params, tfeed)
    assert torch.equal(got, want)
    for a, b in zip(got_l, want_l):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_greedy(jmodel, jparams, feed))
    u = torch.from_numpy(np.random.default_rng(1).random(
        (STEPS, B, K)).astype(np.float32))
    got, got_l, _ = _static_run(model, params, tfeed, u)
    want, want_l = _eager_run(model, params, tfeed, u)
    assert torch.equal(got, want)
    for a, b in zip(got_l, want_l):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b",
                                  "whisper-tiny", "minitron-4b"])
def test_a_reused_state_decodes_as_a_fresh_one(arch):
    """A second, shorter batch prefilled into the first batch's static
    state decodes as it does from a fresh state: recurrentgemma's window
    ring (a first prompt past its 8-slot window, a second inside it),
    mamba2's SSM state, whisper's cross cache (other frames), and a
    global cache whose slots past the new prompt hold the old batch's
    keys.  Tokens and logits, bit for bit."""
    _, _, model, params = _pair(arch)
    u = torch.from_numpy(np.random.default_rng(2).random(
        (STEPS, B, K)).astype(np.float32))
    first = _torch_feed(_feed(model.cfg, 13, 3))
    second = _torch_feed(_feed(model.cfg, 5, 4))
    _, _, graph = _static_run(model, params, first, u)
    reused, reused_l, again = _static_run(model, params, second, u, graph)
    assert again is graph
    fresh, fresh_l, _ = _static_run(model, params, second, u)
    assert torch.equal(reused, fresh)
    for a, b in zip(reused_l, fresh_l):
        assert torch.equal(a, b)


def test_t_and_the_state_advance_in_place():
    """Each step writes ``t`` + 1 into the static ``t`` and every cache in
    place: the prefill's tensors keep their addresses for the slot's
    life, and a second prefill fills the same ones."""
    _, _, model, params = _pair("recurrentgemma-2b")
    graph = tsteps.DecodeGraph(model, ShapeSpec("serve", MAX_LEN, B,
                                                "decode"))
    assert not graph.capture
    logits, st = graph.prefill(params, _torch_feed(_feed(model.cfg, 6, 0)))
    ptrs = [x.data_ptr() for x in _leaves(st)]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(3):
        tok, out = graph(params, tok, st)
        assert out is st and int(st["t"]) == 7 + i
    _, st2 = graph.prefill(params, _torch_feed(_feed(model.cfg, 4, 1)))
    assert st2 is st and int(st["t"]) == 4
    assert [x.data_ptr() for x in _leaves(st)] == ptrs


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def test_static_step_draws_the_eager_steps_uniforms():
    """Uniforms drawn from a generator: the static step draws (B, k) into
    its buffer as the eager step draws them, so the same seed samples the
    same tokens; the step refuses missing noise, uniforms of another
    shape and a state that is not its own; off the card it captures
    nothing."""
    _, _, model, params = _pair("moonshot-v1-16b-a3b")
    shape = ShapeSpec("serve", MAX_LEN, B, "decode")
    feed = _torch_feed(_feed(model.cfg, 7, 5))
    graph = tsteps.DecodeGraph(model, shape, sample_topk=K)
    eager = tsteps.make_serve_step(model, shape, sample_topk=K)
    logits, st = graph.prefill(params, feed)
    _, est = model.prefill(params, feed, max_len=MAX_LEN)
    tok = etok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for _ in range(STEPS):
        tok, st = graph(params, tok, st, g1)
        etok, est = eager(params, etok, est, g2)
        assert torch.equal(tok, etok)
    with pytest.raises(TypeError, match="Generator"):
        graph(params, tok, st)
    with pytest.raises(ValueError, match="uniforms of shape"):
        graph(params, tok, st, torch.zeros(B, K + 1))
    with pytest.raises(ValueError, match="state its prefill returned"):
        graph(params, tok, est, g1)
    assert not graph.capture


def test_capture_tally_counts_launches_once_a_replay():
    """A wrapper's launch inside ``capture_tally`` lands in the graph's
    tally, not in ``launches``; each ``count_replay`` adds the tally."""
    _build.reset_launches()
    _build.count_launch("topk_rows_stream")
    with _build.capture_tally() as tally:
        _build.count_launch("topk_rows_stream")
        _build.count_launch("topk_rows_merge")
    assert tally == {"topk_rows_stream": 1, "topk_rows_merge": 1}
    assert _build.launches == {"topk_rows_stream": 1}
    for _ in range(3):
        _build.count_replay(tally)
    assert _build.launches == {"topk_rows_stream": 4, "topk_rows_merge": 3}
    _build.reset_launches()


def _eager_serve(arch, n_requests, batch_size, decode_steps, topk, seed,
                 max_len):
    """``serve``'s loop as it ran before the static step: the eager step
    on the prefill's own state, the same weights, noise and requests."""
    cfg = torch_smoke(arch)
    model = tzoo.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    step = tsteps.make_serve_step(model, ShapeSpec(
        "serve", max_len, batch_size, "decode"), sample_topk=topk)
    noise = torch.Generator().manual_seed(seed + 1)
    sched = tserve.LengthSortedScheduler(batch_size, method=cfg.sort_method,
                                         device="cpu")
    rng = np.random.default_rng(seed)
    for r in tserve.make_requests(cfg.vocab_size, n_requests, max_len,
                                  decode_steps, rng):
        sched.submit(r)
    done = []
    stats = {"batches": 0, "padding_waste": [], "prefill_ms": [],
             "decode_tps": []}
    tserve._serve_loop(sched, model, params, step, noise, decode_steps,
                       max_len, done, stats, rng=rng)
    return {r.rid: r.out.tolist() for r in done}


@pytest.mark.parametrize("arch", ["minitron-4b", "whisper-tiny",
                                  "moonshot-v1-16b-a3b"])
def test_cpu_serve_keeps_the_eager_loops_tokens(arch):
    """``serve(device="cpu")`` runs the static step: for a fixed seed its
    tokens are the eager loop's (the path before it), batch sizes 3 and 2
    each with their own static state."""
    kw = dict(n_requests=5, batch_size=3, decode_steps=4, topk=5, seed=11,
              max_len=64)
    done, stats = tserve.serve(arch, device="cpu", **kw)
    assert stats["decode_route"] == "static"
    assert stats["graph_captures"] == stats["graph_replays"] == 0
    assert {r.rid: r.out.tolist() for r in done} == _eager_serve(arch, **kw)


def test_serve_persists_and_restores_its_host_mesh_topology(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """A CPU serve with ``state_dir`` snapshots the host mesh's topology
    beside the profile (a one-entry CPU mesh) and the next start restores
    both."""
    monkeypatch.setenv(topology.TOPOLOGY_DIR_ENV, str(tmp_path / "cache"))
    monkeypatch.setenv(tuning.PROFILE_DIR_ENV, str(tmp_path / "prof"))
    mesh = tserve.host_mesh("cpu")
    assert mesh.size == 1 and tuple(mesh.axis_names) == ("data",)
    tuning.set_active(None)
    topology.set_active(None)
    kw = dict(n_requests=2, batch_size=2, decode_steps=2, topk=5,
              device="cpu", state_dir=str(tmp_path / "state"))
    try:
        _, stats = tserve.serve("minitron-4b", **kw)
        assert stats["distributed_queue"] is False
        want = topology.topology_path(topology.from_mesh(mesh),
                                      directory=tmp_path / "state")
        assert want.is_file() and \
            tuning.profile_path(tmp_path / "state").is_file()
        assert capsys.readouterr().out.count("[serve] state snapshot -> ") \
            == 2
        topology.set_active(None)
        tuning.set_active(None)
        tserve.serve("minitron-4b", **kw)
        assert "[serve] restored tuning profile + topology from" in \
            capsys.readouterr().out
        assert topology.active().source == "persisted"
        assert topology.active().signature() == (("data", 1),)
    finally:
        topology.set_active(None)
        tuning.set_active(None)


def test_forced_distributed_queue_matches_the_local_sort(monkeypatch):
    """On a host mesh of 4 CPU entries the distributed queue is on by
    default; over even a small backlog (the scheduler's
    ``distributed_min`` set to 1) it sorts over the mesh and serves the
    same batches, in the same order, with the same tokens as the local
    sort."""
    mesh = make_mesh((4,), ("data",), "cpu")
    monkeypatch.setattr(tserve, "host_mesh", lambda device: mesh)
    monkeypatch.setattr(tserve, "LengthSortedScheduler", functools.partial(
        tserve.LengthSortedScheduler, distributed_min=1))
    kw = dict(n_requests=7, batch_size=3, decode_steps=3, topk=5, seed=4,
              max_len=64, device="cpu")
    runs = {}
    for name, dq in (("mesh", None), ("local", False)):
        done, stats = tserve.serve("minitron-4b", distributed_queue=dq, **kw)
        runs[name] = ([r.rid for r in done],
                      [r.out.tolist() for r in done], stats)
    assert runs["mesh"][2]["distributed_queue"] is True
    assert runs["mesh"][2]["mesh_sorts"] == runs["mesh"][2]["batches"] == 3
    assert runs["local"][2]["mesh_sorts"] == 0
    assert runs["mesh"][:2] == runs["local"][:2]


@pytest.mark.parametrize("flag,want", [([], None),
                                       (["--distributed-queue"], True),
                                       (["--no-distributed-queue"], False)])
def test_main_passes_the_distributed_queue_flag(monkeypatch, flag, want):
    got = {}
    monkeypatch.setattr(tserve, "serve",
                        lambda *a, **kw: got.update(kw))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "minitron-4b",
                                      "--device", "cpu", *flag])
    tserve.main()
    assert got["distributed_queue"] is want
