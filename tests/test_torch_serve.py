"""The port's serving path (``repro_torch.launch``) against the JAX
package's: the length-sorted scheduler's batches, greedy serving of the
minitron-4b smoke model token for token against a JAX oracle loop (float32,
parameters carried over by ``convert.params_from_jax``), top-k sampling
within the JAX step's top-k set, and ``serve(device="cpu")`` end to end.

The reference's own ``serve()`` fails under this jax (its sharding policy),
so the oracle is built from the parts that do run: ``model_zoo.
build(policy=None)``, ``Model.prefill`` and a jitted
``steps.make_serve_step``.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_smoke_config as torch_smoke
from repro_torch.core import tuning
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model_zoo as tzoo


def _requests(mod, lens):
    return [mod.Request(rid=i, prompt=np.zeros(n, np.int32))
            for i, n in enumerate(lens)]


def _schedule(mod, lens, batch_size, **kw):
    sched = mod.LengthSortedScheduler(batch_size, **kw)
    for r in _requests(mod, lens):
        sched.submit(r)
    out = []
    while True:
        batch = sched.next_batch()
        if not batch:
            return out
        out.append(([r.rid for r in batch], sched.padding_waste(batch)))


@pytest.mark.parametrize("seed,n,batch_size", [(0, 16, 4), (1, 23, 5),
                                               (2, 40, 8), (3, 7, 3)])
def test_scheduler_batches_match_the_reference(seed, n, batch_size):
    """Random lengths with heavy ties: the same batches in the same order,
    the same padding waste."""
    lens = np.random.default_rng(seed).integers(1, 12, n)
    want = _schedule(jserve, lens, batch_size)
    got = _schedule(tserve, lens, batch_size, device="cpu")
    assert [b for b, _ in got] == [b for b, _ in want]
    np.testing.assert_allclose([w for _, w in got], [w for _, w in want],
                               rtol=1e-12)


def test_scheduler_never_starves_long_prompts():
    """The reference's anti-starvation case: the long prompt is the oldest
    and anchors the first batch; every later batch serves its oldest."""
    sched = tserve.LengthSortedScheduler(batch_size=4, device="cpu")
    sched.submit(tserve.Request(rid=0, prompt=np.zeros(500, np.int32)))
    rng = np.random.default_rng(7)
    for rid in range(1, 5):
        sched.submit(tserve.Request(rid=rid, prompt=np.zeros(
            int(rng.integers(4, 16)), np.int32)))
    batch = sched.next_batch()
    assert any(r.rid == 0 for r in batch)
    batch_lens = sorted(len(r.prompt) for r in batch if r.rid != 0)
    left_lens = sorted(len(r.prompt) for r in sched.queue)
    assert all(b >= l for b in batch_lens for l in left_lens)
    while sched.queue:
        oldest = sched.queue[0].rid
        assert any(r.rid == oldest for r in sched.next_batch())


def test_scheduler_padding_waste_and_left_pad():
    sched = tserve.LengthSortedScheduler(4, device="cpu")
    batch = [tserve.Request(rid=i, prompt=np.arange(1, n + 1, dtype=np.int32))
             for i, n in enumerate((2, 4))]
    assert sched.padding_waste(batch) == pytest.approx(0.25)
    assert sched.padding_waste([]) == 0.0
    np.testing.assert_array_equal(tserve.left_pad(batch),
                                  [[0, 0, 1, 2], [1, 2, 3, 4]])


def test_requests_match_the_reference_stream():
    reqs = tserve.make_requests(256, 6, 64, 8, seed=0)
    rng = np.random.default_rng(0)
    for r in reqs:
        plen = int(rng.integers(4, 16))
        np.testing.assert_array_equal(
            r.prompt, rng.integers(0, 256, plen).astype(np.int32))


def test_mesh_paths_wait_for_the_distributed_tier():
    with pytest.raises(NotImplementedError, match="distributed tier"):
        tserve.LengthSortedScheduler(4, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# serving the smoke model against a JAX oracle loop
# ---------------------------------------------------------------------------

N_REQ, BATCH, STEPS, MAX_LEN = 6, 3, 8, 64


@pytest.fixture(scope="module")
def pair():
    """The smoke model at float32 in both packages, the same weights."""
    jcfg = dataclasses.replace(jax_smoke("minitron-4b"), dtype="float32")
    jmodel = jzoo.build(jcfg, policy=None)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(torch_smoke("minitron-4b"), dtype="float32")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jmodel, jparams, cfg, params


def _jax_greedy(jmodel, jparams, batches):
    step = jax.jit(jsteps.make_serve_step(
        jmodel, JShapeSpec("serve", MAX_LEN, BATCH, "decode"),
        sample_topk=0))
    out = {}
    for batch in batches:
        toks = jnp.asarray(tserve.left_pad(batch))
        logits, state = jmodel.prefill(jparams, {"tokens": toks},
                                       max_len=MAX_LEN)
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        outs = [nxt]
        for i in range(STEPS - 1):
            nxt, state = step(jparams, nxt, state, jax.random.PRNGKey(i))
            outs.append(nxt)
        gen = np.concatenate([np.asarray(o) for o in outs], axis=1)
        for i, r in enumerate(batch):
            out[r.rid] = gen[i]
    return out


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_serving_matches_jax_oracle(pair, flash):
    jcfg, jmodel, jparams, cfg, params = pair
    cfg = dataclasses.replace(cfg, flash_prefill=flash)
    model = tzoo.build(cfg, device="cpu")
    sched = tserve.LengthSortedScheduler(BATCH, device="cpu")
    ref = tserve.LengthSortedScheduler(BATCH, device="cpu")
    for r in tserve.make_requests(cfg.vocab_size, N_REQ, MAX_LEN, STEPS, 0):
        sched.submit(r)
        ref.submit(dataclasses.replace(r))
    batches = []
    while ref.queue:
        batches.append(ref.next_batch())
    want = _jax_greedy(jmodel, jparams, batches)
    step = tsteps.make_serve_step(model, ShapeSpec("serve", MAX_LEN, BATCH,
                                                   "decode"), sample_topk=0)
    done = []
    stats = {"batches": 0, "padding_waste": [], "prefill_ms": [],
             "decode_tps": []}
    tserve._serve_loop(sched, model, params, step, None, STEPS, MAX_LEN,
                       done, stats)
    assert stats["batches"] == len(batches) == 2
    assert sorted(r.rid for r in done) == list(range(N_REQ))
    for r in done:
        np.testing.assert_array_equal(r.out, want[r.rid], err_msg=str(r.rid))


def test_topk_sampling_stays_in_the_jax_topk_set(pair):
    """Each sampled token lies in the top-k of the JAX step's logits for
    the same state; with given uniforms it is the token the reference's
    Gumbel-max formula picks from them."""
    jcfg, jmodel, jparams, cfg, params = pair
    k = 10
    model = tzoo.build(cfg, device="cpu")
    step = tsteps.make_serve_step(model, ShapeSpec("serve", MAX_LEN, 3,
                                                   "decode"), sample_topk=k)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    _, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=MAX_LEN)
    _, tst = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_len=MAX_LEN)
    gen = torch.Generator().manual_seed(0)
    tok = toks[:, -1:]
    for i in range(12):
        jl, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        jv, ji = jax.lax.top_k(jl, k)
        if i % 2:
            nxt, tst = step(params, torch.from_numpy(tok), tst, gen)
            nxt = nxt.numpy()
        else:
            u = rng.random((3, k)).astype(np.float32)
            nxt, tst = step(params, torch.from_numpy(tok), tst,
                            torch.from_numpy(u))
            nxt = nxt.numpy()
            g = -jnp.log(-jnp.log(jnp.asarray(u) + 1e-9) + 1e-9)
            want = jnp.take_along_axis(
                ji, jnp.argmax(jv + g, axis=-1)[:, None], axis=-1)
            np.testing.assert_array_equal(nxt, np.asarray(want))
        assert nxt.shape == (3, 1) and nxt.dtype == np.int32
        for row in range(3):
            assert nxt[row, 0] in set(np.asarray(ji[row]).tolist())
        tok = nxt


def test_serve_step_refuses_missing_noise(pair):
    _, _, _, cfg, params = pair
    model = tzoo.build(cfg, device="cpu")
    step = tsteps.make_serve_step(model, ShapeSpec("serve", 16, 1, "decode"),
                                  sample_topk=5)
    _, st = model.prefill(params, {"tokens": torch.zeros(1, 3,
                                                         dtype=torch.int32)},
                          max_len=16)
    with pytest.raises(TypeError, match="Generator"):
        step(params, torch.zeros(1, 1, dtype=torch.int32), st)


def test_prefill_step_builder(pair):
    _, _, _, cfg, params = pair
    model = tzoo.build(cfg, device="cpu")
    fn = tsteps.make_prefill_step(model, ShapeSpec("p", 32, 2, "prefill"))
    logits, st = fn(params, {"tokens": torch.ones(2, 5, dtype=torch.int32)})
    assert logits.shape == (2, cfg.vocab_size)
    assert st["body"].k.shape[2] == 32 and int(st["t"]) == 5


# ---------------------------------------------------------------------------
# serve() end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
def test_serve_end_to_end(flash):
    done, stats = tserve.serve("minitron-4b", smoke=True, n_requests=6,
                               batch_size=3, decode_steps=8, topk=10,
                               device="cpu", flash_prefill=flash)
    assert len(done) == 6
    assert all(r.out is not None and len(r.out) == 8 for r in done)
    assert all(((r.out >= 0) & (r.out < 256)).all() for r in done)
    assert stats["batches"] == 2
    assert len(stats["prefill_ms"]) == len(stats["decode_tps"]) == 2


def test_serve_is_seeded():
    a, _ = tserve.serve("minitron-4b", n_requests=4, batch_size=2,
                        decode_steps=4, topk=5, seed=3, device="cpu")
    b, _ = tserve.serve("minitron-4b", n_requests=4, batch_size=2,
                        decode_steps=4, topk=5, seed=3, device="cpu")
    assert [r.out.tolist() for r in a] == [r.out.tolist() for r in b]


def test_serve_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "minitron-4b", "--smoke", "--device", "cpu",
        "--requests", "4", "--batch-size", "2", "--decode-steps", "3",
        "--topk", "5", "--flash-prefill"])
    tserve.main()
    assert "[serve] 4 requests in 2 batches on cpu" in capsys.readouterr().out


def test_tuning_profile_state_dir_round_trip(tmp_path, monkeypatch):
    """serve snapshots the active profile on shutdown; the next start
    restores it (identity-gated by the device fingerprint)."""
    tuning.set_active(None)
    try:
        tserve.serve("minitron-4b", n_requests=2, batch_size=2,
                     decode_steps=2, topk=5, device="cpu",
                     state_dir=str(tmp_path))
        path = tuning.profile_path(tmp_path)
        assert path.is_file()
        saved = tuning.load(path)
        tuning.set_active(dataclasses.replace(saved, run_len=1024,
                                              source="test"))
        assert tserve.restore_state(tmp_path) == ["tuning profile"]
        assert tuning.active().source == "persisted"
        assert tuning.active().run_len == saved.run_len
        # a snapshot from another machine is skipped, never trusted
        other = dataclasses.replace(saved, fingerprint="cuda/other/sm_90")
        tuning.save(other, path)
        tuning.set_active(None)
        assert tserve.restore_state(tmp_path) == []
        assert tuning.active().source == "default"
        # the environment variable names the directory when no flag does
        monkeypatch.setenv(tserve.SERVE_STATE_ENV, str(tmp_path))
        assert tserve.resolve_state_dir() == tmp_path
        assert tserve.resolve_state_dir("x").name == "x"
    finally:
        tuning.set_active(None)
