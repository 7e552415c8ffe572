"""The train step at static addresses (``launch.steps.TrainGraph``), run
uncaptured on the CPU, against the eager ``build_train_step`` for all ten
smoke configs and against the JAX package's jitted, donated train step
(``TrainStep.jit``: ``jax.jit(fn, donate_argnums=(0, 1))``) for three of
them; a new batch shape's own slot; other parameters refused by name;
``launch.train.train(device="cpu")`` resumed from a checkpoint against the
eager loop.

Float32 smoke models.  Against the eager step everything is compared bit
for bit (the metrics, every parameter and optimizer-state leaf): both run
the same ops on the same tensors, the static step with its step number in
a tensor.  Against the reference the tolerances of
``tests/test_torch_train.py``: the loss and gradient norm ``rtol=2e-6``,
the parameters and state ``atol=1e-4`` (a 1-ulp gradient difference where
|g| is near eps moves a parameter by up to ~2 lr), and after compressed
steps the same but for lanes the codec sent differently
(``_close_but_requantized``).  The card's captured step is held to the
eager step in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShape
from repro.launch import steps as jsteps
from repro.optim import grad_compress as jgc
from repro.optim import optimizers as jopt
from repro_torch import tree as ttree
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo as tzoo
from repro_torch.optim import grad_compress as tgc

from _torch_family_pairs import (both, close_trees, family_batch, pair,
                                 port_params)
from test_torch_train import PARAMS, _close_but_requantized

ARCHS = ("minitron-4b", "gemma-2b", "deepseek-67b", "nemotron-4-340b",
         "moonshot-v1-16b-a3b", "dbrx-132b", "mamba2-1.3b",
         "recurrentgemma-2b", "whisper-tiny", "qwen2-vl-72b")
STEPS = 3


def _bits(t):
    t = t.detach()
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same_bits(a, b, what):
    la, lb = ttree.leaves_with_path(a), ttree.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, path)
        assert torch.equal(_bits(x), _bits(y)), (what, path)


def _setup(arch, optimizer="adamw", microbatch=1, codec=None, b=4, s=16):
    cfg = dataclasses.replace(tsmoke(arch), dtype="float32")
    model = tzoo.build(cfg, device="cpu")
    hook = cinit = None
    if codec is not None:
        cinit, hook = tgc.make_compressor(tgc.CompressorConfig(codec=codec))
    fn, opt = tsteps.make_train_step(
        model, cfg, ShapeSpec("t", s, b, "train"), optimizer_name=optimizer,
        microbatch=microbatch, peak_lr=1e-2, total_steps=20,
        grad_compressor=hook)

    def fresh(params):
        params = ttree.map(torch.clone, params)
        state = opt.init(params)
        if cinit is not None:
            state.update(cinit(params))
        return params, state

    return cfg, model, fn, fresh


@pytest.mark.parametrize("arch", ARCHS)
def test_static_step_matches_the_eager_step(arch):
    """Three AdamW steps, each on the batch ``launch.train`` draws for it
    (the family's frames or vision feeds included): the static step's
    metrics, parameters and optimizer state equal the eager step's bit for
    bit, and the state is updated in place."""
    cfg, model, fn, fresh = _setup(arch)
    init = model.init(torch.Generator().manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=0))
    pa, sa = fresh(init)
    pb, sb = fresh(init)
    graph = tsteps.TrainGraph(model, fn)
    leaves = ttree.leaves(pb) + ttree.leaves(sb)
    for step in range(STEPS):
        batch = to_device(ttrain.train_batch(data, cfg, step, 0), "cpu")
        pa, sa, ma = fn(pa, sa, step, batch)
        pb, sb, mb = graph(pb, sb, step, batch)
        _same_bits(ma, mb, f"{arch} step {step} metrics")
    _same_bits(pa, pb, f"{arch} params")
    _same_bits(sa, sb, f"{arch} optimizer state")
    assert all(x is y for x, y in zip(ttree.leaves(pb) + ttree.leaves(sb),
                                      leaves))
    assert not graph.capture and len(graph._slots) == 1
    assert (graph.captures, graph.replays, graph.warmup_steps) == (0, 0, 0)


def _reference_steps(arch, optimizer, microbatch, codec):
    """The reference's metrics and (params, state) after each of ``STEPS``
    steps: its train step jitted with donated parameters and state
    (``TrainStep.jit``).  With a codec only the first step can run so
    (the reference drops the error buffer, ROADMAP Queue 3); the later
    ones run its loss, codec and optimizer by hand, the buffer carried
    across, jitted and donated alike."""
    jc, tc, jm, _, jp = pair(arch)
    hook = None
    if codec is not None:
        jinit, hook = jgc.make_compressor(jgc.CompressorConfig(codec=codec))
    jfn, jo = jsteps.make_train_step(
        jm, jc, JShape("t", 16, 4, "train"), None, optimizer_name=optimizer,
        microbatch=microbatch, peak_lr=1e-2, total_steps=20,
        grad_compressor=hook)
    step_fn = jsteps.TrainStep(jfn, None, None, None).jit(None)
    js = jo.init(jp)
    if codec is not None:
        js = {**js, **jinit(jp)}

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def by_hand(p, st, ef, step, b):
        (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        g, efs = hook(g, {"_ef": ef})
        st, info = jo.update(g, st, step)
        return (jopt.cast_like_params(st["master"], p), st, efs["_ef"],
                {"loss": loss, **info})

    out, ef = [], None
    for step in range(STEPS):
        jb, _ = both(family_batch(tc, 4, 16, 10 + step))
        at = jnp.asarray(step, jnp.int32)
        if codec is None:
            jp, js, met = step_fn(jp, js, at, jb)
        elif step == 0:
            p0 = jp
            jp, _, met = step_fn(p0, js, at, jb)
            # the same first step by hand: the state with its error buffer
            _, js, ef, _ = by_hand(p0, jo.init(p0), jinit(p0)["_ef"], at, jb)
        else:
            jp, js, ef, met = by_hand(jp, js, ef, at, jb)
        # copies: the next step's donation deletes these arrays
        out.append(jax.tree.map(np.asarray, (met, jp, js)))
    return out


@pytest.mark.parametrize("arch,optimizer,microbatch,codec", [
    ("minitron-4b", "adamw", 1, None),
    ("moonshot-v1-16b-a3b", "adafactor", 2, None),
    ("whisper-tiny", "adamw", 1, "topk"),
])
def test_static_step_matches_the_jitted_reference(arch, optimizer,
                                                  microbatch, codec):
    """Three steps of the static step against the reference's jitted,
    donated train step from the same weights (``convert.params_from_jax``)
    on the same batches, at ``test_three_train_steps_match_reference``'s
    tolerances."""
    tc = pair(arch)[1]
    want = _reference_steps(arch, optimizer, microbatch, codec)
    _, model, fn, fresh = _setup(arch, optimizer, microbatch, codec)
    tp, ts = fresh(port_params(arch))
    graph = tsteps.TrainGraph(model, fn)
    for step, (jmet, jp, js) in enumerate(want):
        _, tb = both(family_batch(tc, 4, 16, 10 + step))
        tp, ts, tmet = graph(tp, ts, step, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-6, err_msg=f"step {step} loss")
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=2e-6)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
        if codec is None or step == 0:
            close_trees(jp, tp, PARAMS, f"step {step} params")
        else:
            _close_but_requantized(jp, tp, 2e-2, f"step {step} params")
    if codec is None:
        close_trees(js, ts, PARAMS, "optimizer state")


def test_a_new_batch_shape_gets_its_own_slot():
    """Two batch shapes in turn: one static slot each (its batch and step
    buffers at fixed addresses), every step equal to the eager step's."""
    cfg, model, fn, fresh = _setup("minitron-4b")
    init = model.init(torch.Generator().manual_seed(0))
    pa, sa = fresh(init)
    pb, sb = fresh(init)
    graph = tsteps.TrainGraph(model, fn)
    addr = {}
    for step, (b, s) in enumerate([(4, 16), (2, 16), (4, 16), (2, 8)]):
        _, batch = both(family_batch(cfg, b, s, step))
        pa, sa, ma = fn(pa, sa, step, batch)
        pb, sb, mb = graph(pb, sb, step, batch)
        _same_bits(ma, mb, f"step {step}")
        for key, slot in graph._slots.items():
            ptrs = [slot.step.data_ptr()] + [v.data_ptr()
                                             for v in slot.batch.values()]
            assert addr.setdefault(key, ptrs) == ptrs
    assert len(graph._slots) == 3
    assert sorted(tuple(slot.batch["tokens"].shape)
                  for slot in graph._slots.values()) == [(2, 8), (2, 16),
                                                         (4, 16)]
    _same_bits(pa, pb, "params")
    _same_bits(sa, sb, "optimizer state")


def test_other_parameters_raise_by_name():
    """A slot is bound to the parameter and state tensors of its first
    call: a copy of either raises, naming the first leaf that differs."""
    cfg, model, fn, fresh = _setup("minitron-4b")
    params, state = fresh(model.init(torch.Generator().manual_seed(0)))
    graph = tsteps.TrainGraph(model, fn)
    _, batch = both(family_batch(cfg, 2, 16, 0))
    graph(params, state, 0, batch)
    first = ttree.leaves_with_path(params)[0][0]
    with pytest.raises(ValueError, match=r"bound to other parameters .*"
                       + r"params" + first.replace("[", r"\[")
                       .replace("]", r"\]")):
        graph(ttree.map(torch.clone, params), state, 1, batch)
    other = dict(state, m=ttree.map(torch.clone, state["m"]))
    with pytest.raises(ValueError, match=r"opt_state\['m'\]"):
        graph(params, other, 1, batch)
    graph(params, state, 1, batch)        # its own tensors still step


def test_train_on_the_cpu_resumes_with_the_eager_losses(tmp_path, capsys):
    """``launch.train.train(device="cpu")`` steps through ``TrainGraph``:
    six steps with a checkpoint every three, then resumed to nine (a
    schedule of nine steps), give the losses of the eager step in a loop
    that runs the same schedules from the same weights and batches, bit
    for bit (the checkpoint keeps every bit of the state)."""
    arch, seed = "moonshot-v1-16b-a3b", 0
    kw = dict(smoke=True, batch=4, seq=32, lr=1e-2, ckpt_dir=str(tmp_path),
              ckpt_every=3, log_every=100, device="cpu", seed=seed)
    got = ttrain.train(arch, steps=6, **kw) + ttrain.train(arch, steps=9,
                                                           **kw)
    assert "resumed from step 6 -> starting at 6" in capsys.readouterr().out

    cfg = tsmoke(arch)
    model = tzoo.build(cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4, seed=seed))
    params = model.init(torch.Generator().manual_seed(seed))
    want, state = [], None
    for total, steps in ((6, range(0, 6)), (9, range(6, 9))):
        fn, opt = tsteps.make_train_step(
            model, cfg, ShapeSpec("custom", 32, 4, "train", 1),
            peak_lr=1e-2, total_steps=total)
        state = opt.init(params) if state is None else state
        for step in steps:
            batch = to_device(ttrain.train_batch(data, cfg, step, seed),
                              "cpu")
            params, state, met = fn(params, state, step, batch)
            want.append(float(met["loss"]))
    assert got == want
