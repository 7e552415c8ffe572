"""Training every family: train steps, the microbatch split and the
feeds, the port against the JAX package on the CPU.

Three train steps of the ssm, hybrid, encdec and vlm families against the
reference's jitted ``build_train_step`` (two microbatches for whisper and
qwen2-vl), both built with remat on from the same weights; the microbatch
split of the vlm's (3, B, S) positions; the reference's split of a batch
of three along the sequence (a pinned divergence); the training feeds byte
for byte against the reference's training loop.

Tolerances as ``tests/test_torch_train.py``: float32 loss ``rtol=2e-6``
after steps; parameters after Adam steps ``atol=1e-4`` (a 1-ulp gradient
difference where |g| is near eps moves a parameter by up to ~2 lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShape
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as jsteps
from repro_torch import tree as ttree
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

from _torch_family_pairs import (both, close_trees, family_batch, pair,
                                 port_params)

PARAMS = dict(atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,microbatch", [
    ("mamba2-1.3b", 1), ("recurrentgemma-2b", 1), ("whisper-tiny", 2),
    ("qwen2-vl-72b", 2)])
def test_three_train_steps_match_reference(arch, microbatch):
    """Three AdamW steps against the reference's jitted
    ``build_train_step``; with two microbatches the vlm's positions split
    along their batch axis (this fails on the port's earlier dim-0
    split)."""
    jc, tc, jm, tm, jp = pair(arch)
    tp = port_params(arch)
    jfn, jo = jsteps.make_train_step(
        jm, jc, JShape("t", 16, 4, "train"), None, microbatch=microbatch,
        peak_lr=1e-2, total_steps=20)
    tfn, to = tsteps.make_train_step(
        tm, tc, ShapeSpec("t", 16, 4, "train"), microbatch=microbatch,
        peak_lr=1e-2, total_steps=20)
    jfn = jax.jit(jfn)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        jb, tb = both(family_batch(tc, 4, 16, 10 + step))
        jp, js, jmet = jfn(jp, js, jnp.asarray(step, jnp.int32), jb)
        tp, ts, tmet = tfn(tp, ts, step, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-6, err_msg=f"step {step} loss")
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=2e-6)
        close_trees(jp, tp, PARAMS, f"step {step} params")
    close_trees(js, ts, PARAMS, "optimizer state")


def test_microbatch_split_takes_positions_along_their_batch_axis():
    """Each microbatch gets (3, B / m, S) positions and (B / m, ...) of
    every other entry, in order."""
    seen = []

    class Spy:
        def loss(self, params, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return (params["w"] * 0).sum() + 1.0, {}

    fn = tsteps.build_train_step(
        Spy(), tsteps.opt_lib.adamw(tsteps.opt_lib.cosine_schedule(
            1e-3, 1, 10)), ShapeSpec("t", 5, 4, "train"), microbatch=2)
    params = {"w": torch.zeros(3)}
    opt = tsteps.opt_lib.adamw(tsteps.opt_lib.cosine_schedule(1e-3, 1, 10))
    pos = torch.arange(3 * 4 * 5, dtype=torch.int32).reshape(3, 4, 5)
    toks = torch.arange(4 * 5, dtype=torch.int32).reshape(4, 5)
    fn(params, opt.init(params), 0, {"tokens": toks, "positions": pos})
    assert [tuple(mb["positions"].shape) for mb in seen] == [(3, 2, 5)] * 2
    for j, mb in enumerate(seen):
        assert torch.equal(mb["positions"], pos[:, 2 * j:2 * j + 2])
        assert torch.equal(mb["tokens"], toks[2 * j:2 * j + 2])
    with pytest.raises(ValueError, match="does not split"):
        fn(params, opt.init(params), 0,
           {"tokens": toks[:3], "positions": pos[:, :3]})


def test_reference_splits_a_batch_of_three_along_the_sequence():
    """A pinned divergence (ROADMAP Queue 3): the reference picks the
    positions' split by ``shape[0] == 3``, so a global batch of 3 in 3
    microbatches is cut along the sequence (each microbatch the three rows'
    next third of the tokens); the port splits every entry but
    ``positions`` along the batch, a row a microbatch."""
    arch = "minitron-4b"
    jc, tc, jm, tm, jp = pair(arch)
    tp = port_params(arch)
    jb, tb = both(family_batch(tc, 3, 24, 5))
    jfn, jo = jsteps.make_train_step(
        jm, jc, JShape("t", 24, 3, "train"), None, microbatch=3)
    tfn, to = tsteps.make_train_step(
        tm, tc, ShapeSpec("t", 24, 3, "train"), microbatch=3)
    _, _, jmet = jax.jit(jfn)(jp, jo.init(jp), jnp.asarray(0, jnp.int32), jb)
    tparams = ttree.map(torch.clone, tp)
    _, _, tmet = tfn(tparams, to.init(tparams), 0, tb)
    by_seq = np.mean([float(jm.loss(jp, {k: v[:, 8 * j:8 * j + 8]
                                         for k, v in jb.items()})[0])
                      for j in range(3)])
    by_row = np.mean([float(tsteps.loss_and_grads(
        tm, tp, {k: v[r:r + 1] for k, v in tb.items()})[0])
        for r in range(3)])
    assert float(jmet["loss"]) == pytest.approx(by_seq, rel=1e-6)
    assert float(tmet["loss"]) == pytest.approx(by_row, rel=1e-6)


# ---------------------------------------------------------------------------
# the training feeds
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _reference_batch(monkeypatch, arch, step, batch, seq, seed):
    """The numpy batch the reference's ``launch.train`` hands to the
    device at ``step`` (its loop entered at ``step`` through a stand-in
    checkpointer), captured and the run stopped there."""
    from repro.launch import train as rt
    seen = {}

    def capture(b, mesh, dp):
        seen.update({k: np.array(v) for k, v in b.items()})
        raise _Stop

    class Ckpt:
        def __init__(self, path):
            pass

        def latest_step(self):
            return step

        def restore(self, latest, like, shardings):
            return like, {"next_step": step}

    class NoPreempt:
        preempted = False

        def install(self):
            return self

        def uninstall(self):
            pass

    monkeypatch.setattr(rt, "device_put_batch", capture)
    monkeypatch.setattr(rt, "Checkpointer", Ckpt)
    monkeypatch.setattr(rt, "PreemptionHandler", NoPreempt)
    with pytest.raises(_Stop):
        rt.train(arch, smoke=True, steps=step + 1, batch=batch, seq=seq,
                 ckpt_dir="stand-in", seed=seed)
    return seen


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_training_feeds_match_the_reference_byte_for_byte(arch,
                                                          monkeypatch):
    b, s, seed = 4, 16, 3
    cfg = tsmoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b, seed=seed))
    jdata = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                     global_batch=b, seed=seed))
    for step in (0, 3):
        want = _reference_batch(monkeypatch, arch, step, b, s, seed)
        got = ttrain.train_batch(data, cfg, step, seed)
        extra = {"whisper-tiny": {"frames"},
                 "qwen2-vl-72b": {"vision_embeds", "positions"}}[arch]
        assert set(got) == set(want) == {"tokens", "labels"} | extra
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), (arch, step, k)
        assert jdata.global_batch_at(step)["tokens"].tobytes() == \
            got["tokens"].tobytes()
