"""The port's checkpointer and fault-tolerance runtime.

``repro_torch.checkpoint.checkpointer``: round trips (bfloat16 leaves as
raw bits, float32, int32, prefix lists, stacked leaves), the reference's
on-disk layout (file names, manifest, bf16 as uint16) read by the JAX
package's ``Checkpointer`` and back, atomic renames, async writes, keep
retention, ``latest_step`` and shape checks.
``repro_torch.runtime.fault_tolerance`` against
``repro.runtime.fault_tolerance``.  All exact.
"""
import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.runtime import fault_tolerance as jft
from repro_torch import tree as ttree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.runtime import fault_tolerance as tft

from _torch_parity import to_numpy


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "embed": {"embedding": torch.randn(6, 4, generator=g)
                      .to(torch.bfloat16)},
            "prefix": [{"w": torch.randn(4, 4, generator=g)}],
            "body": {"router": torch.randn(2, 4, 3, generator=g),
                     "wi": torch.randn(2, 3, 4, 5, generator=g)
                     .to(torch.bfloat16)},
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "_ef": [torch.zeros(3), torch.full((2,), -0.0)]},
    }


def _same(a, b):
    for (pa, x), (pb, y) in zip(ttree.leaves_with_path(a),
                                ttree.leaves_with_path(b)):
        assert pa == pb and x.dtype == y.dtype and x.shape == y.shape
        bits = {2: torch.int16, 4: torch.int32}.get(x.element_size())
        assert torch.equal(x.view(bits), y.view(bits)) if bits else \
            torch.equal(x, y)


def test_round_trip_bf16_bits_and_extra(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(5, tree, extra={"next_step": 5})
    ck.wait()
    like = ttree.map(torch.zeros_like, tree)
    got, extra = ck.restore(5, like)
    _same(tree, got)
    assert extra == {"next_step": 5}
    assert ck.latest_step() == 5
    files = sorted(os.listdir(tmp_path / "step_00000005"))
    assert "manifest.json" in files
    assert "__params____embed____embedding__.npy" in files
    arr = np.load(tmp_path / "step_00000005" /
                  "__params____embed____embedding__.npy")
    assert arr.dtype == np.uint16


def test_reference_reads_the_ports_checkpoint_and_back(tmp_path):
    tree = _tree(1)
    Checkpointer(str(tmp_path / "a")).save(3, tree, blocking=True)
    like = ttree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16
                                         if t.dtype == torch.bfloat16 else
                                         to_numpy(t).dtype), tree)
    jtree, _ = JCheckpointer(str(tmp_path / "a")).restore(3, like)
    jc = JCheckpointer(str(tmp_path / "b"))
    jc.save(4, jtree, blocking=True)
    got, _ = Checkpointer(str(tmp_path / "b")).restore(
        4, ttree.map(torch.zeros_like, tree))
    _same(tree, got)


def test_retention_async_and_atomic_rename(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3, 4):
        ck.save(step, tree)            # each save waits for the last write
    ck.wait()
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000003", "step_00000004"]
    assert not any(n.endswith(".tmp") for n in names)
    # a half-written directory is never a checkpoint
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000010").mkdir()        # no manifest
    assert ck.latest_step() == 4


def test_restore_checks_shapes_and_places_on_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(1, tree, blocking=True)
    bad = ttree.map(torch.zeros_like, tree)
    bad["params"]["prefix"][0]["w"] = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, bad)
    got, _ = ck.restore(1, ttree.map(torch.zeros_like, tree), device="cpu")
    assert all(t.device.type == "cpu" for t in ttree.leaves(got))


def test_async_write_failure_surfaces_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    blocker = tmp_path / "step_00000002.tmp"
    ck.save(2, {"x": torch.zeros(2)})
    ck.wait()
    blocker.write_text("")                      # a file where a dir goes
    os.chmod(tmp_path, 0o500)
    try:
        ck.save(3, {"x": torch.zeros(2)})
        if os.geteuid() == 0:
            ck.wait()                           # root writes anyway
            return
        with pytest.raises(RuntimeError, match="async checkpoint"):
            ck.wait()
    finally:
        os.chmod(tmp_path, 0o700)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mp,batch,pods", [
    (8, 2, 64, 1), (7, 2, 64, 1), (16, 4, 128, 2), (12, 1, 32, 2),
    (3, 3, 9, 1)])
def test_elastic_plan_matches_reference(n, mp, batch, pods):
    a = jft.ElasticPlan.plan(n, mp, batch, want_pods=pods)
    b = tft.ElasticPlan.plan(n, mp, batch, want_pods=pods)
    assert (b.mesh_shape, b.axis_names, b.usable_devices,
            b.dropped_devices, b.global_batch) == \
        (a.mesh_shape, a.axis_names, a.usable_devices, a.dropped_devices,
         a.global_batch)
    assert b.microbatch_for(32, 2) == a.microbatch_for(32, 2)
    with pytest.raises(ValueError, match="model_parallel"):
        tft.ElasticPlan.plan(1, 2, batch)


def test_watchdog_flags_a_straggler():
    wd = tft.StepWatchdog(warmup_steps=2, threshold=2.0)
    seen = []
    wd.on_straggler = lambda s, dt, ew: seen.append(s)
    for step in range(5):
        wd.start()
        wd._t0 -= 0.01 if step != 4 else 1.0      # a slow fifth step
        wd.stop(step)
    assert seen == [4] and [f[0] for f in wd.flagged] == [4]


def test_preemption_handler_turns_a_signal_into_a_request():
    h = tft.PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    try:
        assert not h.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(100):
            if h.preempted:
                break
            time.sleep(0.01)
        assert h.preempted
    finally:
        h.uninstall()
