"""The mesh tier's rank form: one program a rank over ``torch.distributed``
collectives, the counterpart of the JAX package's ``shard_map`` programs.

Four ``gloo`` CPU processes (``tests/_torch_ranks_worker.py``) are
started once for the module, beside one subprocess that runs the JAX
package with four forced host devices; each rank runs every case on a
``(4,)`` ``("data",)`` and a ``(2, 2)`` ``("host", "dev")`` DeviceMesh
and reports its checks.  Every case is held, bit for bit, to:

  1. the one-process ``core.mesh.Mesh`` path over the same shards, the
     permutations included, and the counter bytes (``samplesort.*``,
     ``collectives.*``, ``distsort.*``) summed over the ranks;
  2. numpy's stable order (floats by their bits: -0.0 below +0.0, the
     sort's order; top-k by key descending, then index);
  3. the JAX package at D = 4 where jax 0.9.0 runs it: evenly divisible
     lengths (the reference's gather of a padded array fails under 0.9.0)
     on ``jax.make_mesh((4,))`` and ``(2, 2)``: sorts both ways, a
     key-value sort's keys, odd-even, the two-level and the flat sort on
     (2, 2), and top-k values and indices.

Then the launchers' data mesh on the ``(4,)`` mesh: the serve scheduler
at uneven backlogs (bit for bit against the mesh-free scheduler, one on
numpy's stable order, and the reference's ``LengthSortedScheduler(mesh=)``
at D = 4, which raises under jax 0.9.0 at a backlog that four does not
divide: there numpy's order holds it), ``serve`` under the data policy,
and the policy's gradients.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from _torch_ranks_worker import (DTYPES, KINDS, OPS,  # noqa: E402
                                 SCHED_BACKLOGS, SCHED_BATCH,
                                 SCHED_REF_BATCHES, TOPK_K)

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.engine import samplesort as ss
from repro.core import distributed_sort as ds
mesh = jax.make_mesh((4,), ("data",))
m2 = jax.make_mesh((2, 2), ("host", "dev"))
SCHED_BACKLOGS, SCHED_BATCH, SCHED_REF_BATCHES = %r, %d, %d
inp = dict(np.load(sys.argv[1]))
X, XI = jnp.asarray(inp["x"]), jnp.asarray(inp["xi"])
out = {}
out["sort"] = np.asarray(ss.sample_sort(X, mesh, "data"))
out["sort_desc"] = np.asarray(ss.sample_sort(X, mesh, "data",
                                             descending=True))
out["sort_int_hist"] = np.asarray(ss.sample_sort(XI, mesh, "data",
                                                 use_histogram=True))
k, _ = ss.sample_sort(X, mesh, "data", values=jnp.asarray(inp["v"]))
out["kv_keys"] = np.asarray(k)
out["oddeven"] = np.asarray(ds.distributed_sort(X, mesh, "data",
                                                strategy="oddeven"))
for k_ in (1, 64, 500):
    tv, ti = ss.sample_topk(XI, k_, mesh, "data")
    out[f"topk{k_}_v"], out[f"topk{k_}_i"] = np.asarray(tv), np.asarray(ti)
out["hier"] = np.asarray(ss.sample_sort(X, m2, None))
out["flat2x2"] = np.asarray(ss.sample_sort(X, m2, None, hierarchical=False))
tv, ti = ds.distributed_topk(X, 50, m2, None)
out["topk2x2_v"], out["topk2x2_i"] = np.asarray(tv), np.asarray(ti)
# the serve scheduler on the mesh: its first batches, or that it raised
from repro.launch.serve import LengthSortedScheduler, Request
for n in SCHED_BACKLOGS:
    lens = np.random.default_rng(n).integers(4, 4096, n)
    s = LengthSortedScheduler(SCHED_BATCH, mesh=mesh)
    for i, l in enumerate(lens):
        s.submit(Request(rid=i, prompt=np.zeros(int(l), np.int32)))
    try:
        out[f"sched{n}"] = np.asarray(
            [[r.rid for r in s.next_batch()]
             for _ in range(SCHED_REF_BATCHES)])
    except Exception as e:
        out[f"sched{n}_raised"] = np.asarray(type(e).__name__)
np.savez(sys.argv[2], **out)
print("REF4_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    np.savez(out / "inputs.npz",
             x=rng.standard_normal(4 * 512).astype(np.float32),
             xi=rng.integers(-50, 50, 4 * 384).astype(np.int32),
             v=np.arange(4 * 512, dtype=np.int32))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ref_env = {**env, "PYTHONPATH": os.path.join(ROOT, "src"),
               "JAX_PLATFORMS": "cpu"}
    ref_env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % (SCHED_BACKLOGS, SCHED_BATCH,
                                             SCHED_REF_BATCHES),
         str(out / "inputs.npz"),
         str(out / "ref.npz")], env=ref_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_ranks_worker.py"),
         str(r), str(WORLD), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.time() + 300
    logs = []
    for p in procs + [ref]:
        try:
            logs.append(p.communicate(timeout=max(1, deadline - time.time()))
                        [0])
        except subprocess.TimeoutExpired:
            for q in procs + [ref]:
                q.kill()
            raise
    res = []
    for r in range(WORLD):
        path = out / f"rank{r}.json"
        assert path.exists(), f"rank {r} wrote nothing:\n{logs[r][-4000:]}"
        res.append(json.loads(path.read_text()))
    assert "REF4_OK" in logs[-1], logs[-1][-3000:]
    return {"ranks": res, "ref": dict(np.load(out / "ref.npz")),
            "got": dict(np.load(out / "ranks.npz"))
            if (out / "ranks.npz").exists() else None}


def _all(ranks, name):
    """Each rank's value of check ``name`` (no rank may have failed it)."""
    vals = []
    for r, got in enumerate(ranks["ranks"]):
        assert name not in got["errors"], f"rank {r}: {got['errors'][name]}"
        vals.append(got["checks"][name])
    return vals


def _true(tree) -> bool:
    if isinstance(tree, dict):
        return all(_true(v) for v in tree.values())
    return tree is True


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_sort_argsort_sort_kv_both_ways(ranks, mesh, dtype, kind):
    """sort, argsort and sort_kv both ways: an uneven length (4 m - 3),
    fewer keys than ranks, and duplicate-heavy keys (stability): each
    rank's shard equals the one-process path's, the ranks' counter bytes
    sum to its counts, and the gathered result is numpy's stable order."""
    for op in OPS:
        for d in ("asc", "desc"):
            for r, v in enumerate(_all(ranks, f"{mesh}/{dtype}/{kind}/"
                                              f"{op}/{d}")):
                assert v == {"one_process": True, "counters": True,
                             "numpy": True}, (r, op, d, v)


@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_capacity_chunks_and_the_int8_codec(ranks, mesh):
    """pipeline_chunks 1 / 2 / 4, the int8 codec on a float payload and
    (flat) a capacity override and its error, as the one-process path."""
    for r, v in enumerate(_all(ranks, f"{mesh}/options")):
        assert _true(v), (r, v)
        if mesh == "flat":
            assert v["capacity_error"] is True


@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_dtensor_front_door_and_no_fallback(ranks, mesh):
    """``repro_torch.sort`` and ``SortSpec`` with a DeviceMesh: a DTensor
    placed Shard(0) in, one of the same placement out, top-k replicated;
    a plain tensor, a shard off the mesh's device and a collective the
    backend refuses raise (the last naming the collective and gloo)."""
    for r, v in enumerate(_all(ranks, f"{mesh}/front_door")):
        assert _true(v), (r, v)


@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_distributed_sort_strategies(ranks, mesh):
    """``distributed_sort``: sample and odd-even (flat) or the two-level
    sort (2 x 2), and auto, as the one-process path; the pinned
    strategies' counter bytes too."""
    for r, v in enumerate(_all(ranks, f"{mesh}/strategies")):
        assert _true(v), (r, v)


@pytest.mark.parametrize("k", TOPK_K)
@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_topk_ties_and_signed_zeros(ranks, mesh, k):
    """The mesh top-k at k = 1, 64 and k > m, over integer ties and over
    signed zeros: replicated on every rank, as the one-process path, and
    numpy's (key descending, +0.0 above -0.0, lower index first)."""
    for r, v in enumerate(_all(ranks, f"{mesh}/topk")):
        for data in ("ties", "zeros"):
            assert _true(v[f"{data}_k{k}"]), (r, data, v[f"{data}_k{k}"])


@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_relational_ops_replicated(ranks, mesh):
    """unique, group_by and join with a DeviceMesh: the rank sort as the
    backbone, the post-pass on every rank; each as the one-process mesh
    op and numpy (unique values and counts, per-group sums, the pair
    count)."""
    for r, v in enumerate(_all(ranks, f"{mesh}/relational")):
        assert _true(v), (r, v)


@pytest.mark.parametrize("mesh", ["flat", "two"])
def test_topology_tiers_and_calibration(ranks, mesh):
    """gloo ranks on one host's CPU share one device: every axis is tier
    ``local``; a calibration leaves every rank the same numbers (the
    slowest rank's), so all ranks plan alike."""
    vals = _all(ranks, f"{mesh}/topology")
    n_axes = 1 if mesh == "flat" else 2
    for v in vals:
        assert v["tiers"] == ["local"] * n_axes
    assert all(v["calibrated"] == vals[0]["calibrated"] for v in vals)


REF_KEYS = ("sort", "sort_desc", "sort_int_hist", "kv_keys", "oddeven",
            "topk1_v", "topk1_i", "topk64_v", "topk64_i", "topk500_v",
            "topk500_i", "hier", "flat2x2", "topk2x2_v", "topk2x2_i")


@pytest.mark.parametrize("key", REF_KEYS)
def test_ranks_match_the_reference_at_d4(ranks, key):
    """The rank form's gathered results equal the JAX package's
    ``shard_map`` programs on four devices, bit for bit."""
    assert all(_all(ranks, "reference_outputs"))
    got, ref = ranks["got"][key], ranks["ref"][key]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("n", SCHED_BACKLOGS)
def test_scheduler_on_the_data_mesh(ranks, n):
    """The serve scheduler on the (4,) ``data`` DeviceMesh (fault 3i's
    repair: the policy's mesh, every rank sorting its uneven slice of the
    backlog): every batch whose backlog reaches ``distributed_min`` sorted
    over the mesh, then two local ones, bit-equal on every rank to the
    mesh-free scheduler's and to a scheduler on numpy's stable order; the
    first batches equal the reference's at D = 4, or, where the reference
    raises under jax 0.9.0 (a backlog four does not divide), numpy's."""
    vals = _all(ranks, f"data/scheduler/{n}")
    for r, v in enumerate(vals):
        assert v["mesh_sorts"] == (n - 4096) // SCHED_BATCH + 1, (r, v)
        assert v["equal_mesh_free"] and v["equal_numpy"], (r, v)
        assert v["first"] == vals[0]["first"]
    ref = ranks["ref"]
    if f"sched{n}" in ref:
        assert ref[f"sched{n}"].tolist() == vals[0]["first"]
    else:
        assert str(ref[f"sched{n}_raised"]) == "ShardingTypeError"
        assert n % 4
    assert len(vals[0]["first"]) == SCHED_REF_BATCHES


def test_serve_under_the_data_policy(ranks):
    """``serve`` of the float32 smoke minitron under the data policy on
    the (4,) mesh: its tokens equal the unsharded serve's on every rank;
    the distributed queue is on and its scheduler sorts over the policy's
    DeviceMesh (``distributed_min`` cut to 4 so the backlog of 8 reaches
    it); rank 0 alone writes the snapshot (profile and topology), which
    every rank restores on the same mesh."""
    for r, v in enumerate(_all(ranks, "data/serve")):
        assert v["tokens_equal"] and v["requests"] == 8, (r, v)
        assert v["distributed_queue"] is True and v["mesh_sorts"] == 2
        assert v["scheduler_on_the_mesh"] is True
        assert v["snapshot_files"] == ([2] if r == 0 else [0]), (r, v)
        assert v["restored"] == ["tuning profile", "topology"], (r, v)


def test_data_policy_gradients(ranks):
    """The data policy on a mesh without a ``model`` axis: the specs'
    ``model`` entries dropped (the reference's ``sanitize_specs``), the
    FSDP ``data`` entries kept; the float32 smoke moonshot's loss and
    gradients against the unsharded model's."""
    for r, v in enumerate(_all(ranks, "data/gradients")):
        assert v["loss_rel"] <= 1e-6 and v["grad_rel"] <= 2e-5, (r, v)
        assert v["sharded_leaves"] > 0 and "R" in v["placements"], (r, v)
