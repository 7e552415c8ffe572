"""The dry run on the production 16 x 16 mesh (a ``fake`` process group of
256 ranks in this process, rank 0's program traced on fake tensors).

A minitron-4b ``train_4k`` cell under the reference's plan (2 microbatches,
sequence parallelism) is traced at two and three depth units and
extrapolated to its 32 layers, as ``fit_depth`` and the full-size cells
are: its per-device argument bytes are exactly the local shard sizes its
specs imply (parameters, AdamW's master and moments, the batch); it moves
bytes over the mesh; its per-device flops are within the bounds one of
256 ranks can take.  A context-parallel ``prefill_32k`` cell with K6 traces (K6's
custom op under ``FakeTensorMode``).  The fake group is gone afterwards.

The DP-heavy serve layouts: the five cells that once failed (a
sequence-sharded cache filled by a prompt shorter than it or past its
window; whisper's 1500 frames over 16 'model' ranks under ``cp``) trace
at full size; recurrentgemma-2b's windowed caches shard their sequence
under ``dp``.  The dry run's overrides: ``seq_shard=False`` takes a train
cell's sequence parallelism away, and ``--both-meshes`` writes a record
for each production mesh.
"""
import dataclasses
import json
import math
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as ttree
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.models.model_zoo import build
from repro_torch.sharding.partitioning import AbstractMesh, ShardingPolicy

MESH = AbstractMesh.of((16, 16), ("data", "model"))
ARCH = "minitron_4b"


def _local_bytes(specs, tree):
    """Bytes of each leaf's shard under its (sanitized) spec."""
    pol = ShardingPolicy(mesh=MESH)
    axes = dict(zip(MESH.mesh_dim_names, MESH.shape))
    total = 0
    for spec, t in zip(ttree.leaves(specs), ttree.leaves(tree)):
        n = 1
        for entry in pol._sanitize(spec, tuple(t.shape)):
            for a in (entry if isinstance(entry, tuple) else
                      (entry,) if entry else ()):
                n *= axes[a]
        total += math.prod(t.shape) // n * t.element_size()
    return total


def test_train_cell_on_the_16x16_mesh():
    plan = dryrun.TRAIN_PLAN[ARCH]
    rec = dryrun.lower_cell(ARCH, "train_4k", mesh="16x16", verbose=False)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["traced"]["units"] == [2, 3]
    assert rec["plan"]["seq_shard"] and rec["plan"]["microbatch"] == 2

    # the arguments: every leaf's shard, as the specs place it
    cfg, shape = get_config(ARCH), SHAPES["train_4k"]
    model = build(cfg, device="cpu")
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
        _, opt = tsteps.make_train_step(model, cfg, shape)
        state = opt.init(params)
    specs = model.param_specs()
    batch = model.input_specs(shape)
    want = (_local_bytes(specs, params)
            + _local_bytes(opt.state_specs(specs, params), state)
            + _local_bytes(tsteps.batch_specs(model, shape,
                                              ShardingPolicy(mesh=MESH)),
                           batch))
    assert rec["memory"]["argument_bytes"] == want
    assert plan.optimizer == "adamw"

    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and coll["counts"]["all-gather"] > 0
    assert coll["total_bytes"] == sum(coll["bytes"].values())
    assert rec["hlo_analysis"]["collective_total_bytes"] == \
        coll["total_bytes"]
    # one rank's flops: more than the model's 6 N T over 256 (remat's
    # forward, the attention the parameter count leaves out, and
    # minitron's 24 heads, which the policy keeps whole on each of the 16
    # 'model' ranks), far less than a one-rank program's
    model_flops = roofline.model_flops_per_device(rec)
    assert 1.0 < rec["flops"] / model_flops < 16.0
    row = roofline.analyze_record(rec)
    assert row["t_collective_s"] > 0


def test_context_parallel_flash_prefill_traces():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=4096)
    rec = dryrun.lower_cell(ARCH, "prefill_32k", cfg=cfg, shape=shape,
                            mesh="16x16", layout="cp", flash=True,
                            verbose=False)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["plan"]["layout"] == "cp" and \
        rec["plan"]["flash"]
    assert rec["flops"] > 0 and rec["collectives"]["total_bytes"] > 0


# the cells of the serve layouts that failed before the sequence-sharded
# fill and the even shards of ``layers.matmul``
SERVE_CELLS = [("recurrentgemma_2b", "prefill_32k", "dp"),
               ("recurrentgemma_2b", "prefill_32k", "cp"),
               ("whisper_tiny", "decode_32k", "dp"),
               ("whisper_tiny", "prefill_32k", "cp"),
               ("whisper_tiny", "decode_32k", "cp")]


@pytest.mark.parametrize("arch,shape,layout", SERVE_CELLS)
def test_serve_layout_cells_trace(arch, shape, layout):
    rec = dryrun.lower_cell(arch, shape, mesh="16x16", layout=layout,
                            verbose=False)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["plan"]["layout"] == layout, rec.get("reason")
    assert 0 < rec["memory"]["peak_bytes"] <= dryrun.H100_BYTES
    assert rec["flops"] > 0 and rec["collectives"]["total_bytes"] > 0


def test_windowed_caches_shard_the_sequence_under_dp():
    cfg, shape = get_config("recurrentgemma_2b"), SHAPES["decode_32k"]
    mesh = mesh_lib.make_production_mesh()
    try:
        policy = dryrun.make_policy(mesh, dryrun.CellPlan(layout="dp"),
                                    shape)
        model = build(cfg, device="cpu", policy=policy)
        with FakeTensorMode():
            state = model.decode_state(shape.global_batch, shape.seq_len)
        caches = [x for x in ttree.leaves(state) if x.dim() == 4]
        on = mesh.mesh_dim_names.index("model")
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers))
        assert n_attn and len(caches) == 2 * n_attn       # K and V
        assert all(x.shape[1] == cfg.window for x in caches)
        assert all(x.placements[on].is_shard(1) for x in caches)
        assert all(x.to_local().shape[1] == cfg.window // 16
                   for x in caches)
    finally:
        mesh_lib.release_fake_world()


def test_seq_shard_override_changes_a_train_cell():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=32)
    recs = {flag: dryrun.lower_cell(ARCH, "train_4k", cfg=cfg, shape=shape,
                                    mesh="16x16", seq_shard=flag,
                                    verbose=False)
            for flag in (None, False)}
    assert not dist.is_initialized()
    assert recs[None]["plan"]["seq_shard"]            # the reference's plan
    assert not recs[False]["plan"]["seq_shard"]
    # sequence parallelism reduce-scatters each block's output and
    # gathers each block's input; without it neither happens on the
    # sequence, and the activations are whole on each 'model' rank
    assert recs[None]["collectives"]["counts"] != \
        recs[False]["collectives"]["counts"]


def test_both_meshes_writes_a_record_for_each(tmp_path, monkeypatch):
    """The CLI on a cut prefill cell (2 layers, 32 x 64 tokens) under the
    ``dp`` layout: one record a production mesh, each with the CLI's
    overrides in its plan."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=32)
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    monkeypatch.setitem(dryrun.SHAPES, "prefill_32k", shape)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", ARCH, "--shape", "prefill_32k", "--both-meshes",
        "--layout", "dp", "--seq-shard", "1", "--tag", "t"])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    assert not dist.is_initialized()
    names = sorted(f.name for f in tmp_path.iterdir())
    assert names == [f"{ARCH}_prefill_32k_16x16_t.json",
                     f"{ARCH}_prefill_32k_2x16x16_t.json"]
    for name, n in zip(names, (256, 512)):
        rec = json.loads((tmp_path / name).read_text())
        assert rec["ok"] and rec["n_devices"] == n and rec["n_layers"] == 2
        assert rec["plan"]["layout"] == "dp" and rec["plan"]["seq_shard"]


@pytest.mark.parametrize("argv,meshes", [
    ([], {"1"}), (["--mesh", "16x16"], {"16x16"}),
    (["--both-meshes"], {"16x16", "2x16x16"})])
def test_all_sweeps_the_mesh_it_is_given(monkeypatch, argv, meshes):
    """A departure from the reference, whose ``--all`` always takes both
    production meshes: the port's sweeps the one ``--mesh`` (one card by
    default) unless ``--both-meshes`` is given.  ``run_cell`` is replaced
    by a recorder: nothing is traced."""
    calls = []
    monkeypatch.setattr(dryrun, "run_cell", lambda arch, shape, tag="", **kw:
                        calls.append((arch, shape, kw["mesh"])) or {})
    monkeypatch.setattr(sys, "argv", ["dryrun", "--all", *argv])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    assert {m for _, _, m in calls} == meshes
    cells = {(a, s) for a, s, _ in calls}
    assert len(cells) == len(dryrun.ARCH_IDS) * len(SHAPES)
    assert len(calls) == len(cells) * len(meshes)
