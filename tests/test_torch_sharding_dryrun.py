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
"""
import dataclasses
import math

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as ttree
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, roofline
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
