"""The port's sharding specs against the JAX package's, exactly.

The reference's spec functions read only the mesh's axis sizes, so both
sides run on abstract meshes (``jax.sharding.AbstractMesh`` and
``repro_torch.sharding.partitioning.AbstractMesh``) of the production
shapes 16 x 16 and 2 x 16 x 16, and of 2 x 2: no device, no process group.
The reference's trees come from ``jax.eval_shape`` (``steps.abstract_init``,
its optimizers' ``init``, ``decode_state``), the port's from the same
calls under ``FakeTensorMode``: nothing is allocated, so every
architecture is checked at its full size.

Checked for equality, entry for entry: ``kv_repeat``, ``_heads_spec``,
``_cache_spec`` and ``_sanitize`` over grids of head counts and
dimensions; each architecture's parameter specs (raw, in the reference's
leaf order and paths, and sanitized against the parameters' shapes);
``serve_param_specs`` with ``keep_data`` both ways; ``state_specs`` of
AdamW and Adafactor; ``batch_specs`` of each cell kind; the decode state's
specs in the tp and dp layouts.  Plus the spec -> DTensor placement rule.
"""
import functools
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.launch.mesh import dp_axes_of as jdp_axes_of
from repro.models import model_zoo as jzoo
from repro.optim import optimizers as jopt
from repro.sharding.partitioning import ShardingPolicy as JPolicy
from repro_torch import tree as ttree
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import dp_axes_of as tdp_axes_of
from repro_torch.models import model_zoo as tzoo
from repro_torch.optim import optimizers as topt
from repro_torch.sharding.partitioning import P as TP
from repro_torch.sharding.partitioning import AbstractMesh as TAbstractMesh
from repro_torch.sharding.partitioning import ShardingPolicy as TPolicy
from repro_torch.sharding.partitioning import placements_of

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
PROD = ("16x16", "2x16x16")


def _meshes(name):
    shape, axes = MESHES[name]
    return JAbstractMesh(shape, axes), TAbstractMesh.of(shape, axes)


def _policies(name, **kw):
    jm, tm = _meshes(name)
    return (JPolicy(mesh=jm, dp_axes=jdp_axes_of(jm), **kw),
            TPolicy(mesh=tm, dp_axes=tdp_axes_of(tm), **kw))


def _ref(tree):
    """[(path, spec entries)] of a reference spec tree, in leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _port(tree):
    return [(p, tuple(s)) for p, s in ttree.leaves_with_path(tree)]


def _same(ref, port, paths=True):
    r, t = _ref(ref), _port(port)
    if paths:
        assert r == t
    else:                    # NamedTuple fields print differently
        assert [s for _, s in r] == [s for _, s in t]
        assert len(r) == len(t)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    model = jzoo.build(jax_config(arch))
    params, specs = jsteps.abstract_init(model, jax.random.PRNGKey(0))
    return model, params, specs


_FAKE = FakeTensorMode()        # one mode: fake tensors of two don't mix


@functools.lru_cache(maxsize=None)
def _torch_model(arch):
    model = tzoo.build(torch_config(arch), device="cpu")
    with _FAKE:
        params = model.init(torch.Generator().manual_seed(0))
    return model, params, model.param_specs()


# ---------------------------------------------------------------------------
# the policy's own rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serve_layout", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_heads_cache_and_repeat_rules(mesh, serve_layout):
    jp, tp = _policies(mesh, serve_layout=serve_layout)
    assert (jp.tp_size, jp.dp_size) == (tp.tp_size, tp.dp_size)
    for n_kv, n in itertools.product((1, 2, 4, 6, 8, 16, 32),
                                     (1, 4, 6, 8, 16, 32, 48, 96, 128)):
        assert jp.kv_repeat(n_kv, n) == tp.kv_repeat(n_kv, n), (n_kv, n)
    for n, h in itertools.product((1, 2, 6, 8, 16, 24, 96),
                                  (16, 32, 64, 128, 192, 256)):
        assert tuple(jp._heads_spec(n, h)) == tuple(tp._heads_spec(n, h))
        assert tuple(jp._cache_spec(n, h)) == tuple(tp._cache_spec(n, h))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize(mesh):
    jp, tp = _policies(mesh)
    entries = (None, "data", "model", "pod", ("data", "model"),
               ("pod", "data"), ("pod", "data", "model"))
    shapes = ((1, 51865), (16, 256), (2, 3072), (256, 4096), (8, 1))
    for a, b in itertools.product(entries, repeat=2):
        for shape in shapes:
            assert tuple(jp._sanitize(JP(a, b), shape)) == \
                tuple(tp._sanitize(TP(a, b), shape)), (a, b, shape)
    # a spec longer than the shape, and a one-axis tuple
    assert tuple(tp._sanitize(TP(("data",), "model", "data"), (32, 32))) \
        == tuple(jp._sanitize(JP(("data",), "model", "data"), (32, 32)))


def test_spec_entries_normalise_as_the_reference():
    for entries in (((("data",), None)), (((), "model")),
                    ((("pod", "data"), None, "model"))):
        assert tuple(TP(*entries)) == tuple(JP(*entries))


def test_placements_of_is_data_major():
    _, tm = _meshes("16x16")
    assert placements_of(TP("data", "model"), tm) == (Shard(0), Shard(1))
    assert placements_of(TP(None, ("data", "model")), tm) == (Shard(1),
                                                              Shard(1))
    assert placements_of(TP("model", None), tm) == (Replicate(), Shard(0))
    assert placements_of(TP(), tm) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        placements_of(TP(("model", "data")), tm)
    _, tm3 = _meshes("2x16x16")
    assert placements_of(TP(("pod", "data"), None, "model"), tm3) == (
        Shard(0), Shard(0), Shard(2))
    # a spec tree, leaf for leaf
    assert tsteps.shardings_of({"a": [TP("data"), TP()]}, tm) == {
        "a": [(Shard(0), Replicate()), (Replicate(), Replicate())]}
    assert tsteps.shardings_of({"a": TP()}, None) is None


# ---------------------------------------------------------------------------
# parameters and optimizer state of every architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", PROD)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs(arch, mesh):
    _, jparams, jspecs = _jax_model(arch)
    _, tparams, tspecs = _torch_model(arch)
    _same(jspecs, tspecs)
    # the same leaves, of the same shapes
    assert [tuple(x.shape) for x in jax.tree.leaves(jparams)] == \
        [tuple(x.shape) for x in ttree.leaves(tparams)]
    jm, tm = _meshes(mesh)
    _same(jsteps.sanitize_specs(jspecs, jparams, jm),
          tsteps.sanitize_specs(tspecs, tparams, tm))


@pytest.mark.parametrize("keep_data", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_param_specs(arch, keep_data):
    _, jparams, jspecs = _jax_model(arch)
    _, tparams, tspecs = _torch_model(arch)
    jp, tp = _policies("16x16", serve_layout=True)
    for sub in ("prefix", "body", "enc", "dec"):
        if sub in jspecs:
            _same(jp.serve_param_specs(jspecs[sub], keep_data=keep_data),
                  tp.serve_param_specs(tspecs[sub], keep_data=keep_data))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_specs(arch, optimizer):
    _, jparams, jspecs = _jax_model(arch)
    tmodel, tparams, tspecs = _torch_model(arch)
    sched_j = jopt.cosine_schedule(1e-3, 10, 100)
    sched_t = topt.cosine_schedule(1e-3, 10, 100)
    jo = getattr(jopt, optimizer)(sched_j)
    to = getattr(topt, optimizer)(sched_t)
    jstate = jax.eval_shape(jo.init, jparams)
    with _FAKE:
        tstate = to.init(tparams)
    jm, tm = _meshes("16x16")
    _same(jsteps.sanitize_specs(jo.state_specs(jspecs, jparams), jstate, jm),
          tsteps.sanitize_specs(to.state_specs(tspecs, tparams), tstate, tm))


# ---------------------------------------------------------------------------
# batches and decode states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", PROD)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs(arch, mesh):
    jmodel = _jax_model(arch)[0]
    tmodel = _torch_model(arch)[0]
    jp, tp = _policies(mesh)
    jm, tm = _meshes(mesh)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        jshape, tshape = JSHAPES[name], TSHAPES[name]
        _same(jsteps.sanitize_specs(jsteps.batch_specs(jmodel, jshape, jp),
                                    jmodel.input_specs(jshape), jm),
              tsteps.sanitize_specs(tsteps.batch_specs(tmodel, tshape, tp),
                                    tmodel.input_specs(tshape), tm))


def _jax_state(arch, policy, shape):
    cfg = jax_config(arch)
    model = jzoo.build(cfg, policy=policy)
    if model.is_encdec:
        params = jsteps.abstract_init(model, jax.random.PRNGKey(0))[0]
        batch = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 32),
                                                jax.numpy.int32),
                 "frames": jax.ShapeDtypeStruct(
                     (shape.global_batch, cfg.enc_seq, cfg.d_model),
                     jax.numpy.bfloat16)}
        return jax.eval_shape(
            lambda p, b: model.prefill(p, b, max_len=shape.seq_len)[1],
            params, batch)
    return jax.eval_shape(lambda: model.decode_state(shape.global_batch,
                                                     shape.seq_len))


def _torch_state(arch, policy, shape):
    cfg = torch_config(arch)
    model = tzoo.build(cfg, device="cpu", policy=policy)
    b = shape.global_batch
    with _FAKE:
        if model.is_encdec:
            params = model.init(torch.Generator().manual_seed(0))
            return model.prefill(params, {
                "tokens": torch.zeros((b, 32), dtype=torch.int32),
                "frames": torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.bfloat16)},
                max_len=shape.seq_len)[1]
        return model.decode_state(b, shape.seq_len)


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs(arch, layout):
    jp, tp = _policies("16x16", serve_layout=layout == "dp")
    jm, tm = _meshes("16x16")
    shape = "decode_32k"
    jstate = _jax_state(arch, jp, JSHAPES[shape])
    tstate = _torch_state(arch, tp, TSHAPES[shape])
    assert [tuple(x.shape) for x in jax.tree.leaves(jstate)] == \
        [tuple(x.shape) for x in ttree.leaves(tstate)]
    _same(jsteps.sanitize_specs(jsteps.decode_state_specs(jstate, jp),
                                jstate, jm),
          tsteps.sanitize_specs(tsteps.decode_state_specs(tstate, tp),
                                tstate, tm), paths=False)
