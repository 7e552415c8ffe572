"""The port's public surface against the JAX package's, on the CPU.

Held against the reference under the port's backend names
(``repro_torch.BACKEND_NAMES``): ``cost_model.bytes_moved`` (equal with
``plain=True`` over methods x sizes x item sizes x k x key widths x digit
widths; its two departures on the card each pinned to the pricing they
follow), ``planner.choose_method`` and ``planner.constants``,
``launch.steps.abstract_init`` (the leaves and specs of the reference's
``jax.eval_shape`` tree), the v1 ``sort_api.bitonic_sort`` shim (bit for
bit), ``repro_torch.core``'s re-exports, and a name-by-name walk of every
public top-level ``def`` / ``class`` / module-level assignment of the JAX
package, every name a package ``__init__`` re-exports from inside it and
every constant a module imports from inside it, each found in its
counterpart module or in the table of names the port gives another
(``RENAMED``, whose entries must not name a counterpart under the same
name).
"""
import ast
import importlib
import inspect
import itertools
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import repro.core as jcore
import repro_torch
import repro_torch.core as tcore
from _torch_parity import assert_same, to_torch
from repro.configs import get_smoke_config as jax_smoke
from repro.core import cost_model as jcm
from repro.core import sort_api as japi
from repro.engine import planner as jplanner
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro_torch import tree as ttree
from repro_torch import engine as tengine
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import cost_model as tcm
from repro_torch.core import sort_api as tapi
from repro_torch.core import tuning
from repro_torch.engine import planner as tplanner
from repro_torch.kernels.bitonic_topk import MAX_K
from repro_torch.launch import steps as tsteps
from repro_torch.models import model_zoo as tzoo

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_NAME = {**repro_torch.BACKEND_NAMES, "select": "select"}


# ---------------------------------------------------------------------------
# bytes_moved
# ---------------------------------------------------------------------------

def _departs(method, k) -> bool:
    """Where ``plain=False`` follows the port's pricing on the card."""
    return (method == "torch" and k is None) or \
        (method == "cuda" and k is not None and k <= MAX_K)


@pytest.mark.parametrize("k", [None, 1, 64])
@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 5, 4096, (1 << 20) + 3])
@pytest.mark.parametrize("jmethod", ["xla", "bitonic", "pallas", "merge",
                                     "radix", "select"])
def test_bytes_moved_matches_the_reference(jmethod, n, itemsize, k):
    """Equal with ``plain=True`` for every key width and digit width (a
    selection without k raises in both); off ``plain`` equal too, but for
    the two departures."""
    method = PORT_NAME[jmethod]
    for key_bits, digit_bits in itertools.product((16, 32, 64),
                                                  (None, 4, 8)):
        kw = dict(key_bits=key_bits, k=k, digit_bits=digit_bits)
        if jmethod == "select" and k is None:
            with pytest.raises(ValueError):
                jcm.bytes_moved(jmethod, n, itemsize, **kw)
            for plain in (True, False):
                with pytest.raises(ValueError):
                    tcm.bytes_moved(method, n, itemsize, plain=plain, **kw)
            continue
        want = jcm.bytes_moved(jmethod, n, itemsize, **kw)
        got = tcm.bytes_moved(method, n, itemsize, plain=True, **kw)
        assert got == want and type(got) is type(want), (kw, got, want)
        card = tcm.bytes_moved(method, n, itemsize, **kw)
        if not _departs(method, k):
            assert card == want, (kw, card, want)
        elif k is None:                     # torch.sort's 8-bit passes
            assert card == 2 * n * itemsize * -(-key_bits // 8)
        else:                               # K5's one pass
            assert card == n * itemsize + 2 * k * itemsize


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("method", ["imc", "distributed", "spill"])
def test_bytes_moved_refuses_unknown_methods(method, k):
    with pytest.raises(ValueError, match="bytes-moved"):
        jcm.bytes_moved(method, 4096, k=k)
    for plain in (True, False):
        with pytest.raises(ValueError, match="bytes-moved"):
            tcm.bytes_moved(method, 4096, k=k, plain=plain)


@pytest.mark.parametrize("key_bits", [8, 16, 32, 64])
def test_torch_sort_bytes_on_the_card_follow_device_sort_cost_ns(key_bits):
    """On the card ``torch.sort`` is priced by ``device_sort_cost_ns`` as
    a radix sort of 8-bit digits (``torch_card`` a key and pass); its
    bytes are a read and a write of every element a pass, whatever the
    profile's digit width."""
    c = tuning.active().constants
    for n, s in ((4096, 4), ((1 << 20) + 3, 2)):
        passes = -(-key_bits // 8)
        got = tcm.bytes_moved("torch", n, s, key_bits=key_bits,
                              digit_bits=4)
        assert got == 2 * n * s * passes
        cost = tcm.device_sort_cost_ns("torch", n, key_bits=key_bits,
                                       consts=c)
        assert cost == pytest.approx(c.torch_card * n * passes)


@pytest.mark.parametrize("k", [1, 50, MAX_K, MAX_K + 1, 1024])
def test_cuda_topk_bytes_on_the_card_follow_cuda_topk_cost_ns(k):
    """``cuda_topk_cost_ns`` prices K5's one pass for k <= MAX_K (the row
    once, not a sort) and the sort past it; the bytes follow: a read of
    the row and the k pairs written, else the sort and the k-prefix."""
    c = tuning.active().constants
    n, s = 1 << 17, 4
    cost = tcm.cuda_topk_cost_ns(n, k, consts=c)
    sort_cost = tcm.device_sort_cost_ns("cuda", n, consts=c)
    got = tcm.bytes_moved("cuda", n, s, k=k)
    if k <= MAX_K:
        assert cost < sort_cost
        assert got == n * s + 2 * k * s
    else:
        assert cost == sort_cost
        assert got == tcm.bytes_moved("cuda", n, s) + k * s == \
            jcm.bytes_moved("pallas", n, s, k=k)


# ---------------------------------------------------------------------------
# the planner's two small entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int8])
@pytest.mark.parametrize("n,batch", [(64, 1), (4096, 8), (1 << 20, 1)])
def test_choose_method_is_choose_s_method(n, batch, dtype):
    assert tplanner.choose_method(n, batch, dtype, device="cpu") == \
        tplanner.choose(n, batch, dtype, device="cpu").method
    assert tengine.choose_method is tplanner.choose_method
    default = inspect.signature(tplanner.choose).parameters["device"].default
    assert inspect.signature(tplanner.choose_method) \
        .parameters["device"].default == default


def test_constants_are_the_active_profile_s():
    assert tplanner.constants() is tuning.active().constants
    prof = tuning.TuningProfile(
        fingerprint=tuning.device_fingerprint(),
        constants=tuning.DeviceSortConstants(torch=7.5, select=11.0),
        source="calibrated")
    try:
        tuning.set_active(prof)
        assert tplanner.constants() is prof.constants
    finally:
        tuning.set_active(None)
    assert tplanner.constants() == tuning.DeviceSortConstants()
    # the seeds are the reference's, renamed
    jc = jplanner.constants()
    assert tplanner.constants().torch == jc.xla
    assert tplanner.constants().cuda == jc.pallas


# ---------------------------------------------------------------------------
# abstract_init
# ---------------------------------------------------------------------------

def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(jax.tree_util.keystr(p), x) for p, x in flat]


@pytest.mark.parametrize("arch", ["gemma-2b", "moonshot-v1-16b-a3b"])
def test_abstract_init_matches_the_reference(arch):
    jparams, jspecs = jsteps.abstract_init(jzoo.build(jax_smoke(arch)),
                                           jax.random.PRNGKey(0))
    model = tzoo.build(torch_smoke(arch), device="cpu")
    params, specs = tsteps.abstract_init(model,
                                         torch.Generator().manual_seed(0))
    got = ttree.leaves_with_path(params)
    want = _paths(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert isinstance(t, FakeTensor), path
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
    assert [(p, tuple(s)) for p, s in ttree.leaves_with_path(specs)] == \
        [(p, tuple(s)) for p, s in _paths(jspecs)]
    assert specs == model.param_specs()


def test_abstract_init_joins_an_active_fake_mode():
    """Inside a ``FakeTensorMode`` (the dry run's) the params are that
    mode's, so they mix with the step's other fake tensors."""
    model = tzoo.build(torch_smoke("gemma-2b"), device="cpu")
    mode = FakeTensorMode()
    with mode:
        params, _ = tsteps.abstract_init(model,
                                         torch.Generator().manual_seed(0))
        assert all(t.fake_mode is mode for t in ttree.leaves(params))


# ---------------------------------------------------------------------------
# sort_api.bitonic_sort
# ---------------------------------------------------------------------------

def _bitonic_inputs(n, axis, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (3, n) if axis == -1 else (n, 3)
    if dtype == "float32":     # rounded normals: ties
        x = np.round(rng.standard_normal(shape), 1).astype(np.float32)
    else:
        x = rng.integers(-9, 10, shape).astype(np.int32)
    return x, rng.integers(0, 1000, shape).astype(np.int32)


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("n", [5, 64, 100])
def test_bitonic_sort_shim_is_bit_exact(n, descending, axis, dtype,
                                        with_values, monkeypatch):
    x, v = _bitonic_inputs(n, axis, dtype, seed=n + axis)
    kw = dict(axis=axis, descending=descending)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = japi.bitonic_sort(jnp.asarray(x), **kw,
                                 values=jnp.asarray(v) if with_values
                                 else None)
    monkeypatch.setattr(tapi, "_warned", set())
    with pytest.warns(DeprecationWarning, match="bitonic_sort"):
        got = tapi.bitonic_sort(to_torch(x), **kw, device="cpu",
                                values=to_torch(v) if with_values else None)
    if not with_values:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert_same(w, g, f"n={n} {kw}")


# ---------------------------------------------------------------------------
# repro_torch.core and the whole public surface
# ---------------------------------------------------------------------------

def test_core_reexports_match_the_reference():
    assert tcore.__all__ == jcore.__all__
    from repro_torch.core import network, sortspec
    for name in tcore.__all__:
        obj = getattr(tcore, name)
        home = {"network": network, "cost_model": tcm}.get(name)
        if home is not None:
            assert obj is home
        elif name in ("sort", "argsort", "topk", "top_p_mask",
                      "bitonic_sort"):
            assert obj is getattr(tapi, name)
        else:
            assert obj is getattr(sortspec, name)


# reference names the port gives another name or home: module -> {name:
# (port module, names there)}; ROADMAP's table of the closed surface
RENAMED = {
    "core/backends.py": {"XlaBackend": ("core.backends", ["TorchBackend"]),
                         "PallasBackend": ("core.backends",
                                           ["CudaBackend"]),
                         "MAX_PALLAS_N": ("core.backends", ["MAX_CUDA_N"])},
    "core/cost_model.py": {"xla_topk_cost_ns": ("core.cost_model",
                                                ["native_topk_cost_ns"])},
    "core/topology.py": {
        "TIER_ICI": ("core.topology", ["TIER_NVLINK"]),
        "TIER_DCN": ("core.topology", ["TIER_NETWORK"]),
        # the network tier is priced by its own link constants, not as
        # the fast tier slowed down
        "DCN_SLOWDOWN": ("core.tuning", ["LinkConstants",
                                         "NETWORK_BYTES_PER_S"])},
    "core/tuning.py": {"DEFAULT_RUN_LEN": ("core.tuning",
                                           ["CUDA_RUN_LEN"])},
    "engine/runs.py": {"DEFAULT_RUN_LEN": ("core.tuning",
                                           ["CUDA_RUN_LEN",
                                            "DEFAULT_CPU_RUN_LEN"])},
    "kernels/merge_path.py": {"DEFAULT_CHUNK": ("kernels.merge_path",
                                                ["KERNEL_TILE"])},
    "launch/roofline.py": {"ICI_BW": ("launch.roofline", ["NVLINK_BW"])},
    "engine/planner.py": {"on_tpu": ("engine.planner", ["on_cuda"]),
                          "MAX_PALLAS_N": ("engine.planner",
                                           ["MAX_CUDA_N"])},
    "launch/steps.py": {"TrainStep": ("launch.steps", ["TrainGraph"])},
    "launch/hlo_analysis.py": {
        **{name: ("launch.hlo_analysis", ["OpTrace"])
           for name in ("parse_hlo", "Computation", "shape_bytes")},
        # XLA's collective op names -> torch's c10d ops, by the same kinds
        "COLLECTIVE_OPS": ("launch.hlo_analysis", ["COLLECTIVES"])},
    "launch/dryrun.py": {"collect_collectives": ("launch.hlo_analysis",
                                                 ["OpTrace"])},
    "data/pipeline.py": {"device_put_batch": ("launch.steps",
                                              ["place_batch"])},
    "kernels/bitonic_sort.py": {"default_block_rows": (
        "kernels.bitonic_sort", ["thread_keys", "shared_from", "MAX_N"])},
    "kernels/ref.py": {
        "bitonic_sort": ("kernels.bitonic_sort", ["apply_network"]),
        "bitonic_sort_kv": ("kernels.bitonic_sort", ["apply_network_kv"]),
        "bitonic_topk": ("kernels.bitonic_topk", ["topk_plain"]),
        "bitserial_cas": ("kernels.bitserial_cas", ["exec_program_plain"])},
}


def _from_repro(node) -> bool:
    """Whether an ``import from`` takes its names from inside the
    package (``repro.*`` or a relative import), not from a third party
    (jax, numpy, typing)."""
    return bool(node.level) or (node.module or "").split(".")[0] == "repro"


def _top_level(path: pathlib.Path):
    """(public names, every top-level bound name) of a file.  The public
    names: its ``def`` / ``class`` names and module-level assignments not
    starting with ``_``; the names a package ``__init__`` imports from
    inside the package (its re-exports); and the constants (upper-case
    names) any module imports from inside the package, as
    ``engine/planner.py`` re-exports ``core/backends``'s caps."""
    body = ast.parse(path.read_text()).body
    init = path.name == "__init__.py"
    defs = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            defs.add(n.name)
        elif isinstance(n, ast.Assign):
            defs |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            defs.add(n.target.id)
        elif isinstance(n, ast.ImportFrom) and _from_repro(n):
            defs |= {a.asname or a.name for a in n.names
                     if init or (a.asname or a.name).isupper()}
    defs = {d for d in defs if not d.startswith("_")}
    bound = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            bound.add(n.name)
        elif isinstance(n, ast.Assign):
            bound |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            bound.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            bound |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return defs, bound


def test_every_public_name_of_the_reference_has_a_counterpart():
    missing = []
    for ref in sorted((ROOT / "src" / "repro").rglob("*.py")):
        rel = ref.relative_to(ROOT / "src" / "repro").as_posix()
        defs, _ = _top_level(ref)
        port = ROOT / "src" / "repro_torch" / rel
        bound = _top_level(port)[1] if port.exists() else set()
        renamed = RENAMED.get(rel, {})
        for name in sorted(defs - bound):
            if name not in renamed:
                missing.append(f"{rel}:{name}")
                continue
            mod, targets = renamed[name]
            home = importlib.import_module(f"repro_torch.{mod}")
            assert all(hasattr(home, t) for t in targets), (rel, name)
    assert not missing, missing


def test_renamed_names_have_no_counterpart_under_their_own_name():
    """A ``RENAMED`` entry is for a name the port does not bind in its
    counterpart module: one it binds there under its own name is no
    rename."""
    same = []
    for rel, names in RENAMED.items():
        port = ROOT / "src" / "repro_torch" / rel
        bound = _top_level(port)[1] if port.exists() else set()
        same += [f"{rel}:{n}" for n in names if n in bound]
    assert not same, same


def test_sharding_package_reexports_the_policy():
    import repro.sharding as jsharding
    import repro_torch.sharding as tsharding
    from repro_torch.sharding import partitioning
    for name in ("ShardingPolicy", "NO_SHARDING"):
        assert hasattr(jsharding, name)
        assert getattr(tsharding, name) is getattr(partitioning, name)
    assert tsharding.NO_SHARDING.mesh is None
    assert not tsharding.NO_SHARDING.places

