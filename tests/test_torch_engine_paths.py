"""The slice as a whole, part two: key-value sorts, top-k, the card's
route through the kernels' plain versions and gradients against the JAX
package (bit for bit, same profile, ``repro_torch.BACKEND_NAMES``); then
the planner, the profile, the device rules, the fields not carried yet and
the port's import isolation.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sort as jsort
import repro_torch
import repro_torch.sort as tsort
from _torch_parity import assert_same, keys, to_torch
from repro import engine as jengine
from repro.core import tuning as jtuning
from repro_torch import convert, engine as tengine
from repro_torch.core import tuning as ttuning

RUN_LEN = 512


@pytest.fixture(scope="module", autouse=True)
def shared_profile():
    """The port runs on the JAX package's active profile, converted."""
    prof = convert.profile_from_jax(jtuning.active().to_dict())
    ttuning.set_active(prof)
    yield prof
    ttuning.set_active(None)


def _n(method: str) -> int:
    # the pallas reference runs in interpret mode and the bitonic one op by
    # op over the padded row: keep their rows short
    return {"pallas": 700, "bitonic": 1000}.get(method, 3000)


def _pair(method):
    return method, repro_torch.BACKEND_NAMES[method]


@pytest.mark.parametrize("method", ["xla", "bitonic", "merge", "radix"])
@pytest.mark.parametrize("payload", ["int32", "float32"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_kv_matches_reference(method, payload, descending):
    jm, tm = _pair(method)
    k = keys("int32", (2, _n(method)), "dup_heavy", seed=9)
    v = np.random.default_rng(9).integers(-50, 50, size=k.shape) \
        .astype(payload)
    rk, rv = jsort.sort_kv(jnp.asarray(k), jnp.asarray(v), method=jm,
                           descending=descending, run_len=RUN_LEN)
    gk, gv = tsort.sort_kv(to_torch(k), to_torch(v), method=tm,
                           descending=descending, run_len=RUN_LEN,
                           device="cpu")
    assert_same(rk, gk, "keys")
    assert_same(rv, gv, "payload")


@pytest.mark.parametrize("method", ["xla", "bitonic", "merge", "radix"])
@pytest.mark.parametrize("name,dist", [("float32", "mixed"),
                                       ("int32", "dup_heavy"),
                                       ("bfloat16", "mixed")])
def test_topk_matches_reference(method, name, dist):
    """``torch`` vs ``lax.top_k`` includes ±0.0 ties: +0.0 ranks first."""
    jm, tm = _pair(method)
    k = 1 if method == "xla" and name == "int32" else 64
    x = keys(name, (2, _n(method)), dist, seed=13)
    rv, ri = jsort.topk(jnp.asarray(x), k, method=jm, run_len=RUN_LEN)
    gv, gi = tsort.topk(to_torch(x), k, method=tm, run_len=RUN_LEN,
                        device="cpu")
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")


def test_cuda_backend_has_no_topk_yet():
    """The ``cuda`` backend has a top-k since K5 was ported: explicit
    requests run at any n (as the reference's ``pallas`` top-k), and
    ``max_n`` caps only what ``auto`` hands it."""
    from repro_torch.core.backends import MAX_CUDA_N
    from repro_torch.core.sortspec import get_backend
    assert get_backend("cuda").capabilities.supports_topk
    v, i = tsort.topk(torch.tensor([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]),
                      2, method="cuda", device="cpu")
    assert v.tolist() == [9.0, 6.0] and i.tolist() == [5, 7]
    assert not get_backend("cuda").eligible(MAX_CUDA_N + 1, torch.float32)


@pytest.mark.parametrize("kv", [False, True])
def test_card_route_plain_versions_match_pallas_route(kv):
    """The plan a card gets — bitonic-kernel runs, merge-path merges — run
    through the kernels' plain versions on the CPU, against the JAX
    engine under its TPU plan (Pallas runs and merges, interpreted).
    Inputs avoid -0.0 (the reference merge kernel rewrites it as +0.0)."""
    x = keys("float32", (1, 1024), "uniform", seed=23)
    jplan = jengine.Plan(method="merge", run_len=256, run_method="pallas",
                         merge_backend="pallas", costs={})
    tplan = tengine.Plan(method="merge", run_len=256, run_method="cuda",
                         merge_backend="cuda", costs={})
    if kv:
        idx = np.arange(x.shape[-1], dtype=np.int32)[None]
        for desc in (False, True):
            rk, rv = jengine.merge_sort_rows_kv(
                jnp.asarray(x), jnp.asarray(idx), descending=desc,
                plan=jplan, interpret=True)
            gk, gv = tengine.merge_sort_rows_kv(
                to_torch(x), to_torch(idx), descending=desc, plan=tplan)
            assert_same(rk, gk)
            assert_same(rv, gv)
    else:
        for desc in (False, True):
            ref = jengine.merge_sort_rows(jnp.asarray(x), descending=desc,
                                          plan=jplan, interpret=True)
            assert_same(ref, tengine.merge_sort_rows(
                to_torch(x), descending=desc, plan=tplan))


@pytest.mark.parametrize("descending", [False, True])
def test_card_route_keeps_payloads_past_n_on_sentinel_keys(descending):
    """A key-value merge sort on the card's plan (K1 runs, K2 merges;
    plain versions here): an int32 payload above n on a key equal to the
    runs' pad key must survive.  K1 breaks key ties on the payload, so
    riding the runs directly a pad (payload n) sorted ahead of it and the
    slice to n cut it off; the payload now rides as positions, giving the
    reference's CPU result (ties in index order)."""
    sent = float("-inf") if descending else float("inf")
    x = keys("float32", (2, 1000), "uniform", seed=29)
    x[:, 990:] = sent
    v = np.random.default_rng(29).integers(1000, 1 << 30, size=x.shape) \
        .astype(np.int32)
    tplan = tengine.Plan(method="merge", run_len=256, run_method="cuda",
                         merge_backend="cuda", costs={})
    rk, rv = jsort.sort_kv(jnp.asarray(x), jnp.asarray(v), method="merge",
                           descending=descending, run_len=256)
    gk, gv = tengine.merge_sort_rows_kv(to_torch(x), to_torch(v),
                                        descending=descending, plan=tplan)
    assert_same(rk, gk)
    assert_same(rv, gv)


@pytest.mark.parametrize("descending", [False, True])
def test_card_stable_route_plain_versions_match_reference(descending):
    """A stable key-value sort on the card sorts its runs with the radix
    kernels (K1 is not stable).  That route, through the plain versions on
    the CPU, gives the JAX engine's stable pipeline bit for bit: a stable
    sort has one result."""
    x = keys("int32", (2, 1024), "dup_heavy", seed=37)
    idx = np.arange(1024, dtype=np.int32)[None].repeat(2, 0)
    jplan = jengine.Plan(method="merge", run_len=256, run_method="xla",
                         merge_backend="xla", costs={})
    tplan = tengine.Plan(method="merge", run_len=256, run_method="cuda",
                         merge_backend="cuda", costs={},
                         stable_run_method="radix")
    rk, rv = jengine.merge_sort_rows_kv(jnp.asarray(x), jnp.asarray(idx),
                                        descending=descending, plan=jplan,
                                        stable=True)
    gk, gv = tengine.merge_sort_rows_kv(to_torch(x), to_torch(idx),
                                        descending=descending, plan=tplan,
                                        stable=True)
    assert_same(rk, gk)
    assert_same(rv, gv)


@pytest.mark.parametrize("method", ["bitonic", "radix"])
def test_run_methods_match_reference(method):
    """The run methods the planner does not pick on its own (the plain
    network and radix runs) still cut and sort runs like the reference."""
    from repro.engine import runs as jruns
    from repro_torch.engine import runs as truns
    x = keys("float32", (2, 1000), "mixed", seed=29)
    idx = np.arange(1000, dtype=np.int32)[None].repeat(2, 0)
    for desc in (False, True):
        assert_same(jruns.generate_runs(jnp.asarray(x), 128, method=method,
                                        descending=desc, interpret=True),
                    truns.generate_runs(to_torch(x), 128, method=method,
                                        descending=desc))
        rk, rv = jruns.generate_runs_kv(jnp.asarray(x), jnp.asarray(idx), 128,
                                        method=method, descending=desc,
                                        interpret=True)
        gk, gv = truns.generate_runs_kv(to_torch(x), to_torch(idx), 128,
                                        method=method, descending=desc)
        assert_same(rk, gk)
        assert_same(rv, gv)


def test_bitonic_box_merge_matches_reference():
    from repro.engine import merge as jmerge
    from repro_torch.engine import merge as tmerge
    x = np.sort(keys("float32", (3, 2, 64), "mixed", seed=31), axis=-1)
    a, b = x[:, 0], x[:, 1]
    va = np.arange(64, dtype=np.int32)[None].repeat(3, 0)
    vb = va + 64
    for desc in (False, True):
        if desc:
            a, b = a[:, ::-1].copy(), b[:, ::-1].copy()
        ref = jmerge.merge_pairs(jnp.asarray(a), jnp.asarray(b),
                                 descending=desc, backend="bitonic")
        got = tmerge.merge_pairs(to_torch(a), to_torch(b), descending=desc,
                                 backend="bitonic")
        assert_same(ref, got)
        rk, rv = jmerge.merge_pairs(
            jnp.asarray(a), jnp.asarray(b), descending=desc,
            backend="bitonic", values=(jnp.asarray(va), jnp.asarray(vb)))
        gk, gv = tmerge.merge_pairs(
            to_torch(a), to_torch(b), descending=desc, backend="bitonic",
            values=(to_torch(va), to_torch(vb)))
        assert_same(rk, gk)
        assert_same(rv, gv)


@pytest.mark.parametrize("method", ["xla", "bitonic", "pallas"])
def test_sort_gradient_matches_reference_vjp(method):
    jm, tm = _pair(method)
    x = np.array([[3.0, 1.0, 1.0, -2.0, 0.5, 3.0, 7.0, -2.0, 1.0]],
                 np.float32)
    w = np.arange(1, 10, dtype=np.float32)[None]
    for desc in (False, True):
        gj = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jsort.sort(
            v, method=jm, descending=desc)))(jnp.asarray(x))
        xt = to_torch(x).requires_grad_(True)
        (to_torch(w) * tsort.sort(xt, method=tm, descending=desc,
                                  device="cpu")).sum().backward()
        assert_same(gj, xt.grad, f"{method} desc={desc}")


# ---------------------------------------------------------------------------
# planner, profile, device rules
# ---------------------------------------------------------------------------

def test_plans_route_kernels_by_device():
    cpu = tengine.choose(1 << 20, 1, torch.float32, requested="merge",
                         device="cpu")
    gpu = tengine.choose(1 << 20, 1, torch.float32, requested="merge",
                         device="cuda")
    assert (cpu.run_method, cpu.merge_backend) == ("torch", "torch")
    assert (gpu.run_method, gpu.merge_backend) == ("cuda", "cuda")
    assert (cpu.stable_run_method, gpu.stable_run_method) == ("torch", "radix")
    assert set(gpu.costs) == {"torch", "bitonic", "cuda", "merge", "radix",
                              "select"}


@pytest.mark.parametrize("run_len", [None, 3000, 1 << 14, 1 << 15, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_card_runs_fit_the_bitonic_kernel(run_len, dtype):
    """On the card every run is one row of K1: a longer run length is cut
    to what the kernel holds, never handed to ``torch.sort``.  The CPU
    keeps the requested run length, as the reference does."""
    from repro_torch.core.backends import MAX_CUDA_N
    from repro_torch.core.sortspec import next_pow2
    gpu = tengine.choose(1 << 22, 1, dtype, requested="merge",
                         run_len=run_len, device="cuda")
    cpu = tengine.choose(1 << 22, 1, dtype, requested="merge",
                         run_len=run_len, device="cpu")
    want = run_len or ttuning.active().run_len
    assert gpu.run_len == min(next_pow2(want), MAX_CUDA_N)
    assert (gpu.run_method, gpu.stable_run_method) == ("cuda", "radix")
    assert cpu.run_len == want and cpu.run_method == "torch"


def test_auto_picks_like_the_reference_on_the_host():
    """Same constants, same eligibility: the CPU plan is the JAX CPU plan
    under the name mapping (top-k excepted: lax.top_k has its own price)."""
    for n, dt in ((100, "float32"), (3000, "int32"), (1 << 20, "uint8")):
        jp = jengine.choose(n, 1, jnp.dtype(dt), run_len=RUN_LEN)
        tp = tengine.choose(n, 1, getattr(torch, dt), run_len=RUN_LEN,
                            device="cpu")
        assert repro_torch.BACKEND_NAMES.get(jp.method, jp.method) \
            == tp.method, (n, dt)


def test_profile_from_jax_carries_the_knobs(shared_profile):
    d = dataclasses.replace(jtuning.active(), run_len=1024, digit_bits=4,
                            radix_tile=128).to_dict()
    p = convert.profile_from_jax(d)
    assert (p.run_len, p.digit_bits, p.radix_tile) == (1024, 4, 128)
    c = jtuning.active().constants
    assert (p.constants.torch, p.constants.cuda, p.constants.radix) == \
        (c.xla, c.pallas, c.radix)
    with pytest.raises(ttuning.ProfileError):
        convert.profile_from_jax({"schema": "other"})


def test_profile_json_round_trip(tmp_path):
    p = ttuning.TuningProfile(fingerprint="cpu/x/torch-0", run_len=2048)
    q = ttuning.load(ttuning.save(p, tmp_path / "p.json"))
    assert dataclasses.replace(q, source="default") == p
    with pytest.raises(ttuning.ProfileError):
        ttuning.TuningProfile.from_dict({**p.to_dict(), "bogus": 1})
    assert ttuning.device_fingerprint().startswith(
        "cuda/" if torch.cuda.is_available() else "cpu/")


def test_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(10.0)
    for call in (lambda: tsort.sort(x), lambda: tsort.argsort(x),
                 lambda: tsort.topk(x, 2), lambda: tsort.sort_kv(x, x),
                 lambda: tengine.sort(x)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_result_on_requested_device_from_numpy_input():
    out = tsort.sort(np.array([3, 1, 2], np.int32), device="cpu")
    assert out.device.type == "cpu"
    assert out.tolist() == [1, 2, 3]


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()},
    {"axis_name": "data"}, {"method": "distributed"},
    {"mesh": "device_mesh"}])
def test_fields_not_ported_fail_loudly(kwargs):
    """Every field of the JAX package's spec is carried now (the
    distributed tier last): a mesh that is neither a ``core.mesh.Mesh``
    nor a ``DeviceMesh`` and an ``axis_name`` without a mesh fail loudly,
    as the reference's do; a ``DeviceMesh`` (here a one-rank gloo group)
    runs the rank form, a DTensor in and out; ``method="distributed"``
    sorts each row over the host mesh of its device (one CPU entry here).
    Nothing stands in ``NOT_PORTED``."""
    from repro_torch.core import sortspec as tspec
    assert tspec.NOT_PORTED == {}
    x = np.array([[3.0, 1.0, 2.0, 0.5]], np.float32)
    if "method" in kwargs:
        out = tsort.sort(x, device="cpu", **kwargs)
        assert out.tolist() == [[0.5, 1.0, 2.0, 3.0]]
        return
    if kwargs.get("mesh") == "device_mesh":
        import torch.distributed as dist
        from repro_torch.engine import samplesort
        from repro_torch.launch.mesh import make_host_device_mesh
        assert not dist.is_initialized()
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            dm = make_host_device_mesh((1,), ("data",), device="cpu")
            xd = samplesort.shard_of(torch.from_numpy(x[0]), dm)
            tsort.SortSpec(mesh=dm).canonical(xd)
            out = tsort.sort(xd, mesh=dm)
            assert tuple(out.placements) == tuple(xd.placements)
            assert out.to_local().tolist() == [0.5, 1.0, 2.0, 3.0]
            with pytest.raises(TypeError, match="DTensor"):
                tsort.sort(torch.from_numpy(x[0]), mesh=dm)
        finally:
            dist.destroy_process_group()
        return
    err = TypeError if "mesh" in kwargs else ValueError
    with pytest.raises(err, match="Mesh" if "mesh" in kwargs
                       else "requires a mesh"):
        tsort.sort(x, device="cpu", **kwargs)
    with pytest.raises((TypeError, ValueError)):
        tsort.run(tsort.SortSpec(segment_ids=torch.zeros(4), mesh=object()),
                  x, device="cpu")


def test_auto_above_the_spill_threshold_fails_loudly():
    """Above the threshold ``auto`` no longer raises: it runs the spill
    tier (``tests/test_torch_spill.py`` holds its bits), as the reference
    does; an explicit method is honoured."""
    prof = ttuning.active()
    ttuning.set_active(dataclasses.replace(prof, spill_threshold_bytes=64))
    try:
        x = np.arange(100, dtype=np.float32)[::-1].copy()
        assert tengine.choose(100, 1, torch.float32, device="cpu").method \
            == "spill"
        assert tsort.sort(x, device="cpu").tolist() == sorted(x.tolist())
        tsort.sort(x, method="torch", device="cpu")
    finally:
        ttuning.set_active(prof)


def test_tracing_records_spans_and_plan_events():
    from repro_torch import obs
    obs.clear()
    tengine.clear_plan_cache()
    with obs.tracing():
        tsort.sort(np.arange(5000, dtype=np.float32)[::-1].copy(),
                   method="merge", run_len=RUN_LEN, device="cpu")
    names = [s["name"] for s in obs.spans()]
    assert "engine.sort" in names
    assert all(s["device_ms"] is None for s in obs.spans())   # CPU: no clock
    assert obs.events("plan_decision")[0]["method"] == "merge"
    obs.clear()


def test_import_pulls_in_neither_jax_nor_repro():
    """Every module of the port, the examples and the calibration CLI
    (``scripts/torch/autotune.py``) load without jax or the JAX
    package."""
    code = ("import sys\n"
            "import repro_torch, repro_torch.sort, repro_torch.engine, "
            "repro_torch.convert, repro_torch.obs\n"
            "from repro_torch.core import backends\n"
            "from repro_torch.kernels import ops, radix_sort, merge_path, "
            "radix_select, bitonic_topk, bitserial_cas\n"
            "from repro_torch.engine import segmented, spill, planner\n"
            "from repro_torch.core import imc_array, gates, network, cas, "
            "sorter, cost_model, sort_api\n"
            "from repro_torch.configs import adsimc_paper, base, "
            "minitron_4b, moonshot_v1_16b, dbrx_132b\n"
            "from repro_torch.kernels import flash_attention\n"
            "from repro_torch.models import layers, attention, transformer, "
            "model_zoo, moe\n"
            "from repro_torch.launch import steps, serve, train\n"
            "from repro_torch.optim import optimizers, grad_compress\n"
            "from repro_torch.data import pipeline\n"
            "from repro_torch.checkpoint import checkpointer\n"
            "from repro_torch.runtime import fault_tolerance\n"
            "from repro_torch import tree\n"
            "import repro_torch.relational\n"
            "from repro_torch.relational import relspec, unique, groupby, "
            "join, encode, sketch\n"
            "from repro_torch.obs import report\n"
            "from repro_torch.core import mesh, topology, distributed_sort\n"
            "from repro_torch.engine import samplesort, collectives\n"
            "from repro_torch.relational import _core\n"
            "from repro_torch.core import sortspec\n"
            "from repro_torch.launch import mesh as launch_mesh\n"
            "from repro_torch.models import ssm, rglru, encdec\n"
            "from repro_torch.configs import gemma_2b, deepseek_67b, "
            "nemotron_4_340b, mamba2_13b, recurrentgemma_2b, whisper_tiny, "
            "qwen2_vl_72b\n"
            "import glob, runpy\n"
            "examples = sorted(glob.glob(sys.argv[1] + '/*.py'))\n"
            "assert len(examples) == 6, examples\n"
            "for path in examples:\n"
            "    runpy.run_path(path)\n"
            "runpy.run_path(sys.argv[2])['main']\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    examples = os.path.join(os.path.dirname(__file__), os.pardir,
                            "examples", "torch")
    autotune = os.path.join(os.path.dirname(__file__), os.pardir,
                            "scripts", "torch", "autotune.py")
    subprocess.run([sys.executable, "-c", code, examples, autotune],
                   check=True, env=env, timeout=120)
