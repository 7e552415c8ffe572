"""The port's link layer: ``core.topology``, the tuning profile's link
constants, the distributed cost model and ``planner.choose_distributed``,
held to the JAX package (the reference's tiers mapped ``ici`` ->
``nvlink``, ``dcn`` -> ``network`` by ``convert.topology_from_jax``)."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import topology as jtopo
from repro.core import tuning as jtuning
from repro.engine import planner as jplanner
from repro_torch import convert
from repro_torch.core import cost_model as cm
from repro_torch.core import topology as topo
from repro_torch.core import tuning
from repro_torch.core.mesh import make_mesh
from repro_torch.engine import planner


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv(topo.TOPOLOGY_DIR_ENV, str(tmp_path / "topo"))
    monkeypatch.setenv(tuning.PROFILE_DIR_ENV, str(tmp_path / "prof"))
    topo.set_active(None)
    jtopo.set_active(None)
    yield
    topo.set_active(None)
    jtopo.set_active(None)
    tuning.set_active(None)
    planner.clear_plan_cache()


def _fake_mesh(shape, names):
    """What both packages' ``from_mesh`` read: names and sizes."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, shape)))


def _ref_links() -> tuning.LinkConstants:
    c = jtuning.DeviceSortConstants()
    return tuning.LinkConstants(
        collective_alpha=c.collective_alpha,
        collective_per_byte=c.collective_per_byte,
        network_alpha=c.dcn_alpha, network_per_byte=c.dcn_per_byte)


def _use_reference_seeds():
    """The port's active profile with the reference's cost seeds and link
    constants, so the two models price alike."""
    prof = convert.profile_from_jax(
        jtuning.TuningProfile(fingerprint="cpu/x/jax").to_dict())
    tuning.set_active(dataclasses.replace(
        prof, fingerprint=tuning.device_fingerprint(), links=_ref_links()))


def test_link_seeds_are_the_h100_specification():
    lk = tuning.LinkConstants()
    assert 1e9 / lk.collective_per_byte == pytest.approx(450e9)
    assert 1e9 / lk.network_per_byte == pytest.approx(50e9)
    prof = tuning.TuningProfile(fingerprint="f", links=_ref_links())
    back = tuning.TuningProfile.from_dict(json.loads(json.dumps(
        prof.to_dict())))
    assert back.links == prof.links
    with pytest.raises(tuning.ProfileError, match="unknown link"):
        tuning.TuningProfile.from_dict(dict(prof.to_dict(),
                                            links={"warp": 1.0}))
    with pytest.raises(tuning.ProfileError, match="positive"):
        tuning.TuningProfile(fingerprint="f", links=tuning.LinkConstants(
            collective_per_byte=0.0))


@pytest.mark.parametrize("shape,names", [((8,), ("data",)),
                                         ((2, 4), ("host", "dev")),
                                         ((1, 8), ("host", "dev"))])
def test_from_mesh_schema_matches_reference(shape, names):
    want = jtopo.from_mesh(_fake_mesh(shape, names), fingerprint="fp")
    conv = convert.topology_from_jax(want.to_dict())
    got = topo.from_mesh(_fake_mesh(shape, names), fingerprint="fp")
    assert conv.signature() == got.signature() == want.signature()
    assert [a.tier for a in conv.axes] == [a.tier for a in got.axes] == \
        [convert.TIERS[a.tier] for a in want.axes]
    assert conv.is_hierarchical == got.is_hierarchical == \
        want.is_hierarchical
    assert conv.source == "converted"
    for a, b in zip(conv.axes, want.axes):
        assert (a.bandwidth_bytes_per_s, a.latency_ns) == \
            (b.bandwidth_bytes_per_s, b.latency_ns)
    d = got.to_dict()
    assert set(d) == set(want.to_dict()) and d["schema"] == topo.SCHEMA
    assert set(d["axes"][0]) == set(want.to_dict()["axes"][0])


def test_topology_validation_errors():
    with pytest.raises(topo.TopologyError, match="tier"):
        topo.TopologyAxis("a", 2, "ici", 1.0, 0.0)
    with pytest.raises(topo.TopologyError, match="size"):
        topo.TopologyAxis("a", 0, "nvlink", 1.0, 0.0)
    with pytest.raises(topo.TopologyError, match="bandwidth"):
        topo.TopologyAxis("a", 2, "nvlink", 0.0, 0.0)
    t = topo.from_mesh(_fake_mesh((2, 4), ("h", "d")))
    d = t.to_dict()
    for bad, match in [(dict(d, schema="x"), "schema"),
                       (dict(d, extra=1), "unknown topology fields"),
                       (dict(d, axes="no"), "list"),
                       ({k: v for k, v in d.items() if k != "fingerprint"},
                        "fingerprint")]:
        with pytest.raises(topo.TopologyError, match=match):
            topo.Topology.from_dict(bad)
    with pytest.raises(topo.TopologyError, match="JAX topology"):
        convert.topology_from_jax(d)


def test_persistence_for_mesh_and_generation(tmp_path):
    mesh = make_mesh((2, 4), ("host", "dev"), "cpu")
    t = topo.from_mesh(mesh)
    assert topo.for_mesh(mesh).source == "default"
    fast = dataclasses.replace(t, axes=tuple(
        dataclasses.replace(a, bandwidth_bytes_per_s=1e12) for a in t.axes))
    p = topo.save(fast)
    assert topo.persisted_path(t.signature()) == p
    got = topo.for_mesh(mesh)
    assert got.source == "persisted" and got.axes == fast.axes
    g = topo.generation()
    topo.set_active(t)
    assert topo.generation() == g + 1 and topo.for_mesh(mesh) is t
    # a file under another fingerprint's name is passed over
    (tmp_path / "topo" / "junk.json").write_text("{")
    assert topo.load_for_mesh((("x", 3),)) is None
    with pytest.raises(topo.TopologyError, match="cannot read"):
        topo.load(tmp_path / "topo" / "junk.json")


def test_calibrate_records_a_shared_device_as_local():
    """Every entry on the CPU: each axis's copies stay in one memory, so
    the fit is recorded under tier ``local``, never as NVLink."""
    mesh = make_mesh((2, 4), ("host", "dev"), "cpu")
    t = topo.calibrate(mesh, small_bytes=256, large_bytes=1 << 14, reps=1)
    assert [a.tier for a in t.axes] == ["local", "local"]
    assert t.source == "calibrated" and topo.active() is t
    assert len(t.probe_ns) == 4 and all(v > 0 for v in t.probe_ns.values())
    one = topo.calibrate(make_mesh((1, 4), ("host", "dev"), "cpu"),
                         reps=1, set_as_active=False)
    assert one.axes[0].tier == "network"     # size 1: the default, unprobed


# ---------------------------------------------------------------------------
# cost model and plans against the reference
# ---------------------------------------------------------------------------

def _consts():
    return convert.profile_from_jax(jtuning.TuningProfile(
        fingerprint="x").to_dict()).constants


@pytest.mark.parametrize("n,d", [(1 << 10, 2), (1 << 16, 8), (1 << 22, 8),
                                 (12345, 5)])
def test_distributed_cost_model_matches_reference(n, d):
    c, lk = _consts(), _ref_links()
    jc = jtuning.DeviceSortConstants()
    assert cm.collective_cost_ns(d, n, 4, lk) == \
        pytest.approx(jcm.collective_cost_ns(d, n, 4, jc))
    for s in ("oddeven", "sample"):
        assert cm.distributed_sort_cost_ns(s, n, d, 4, consts=c, links=lk) \
            == pytest.approx(jcm.distributed_sort_cost_ns(s, n, d, 4,
                                                          consts=jc))
    for inner, outer in [(4, 2), (8, 1), (2, 4)]:
        assert cm.flat_collective_rates(inner, outer, links=lk) == \
            pytest.approx(jcm.flat_collective_rates(inner, outer, consts=jc))
        assert cm.hierarchical_sort_cost_ns(n, inner, outer, 4, consts=c,
                                            links=lk) == pytest.approx(
            jcm.hierarchical_sort_cost_ns(n, inner, outer, 4, consts=jc))
    with pytest.raises(ValueError, match="strategy"):
        cm.distributed_sort_cost_ns("bogo", n, d)


@pytest.mark.parametrize("n", [1 << 10, 1 << 14, 1 << 20, 1 << 26])
@pytest.mark.parametrize("dcn_slowdown", [None, 1.0, 100.0])
def test_choose_distributed_matches_reference(n, dcn_slowdown):
    """One tier (no topology) and two tiers (the reference's topology,
    converted; the slow tier at its seed, as fast as the inner one, and
    100x slower): the same strategy and costs."""
    _use_reference_seeds()
    jtuning.set_active(None)
    jt = None
    if dcn_slowdown is not None:
        jt = jtopo.from_mesh(_fake_mesh((2, 4), ("h", "d")),
                             fingerprint="fp")
        inner = jt.axes[1]
        jt = dataclasses.replace(jt, axes=(dataclasses.replace(
            jt.axes[0], bandwidth_bytes_per_s=inner.bandwidth_bytes_per_s
            / dcn_slowdown, latency_ns=inner.latency_ns * dcn_slowdown),
            inner))
    want = jplanner.choose_distributed(n, 8, topology=jt)
    tt = None if jt is None else convert.topology_from_jax(jt.to_dict())
    got = planner.choose_distributed(n, 8, torch.float32, topology=tt)
    assert got.strategy == want.strategy
    assert set(got.costs) == set(want.costs)
    for s in want.costs:
        assert got.costs[s] == pytest.approx(want.costs[s]), s
    again = planner.choose_distributed_cached(n, 8, torch.float32,
                                              topology=tt)
    assert again == got
    assert planner.choose_distributed_cached(
        n, 8, torch.float32, topology=tt) is again
    topo.set_active(None)           # a new topology generation re-plans
    assert planner.choose_distributed_cached(
        n, 8, torch.float32, topology=tt) is not again


def test_topology_must_span_the_sort():
    t = topo.from_mesh(_fake_mesh((2, 4), ("h", "d")))
    with pytest.raises(ValueError, match="spans 8"):
        planner.choose_distributed(1 << 20, 4, topology=t)
    assert np.isfinite(planner.choose_distributed(1 << 20, 8,
                                                  topology=t).costs["hier"])
