"""The port's tuning layer and calibration (``repro_torch.core.tuning``,
``repro_torch.engine.planner.calibrate``) on the CPU: persistence,
resolution, the drift refresh (``tests/test_tuning.py``'s tests, one for
one), and calibrate's profile against the JAX package's at the same
arguments.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import tuning as jtuning
from repro.engine import planner as jplanner
from repro_torch import convert
from repro_torch.core import cost_model
from repro_torch.core import tuning as tuning
from repro_torch.engine import planner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's names -> the port's
NAMES = {"xla": "torch", "pallas": "cuda", "xla_topk": "torch_topk",
         "pallas_interpret_penalty": "cuda_plain_penalty"}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """An empty profile directory and a fresh ambient for every test."""
    monkeypatch.setenv(tuning.PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    tuning.set_active(None)
    planner.clear_plan_cache()
    yield
    tuning.set_active(None)
    planner.clear_plan_cache()


def _ported(name: str) -> str:
    head, _, rest = name.partition(".")
    return ".".join([NAMES.get(head, head)] + ([rest] if rest else []))


# ---------------------------------------------------------------------------
# profile object: round trip + validation
# ---------------------------------------------------------------------------

def test_json_round_trip_preserves_everything():
    prof = tuning.TuningProfile(
        fingerprint="cpu/test/torch-0",
        constants=tuning.DeviceSortConstants(torch=7.5, select=11.0,
                                             torch_topk=2.0,
                                             pcie_per_byte=0.03),
        digit_bits=4, radix_tile=128, run_len=4096, capacity_slack=1.25,
        select_min_n=512, merge_fanin=4, source="calibrated",
        probe_ns={"torch.sort.n256": 123.0},
        sweeps={"digit_bits": {"digit_bits=4": 100.0}})
    again = tuning.TuningProfile.from_dict(
        json.loads(json.dumps(prof.to_dict())))
    assert again == prof


def test_save_load_round_trip_on_disk(tmp_path):
    prof = tuning.TuningProfile(fingerprint="cpu/test/torch-0", run_len=4096)
    path = tuning.save(prof, tmp_path / "p.json")
    assert dataclasses.replace(tuning.load(path), source="default") == prof


@pytest.mark.parametrize("mutation", [
    {"schema": "repro_torch.tuning.profile/v999"}, {"schema": None},
    {"digit_bits": 3}, {"radix_tile": 4}, {"run_len": 1},
    {"capacity_slack": 0.5}, {"select_min_n": -1}, {"merge_fanin": 1},
    {"spill_threshold_bytes": 8}, {"not_a_field": 1},
    {"constants": {"warp_speed": 9.0}},
])
def test_from_dict_rejects_bad_documents(mutation):
    doc = tuning.TuningProfile(fingerprint="cpu/test/torch-0").to_dict()
    doc.update(mutation)
    with pytest.raises(tuning.ProfileError):
        tuning.TuningProfile.from_dict(doc)


def test_load_rejects_malformed_file(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(tuning.ProfileError):
        tuning.load(bad)
    with pytest.raises(tuning.ProfileError):
        tuning.load(tmp_path / "missing.json")


# ---------------------------------------------------------------------------
# resolution: a persisted profile wins, mismatches fall back to the seeds
# ---------------------------------------------------------------------------

def test_active_resolves_defaults_when_nothing_persisted():
    prof = tuning.active()
    assert prof.source == "default"
    assert prof == tuning.default_profile()
    assert tuning.persisted_path() is None


def test_search_path_is_the_ports_own(monkeypatch, tmp_path):
    dirs = tuning.search_dirs()
    assert dirs[0] == tmp_path / "profiles"
    assert dirs[-1].parts[-2:] == ("repro_torch", "profiles")
    monkeypatch.delenv(tuning.PROFILE_DIR_ENV)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert tuning.cache_dir() == tmp_path / "xdg" / "repro_torch" / "profiles"
    # the package's directory ships without a profile
    assert not list(dirs[-1].glob("*.json"))


def test_persisted_profile_wins_resolution():
    mine = dataclasses.replace(tuning.default_profile(), run_len=4096,
                               merge_fanin=4)
    tuning.save(mine)                       # default path: the isolated dir
    tuning.set_active(None)
    prof = tuning.active()
    assert prof.source == "persisted"
    assert (prof.run_len, prof.merge_fanin) == (4096, 4)
    assert tuning.persisted_path() is not None


def test_foreign_fingerprint_is_rejected():
    """A profile copied from another machine into this one's file slot is
    not trusted: resolution falls back to the seeds."""
    other = tuning.TuningProfile(fingerprint="cuda/other/sm_90/torch-0",
                                 run_len=64)
    tuning.save(other, tuning.profile_path())
    assert tuning.load_for_device() is None
    assert tuning.persisted_path() is None
    assert tuning.active().source == "default"


def test_corrupt_persisted_file_falls_back():
    p = tuning.profile_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("{broken")
    assert tuning.load_for_device() is None
    assert tuning.active().source == "default"


def test_set_active_and_reset_bump_the_generation_and_replan():
    g0 = tuning.generation()
    before = planner.choose_cached(1 << 20, 1, torch.float32, device="cpu")
    tuning.set_active(dataclasses.replace(tuning.active(), run_len=1024,
                                          spill_threshold_bytes=64))
    g1 = tuning.generation()
    assert g1 > g0
    after = planner.choose_cached(1 << 20, 1, torch.float32, device="cpu")
    assert (before.method, after.method) != ("spill", "spill")
    assert after.method == "spill"
    planner.reset_calibration()
    assert tuning.generation() > g1
    assert tuning.active() == tuning.default_profile()
    assert planner.choose_cached(1 << 20, 1, torch.float32,
                                 device="cpu").method == before.method


# ---------------------------------------------------------------------------
# calibrate: the reference's profile under the port's names
# ---------------------------------------------------------------------------

def test_calibrate_mirrors_the_reference_profile():
    """At the same arguments both packages probe the same backends (under
    the port's names) and sweep the same knobs over the same grids."""
    try:
        want = jplanner.calibrate(tile_n=256, batch=4, reps=1)
    finally:
        jtuning.set_active(None)
        jplanner.clear_plan_cache()
    got = planner.calibrate(tile_n=256, batch=4, reps=1, device="cpu")
    assert got.source == "calibrated" and tuning.active() is got
    assert got.fingerprint == tuning.device_fingerprint()
    assert {_ported(k) for k in want.probe_ns} == set(got.probe_ns)
    assert set(want.sweeps) == set(got.sweeps)
    for knob in want.sweeps:
        assert set(want.sweeps[knob]) == set(got.sweeps[knob]), knob
    ported = {NAMES.get(k, k) for k in
              dataclasses.asdict(want.constants)} - {
        "collective_alpha", "collective_per_byte", "dcn_alpha",
        "dcn_per_byte"}
    # plus the port's own: torch.sort's radix price on the card
    assert ported | {"torch_card"} == set(dataclasses.asdict(got.constants))
    for f in ("digit_bits", "radix_tile", "capacity_slack",
              "spill_threshold_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.run_len in (256, 512, 1024)
    assert got.merge_fanin in (2, 4, 8, 16)


def test_calibrate_constants_are_finite_and_positive():
    prof = planner.calibrate(tile_n=256, batch=4, reps=1, device="cpu")
    for name, v in dataclasses.asdict(prof.constants).items():
        assert np.isfinite(v) and v > 0, name
    assert all(v > 0 for v in prof.probe_ns.values())
    assert all(v > 0 for t in prof.sweeps.values() for v in t.values())
    # off the card the kernel backends keep their seeds, unswept
    assert "digit_bits" not in prof.sweeps
    assert not any(k.startswith(("cuda.", "radix.")) for k in prof.probe_ns)
    assert set(planner.NOT_SWEPT) == {"radix_tile", "capacity_slack"}


def test_calibrate_refuses_a_device_the_fingerprint_does_not_name():
    if torch.cuda.is_available():
        pytest.skip("a card machine calibrates its card")
    with pytest.raises(RuntimeError, match="cuda"):
        planner.calibrate(tile_n=256, batch=4, reps=1)


def test_calibrate_persists_and_fresh_process_loads():
    prof = planner.calibrate(tile_n=256, batch=4, reps=1, persist=True,
                             sweep_params=False, device="cpu")
    path = tuning.persisted_path()
    assert path is not None
    plan = planner.choose(100000, 1, torch.float32, device="cpu")
    code = (
        "import json\n"
        "import torch\n"
        "from repro_torch.core import tuning\n"
        "from repro_torch.engine import planner\n"
        "prof = tuning.active()\n"
        "plan = planner.choose(100000, 1, torch.float32, device='cpu')\n"
        "print(json.dumps({'source': prof.source,\n"
        "                  'fingerprint': prof.fingerprint,\n"
        "                  'torch': prof.constants.torch,\n"
        "                  'method': plan.method,\n"
        "                  'run_len': plan.run_len}))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src",
             tuning.PROFILE_DIR_ENV: str(path.parent)})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["source"] == "persisted"
    assert got["fingerprint"] == prof.fingerprint
    assert got["torch"] == pytest.approx(prof.constants.torch)
    assert (got["method"], got["run_len"]) == (plan.method, plan.run_len)


def test_profile_from_jax_carries_every_new_field():
    d = dataclasses.replace(
        jtuning.TuningProfile(fingerprint="cpu/x/jax-0"),
        merge_fanin=4, capacity_slack=1.5,
        constants=jtuning.DeviceSortConstants(
            xla_topk=2.5, pcie_per_byte=0.01, host_merge_level=3.0,
            collective_alpha=1.0)).to_dict()
    p = convert.profile_from_jax(d)
    assert (p.merge_fanin, p.capacity_slack) == (4, 1.5)
    c = p.constants
    assert (c.torch_topk, c.pcie_per_byte, c.host_merge_level) == \
        (2.5, 0.01, 3.0)
    assert not hasattr(c, "collective_alpha")


# ---------------------------------------------------------------------------
# the repaired top-k prices
# ---------------------------------------------------------------------------

def test_cuda_topk_price_is_one_pass_up_to_k256():
    """K5 reads a row once for k <= 256: its price grows linearly in n,
    not as K1's n log^2 n; past 256 it is the network's sort-prefix."""
    c1 = cost_model.cuda_topk_cost_ns(1 << 16, 50)
    c2 = cost_model.cuda_topk_cost_ns(1 << 20, 50)
    # 16x the keys cost at most 16x (n log^2 n would be 16 x 1.25^2 = 25x)
    assert 15 < c2 / c1 <= 16
    assert c2 < cost_model.device_sort_cost_ns("cuda", 1 << 20) / 100
    assert cost_model.cuda_topk_cost_ns(1 << 20, 300) == \
        cost_model.device_sort_cost_ns("cuda", 1 << 20)
    plan = planner.choose(256000, 8, torch.float32, k=50, device="cuda")
    assert plan.costs["cuda"] == cost_model.cuda_topk_cost_ns(256000, 50, 8)
    # K5's one pass takes the sampling rows, far past K1's cap: on the
    # seed profile auto now picks it over the radix sort-prefix
    assert plan.method == "cuda"
    assert planner.choose(1 << 20, 1, torch.float32, k=300,
                          device="cuda").method != "cuda"


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16,
                                   np.uint16, np.int8])
@pytest.mark.parametrize("n", [64, 4096, 1 << 16, 1 << 20, 1 << 28])
def test_cpu_torch_price_and_plans_are_the_references(n, dtype):
    """Off the card ``torch`` keeps the reference's comparison-sort price
    (its ``xla``), so CPU plans are the reference's."""
    tdt = getattr(torch, np.dtype(dtype).name)
    for batch in (1, 8):
        want = jplanner.choose(n, batch, dtype)
        got = planner.choose(n, batch, tdt, device="cpu")
        assert got.costs["torch"] == pytest.approx(want.costs["xla"])
        assert got.method == NAMES.get(want.method, want.method)


def test_card_torch_price_is_a_radix_sort():
    """On the card ``torch.sort`` is priced as the radix sort it runs:
    linear in n, a pass a byte of key, its own constant; the seed plans it
    over K3 at the shapes where it was measured faster (the 2^28 float32
    sort, the 2^26 int32 argsort), and CPU plans keep n log2 n."""
    c = tuning.active().constants
    for kb, passes in ((32, 4), (16, 2), (8, 1)):
        one = cost_model.device_sort_cost_ns("torch", 1 << 20, key_bits=kb)
        assert one == c.torch_card * (1 << 20) * passes
        for n in (1 << 12, 1 << 24, 1 << 28):
            assert cost_model.device_sort_cost_ns(
                "torch", 2 * n, key_bits=kb) == 2 * \
                cost_model.device_sort_cost_ns("torch", n, key_bits=kb)
    assert cost_model.device_sort_cost_ns("torch", 1 << 20, plain=True) == \
        c.torch * (1 << 20) * 20
    for n, dtype in ((1 << 28, torch.float32), (1 << 26, torch.int32)):
        plan = planner.choose(n, 1, dtype, device="cuda")
        assert plan.method == "torch", plan.costs
        assert plan.costs["torch"] < plan.costs["radix"]


def test_torch_topk_native_price_off_the_card_only():
    off = planner.choose(1 << 20, 1, torch.float32, k=64, device="cpu")
    on = planner.choose(1 << 20, 1, torch.float32, k=64, device="cuda")
    assert off.costs["torch"] == cost_model.native_topk_cost_ns(1 << 20, 64)
    assert on.costs["torch"] == cost_model.device_sort_cost_ns(
        "torch", 1 << 20)
    want = jplanner.choose(1 << 20, 1, np.float32, k=64)
    assert want.costs["xla"] == pytest.approx(off.costs["torch"])


# ---------------------------------------------------------------------------
# the drift refresh: drift -> re-probe -> clean slate, with a cooldown
# ---------------------------------------------------------------------------

@pytest.fixture()
def _obs_on():
    from repro_torch.obs import metrics, trace
    trace.enable()
    metrics.reset()
    tuning._last_refresh_t = None
    yield metrics
    tuning._last_refresh_t = None
    metrics.reset()
    trace.disable()


def _drift(h, ratio=50.0):
    for _ in range(tuning.REFRESH_MIN_OBSERVATIONS):
        h.observe(ratio)


def _fresh():
    return dataclasses.replace(tuning.default_profile(), source="calibrated")


def test_refresh_needs_enough_signal(_obs_on):
    h = _obs_on.histogram("planner.cost_model_error")
    for _ in range(tuning.REFRESH_MIN_OBSERVATIONS - 1):
        h.observe(100.0)
    assert tuning.refresh_if_stale() is None


def test_refresh_in_band_is_a_noop(_obs_on):
    h = _obs_on.histogram("planner.cost_model_error")
    _drift(h, 1.1)
    assert tuning.refresh_if_stale() is None
    assert h.count == tuning.REFRESH_MIN_OBSERVATIONS


def test_refresh_on_drift_recalibrates_and_clears(_obs_on, monkeypatch):
    h = _obs_on.histogram("planner.cost_model_error")
    _drift(h)
    fresh = _fresh()
    calls = {}

    def _fake_calibrate(**kw):
        calls.update(kw)
        tuning.set_active(fresh)
        return fresh

    monkeypatch.setattr(planner, "calibrate", _fake_calibrate)
    assert tuning.refresh_if_stale(persist=False, tile_n=256) is fresh
    assert calls == {"persist": False, "tile_n": 256}
    assert h.count == 0
    assert _obs_on.counter("tuning.refreshes").value == 1


def test_refresh_cooldown_rate_limits(_obs_on, monkeypatch):
    h = _obs_on.histogram("planner.cost_model_error")
    fresh = _fresh()
    calls = []
    monkeypatch.setattr(planner, "calibrate",
                        lambda **kw: (calls.append(kw), fresh)[1])
    clock = {"t": 1000.0}
    _drift(h)
    assert tuning.refresh_if_stale(persist=False,
                                   now_fn=lambda: clock["t"]) is fresh
    assert len(calls) == 1 and h.count == 0
    _drift(h)
    assert tuning.refresh_if_stale(persist=False,
                                   now_fn=lambda: clock["t"]) is None
    assert len(calls) == 1
    assert h.count == tuning.REFRESH_MIN_OBSERVATIONS
    assert _obs_on.counter("tuning.refreshes_rate_limited").value == 1
    clock["t"] += tuning.REFRESH_COOLDOWN_S + 1.0
    assert tuning.refresh_if_stale(persist=False,
                                   now_fn=lambda: clock["t"]) is fresh
    assert len(calls) == 2 and h.count == 0
    assert _obs_on.counter("tuning.refreshes").value == 2


def test_refresh_cooldown_checked_after_signal(_obs_on, monkeypatch):
    h = _obs_on.histogram("planner.cost_model_error")
    monkeypatch.setattr(tuning, "_last_refresh_t", 1000.0)
    _drift(h, 1.1)
    assert tuning.refresh_if_stale(now_fn=lambda: 1001.0) is None
    assert _obs_on.counter("tuning.refreshes_rate_limited").value == 0


def test_profile_reset_clears_refresh_cooldown(_obs_on, monkeypatch):
    h = _obs_on.histogram("planner.cost_model_error")
    fresh = _fresh()
    calls = []
    monkeypatch.setattr(planner, "calibrate",
                        lambda **kw: (calls.append(kw),
                                      tuning.set_active(fresh), fresh)[2])
    clock = {"t": 1000.0}
    _drift(h)
    assert tuning.refresh_if_stale(persist=False,
                                   now_fn=lambda: clock["t"]) is fresh
    assert tuning._last_refresh_t == clock["t"]
    tuning.set_active(None)
    assert tuning._last_refresh_t is None
    clock["t"] += 1.0
    _drift(h)
    assert tuning.refresh_if_stale(persist=False,
                                   now_fn=lambda: clock["t"]) is fresh
    assert len(calls) == 2
    assert _obs_on.counter("tuning.refreshes_rate_limited").value == 0


def test_refresh_cooldown_zero_disables(_obs_on, monkeypatch):
    h = _obs_on.histogram("planner.cost_model_error")
    fresh = _fresh()
    calls = []
    monkeypatch.setattr(planner, "calibrate",
                        lambda **kw: (calls.append(kw), fresh)[1])
    for _ in range(2):
        _drift(h)
        assert tuning.refresh_if_stale(persist=False, cooldown_s=0.0,
                                       now_fn=lambda: 1000.0) is fresh
    assert len(calls) == 2


@pytest.mark.parametrize("live", [False, True])
def test_maybe_refresh_is_gated_by_env(_obs_on, monkeypatch, live):
    h = _obs_on.histogram("planner.cost_model_error")
    _drift(h)
    calls = []
    monkeypatch.setattr(planner, "calibrate",
                        lambda **kw: (calls.append(kw), _fresh())[1])
    monkeypatch.setattr(tuning, "_autotune_live", None)
    monkeypatch.setenv(tuning.AUTOTUNE_ENV, "1" if live else "0")
    tuning.maybe_refresh()
    assert len(calls) == int(live)
    assert h.count == (0 if live else tuning.REFRESH_MIN_OBSERVATIONS)


def test_engine_cost_observations_feed_maybe_refresh(monkeypatch):
    """``engine._obs_finish`` hands every fenced observation to the hook
    (the reference's closed loop)."""
    from repro_torch import engine
    calls = []
    monkeypatch.setattr(tuning, "maybe_refresh", lambda: calls.append(1))

    class _Span:
        device_ms = 1.0

    plan = planner.choose(64, 1, torch.float32, device="cpu")
    from repro_torch.obs import trace
    trace.enable()
    try:
        engine._obs_finish(_Span(), "sort", plan, 64, 1)
    finally:
        trace.disable()
    assert calls == [1]
