"""The port's spill tier (``repro_torch.engine.spill``) and k-way merges
against the JAX package's (``repro.engine.spill``, ``repro.engine.merge``),
bit for bit, on the CPU.

Both packages run on the same profile (the JAX one, converted), and tiny
chunks make a few hundred keys many runs, so both cut the same runs at the
same boundaries and every merge block boundary is exercised.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sort as tsort
from _torch_parity import assert_same, keys, np_dtype, to_numpy, to_torch
from repro.core import tuning as jtuning
from repro.engine import merge as jmerge
from repro.engine import planner as jplanner
from repro.engine import spill as jspill
from repro_torch import convert
from repro_torch import engine as tengine
from repro_torch.core import sortspec as tsortspec
from repro_torch.core import tuning as ttuning
from repro_torch.engine import merge as tmerge
from repro_torch.engine import planner as tplanner
from repro_torch.engine import spill as tspill

CHUNK_BYTES = 256             # 64 float32 keys a chunk
DTYPES = ["float32", "bfloat16", "float16", "int32", "uint32", "int16",
          "uint16", "int8", "uint8"]


@pytest.fixture(autouse=True)
def shared_profile():
    """Both packages on the JAX package's active profile."""
    jtuning.set_active(None)
    jplanner.clear_plan_cache()
    prof = convert.profile_from_jax(jtuning.active().to_dict())
    ttuning.set_active(prof)
    tplanner.clear_plan_cache()
    yield prof
    jtuning.set_active(None)
    jplanner.clear_plan_cache()
    ttuning.set_active(None)
    tplanner.clear_plan_cache()


def _install_threshold(threshold: int) -> None:
    for tun, pl in ((jtuning, jplanner), (ttuning, tplanner)):
        tun.set_active(dataclasses.replace(
            tun.active(), spill_threshold_bytes=threshold))
        pl.clear_plan_cache()


def _normal(n, dtype="float32", seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


# ---------------------------------------------------------------------------
# bit-exactness against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", DTYPES)
def test_spill_sort_bits_match_reference(name, descending):
    """Every dtype of the spill backend, both directions, keys with ties,
    signed zeros and infinities (floats) or the dtype's extremes (ints),
    cut into several uneven runs."""
    x = keys(name, (300,), "mixed", seed=len(name))
    want = jspill.spill_sort(x, descending=descending,
                             chunk_bytes=CHUNK_BYTES)
    got = tspill.spill_sort(to_torch(x), descending=descending,
                            chunk_bytes=CHUNK_BYTES, device="cpu")
    assert got.device.type == "cpu"
    assert_same(want, got, f"{name} descending={descending}")


@pytest.mark.parametrize("descending", [False, True])
def test_spill_sort_kv_stable_dup_heavy(descending):
    rng = np.random.default_rng(3)
    k = rng.integers(0, 8, 700).astype(np.int32)
    v = rng.integers(-1000, 1000, 700).astype(np.int32)
    jk, jv = jspill.spill_sort_kv(k, v, descending=descending,
                                  chunk_bytes=CHUNK_BYTES)
    tk, tv = tspill.spill_sort_kv(to_torch(k), to_torch(v),
                                  descending=descending,
                                  chunk_bytes=CHUNK_BYTES, device="cpu")
    assert_same(jk, tk)
    assert_same(jv, tv)
    order = np.argsort(-k.astype(np.int64) if descending else k,
                       kind="stable")
    np.testing.assert_array_equal(to_numpy(tv), v[order])


@pytest.mark.parametrize("descending", [False, True])
def test_spill_argsort_is_the_stable_permutation(descending):
    x = np.random.default_rng(11).integers(0, 5, 500).astype(np.int32)
    got = tspill.spill_argsort(to_torch(x), descending=descending,
                               chunk_bytes=CHUNK_BYTES, device="cpu")
    assert_same(jspill.spill_argsort(x, descending=descending,
                                     chunk_bytes=CHUNK_BYTES), got)
    key = -x.astype(np.int64) if descending else x
    np.testing.assert_array_equal(to_numpy(got),
                                  np.argsort(key, kind="stable"))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["float32", "float16"])
def test_spill_nan_keys_match_reference(name, descending):
    """NaN keys (some with other payloads and the sign bit) sort last
    ascending, first descending, as the reference's total order puts
    them: the chunk sorts pin to ``torch`` and the merges run on
    ``merge.order_key``."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(400).astype(name)
    x[rng.integers(0, 400, 30)] = np.nan
    x[rng.integers(0, 400, 10)] = np.inf
    x[rng.integers(0, 400, 10)] = -np.inf
    x[::37] = 0.0
    x[5::37] = -0.0
    bits = x.view(np.uint32 if name == "float32" else np.uint16)
    bits[3::97] |= 0x7F800001 if name == "float32" else 0x7C01   # NaN payloads
    assert_same(jspill.spill_sort(x, descending=descending,
                                  chunk_bytes=CHUNK_BYTES),
                tspill.spill_sort(to_torch(x), descending=descending,
                                  chunk_bytes=CHUNK_BYTES, device="cpu"))
    v = np.arange(400, dtype=np.int32)
    jk, jv = jspill.spill_sort_kv(x, v, descending=descending,
                                  chunk_bytes=CHUNK_BYTES)
    tk, tv = tspill.spill_sort_kv(to_torch(x), to_torch(v),
                                  descending=descending,
                                  chunk_bytes=CHUNK_BYTES, device="cpu")
    assert_same(jk, tk)
    assert_same(jv, tv)


@pytest.mark.parametrize("descending", [False, True])
def test_spill_bfloat16_keeps_nan_payloads(descending):
    """bfloat16 rides the pipeline as its order code: NaN payload bits,
    both signs, come back exactly as the reference's."""
    x = keys("bfloat16", (500,), "mixed", seed=2)
    b = x.view(np.uint16)
    b[7::61] = 0x7FC1          # +NaN, payload 1
    b[11::67] = 0xFF85         # -NaN, payload 5
    b[13::71] = 0x7F81         # signalling payload
    assert_same(jspill.spill_sort(x, descending=descending,
                                  chunk_bytes=CHUNK_BYTES),
                tspill.spill_sort(to_torch(x), descending=descending,
                                  chunk_bytes=CHUNK_BYTES, device="cpu"))
    v = np.arange(500, dtype=np.int32)
    jk, jv = jspill.spill_sort_kv(x, v, descending=descending,
                                  chunk_bytes=CHUNK_BYTES)
    tk, tv = tspill.spill_sort_kv(to_torch(x), to_torch(v),
                                  descending=descending,
                                  chunk_bytes=CHUNK_BYTES, device="cpu")
    assert_same(jk, tk)
    assert_same(jv, tv)


# ---------------------------------------------------------------------------
# chunk-boundary shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks,delta", [(1, -1), (1, 1), (3, -5), (3, 5)])
def test_n_not_a_multiple_of_the_chunk(chunks, delta):
    n = chunks * tspill.chunk_elems(4, CHUNK_BYTES) + delta
    x = _normal(n, seed=n)
    assert_same(jspill.spill_sort(x, chunk_bytes=CHUNK_BYTES),
                tspill.spill_sort(to_torch(x), chunk_bytes=CHUNK_BYTES,
                                  device="cpu"))


def test_n_below_one_chunk_passes_through():
    x = _normal(13)
    got = tspill.spill_sort(to_torch(x), chunk_bytes=CHUNK_BYTES,
                            device="cpu")
    assert_same(jspill.spill_sort(x, chunk_bytes=CHUNK_BYTES), got)
    np.testing.assert_array_equal(to_numpy(got), np.sort(x))


def test_empty_input():
    out = tspill.spill_sort(torch.empty(0), chunk_bytes=CHUNK_BYTES,
                            device="cpu")
    assert out.shape == (0,) and out.dtype == torch.float32
    sk, sv = tspill.spill_sort_kv(torch.empty(0, dtype=torch.int32),
                                  torch.empty(0, dtype=torch.int32),
                                  chunk_bytes=CHUNK_BYTES, device="cpu")
    assert sk.shape == sv.shape == (0,)


def test_overlap_off_is_equal_not_just_close():
    x = to_torch(keys("float32", (777,), "mixed", seed=5))
    a = tspill.spill_sort(x, chunk_bytes=CHUNK_BYTES, overlap=True,
                          device="cpu")
    b = tspill.spill_sort(x, chunk_bytes=CHUNK_BYTES, overlap=False,
                          device="cpu")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    i = torch.arange(777, dtype=torch.int32)
    ka, va = tspill.spill_sort_kv(x, i, chunk_bytes=CHUNK_BYTES,
                                  overlap=True, device="cpu")
    kb, vb = tspill.spill_sort_kv(x, i, chunk_bytes=CHUNK_BYTES,
                                  overlap=False, device="cpu")
    assert torch.equal(va, vb) and torch.equal(ka.view(torch.int32),
                                               kb.view(torch.int32))


def test_rejects_non_1d_and_bad_chunk():
    with pytest.raises(ValueError, match="1-D"):
        tspill.spill_sort(torch.zeros(2, 3), device="cpu")
    with pytest.raises(ValueError, match="chunk_bytes"):
        tspill.spill_sort(torch.zeros(8), chunk_bytes=4, device="cpu")
    with pytest.raises(ValueError, match="match keys"):
        tspill.spill_sort_kv(torch.zeros(4), torch.zeros(5, dtype=torch.int32),
                             device="cpu")


# ---------------------------------------------------------------------------
# planner routing, plan cache, capture fallback, registry
# ---------------------------------------------------------------------------

def test_planner_routes_oversized_to_spill():
    _install_threshold(1024)
    plan = tplanner.choose(4096, 1, torch.float32, device="cpu")
    want = jplanner.choose(4096, 1, np.float32)
    assert plan.method == want.method == "spill"
    assert plan.costs["spill"] == pytest.approx(want.costs["spill"])
    assert tplanner.choose(64, 1, torch.float32, device="cpu").method \
        != "spill"
    # top-k stays on the device paths above the threshold
    assert tplanner.choose(4096, 1, torch.float32, k=8, device="cpu") \
        .method != "spill"


def test_spill_never_a_candidate_below_threshold():
    plan = tplanner.choose(512, 1, torch.float32, device="cpu")
    assert plan.method != "spill" and "spill" not in plan.costs


def test_threshold_change_invalidates_cached_plans():
    assert tplanner.choose_cached(4096, 1, torch.float32,
                                  device="cpu").method != "spill"
    _install_threshold(1024)            # bumps the tuning generation
    assert tplanner.choose_cached(4096, 1, torch.float32,
                                  device="cpu").method == "spill"
    ttuning.set_active(None)
    assert tplanner.choose_cached(4096, 1, torch.float32,
                                  device="cpu").method != "spill"


@pytest.mark.parametrize("entry", ["sort", "argsort", "sort_kv"])
def test_front_doors_auto_spill_and_match(entry):
    """``engine``/``repro_torch.sort`` with ``method="auto"`` above the
    threshold run the spill tier (no longer a raise), the result a CPU
    tensor with the reference's bits."""
    _install_threshold(1024)
    x = keys("float32", (4096,), "mixed", seed=9)
    v = np.arange(4096, dtype=np.int32)[::-1].copy()
    from repro import engine as jengine
    if entry == "sort":
        want = jengine.sort(x)
        got = tengine.sort(to_torch(x), device="cpu")
        assert_same(want, got)
        assert_same(want, tsort.sort(to_torch(x), device="cpu"))
        assert_same(want, tsort.sort(to_torch(x), method="spill",
                                     device="cpu"))
    elif entry == "argsort":
        want = jengine.argsort(x, stable=True)
        got = tengine.argsort(to_torch(x), device="cpu")
        assert_same(want, got)
        assert_same(want, tsort.argsort(to_torch(x), device="cpu"))
    else:
        jk, jv = jengine.sort_kv(x, v, stable=True)
        got, tv = tengine.sort_kv(to_torch(x), to_torch(v), device="cpu")
        assert_same(jk, got)
        assert_same(jv, tv)
    assert got.device.type == "cpu"


def test_capture_fallback_swaps_spill_for_merge(monkeypatch):
    """While a CUDA graph is being captured a spill plan degrades to the
    merge pipeline (the reference's outer-jit fallback)."""
    _install_threshold(1024)
    calls = []
    real = tspill.sort_rows
    monkeypatch.setattr(tspill, "sort_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = to_torch(_normal(4096, seed=10))
    monkeypatch.setattr(tengine, "_capturing", lambda: True)
    out = tengine.sort(x, device="cpu")
    assert not calls
    np.testing.assert_array_equal(to_numpy(out), np.sort(to_numpy(x)))
    monkeypatch.setattr(tengine, "_capturing", lambda: False)
    tengine.sort(x, device="cpu")
    assert calls


def test_spill_backend_registered_with_honest_caps():
    from repro.core import sortspec as jsortspec
    caps = tsortspec.get_backend("spill").capabilities
    ref = jsortspec.get_backend("spill").capabilities
    assert caps.stable and caps.supports_kv
    assert not caps.supports_topk and not caps.auto_dispatch
    assert (caps.dtypes, caps.substrate, caps.supports_segments) == \
        (ref.dtypes, ref.substrate, ref.supports_segments)
    assert "spill" not in tsortspec.NOT_PORTED
    with pytest.raises(ValueError, match="top-k"):
        tsort.topk(torch.zeros(8), 2, method="spill", device="cpu")


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

def test_int8_codec_bits_match_reference():
    """The int8 codec is lossy but deterministic: the same runs quantize
    to the same codes, so the merged result is the reference's bits."""
    x = _normal(600, seed=2)
    want = jspill.spill_sort(x, chunk_bytes=CHUNK_BYTES, codec="int8")
    got = tspill.spill_sort(to_torch(x), chunk_bytes=CHUNK_BYTES,
                            codec="int8", device="cpu")
    assert_same(want, got)
    out = to_numpy(got)
    assert np.all(np.diff(out) >= 0)
    assert np.max(np.abs(out - np.sort(x))) <= 2 * np.abs(x).max() / 127.0


def test_int8_codec_rejects_int_keys():
    with pytest.raises(ValueError, match="int8 spill codec"):
        tspill.spill_sort(torch.arange(64, dtype=torch.int32),
                          chunk_bytes=CHUNK_BYTES, codec="int8",
                          device="cpu")


def test_kv_codec_compresses_payload_keys_exact():
    rng = np.random.default_rng(4)
    k = rng.integers(0, 100, 500).astype(np.int32)
    v = rng.standard_normal(500).astype(np.float32)
    jk, jv = jspill.spill_sort_kv(k, v, chunk_bytes=CHUNK_BYTES,
                                  codec="int8")
    tk, tv = tspill.spill_sort_kv(to_torch(k), to_torch(v),
                                  chunk_bytes=CHUNK_BYTES, codec="int8",
                                  device="cpu")
    assert_same(jk, tk)
    assert_same(jv, tv)
    np.testing.assert_array_equal(to_numpy(tk), np.sort(k))


# ---------------------------------------------------------------------------
# k-way merges: pads against genuine sentinel-valued keys and NaN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["int32", "uint16", "float32"])
def test_kway_merge_kv_sentinel_valued_genuine_keys(name):
    """Genuine keys equal to the pad (the dtype's maximum, +inf) tie with
    it; the pads are dropped by position and never displace them."""
    dt = np_dtype(name)
    top = np.inf if name == "float32" else np.iinfo(dt).max
    a = np.array([1, top, top], dt)
    b = np.array([0, top], dt)
    va = np.array([10, 11, 12], np.int32)
    vb = np.array([20, 21], np.int32)
    import jax.numpy as jnp
    jk, jv = jmerge.kway_merge_kv([jnp.asarray(a), jnp.asarray(b)],
                                  [jnp.asarray(va), jnp.asarray(vb)])
    tk, tv = tmerge.kway_merge_kv([to_torch(a), to_torch(b)],
                                  [to_torch(va), to_torch(vb)])
    assert_same(jk, tk)
    assert_same(jv, tv)
    np.testing.assert_array_equal(to_numpy(tv), [20, 10, 11, 12, 21])


@pytest.mark.parametrize("descending", [False, True])
def test_kway_merge_nan_tail(descending):
    import jax.numpy as jnp
    a = np.array([1.0, np.inf, np.nan], np.float32)
    b = np.array([-np.inf, -0.0, 2.0, np.nan], np.float32)
    c = np.array([0.0, 0.5], np.float32)
    runs = [a, b, c]
    if descending:
        runs = [r[::-1].copy() for r in runs]
    want = jmerge.kway_merge([jnp.asarray(r) for r in runs],
                             descending=descending)
    got = tmerge.kway_merge([to_torch(r) for r in runs],
                            descending=descending)
    assert_same(want, got)
    v = [np.arange(len(r), dtype=np.int32) + 10 * i
         for i, r in enumerate(runs)]
    jk, jv = jmerge.kway_merge_kv([jnp.asarray(r) for r in runs],
                                  [jnp.asarray(t) for t in v],
                                  descending=descending)
    tk, tv = tmerge.kway_merge_kv([to_torch(r) for r in runs],
                                  [to_torch(t) for t in v],
                                  descending=descending)
    assert_same(jk, tk)
    assert_same(jv, tv)


@pytest.mark.parametrize("fanin", [2, 3, 16])
def test_grouped_merge_width_keeps_the_stable_order(fanin):
    """Any merge width gives the one stable merge (contiguous groups keep
    the left-first tie rule across levels)."""
    rng = np.random.default_rng(fanin)
    runs = [np.sort(rng.integers(0, 6, int(m)).astype(np.int32))
            for m in rng.integers(1, 40, 7)]
    vals = [np.arange(r.size, dtype=np.int32) + 100 * i
            for i, r in enumerate(runs)]
    mk, mv = tspill._grouped_kway_kv([to_torch(r) for r in runs],
                                     [to_torch(v) for v in vals], fanin,
                                     descending=False, backend="torch")
    cat_k, cat_v = np.concatenate(runs), np.concatenate(vals)
    order = np.argsort(cat_k, kind="stable")
    np.testing.assert_array_equal(to_numpy(mk), cat_k[order])
    np.testing.assert_array_equal(to_numpy(mv), cat_v[order])


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_spill_counters_spans_and_overlap_gauge():
    from repro_torch.obs import metrics, trace
    trace.enable()
    trace.clear()
    metrics.reset()
    try:
        x = to_torch(_normal(600, seed=6))
        nbytes = x.numel() * 4
        tspill.spill_sort(x, chunk_bytes=CHUNK_BYTES, device="cpu")
        # each key crosses twice in the spill phase and twice in merges
        assert metrics.counter("spill.h2d_bytes").value == 2 * nbytes
        assert metrics.counter("spill.d2h_bytes").value == 2 * nbytes
        assert 0.0 <= metrics.gauge("spill.overlap_fraction").value <= 1.0
        names = [s["name"] for s in trace.spans()]
        assert names.count("spill.chunk") == -(-600 // 64)
        assert "spill.sort" in names and "spill.merge_block" in names
    finally:
        metrics.reset()
        trace.clear()
        trace.disable()
