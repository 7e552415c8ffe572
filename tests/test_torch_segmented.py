"""Parity of the port's ragged and padded-row sorts
(``engine/segmented.py`` and the ``sort.py`` forms over it) with the JAX
package's, on the same seeded numpy inputs, bit for bit; the spec
validation of those forms and of the selection backend; and the planner's
k-aware ``auto`` with its ``select_min_n`` switch-over.
"""
import dataclasses

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

RUN_LEN = 256


@pytest.fixture(scope="module", autouse=True)
def shared_profile():
    """The port runs on the JAX package's active profile, converted."""
    prof = convert.profile_from_jax(jtuning.active().to_dict())
    ttuning.set_active(prof)
    yield prof
    ttuning.set_active(None)


def _pair(method):
    return method, repro_torch.BACKEND_NAMES[method]


def _segments(shape, n_seg, seed):
    return np.random.default_rng(seed).integers(0, n_seg, size=shape) \
        .astype(np.int32)


@pytest.mark.parametrize("n", [0, 1, 7, 100])
def test_segment_ids_from_row_splits_matches_reference(n):
    splits = np.array([0, 0, 3, 5, 5, n if n >= 5 else 5], np.int32)
    ref = jengine.segment_ids_from_row_splits(jnp.asarray(splits), n)
    got = tengine.segment_ids_from_row_splits(to_torch(splits), n,
                                              device="cpu")
    assert_same(ref, got)


@pytest.mark.parametrize("method", ["xla", "merge", "radix"])
@pytest.mark.parametrize("name,dist", [("float32", "mixed"),
                                       ("int32", "dup_heavy"),
                                       ("uint16", "uniform")])
@pytest.mark.parametrize("descending", [False, True])
def test_segmented_sort_matches_reference(method, name, dist, descending):
    jm, tm = _pair(method)
    x = keys(name, (2, 1000), dist, seed=31)
    seg = _segments(x.shape, 13, seed=32)
    ro = jengine.segmented_argsort(jnp.asarray(x), jnp.asarray(seg),
                                   descending=descending, method=jm,
                                   run_len=RUN_LEN)
    go = tengine.segmented_argsort(to_torch(x), to_torch(seg),
                                   descending=descending, method=tm,
                                   run_len=RUN_LEN, device="cpu")
    assert_same(ro, go, "permutation")
    rv, rs = jengine.segmented_sort(jnp.asarray(x), jnp.asarray(seg),
                                    descending=descending, method=jm,
                                    run_len=RUN_LEN)
    gv, gs = tengine.segmented_sort(to_torch(x), to_torch(seg),
                                    descending=descending, method=tm,
                                    run_len=RUN_LEN, device="cpu")
    assert_same(rv, gv, "values")
    assert_same(rs, gs, "segments")


@pytest.mark.parametrize("method", ["xla", "merge", "cuda"])
@pytest.mark.parametrize("name", ["float32", "int8", "uint32", "bfloat16"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_padded_rows_matches_reference(method, name, descending):
    jm = {"cuda": "pallas"}.get(method, method)
    tm = repro_torch.BACKEND_NAMES[jm]
    n = 700 if method == "cuda" else 1500
    x = keys(name, (4, n), "mixed", seed=41)
    lengths = np.array([0, 1, n // 3, n], np.int32)
    ref = jengine.sort_padded_rows(jnp.asarray(x), jnp.asarray(lengths),
                                   descending=descending, method=jm,
                                   fill_value=7, run_len=RUN_LEN)
    got = tengine.sort_padded_rows(to_torch(x), to_torch(lengths),
                                   descending=descending, method=tm,
                                   fill_value=7, run_len=RUN_LEN,
                                   device="cpu")
    assert_same(ref, got)


@pytest.mark.parametrize("method", ["xla", "merge", "radix"])
def test_group_tokens_by_expert_matches_reference(method):
    """A stable grouping of (tokens x top-k) expert ids; an id past the
    last expert is dropped from the splits and a negative one counts as
    expert 0, as ``jnp.bincount(length=)`` does."""
    jm, tm = _pair(method)
    ids = _segments((512 * 2,), 8, seed=51)
    ids[5], ids[9] = 8, -1
    rp, rs = jengine.group_tokens_by_expert(jnp.asarray(ids), 8, method=jm)
    gp, gs = tengine.group_tokens_by_expert(to_torch(ids), 8, method=tm,
                                            device="cpu")
    assert_same(rp, gp, "permutation")
    assert_same(rs, gs, "row splits")


@pytest.mark.parametrize("form", ["segment_ids", "row_splits", "indices",
                                  "values"])
@pytest.mark.parametrize("descending", [False, True])
def test_segment_sort_front_door_matches_reference(form, descending):
    x = keys("float32", (900,), "mixed", seed=61)
    splits = np.array([0, 4, 4, 300, 301, 899, 900], np.int32)
    seg = np.repeat(np.arange(6, dtype=np.int32), np.diff(splits))
    if form == "row_splits":
        ref = jsort.segment_sort(jnp.asarray(x), row_splits=jnp.asarray(
            splits), descending=descending)
        got = tsort.segment_sort(to_torch(x), row_splits=to_torch(splits),
                                 descending=descending, device="cpu")
    elif form == "values":
        pay = np.arange(900, dtype=np.float32)[::-1].copy()
        spec = dict(descending=descending, segment_ids=seg)
        ref = jsort.run(jsort.SortSpec(values=jnp.asarray(pay), **{
            **spec, "segment_ids": jnp.asarray(seg)}), jnp.asarray(x))
        got = tsort.run(tsort.SortSpec(values=to_torch(pay), **{
            **spec, "segment_ids": to_torch(seg)}), to_torch(x),
            device="cpu")
    else:
        ref = jsort.segment_sort(jnp.asarray(x), segment_ids=jnp.asarray(seg),
                                 descending=descending,
                                 indices=form == "indices")
        got = tsort.segment_sort(to_torch(x), segment_ids=to_torch(seg),
                                 descending=descending,
                                 indices=form == "indices", device="cpu")
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,),
                    got if isinstance(got, tuple) else (got,)):
        assert_same(r, g)


@pytest.mark.parametrize("fill_value", [0, -3])
def test_sort_valid_lengths_front_door_matches_reference(fill_value):
    x = keys("int16", (3, 500), "mixed", seed=71)
    lengths = np.array([500, 250, 2], np.int32)
    for desc in (False, True):
        ref = jsort.sort(jnp.asarray(x), valid_lengths=jnp.asarray(lengths),
                         fill_value=fill_value, descending=desc)
        got = tsort.sort(to_torch(x), valid_lengths=to_torch(lengths),
                         fill_value=fill_value, descending=desc,
                         device="cpu")
        assert_same(ref, got)


@pytest.mark.parametrize("spec,match", [
    ({"segment_ids": np.zeros(8, np.int32),
      "row_splits": np.array([0, 8])}, "not both"),
    ({"segment_ids": np.zeros(8, np.int32),
      "valid_lengths": np.array([3])}, "mutually exclusive"),
    ({"segment_ids": np.zeros(8, np.int32), "k": 2}, "top-k over"),
    ({"valid_lengths": np.array([3]), "k": 2}, "top-k over"),
    ({"segment_ids": np.zeros(8, np.int32), "method": "select"},
     "selection-only"),
    ({"valid_lengths": np.array([3]), "indices": True}, "value sorts"),
])
def test_segment_and_padded_spec_validation(spec, match):
    """The reference's spec rules: each bad combination is a ValueError,
    raised before any sort runs."""
    x = np.zeros((1, 8), np.float32)
    spec = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in spec.items()}
    with pytest.raises(ValueError, match=match):
        tsort.run(tsort.SortSpec(**spec), x, device="cpu")


# ---------------------------------------------------------------------------
# the k-aware planner
# ---------------------------------------------------------------------------

def test_auto_topk_switches_to_selection_from_select_min_n():
    """``auto`` never picks the selection backend below ``select_min_n``;
    from there on it picks it where it is the cheapest (on the CPU, where
    the kernel backends pay their plain penalty, once the torch backend's
    native top-k is priced above it: its seed makes it the cheapest on the
    CPU, as the reference's ``lax.top_k`` is), and moving the floor moves
    the switch-over.  An explicit ``select`` is honoured below it."""
    base = ttuning.active()
    prof = dataclasses.replace(base, constants=dataclasses.replace(
        base.constants, torch_topk=1e3))
    ttuning.set_active(prof)
    lo = tengine.choose(prof.select_min_n - 1, 1, torch.float32, k=8,
                        device="cpu")
    hi = tengine.choose(1 << 16, 1, torch.float32, k=8, device="cpu")
    assert lo.method != "select"
    assert hi.method == "select"
    assert hi.costs["select"] < hi.costs["torch"]
    ttuning.set_active(dataclasses.replace(prof, select_min_n=1 << 17))
    try:
        assert tengine.choose(1 << 16, 1, torch.float32, k=8,
                              device="cpu").method != "select"
        tengine.clear_plan_cache()
        v, i = tsort.topk(np.arange(16, dtype=np.float32), 3,
                          method="select", device="cpu")
        assert i.tolist() == [15, 14, 13]
    finally:
        ttuning.set_active(base)


def test_topk_plans_price_selection_and_the_card_backends():
    """A top-k plan prices ``select`` with the selection model, ``cuda``
    as K5's one pass (k <= 256) and every other sort backend on the card
    at its sort; ``cuda`` takes top-k now, ``select`` no sort, and neither
    is offered a plain sort by ``auto``."""
    from repro_torch.core import cost_model
    plan = tengine.choose(1 << 20, 4, torch.float32, k=64, device="cuda")
    assert plan.costs["select"] == cost_model.selection_cost_ns(
        1 << 20, 64, 32, 4)
    assert plan.costs["cuda"] == cost_model.cuda_topk_cost_ns(
        1 << 20, 64, 4)
    assert plan.costs["torch"] == cost_model.device_sort_cost_ns(
        "torch", 1 << 20, 4)
    sort_plan = tengine.choose(1 << 20, 4, torch.float32, device="cuda")
    assert sort_plan.method != "select"
    small = tengine.choose(64, 16384, torch.float32, k=8, device="cuda")
    assert small.method == "cuda"
