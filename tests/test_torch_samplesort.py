"""The port's sample sort (``repro_torch.engine.samplesort``) and its
exchanges (``engine.collectives``) on CPU meshes in one process.

Held to the JAX package on everything that runs in one process: the
splitters, both bucket-bound routes, the byte accounting, the int8 wire
codec and a whole sort over a 1-entry mesh.  Held to numpy on 8-entry
meshes (``tests/test_torch_distributed.py`` holds them to the reference
at D = 8 where it runs): keys bit for bit, ties in ascending index order
both ways, payloads with their keys, over the nine keycodec dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tuning as jtuning
from repro.engine import collectives as jcoll
from repro.engine import samplesort as jss
from repro_torch.core import keycodec
from repro_torch.core.mesh import make_mesh
from repro_torch.engine import collectives as coll
from repro_torch.engine import samplesort as ss
from repro_torch.kernels import radix_sort as rsk
from repro_torch.obs import metrics, trace as obs

from _bucket_cases import CASES, bucket_case
from _torch_parity import assert_same, keys, to_numpy, to_torch

DTYPES = ["float32", "bfloat16", "float16", "int32", "uint32", "int16",
          "uint16", "int8", "uint8"]


def _mesh8():
    return make_mesh((8,), ("data",), "cpu")


def _order(x: torch.Tensor, descending: bool) -> np.ndarray:
    """numpy's stable order of the keycodec keys: ties by index."""
    enc = keycodec.encode(x, descending=descending).numpy()
    u = enc.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[enc.itemsize])
    return np.argsort(u, kind="stable")


def _bits(t):
    return to_numpy(t).view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                             8: np.uint64}[t.element_size()])


# ---------------------------------------------------------------------------
# the building blocks against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,s", [(2, 8), (8, 16), (5, 3)])
def test_select_splitters_matches_reference(n_dev, s):
    rng = np.random.default_rng(n_dev)
    samples = rng.integers(-1000, 1000, n_dev * s).astype(np.int32)
    assert_same(jss.select_splitters(jnp.asarray(samples), n_dev),
                ss.select_splitters(torch.from_numpy(samples), n_dev))


@pytest.mark.parametrize("use_histogram", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 8, 9])
def test_bucket_bounds_both_routes_match_reference(use_histogram, n_dev):
    """Sorted signed-order keys (int32; the reference's uint32 codes, sign
    bit flipped, order the same) cut by D - 1 splitters, with ties on the
    splitters; the histogram route runs the reference's Pallas
    ``_digit_stats`` in interpret mode."""
    rng = np.random.default_rng(7 + n_dev)
    ks = np.sort(rng.integers(0, 40, 700)).astype(np.uint32)
    sp = np.sort(rng.choice(ks, n_dev - 1)).astype(np.uint32)
    want = jss.bucket_bounds(jnp.asarray(ks), jnp.asarray(sp),
                             use_histogram=use_histogram, interpret=True)
    flip = np.uint32(1 << 31)
    got = ss.bucket_bounds(torch.from_numpy((ks ^ flip).view(np.int32)),
                           torch.from_numpy((sp ^ flip).view(np.int32)),
                           use_histogram=use_histogram)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32


@pytest.mark.parametrize("use_histogram", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_bucket_bounds_edge_cases_match_reference(use_histogram, case):
    """The edge cases of K3's bucket search (``tests/_bucket_cases.py``:
    one key, fewer than 33, all keys equal, splitters all below or above
    the keys, runs of repeated splitters, ties ending at the search's
    first-round probes, 1022 splitters) through both routes of
    ``bucket_bounds`` against the reference's, int32 keys (the
    reference's uint32 codes with the sign bit flipped)."""
    info = np.iinfo(np.int32)
    k, sp = bucket_case(case, 3000, info.min, info.max, 11)
    flip = np.int64(1 << 31)
    want = jss.bucket_bounds(jnp.asarray((k + flip).astype(np.uint32)),
                             jnp.asarray((sp + flip).astype(np.uint32)),
                             use_histogram=use_histogram, interpret=True)
    got = ss.bucket_bounds(torch.from_numpy(k.astype(np.int32)),
                           torch.from_numpy(sp.astype(np.int32)),
                           use_histogram=use_histogram)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got[-1] == k.shape[0]


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("n_split", [0, 1, 7, 255, 1022])
def test_bucket_hist_plain_counts_intervals(dtype, n_split):
    """The plain version of ``radix_bucket_hist``: per-bucket counts of
    ``searchsorted(splitters, key, left)``, the pad bin zero, D + 1 <=
    1024 and a loud error past it."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(n_split)
    k = torch.from_numpy(np.sort(rng.integers(info.min, info.max + 1,
                                              5000))).to(dtype)
    sp = torch.from_numpy(np.sort(rng.integers(info.min, info.max + 1,
                                               n_split))).to(dtype)
    got = rsk.bucket_hist(k, sp)
    want = torch.bincount(torch.searchsorted(sp, k).to(torch.int64),
                          minlength=n_split + 2)
    assert got.dtype == torch.int32 and got.shape == (n_split + 2,)
    assert torch.equal(got.to(torch.int64), want)
    if n_split == 1022:
        with pytest.raises(ValueError, match="1024"):
            rsk.bucket_hist(k, torch.cat([sp, sp[:1]]))


def test_byte_accounting_and_capacity_match_reference():
    for d, m, it, cap in [(8, 4096, 4, None), (8, 4096, 8, 1024),
                          (2, 7, 2, 3), (1, 100, 4, None)]:
        assert ss.alltoall_bytes_per_device(d, m, it, cap) == \
            jss.alltoall_bytes_per_device(d, m, it, cap)
        assert ss.topk_candidate_bytes_per_device(d, 64, m, it) == \
            jss.topk_candidate_bytes_per_device(d, 64, m, it)
        assert ss.default_samples_per_shard(m, d) == \
            jss.default_samples_per_shard(m, d)
    for cap, m in [(0, 10), (5, 10), (9, 10), (17, 16), (3, 1000)]:
        assert ss._round_capacity(cap, m) == jss._round_capacity(cap, m)
    for c, r in [(4096, None), (4096, 3), (6, 4), (7, 4), (1, 8)]:
        assert coll.pipeline_chunks(c, r) == jcoll.pipeline_chunks(c, r)
    assert coll.wire_bytes_saved(8, 1024, 4) == \
        jcoll.wire_bytes_saved(8, 1024, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_wire_codec_matches_reference(dtype):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((8, 300)).astype(np.float32) * 7
    v[2] = 0.0                                  # an all-zero bucket
    jv = jnp.asarray(v).astype(jnp.dtype(dtype))
    tv = to_torch(np.asarray(jv))
    jq, js = jcoll.wire_encode_int8(jv)
    tq, ts = coll.wire_encode_int8(tv)
    assert_same(jq, tq, "q")
    assert_same(js, ts, "scale")
    assert_same(jcoll.wire_decode_int8(jq, js, jv.dtype),
                coll.wire_decode_int8(tq, ts, tv.dtype), "decode")


def test_exchanges_copy_into_fresh_buffers():
    devs = ["cpu"] * 4
    sends = [torch.arange(8).reshape(4, 2) + 100 * i for i in range(4)]
    out = coll.all_to_all(sends, devs)
    for j in range(4):
        for i in range(4):
            assert torch.equal(out[j][i], sends[i][j])
            assert out[j].data_ptr() != sends[i].data_ptr()
    ch = coll.chunked_all_to_all([s.repeat(1, 2) for s in sends], devs,
                                 chunks=2)
    assert ch[1].shape == (4, 2, 2)
    assert torch.equal(ch[1][3, 1], sends[3][1])
    g = coll.all_gather([torch.tensor([i]) for i in range(3)], devs[:3])
    assert all(t.tolist() == [0, 1, 2] for t in g)
    r = coll.redistribute([torch.arange(3), torch.arange(3, 10)], [4, 0, 6],
                          devs[:3])
    assert [t.tolist() for t in r] == [[0, 1, 2, 3], [], [4, 5, 6, 7, 8, 9]]
    mesh = make_mesh((2, 3), ("h", "d"), "cpu")
    assert coll.axis_groups(mesh, "d") == [[0, 1, 2], [3, 4, 5]]
    assert coll.axis_groups(mesh, "h") == [[0, 3], [1, 4], [2, 5]]
    assert coll.axis_groups(mesh, ("h", "d")) == [[0, 1, 2, 3, 4, 5]]
    assert ss._lin_index(mesh, ("d", "h"), 4) == 3


# ---------------------------------------------------------------------------
# a whole sort at D = 1 against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int8", "uint16"])
def test_sample_sort_one_entry_matches_reference(dtype, descending):
    x = keys(dtype, (777,), "mixed", 11)
    jmesh = jax.make_mesh((1,), ("data",))
    want = jss.sample_sort(jnp.asarray(x), jmesh, "data",
                           descending=descending)
    got = ss.sample_sort(to_torch(x), make_mesh((1,), ("data",), "cpu"),
                         "data", descending=descending)
    assert_same(want, got)


# ---------------------------------------------------------------------------
# D = 8 on a CPU mesh against numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_sort_every_dtype_bit_exact_ties_by_index(dtype, descending):
    """An uneven length, the dtype's extremes (floats: ±0.0, ±inf) and
    heavy ties: keys bit for bit, the permutation numpy's stable one, and
    an int32 payload with its keys."""
    x = to_torch(keys(dtype, (2003,), "mixed", 5))
    order = _order(x, descending)
    mesh = _mesh8()
    got = ss.sample_sort(x, mesh, descending=descending)
    np.testing.assert_array_equal(_bits(got), _bits(x)[order])
    k, perm = ss.sample_sort(x, mesh, descending=descending,
                             return_indices=True)
    np.testing.assert_array_equal(perm.numpy(), order)
    v = torch.arange(2003, dtype=torch.int32) * 3 - 7
    k, pv = ss.sample_sort(x, mesh, values=v, descending=descending)
    np.testing.assert_array_equal(_bits(k), _bits(x)[order])
    np.testing.assert_array_equal(pv.numpy(), v.numpy()[order])


@pytest.mark.parametrize("dist", ["all_equal", "dup_heavy", "uniform"])
def test_sample_sort_tie_heavy_inputs(dist):
    x = to_torch(keys("int32", (1500,), dist, 9))
    for descending in (False, True):
        order = _order(x, descending)
        _, perm = ss.sample_sort(x, _mesh8(), descending=descending,
                                 return_indices=True)
        np.testing.assert_array_equal(perm.numpy(), order)


def test_sample_sort_payload_at_the_pad_key():
    """Genuine keys equal to the pad (the dtype's maximum, either
    direction's extreme) keep their payloads: validity is counted, never
    read off a sentinel."""
    rng = np.random.default_rng(17)
    k = rng.integers(0, 4, 333).astype(np.int32)
    k[k == 3] = np.iinfo(np.int32).max
    k[k == 2] = np.iinfo(np.int32).min
    x = torch.from_numpy(k)
    v = torch.from_numpy(np.arange(333, dtype=np.int32))
    for descending in (False, True):
        order = _order(x, descending)
        sk, sv = ss.sample_sort(x, _mesh8(), values=v, descending=descending)
        np.testing.assert_array_equal(sk.numpy(), k[order])
        np.testing.assert_array_equal(sv.numpy(), order)


def test_histogram_route_equals_binary_search_route():
    x = to_torch(keys("float32", (3001,), "mixed", 21))
    v = torch.arange(3001, dtype=torch.int32)
    a = ss.sample_sort(x, _mesh8(), values=v, use_histogram=False)
    b = ss.sample_sort(x, _mesh8(), values=v, use_histogram=True)
    assert torch.equal(_bits_t(a[0]), _bits_t(b[0]))
    assert torch.equal(a[1], b[1])


def _bits_t(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def test_small_and_empty_shards():
    """Fewer keys than entries, and shards of any lengths through the
    shard-level entry: the output is cut like the input."""
    mesh = _mesh8()
    x = torch.tensor([5, -1, 3], dtype=torch.int32)
    assert ss.sample_sort(x, mesh).tolist() == [-1, 3, 5]
    rng = np.random.default_rng(4)
    lens = [0, 5, 300, 1, 0, 77, 12, 40]
    shards = [torch.from_numpy(rng.integers(-9, 9, n).astype(np.int16))
              for n in lens]
    out, pos = ss.sample_sort_shards(shards, mesh, return_indices=True,
                                     descending=True)
    assert [t.shape[0] for t in out] == lens
    whole = torch.cat(shards)
    order = _order(whole, True)
    np.testing.assert_array_equal(torch.cat(out).numpy(),
                                  whole.numpy()[order])
    np.testing.assert_array_equal(torch.cat(pos).numpy(), order)


def test_capacity_override_and_errors():
    x = to_torch(keys("int32", (1024,), "uniform", 2))
    mesh = _mesh8()
    want = ss.sample_sort(x, mesh)
    assert torch.equal(ss.sample_sort(x, mesh, capacity=128), want)
    with pytest.raises(ValueError, match="realized maximum"):
        ss.sample_sort(x, mesh, capacity=2)
    with pytest.raises(ValueError, match="1-D"):
        ss.sample_sort(x.reshape(2, -1), mesh)
    with pytest.raises(ValueError, match="keycodec"):
        ss.sample_sort(x.to(torch.float64), mesh)
    with pytest.raises(ValueError, match="not in mesh axes"):
        ss.sample_sort(x, mesh, "model")
    with pytest.raises(ValueError, match="PAYLOAD"):
        ss.sample_sort(x, mesh, wire_codec="int8")


def test_obs_counts_the_exchange_and_the_skew():
    x = to_torch(keys("float32", (4096,), "uniform", 8))
    metrics.reset()
    with obs.tracing():
        ss.sample_sort(x, _mesh8())
    snap = metrics.snapshot()
    m = 512
    cap = ss._round_capacity(int(snap["samplesort.bucket_fill_max"]["max"]),
                             m)
    want = 8 * jss.alltoall_bytes_per_device(8, m, 4, cap)
    assert snap["samplesort.alltoall_bytes"]["value"] == want
    assert snap["collectives.nvlink_bytes"]["value"] == want
    assert snap["samplesort.sorts"]["value"] == 1
    assert snap["samplesort.bucket_skew"]["value"] >= 1.0
    assert any(s["name"] == "samplesort.phase2" for s in obs.spans())
    metrics.reset()


def test_reference_tuning_seed_for_slack():
    """The capacity slack the sort reads is the profile's, seeded as the
    reference's."""
    from repro_torch.core import tuning
    assert tuning.active().capacity_slack == \
        jtuning.TuningProfile(fingerprint="x").capacity_slack
