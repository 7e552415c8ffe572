"""The two-level sample sort of the port (``sample_sort`` on an (outer,
inner) mesh) on CPU meshes, held to numpy: 2 x 4 and 4 x 2 run the four
phases, 1 x 8 demotes to the flat schedule (a size-1 tier has no link to
spare), both give the flat schedule's bits.  Pipeline chunks cut the
outer exchange; the int8 codec narrows a float payload on it: keys stay
exact, payloads equal the codec's decode of their encode."""
import numpy as np
import pytest
import torch

from repro_torch.core import keycodec
from repro_torch.core.mesh import make_mesh
from repro_torch.engine import collectives as coll
from repro_torch.engine import samplesort as ss
from repro_torch.obs import metrics, trace as obs

from _torch_parity import keys, to_torch


def _order(x, descending):
    enc = keycodec.encode(x, descending=descending).numpy()
    return np.argsort(enc.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[
        enc.itemsize]), kind="stable")


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()]).numpy()


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("dtype,dist", [("float32", "mixed"),
                                        ("int16", "dup_heavy"),
                                        ("uint8", "uniform")])
@pytest.mark.parametrize("descending", [False, True])
def test_two_level_sort_bit_exact_ties_by_index(shape, dtype, dist,
                                                descending):
    mesh = make_mesh(shape, ("host", "dev"), "cpu")
    x = to_torch(keys(dtype, (2501,), dist, 41))
    order = _order(x, descending)
    k, perm = ss.sample_sort(x, mesh, None, descending=descending,
                             return_indices=True, pipeline_chunks=4)
    np.testing.assert_array_equal(_bits(k), _bits(x)[order])
    np.testing.assert_array_equal(perm.numpy(), order)
    flat = ss.sample_sort(x, mesh, None, descending=descending,
                          hierarchical=False)
    np.testing.assert_array_equal(_bits(flat), _bits(k))


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_int8_codec_on_the_payload(chunks):
    """Keys exact; each payload is what the codec's per-bucket scale makes
    of it: within half a step of the bucket's absmax / 127, and the
    codec's decode of its encode when a bucket holds it alone."""
    rng = np.random.default_rng(chunks)
    x = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    mesh = make_mesh((2, 4), ("host", "dev"), "cpu")
    k, pv = ss.sample_sort(x, mesh, None, values=v, pipeline_chunks=chunks,
                           wire_codec="int8")
    order = _order(x, False)
    np.testing.assert_array_equal(_bits(k), _bits(x)[order])
    want = v.numpy()[order]
    step = np.abs(v.numpy()).max() / 127
    assert np.all(np.abs(pv.numpy() - want) <= step / 2 + 1e-7)
    q, s = coll.wire_encode_int8(torch.tensor([[0.3, -1.0, 0.25]]))
    assert coll.wire_decode_int8(q, s, torch.float32).tolist()[0][1] == -1.0
    exact, ev = ss.sample_sort(x, mesh, None, values=v)
    np.testing.assert_array_equal(ev.numpy(), want)
    with pytest.raises(ValueError, match="float payloads"):
        ss.sample_sort(x, mesh, None, values=v.to(torch.int32),
                       wire_codec="int8")
    with pytest.raises(ValueError, match="unknown wire_codec"):
        ss.sample_sort(x, mesh, None, values=v, wire_codec="fp8")


def test_two_level_needs_two_axes_and_no_capacity():
    x = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly two mesh axes"):
        ss.sample_sort(x, make_mesh((8,), ("data",), "cpu"),
                       hierarchical=True)
    with pytest.raises(ValueError, match="capacity"):
        ss.sample_sort(x, make_mesh((2, 4), ("h", "d"), "cpu"), None,
                       capacity=8)
    # one axis of a two-axis mesh: the flat sort over that axis's entries
    out = ss.sample_sort(x.flip(0), make_mesh((2, 4), ("h", "d"), "cpu"),
                         "d")
    assert out.tolist() == list(range(64))


def test_per_tier_byte_counters():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    metrics.reset()
    with obs.tracing():
        ss.sample_sort(x, make_mesh((2, 4), ("h", "d"), "cpu"), None,
                       values=v, pipeline_chunks=4, wire_codec="int8")
    snap = metrics.snapshot()
    assert snap["collectives.nvlink_bytes"]["value"] > 0
    assert snap["collectives.network_bytes"]["value"] > 0
    assert snap["collectives.wire_bytes_saved"]["value"] > 0
    names = [s["name"] for s in obs.spans()]
    assert [f"samplesort.hier.phase{i}" for i in (1, 2, 3, 4)] == \
        [n for n in names if n.startswith("samplesort.hier")]
    metrics.reset()
