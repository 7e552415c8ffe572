"""Parity of repro_torch.core.keycodec with repro.core.keycodec, bit for bit,
for every supported dtype and both directions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, keys, to_numpy, to_torch
from repro.core import keycodec as jkc
from repro_torch.core import keycodec as tkc

_ALL = tuple(jkc.SUPPORTED)


def test_supported_dtypes_match():
    assert tuple(tkc.SUPPORTED) == _ALL


@pytest.mark.parametrize("name", _ALL)
@pytest.mark.parametrize("descending", [False, True])
def test_encode_decode_bit_exact(name, descending):
    x = keys(name, (600,), "mixed", seed=hash((name, descending)) % 2**31)
    enc_j = jkc.encode(jnp.asarray(x), descending=descending)
    enc_t = tkc.encode(to_torch(x), descending=descending)
    assert enc_t.dtype == tkc.key_dtype(to_torch(x).dtype)
    assert tkc.key_bits(to_torch(x).dtype) == jkc.key_bits(x.dtype)
    assert_same(enc_j, enc_t, f"encode {name}")
    # the port decodes its own keys, and the reference's, back to x
    assert_same(x, tkc.decode(enc_t, to_torch(x).dtype,
                              descending=descending), f"decode {name}")
    carrier = to_torch(np.asarray(enc_j).view(
        {1: np.int8, 2: np.int16, 4: np.int32}[x.dtype.itemsize]))
    assert_same(jkc.decode(enc_j, x.dtype, descending=descending),
                tkc.decode(carrier, to_torch(x).dtype,
                           descending=descending), f"decode ref {name}")


@pytest.mark.parametrize("name", _ALL)
def test_encoded_order_is_source_order(name):
    """Unsigned order of the encoded keys == the source order (-0.0 below
    +0.0), checked by sorting the unsigned views."""
    x = keys(name, (400,), "mixed", seed=7)
    enc = to_numpy(tkc.encode(to_torch(x)))
    u = enc.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[enc.itemsize])
    srt = np.asarray(x)[np.argsort(u, kind="stable")].astype(np.float64)
    assert (srt[1:] >= srt[:-1]).all()


@pytest.mark.parametrize("name", ["uint16", "uint32"])
def test_to_signed_is_an_order_preserving_bijection(name):
    info = np.iinfo(name)
    x = np.array([0, 1, 7, info.max // 2, info.max // 2 + 1, info.max - 1,
                  info.max], dtype=name)
    t = to_torch(x)
    s = tkc.to_signed(t)
    assert (np.diff(to_numpy(s).astype(np.int64)) > 0).all()
    assert_same(x, tkc.from_signed(s, t.dtype))


def test_total_order_key_ranks_positive_zero_first():
    """lax.top_k's order: +0.0 above -0.0, so a descending sort on the
    total-order key puts +0.0 first, as the JAX reference does."""
    x = np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0], np.float32)
    import jax
    ref = np.asarray(jax.lax.top_k(jnp.asarray(x), 6)[1])
    key = tkc.total_order_key(to_torch(x))
    got = torch.sort(key, descending=True, stable=True).indices.numpy()
    np.testing.assert_array_equal(ref, got)
