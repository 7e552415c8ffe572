"""The slice as a whole: ``repro.sort`` against ``repro_torch.sort`` on the
CPU, bit for bit, through the backend-name mapping of
``repro_torch.BACKEND_NAMES``, with both packages cutting runs and digits
from the same tuning profile (``repro_torch.convert.profile_from_jax``).
Sorts and argsorts here; key-value sorts, top-k, gradients and the
device rules in test_torch_engine_paths.py.
"""
import jax.numpy as jnp
import pytest
import torch

import repro.sort as jsort
import repro_torch
import repro_torch.sort as tsort
from _torch_parity import assert_same, keys, to_torch
from repro.core import tuning as jtuning
from repro_torch import convert
from repro_torch.core import tuning as ttuning

SORT_CASES = [("float32", "mixed"), ("bfloat16", "mixed"), ("int32", "mixed"),
              ("uint32", "mixed"), ("int8", "dup_heavy"),
              ("float16", "all_equal"), ("uint16", "uniform")]
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


# the network backends (slow references) take the cases that differ in
# kind: float with ±0.0/±inf, unsigned 32-bit extremes, narrow ints
NETWORK_CASES = [("float32", "mixed"), ("uint32", "mixed"),
                 ("int8", "dup_heavy")]
SORT_PARAMS = [(m, n, d) for m in ("xla", "merge", "radix")
               for n, d in SORT_CASES] + \
    [(m, n, d) for m in ("bitonic", "pallas") for n, d in NETWORK_CASES]


def _pair(method):
    return method, repro_torch.BACKEND_NAMES[method]


@pytest.mark.parametrize("method,name,dist", SORT_PARAMS)
@pytest.mark.parametrize("descending", [False, True])
def test_sort_matches_reference(method, name, dist, descending):
    jm, tm = _pair(method)
    x = keys(name, (2, _n(method)), dist, seed=hash((name, dist)) % 2**31)
    ref = jsort.sort(jnp.asarray(x), method=jm, descending=descending,
                     run_len=RUN_LEN)
    got = tsort.sort(to_torch(x), method=tm, descending=descending,
                     run_len=RUN_LEN, device="cpu")
    assert_same(ref, got, f"{method} {name} {dist} desc={descending}")


@pytest.mark.parametrize("method", ["xla", "bitonic", "merge", "radix",
                                    "pallas"])
@pytest.mark.parametrize("name,dist", [("float32", "mixed"),
                                       ("int16", "mixed"),
                                       ("uint32", "dup_heavy")])
@pytest.mark.parametrize("descending", [False, True])
def test_argsort_matches_reference(method, name, dist, descending):
    jm, tm = _pair(method)
    x = keys(name, (2, _n(method)), dist, seed=5)
    ref = jsort.argsort(jnp.asarray(x), method=jm, descending=descending,
                        run_len=RUN_LEN)
    got = tsort.argsort(to_torch(x), method=tm, descending=descending,
                        run_len=RUN_LEN, device="cpu")
    assert got.dtype == torch.int32
    assert_same(ref, got, f"argsort {method} {name} desc={descending}")


@pytest.mark.parametrize("method", ["bitonic", "pallas"])
def test_stable_argsort_forces_the_stable_pipeline(method):
    jm, tm = _pair(method)
    x = keys("int32", (1, 2000), "dup_heavy", seed=17)
    ref = jsort.argsort(jnp.asarray(x), method=jm, stable=True,
                        run_len=RUN_LEN)
    got = tsort.argsort(to_torch(x), method=tm, stable=True,
                        run_len=RUN_LEN, device="cpu")
    assert_same(ref, got)


def test_axis_and_leading_dims():
    x = keys("float32", (3, 40, 5), "mixed", seed=19)
    for axis in (0, 1, -1):
        ref = jsort.sort(jnp.asarray(x), axis=axis, method="merge",
                         run_len=16)
        got = tsort.sort(to_torch(x), axis=axis, method="merge", run_len=16,
                         device="cpu")
        assert_same(ref, got, f"axis={axis}")
    rv, ri = jsort.topk(jnp.asarray(x), 3, axis=1, method="xla")
    gv, gi = tsort.topk(to_torch(x), 3, axis=1, method="torch", device="cpu")
    assert_same(rv, gv)
    assert_same(ri, gi)
