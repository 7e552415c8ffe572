"""Shared helpers of the JAX <-> PyTorch parity tests.

Inputs are made once with numpy from a seed and handed to both packages;
results are compared as raw bit patterns, so -0.0 vs +0.0 counts.

Under pytest-xdist each worker process takes its share of the machine's
cores for torch's intra-op pool.  By default every worker starts a pool of
one thread a core, so N workers hold N times the cores, and an op on the
tests' small tensors waits for pool threads that are not running (on an
8-core x86 host, in one process, a 36864-element float32 ``sqrt`` took
1-7 ms on an 8-thread pool and 0.012 ms on one thread).  A test run in
one process keeps torch's default.
"""
import os

import jax.numpy as jnp
import numpy as np
import torch

_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_TORCH_CARRIER = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                  np.dtype(np.int32): torch.int32}


def to_torch(a) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor with identical bits."""
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """CPU tensor -> numpy array with identical bits (bf16 as jnp's)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


def assert_same(jax_out, torch_out, what: str = "") -> None:
    """Bit-exact equality of a JAX result and a port result."""
    j = np.asarray(jax_out)
    t = to_numpy(torch_out) if isinstance(torch_out, torch.Tensor) \
        else np.asarray(torch_out)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    assert j.dtype.itemsize == t.dtype.itemsize, (what, j.dtype, t.dtype)
    np.testing.assert_array_equal(bits(j), bits(t), err_msg=what)


def np_dtype(name: str):
    return jnp.bfloat16 if name == "bfloat16" else np.dtype(name)


def keys(name: str, shape, dist: str, seed: int) -> np.ndarray:
    """Keys of ``name`` in one of the conformance suites' distributions:

    ``mixed``      negatives, heavy ties, ±0.0 and ±inf (floats) or the
                   dtype's extremes (ints) — test_sort_conformance's input
    ``uniform``    integers in a small range (test_fuzz_conformance)
    ``dup_heavy``  four distinct values
    ``all_equal``  one value
    """
    rng = np.random.default_rng(seed)
    dt = np_dtype(name)
    is_float = name.startswith(("float", "bfloat"))
    if dist == "mixed":
        if is_float:
            x = np.round(rng.standard_normal(shape) * 3).astype(np.float32)
            flat = x.reshape(-1)
            flat[::7] = 0.0
            flat[1::7] = -0.0
            flat[2::11] = np.inf
            flat[3::11] = -np.inf
            return x.astype(dt)
        info = np.iinfo(dt)
        x = rng.integers(max(info.min, -7), min(info.max, 8),
                         size=shape).astype(dt)
        x.reshape(-1)[0], x.reshape(-1)[1] = info.min, info.max
        return x
    lo, hi = (0, 100) if name.startswith("uint") else (-100, 100)
    if dist == "uniform":
        raw = rng.integers(lo, hi, size=shape)
    elif dist == "dup_heavy":
        raw = rng.integers(0, 4, size=shape)
    else:
        raw = np.full(shape, rng.integers(lo, hi))
    return raw.astype(np.float32).astype(dt) if is_float else raw.astype(dt)
