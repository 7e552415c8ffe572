"""The port's unsharded prefill against the JAX package's at the prompt
lengths the serve layout's sequence-sharded cache is held to (the gloo
mesh's ``check_serve_layout_prefill``, ``tests/_torch_sharding_worker.py``,
holds the sharded port to this unsharded one): shorter than the cache
(16 and 15 into 64), as long as it (64), a window of 8 filled (8) and
outgrown (32 and 13, the ring rolled by 0 and 5), and whisper's encoder
over 15 frames.  The logits and every decode-state leaf, float32 smoke
models, the reference jitted.

Tolerance: ``atol=rtol=1e-4``, as ``test_torch_families.py`` (both
packages run float32 on the CPU; only the summation order differs).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_family_pairs import pair, port_params
from _torch_parity import to_numpy, to_torch
from repro_torch import tree as ttree

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 64
CASES = [("minitron-4b", 16), ("minitron-4b", 15), ("minitron-4b", 64),
         ("recurrentgemma-2b", 8), ("recurrentgemma-2b", 32),
         ("recurrentgemma-2b", 13), ("whisper-tiny", 8)]
ENC_SEQ = 15                 # whisper's frames: not a multiple of tp = 2


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch):
    return jax.jit(pair(arch)[2].prefill, static_argnames="max_len")


def _batch(cfg, s):
    rng = np.random.default_rng(s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (2, ENC_SEQ, cfg.d_model)).astype(np.float32) * 0.1
    return out


@pytest.mark.parametrize("arch,s", CASES)
def test_prefill_matches_the_reference_at_serve_lengths(arch, s):
    jc, tc, _, tm, jp = pair(arch)
    batch = _batch(tc, s)
    jl, jst = _jax_prefill(arch)(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                 max_len=MAX_LEN)
    tl, tst = tm.prefill(port_params(arch),
                         {k: to_torch(v) for k, v in batch.items()},
                         max_len=MAX_LEN)
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), **TOL)
    # both trees flatten in the same order (dict keys sorted, K before V)
    ja, ta = jax.tree.leaves(jst), ttree.leaves(tst)
    assert len(ja) == len(ta)
    for i, (a, b) in enumerate(zip(ja, ta)):
        assert tuple(a.shape) == tuple(b.shape), i
        np.testing.assert_allclose(to_numpy(b).astype(np.float32),
                                   np.asarray(a, np.float32), **TOL,
                                   err_msg=f"{arch} prefill of {s}: leaf {i}")
    if tc.window:                  # a windowed cache holds the last window
        caches = [x for x in jax.tree.leaves(jst) if x.ndim >= 4]
        assert caches and all(x.shape[-3] == tc.window for x in caches)
