"""Shared helpers of the training parity tests of every family: the
reference and port smoke models in float32 with remat on, built once an
architecture, and a batch of each family's inputs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jsmoke
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch import tree as ttree
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.models import model_zoo as tzoo

from _torch_parity import to_numpy, to_torch


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(reference cfg, port cfg, reference model, port model, reference
    params): float32 smoke models, remat on in both."""
    jc = dataclasses.replace(jsmoke(arch), dtype="float32")
    tc = dataclasses.replace(tsmoke(arch), dtype="float32")
    jm = jzoo.build(jc, policy=None, remat=True)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = tzoo.build(tc, device="cpu")
    return jc, tc, jm, tm, jax.tree.map(np.asarray, jp)


def port_params(arch):
    jc, tc, _, _, jp = pair(arch)
    return convert.params_from_jax(jp, tc, device="cpu")


@functools.lru_cache(maxsize=None)
def jit_value_and_grad(arch):
    jm = pair(arch)[2]
    return jax.jit(jax.value_and_grad(jm.loss, has_aux=True))


def family_batch(cfg, b, s, seed):
    """A numpy batch of the family's inputs: tokens and labels (a masked
    run inside a row); frames for the encoder-decoder; vision embeddings
    and M-RoPE positions whose three rows differ for the vlm."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    labels[0, :3] = -100
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32) * 0.1
        pos = np.arange(s, dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.stack([pos, pos // 2, pos % 4]), (b, 3, s)
        ).transpose(1, 0, 2).copy()
    return out


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: to_torch(v) for k, v in batch.items()})


def close_trees(jtree, ttree_, tol, what):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = ttree.leaves_with_path(ttree_)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(
            to_numpy(b).astype(np.float32), np.asarray(a, np.float32),
            **tol, err_msg=f"{what} {jax.tree_util.keystr(path)}")
