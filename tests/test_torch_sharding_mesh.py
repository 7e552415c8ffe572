"""The port's sharded paths on a (2, 2) ``("data", "model")`` CPU mesh.

Four ``gloo`` processes (``tests/_torch_sharding_worker.py``) are started
once for the module; each runs every check and reports what it measured,
and the parametrised tests below hold each rank's numbers.  The reference
is the port's own unsharded run on the same inputs (float32 smoke models,
weights from seed 0): the unsharded port is held to the JAX package by the
other test files, and the JAX package's own sharded paths do not run under
jax 0.9.0.

Tolerances: float32 logits within 1e-4 (a sharded product sums its
partial products in another order: a few ulp of logits of order 1-10);
losses within 1e-5 relative; gradients within 1e-4 of each leaf's largest
entry (``train_sp``: the dense model with sequence parallelism, its
``sp_gather`` / ``sp_scatter`` around each block).  Train steps: three
steps on three batches, the last two at lr > 0, with the global norm
clipping (the clip norm is below the gradients' norm, so a norm taken over
a rank's own shards would scale the moments).  Each step's loss and
gradient norm within 1e-5 relative; every optimizer moment leaf (AdamW's m
and v, Adafactor's factored vr / vc and whole v) within 1e-4 of its own
largest entry; the master copy and the parameters within 1e-2 lr (Adam
moves an entry by about lr whatever its gradient, so a skipped or
reversed update is off by lr or 2 lr; measured: below 1e-3 lr).  MoE
routing: the same experts, pair for pair.  Checkpoint and resume
(``launch.train``: a step on the (2, 2) mesh, saved, one more on a
(1, 4) mesh): both losses within 1e-5 relative of a run without a policy;
in the two step-2 checkpoints every moment leaf within 1e-4 of its
largest entry, and at most 1e-3 of the parameter and master entries more
than 1e-3 lr apart (two steps at lr > 0: an entry whose gradient is near
zero may move by up to about 2 lr a step either way; a lost or misplaced
state moves nearly every entry).
"""
import json
import os
import socket
import subprocess
import sys
import time

import pytest

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
LOGIT_TOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_mesh")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_sharding_worker.py"),
         str(r), str(WORLD), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.time() + 600
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1, deadline - time.time()))
                        [0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    res = []
    for r in range(WORLD):
        path = out / f"rank{r}.json"
        assert path.exists(), f"rank {r} wrote nothing:\n{logs[r][-4000:]}"
        res.append(json.loads(path.read_text()))
    return res


RANKS = list(range(WORLD))


def _check(ranks, rank, name):
    got = ranks[rank]
    assert not got["errors"], got["errors"]
    return got["checks"][name]


@pytest.mark.parametrize("rank", RANKS)
def test_dense_prefill_and_decode_tp(ranks, rank):
    assert _check(ranks, rank, "kv_repeat") == 2      # n_kv 1 on tp 2
    assert _check(ranks, rank, "prefill_tp") <= LOGIT_TOL
    assert _check(ranks, rank, "decode_tp") <= LOGIT_TOL
    assert _check(ranks, rank, "decode_cache") <= LOGIT_TOL
    # the serve layout: a sequence-sharded cache written slot by slot
    assert _check(ranks, rank, "serve_cache_seq_sharded")
    assert _check(ranks, rank, "decode_serve") <= LOGIT_TOL
    assert _check(ranks, rank, "decode_serve_cache") <= LOGIT_TOL


@pytest.mark.parametrize("rank", RANKS)
def test_flash_prefill_heads_sharded(ranks, rank):
    assert _check(ranks, rank, "prefill_flash_tp") <= LOGIT_TOL


@pytest.mark.parametrize("rank", RANKS)
def test_context_parallel_prefill_offsets(ranks, rank):
    assert _check(ranks, rank, "prefill_cp") <= LOGIT_TOL
    # rank = data * 2 + model: model rank 1 owns queries 128..255
    want = [0] if rank % 2 == 0 else [128]
    assert _check(ranks, rank, "cp_offsets") == want


@pytest.mark.parametrize("rank", RANKS)
def test_moe_prefill_routes_alike(ranks, rank):
    assert _check(ranks, rank, "prefill_moe") <= LOGIT_TOL
    assert _check(ranks, rank, "moe_route_layers") == 2
    assert _check(ranks, rank, "moe_routes_differ") == 0


@pytest.mark.parametrize("rank", RANKS)
def test_static_decode_step_under_the_policy(ranks, rank):
    """Two batches decoded through one static state of DTensors (each
    prefilled into it) give the unsharded eager step's tokens."""
    assert _check(ranks, rank, "static_decode_prefill") <= LOGIT_TOL
    assert _check(ranks, rank, "static_decode_tokens_differ") == 0
    assert _check(ranks, rank, "static_decode_state_reused")
    assert _check(ranks, rank, "static_decode_t") == 9 + 4


@pytest.mark.parametrize("name", ["train_dense", "train_moe", "train_sp",
                                  "train_adafactor"])
@pytest.mark.parametrize("rank", RANKS)
def test_train_step_with_remat(ranks, rank, name):
    assert _check(ranks, rank, f"{name}_loss_rel") <= 1e-5
    assert _check(ranks, rank, f"{name}_grad_rel") <= 1e-4
    lrs = _check(ranks, rank, f"{name}_lrs")
    assert lrs[0] == 0 and min(lrs[1:]) > 0
    assert _check(ranks, rank, f"{name}_clipped")
    assert _check(ranks, rank, f"{name}_step_loss_rel") <= 1e-5
    assert _check(ranks, rank, f"{name}_gnorm_rel") <= 1e-5
    assert _check(ranks, rank, f"{name}_moment_rel") <= 1e-4
    assert _check(ranks, rank, f"{name}_master_err") <= 1e-2 * max(lrs)
    assert _check(ranks, rank, f"{name}_param_err") <= 1e-2 * max(lrs)
    if name == "train_adafactor":
        assert _check(ranks, rank, f"{name}_factored") > 0


@pytest.mark.parametrize("rank", RANKS)
def test_checkpoint_resumes_on_another_mesh(ranks, rank):
    assert _check(ranks, rank, "resume_steps") == 2
    assert _check(ranks, rank, "resume_loss_rel") <= 1e-5
    assert _check(ranks, rank, "resume_ckpt_same_leaves")
    assert _check(ranks, rank, "resume_ckpt_moment_rel") <= 1e-4
    assert _check(ranks, rank, "resume_ckpt_master_off") <= 1e-3


@pytest.mark.parametrize("rank", RANKS)
def test_param_sharding_round_trip(ranks, rank):
    assert _check(ranks, rank, "roundtrip_leaves") > 10
    assert _check(ranks, rank, "roundtrip_whole_mismatches") == 0
    assert _check(ranks, rank, "roundtrip_local_mismatches") == 0
