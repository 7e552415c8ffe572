"""One rank of the sharded parity run (``test_torch_sharding_mesh.py``).

    python tests/_torch_sharding_worker.py RANK WORLD PORT OUT_DIR

Joins a ``gloo`` group of WORLD CPU processes at ``tcp://localhost:PORT``,
builds a (2, 2) ``("data", "model")`` DeviceMesh, runs each check of the
port's sharded paths against the port's own unsharded result on the same
inputs (float32 smoke models, weights from seed 0), and writes
``OUT_DIR/rank<RANK>.json``: ``{"checks": {name: measured value}}``.  A
check that raises writes its traceback instead of a value.
"""
import contextlib
import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from repro_torch import tree as ttree  # noqa: E402
from repro_torch.configs import ShapeSpec, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as k6  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.launch.mesh import make_host_device_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.sharding.partitioning import (ShardingPolicy,  # noqa: E402
                                               full_tensor)

PEAK_LR = 1e-3
CLIP = 0.5                   # below the smoke models' gradient norms
TOKENS = 256                 # two K6 query blocks a model rank under CP


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _tokens(b, s, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, s), generator=g, dtype=torch.int32)


def _err(a, b):
    return float((a - full_tensor(b)).abs().max())


def _prefill_pair(cfg, policy, tokens, max_len, specs_fn=None,
                  during=contextlib.nullcontext):
    """(unsharded prefill, sharded prefill, both models, params); the
    sharded prefill runs inside ``during()``."""
    m0 = build(cfg, device="cpu")
    m1 = build(cfg, device="cpu", policy=policy)
    p = m0.init(torch.Generator().manual_seed(0))
    specs = None if specs_fn is None else specs_fn(m1)
    out0 = m0.prefill(p, {"tokens": tokens}, max_len=max_len)
    ps = m1.place(p, specs)
    with during():
        out1 = m1.prefill(ps, {"tokens": tokens}, max_len=max_len)
    return out0, out1, (m0, m1), (p, ps)


def check_dense(mesh, out):
    pol = ShardingPolicy(mesh=mesh)
    cfg = _cfg("minitron-4b", n_kv_heads=1)
    tok = _tokens(4, 32)
    (l0, s0), (l1, s1), (m0, m1), (p, ps) = _prefill_pair(cfg, pol, tok, 64)
    out["kv_repeat"] = m1.impl.attn_cfg.kv_repeat
    out["prefill_tp"] = _err(l0, l1)
    nxt = torch.argmax(l0, dim=-1)[:, None].to(torch.int32)
    errs = []
    for _ in range(3):
        d0, s0 = m0.decode_step(p, nxt, s0)
        d1, s1 = m1.decode_step(ps, nxt, s1)
        errs.append(_err(d0, d1))
        nxt = torch.argmax(d0, dim=-1)[:, None].to(torch.int32)
    out["decode_tp"] = max(errs)
    # the placed cache, reassembled, is the unsharded one
    k0 = s0["body"].k
    out["decode_cache"] = _err(k0, s1["body"].k)
    # the DP-heavy serve layout: layer weights on (data x model), the cache
    # sequence-sharded over 'model' (each rank writes the slots it holds),
    # decoding from an empty state
    sv = ShardingPolicy(mesh=mesh, serve_layout=True)
    m2 = build(cfg, device="cpu", policy=sv)
    specs = m2.param_specs()
    for sub in ("prefix", "body"):
        if sub in specs:
            specs[sub] = sv.serve_param_specs(specs[sub])
    p2 = m2.place(p, specs)
    s0, s2 = m0.decode_state(4, 64), m2.decode_state(4, 64)
    out["serve_cache_seq_sharded"] = any(
        pl.is_shard(1) for pl in s2["body"].k.placements)
    nxt, errs = tok[:, :1], []
    for _ in range(3):
        d0, s0 = m0.decode_step(p, nxt, s0)
        d2, s2 = m2.decode_step(p2, nxt, s2)
        errs.append(_err(d0, d2))
        nxt = torch.argmax(d0, dim=-1)[:, None].to(torch.int32)
    out["decode_serve"] = max(errs)
    out["decode_serve_cache"] = _err(s0["body"].k, s2["body"].k)


def check_flash(mesh, out):
    cfg = _cfg("minitron-4b", n_kv_heads=1, flash_prefill=True)
    tok = _tokens(4, TOKENS)
    pol = ShardingPolicy(mesh=mesh)
    (l0, _), (l1, _), _, _ = _prefill_pair(cfg, pol, tok, TOKENS)
    out["prefill_flash_tp"] = _err(l0, l1)
    # context parallel: queries sharded on 'model', K/V whole, q_offset
    offsets = []
    real = k6.flash_attention

    @contextlib.contextmanager
    def spy_k6():
        def spy(q, k, v, **kw):
            offsets.append(int(kw.get("q_offset") or 0))
            return real(q, k, v, **kw)

        k6.flash_attention = spy
        try:
            yield
        finally:
            k6.flash_attention = real

    cp = ShardingPolicy(mesh=mesh, seq_shard=True, serve_layout=True,
                        cp_layout=True)

    def serve_specs(model):
        specs = model.param_specs()
        for sub in ("prefix", "body"):
            specs[sub] = cp.serve_param_specs(specs[sub], keep_data=True)
        return specs

    (l0, _), (l1, _), _, _ = _prefill_pair(cfg, cp, tok, TOKENS,
                                           serve_specs, spy_k6)
    out["prefill_cp"] = _err(l0, l1)
    out["cp_offsets"] = sorted(set(offsets))


def check_moe(mesh, out):
    cfg = _cfg("moonshot-v1-16b-a3b")
    tok = _tokens(4, 32)
    pol = ShardingPolicy(mesh=mesh)
    routes = []
    real = moe._route

    def spy(params, x, c):
        res = real(params, x, c)
        routes.append(res[1].clone())
        return res

    moe._route = spy
    try:
        (l0, _), (l1, _), _, _ = _prefill_pair(cfg, pol, tok, 64)
    finally:
        moe._route = real
    out["prefill_moe"] = _err(l0, l1)
    # the first half of the records is the unsharded run (whole batch),
    # the second this rank's rows of the sharded one
    n = len(routes) // 2
    rows = routes[n].shape[0]
    lo = mesh.get_local_rank("data") * rows
    out["moe_routes_differ"] = sum(
        int((a[lo:lo + rows] != b).sum()) for a, b in zip(routes[:n],
                                                          routes[n:]))
    out["moe_route_layers"] = n


def check_static_decode(mesh, out):
    """The serve's static decode step (``steps.DecodeGraph``, uncaptured
    off the card) on the sharded model: two batches through one static
    state of DTensors, the second shorter, each prefilled into it, against
    the eager step without a policy under the same uniforms."""
    cfg = _cfg("minitron-4b", n_kv_heads=1)
    m0 = build(cfg, device="cpu")
    m1 = build(cfg, device="cpu", policy=ShardingPolicy(mesh=mesh))
    p = m0.init(torch.Generator().manual_seed(0))
    ps = m1.place(p)
    shape = ShapeSpec("serve", 64, 4, "decode")
    graph = steps.DecodeGraph(m1, shape, sample_topk=5)
    eager = steps.make_serve_step(m0, shape, sample_topk=5)
    gen = torch.Generator().manual_seed(3)
    errs, differ, states = [], 0, []
    for s in (24, 9):
        tok = _tokens(4, s, seed=s)
        l0, s0 = m0.prefill(p, {"tokens": tok}, max_len=64)
        l1, s1 = graph.prefill(ps, {"tokens": tok})
        states.append(s1)
        errs.append(_err(l0, l1))
        n0 = n1 = torch.argmax(l0, dim=-1)[:, None].to(torch.int32)
        for _ in range(4):
            u = torch.rand((4, 5), generator=gen)
            n0, s0 = eager(p, n0, s0, u)
            n1, s1 = graph(ps, n1, s1, u)
            n1 = full_tensor(n1)
            differ += int((n0 != n1).sum())
        out["static_decode_t"] = int(full_tensor(s1["t"]))
    out["static_decode_prefill"] = max(errs)
    out["static_decode_tokens_differ"] = differ
    out["static_decode_state_reused"] = states[0] is states[1]


def _state_errs(sa, sb):
    """(largest moment error against its leaf's largest entry, largest
    master error)."""
    mom, master = 0.0, 0.0
    for k in sa:
        for a, b in zip(ttree.leaves(sa[k]), ttree.leaves(sb[k])):
            d = (a - full_tensor(b)).abs().max()
            if k == "master":
                master = max(master, float(d))
            else:
                mom = max(mom, float(d / a.abs().max().clamp(min=1e-30)))
    return mom, master


def check_train(mesh, out, arch, name, seq_shard=False, optimizer="adamw"):
    cfg = _cfg(arch)
    pol = ShardingPolicy(mesh=mesh, seq_shard=seq_shard)
    m0 = build(cfg, device="cpu")            # remat on, as the default
    m1 = build(cfg, device="cpu", policy=pol)
    p = m0.init(torch.Generator().manual_seed(0))
    tok = _tokens(4, 32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    loss0, _, g0 = steps.loss_and_grads(m0, p, batch)
    with steps.sharded(pol):
        loss1, _, g1 = steps.loss_and_grads(m1, m1.place(p),
                                            steps.place_batch(m1, batch))
    out[f"{name}_loss_rel"] = float(abs(loss0 - full_tensor(loss1))
                                    / abs(loss0))
    out[f"{name}_grad_rel"] = max(
        float((a - full_tensor(b)).abs().max() / a.abs().max().clamp(
            min=1e-30)) for a, b in zip(ttree.leaves(g0), ttree.leaves(g1)))
    # three optimizer steps (the first at the warmup's lr 0), each on a
    # batch of its own; the global norm clips (``CLIP`` is below it), and
    # Adafactor factors the smoke model's matrices (32 <= both dims)
    shape = ShapeSpec("t", 32, 4, "train")
    sched = opt_lib.cosine_schedule(PEAK_LR, warmup=1, total=10)
    opt = (opt_lib.adafactor(sched, clip_norm=CLIP, min_dim_factored=32)
           if optimizer == "adafactor" else opt_lib.adamw(sched,
                                                          clip_norm=CLIP))
    f0 = steps.build_train_step(m0, opt, shape)
    f1 = steps.build_train_step(m1, opt, shape)
    pa = ttree.map(lambda t: t.clone(), p)
    sa = opt.init(pa)
    pb, sb = steps.place_train_state(
        m1, opt, ttree.map(lambda t: t.clone(), p),
        opt.init(ttree.map(lambda t: t.clone(), p)))
    loss_rel, gnorm_rel, lrs, gnorms = [], [], [], []
    for step in range(3):
        tok = _tokens(4, 32, seed=10 + step)
        bt = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
        pa, sa, ma = f0(pa, sa, step, bt)
        pb, sb, mb = f1(pb, sb, step, steps.place_batch(m1, bt))
        loss_rel.append(float(abs(ma["loss"] - full_tensor(mb["loss"]))
                              / abs(ma["loss"])))
        gnorm_rel.append(float(abs(ma["grad_norm"]
                                   - full_tensor(mb["grad_norm"]))
                               / ma["grad_norm"]))
        gnorms.append(float(ma["grad_norm"]))
        lrs.append(float(full_tensor(mb["lr"])))
    out[f"{name}_step_loss_rel"] = max(loss_rel)
    out[f"{name}_gnorm_rel"] = max(gnorm_rel)
    out[f"{name}_clipped"] = min(gnorms) > CLIP
    out[f"{name}_lrs"] = lrs
    out[f"{name}_factored"] = sum("vr" in k for k, _ in
                                  ttree.leaves_with_path(sb))
    out[f"{name}_moment_rel"], out[f"{name}_master_err"] = _state_errs(sa,
                                                                       sb)
    out[f"{name}_param_err"] = max(
        _err(a, b) for a, b in zip(ttree.leaves(pa), ttree.leaves(pb)))


def check_roundtrip(mesh, out):
    pol = ShardingPolicy(mesh=mesh)
    model = build(_cfg("moonshot-v1-16b-a3b"), device="cpu", policy=pol)
    p = model.init(torch.Generator().manual_seed(0))
    placed = model.place(p)
    bad, local_bad = 0, 0
    for whole, d in zip(ttree.leaves(p), ttree.leaves(placed)):
        bad += int(not torch.equal(whole, full_tensor(d)))
        # the local shard is the slice its placements name, data-major
        want = whole
        for i, pl in enumerate(d.placements):
            if pl.is_shard():
                n, j = mesh.size(i), mesh.get_local_rank(i)
                step = want.shape[pl.dim] // n
                want = want.narrow(pl.dim, j * step, step)
        local_bad += int(not torch.equal(want, d.to_local()))
    out["roundtrip_whole_mismatches"] = bad
    out["roundtrip_local_mismatches"] = local_bad
    out["roundtrip_leaves"] = len(ttree.leaves(p))


def check_resume(mesh, out, ckpt_root):
    """Train a step on the (2, 2) mesh, checkpoint, resume on a (1, 4)
    mesh for one more (``launch.train``, the float32 smoke model); against
    the same runs without a policy."""
    kw = dict(smoke=True, batch=4, seq=32, lr=PEAK_LR, ckpt_every=1,
              log_every=100, device="cpu")
    plain = os.path.join(ckpt_root, f"plain{dist.get_rank()}")
    placed = os.path.join(ckpt_root, "placed")
    real = train_lib.get_smoke_config
    train_lib.get_smoke_config = _cfg
    try:
        want = (train_lib.train("minitron-4b", steps=1, ckpt_dir=plain, **kw)
                + train_lib.train("minitron-4b", steps=2, ckpt_dir=plain,
                                  **kw))
        got = train_lib.train("minitron-4b", steps=1, ckpt_dir=placed,
                              policy=ShardingPolicy(mesh=mesh), **kw)
        dist.barrier()                   # rank 0's checkpoint is written
        other = make_host_device_mesh((1, 4), device="cpu")
        got += train_lib.train("minitron-4b", steps=2, ckpt_dir=placed,
                               policy=ShardingPolicy(mesh=other), **kw)
        dist.barrier()
    finally:
        train_lib.get_smoke_config = real
    out["resume_steps"] = len(got)
    out["resume_loss_rel"] = max(abs(a - b) / abs(a)
                                 for a, b in zip(want, got))
    # the two runs' checkpoints at step 2 hold the same leaves, alike
    da, db = (os.path.join(d, "step_00000002") for d in (plain, placed))
    ma, mb = (json.load(open(os.path.join(d, "manifest.json")))["leaves"]
              for d in (da, db))
    out["resume_ckpt_same_leaves"] = ma == mb
    mom, off, n = 0.0, 0, 0
    for k in ma:
        fa, fb = (np.load(os.path.join(d, Checkpointer._fname(k) + ".npy"))
                  for d in (da, db))
        d = np.abs(fa - fb)
        if k.startswith("['opt']['m']") or k.startswith("['opt']['v']"):
            mom = max(mom, float(d.max()) / max(float(np.abs(fa).max()),
                                                1e-30))
        else:                            # the parameters and the master
            off += int((d > 1e-3 * PEAK_LR).sum())
            n += d.size
    out["resume_ckpt_moment_rel"] = mom
    out["resume_ckpt_master_off"] = off / n


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_host_device_mesh((2, 2), device="cpu")
    checks, errors = {}, {}
    for fn, args in ((check_dense, ()), (check_flash, ()), (check_moe, ()),
                     (check_static_decode, ()),
                     (check_train, ("minitron-4b", "train_dense")),
                     (check_train, ("moonshot-v1-16b-a3b", "train_moe")),
                     (check_train, ("minitron-4b", "train_sp", True)),
                     (check_train, ("moonshot-v1-16b-a3b", "train_adafactor",
                                    False, "adafactor")),
                     (check_roundtrip, ()),
                     (check_resume, (os.path.join(out_dir, "ckpt"),))):
        try:
            fn(mesh, checks, *args)
        except Exception:  # noqa: BLE001 — reported to the test
            errors[fn.__name__ + "".join(f"-{a}" for a in args[1:])] = \
                traceback.format_exc()[-3000:]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"checks": checks, "errors": errors}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
