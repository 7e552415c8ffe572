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
from repro_torch.launch import serve as serve_lib  # noqa: E402
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
    p2 = m2.place(p, sv.layout_param_specs(m2.param_specs()))
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


def _tree_err(a, b):
    """The largest entry difference of two states, leaf by leaf (``b``'s
    DTensors reassembled; a cache of ``b`` whose kv heads a policy
    repeated up to tp, ``kv_repeat``, against ``a``'s heads repeated
    alike).  The two states must hold as many leaves, of equal shapes."""
    la, lb = ttree.leaves(a), ttree.leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"states of {len(la)} and {len(lb)} leaves")
    errs = []
    for x, y in zip(la, lb):
        if x.dim() >= 4 and x.shape[-2] != y.shape[-2]:
            x = x.repeat_interleave(y.shape[-2] // x.shape[-2], dim=-2)
        if tuple(x.shape) != tuple(y.shape):
            raise AssertionError(f"a leaf of shape {tuple(y.shape)} against "
                                 f"{tuple(x.shape)}")
        errs.append(_err(x.float(), y.float()))
    return max(errs)


def _serve_pair(cfg, policy):
    """(unsharded model, policy model, params, params placed by the
    policy's layout: a serve layout's layer weights by
    ``layout_param_specs``)."""
    m0 = build(cfg, device="cpu")
    m1 = build(cfg, device="cpu", policy=policy)
    p = m0.init(torch.Generator().manual_seed(0))
    return m0, m1, p, m1.place(p, policy.layout_param_specs(
        m1.param_specs()))


def _prefill_decode(out, name, models, params, batch, max_len, states=None,
                    steps=3):
    """Prefill ``batch`` on both models (into ``states`` in place when
    given), then ``steps`` greedy decode steps; records the largest logit
    error of the prefill and of the decode steps, and the reassembled
    state's after the prefill and after the last step.  Returns the two
    states."""
    (m0, m1), (p0, p1) = models, params
    s0, s1 = states if states is not None else (None, None)
    l0, s0 = m0.prefill(p0, batch, max_len=max_len, state=s0)
    l1, s1 = m1.prefill(p1, batch, max_len=max_len, state=s1)
    out[f"{name}_prefill"] = _err(l0, l1)
    out[f"{name}_prefill_state"] = _tree_err(s0, s1)
    nxt, errs = torch.argmax(l0, dim=-1)[:, None].to(torch.int32), []
    for _ in range(steps):
        d0, s0 = m0.decode_step(p0, nxt, s0)
        d1, s1 = m1.decode_step(p1, nxt, s1)
        errs.append(_err(d0, d1))
        nxt = torch.argmax(d0, dim=-1)[:, None].to(torch.int32)
    if steps:
        out[f"{name}_decode"] = max(errs)
        out[f"{name}_decode_state"] = _tree_err(s0, s1)
    return s0, s1


def check_serve_layout_prefill(mesh, out):
    """The DP-heavy serve layout (layer weights on (data x model), the KV
    cache sequence-sharded over 'model') prefilled from prompts of any
    length against the unsharded port, each followed by 3 decode steps:
    shorter than the cache (16 and 15, the latter not divisible by tp);
    as long as it (a window of 8 filled by 8; minitron's 64 into 64, which
    leaves no slot to decode into); past the window (32 and 13: rolls of
    0 and 5); a prefill into a state that already holds values.  Then
    whisper under the cp layout with 15 encoder frames, which tp does not
    divide (fault 3g's uneven sequence shard)."""
    sv = ShardingPolicy(mesh=mesh, serve_layout=True)
    m0, m1, p, ps = _serve_pair(_cfg("minitron-4b"), sv)
    _prefill_decode(out, "serve_minitron_64", (m0, m1), (p, ps),
                    {"tokens": _tokens(4, 64, 64)}, 64, steps=0)
    for arch, prompts, again in (("minitron-4b", (16, 15), 15),
                                 ("recurrentgemma-2b", (8, 32, 13), 13)):
        m0, m1, p, ps = _serve_pair(_cfg(arch), sv)
        key = arch.split("-")[0]
        caches = [st for st in ttree.leaves(m1.decode_state(4, 64))
                  if st.dim() >= 4]
        out[f"serve_{key}_cache_seq_sharded"] = all(
            any(pl.is_shard(st.dim() - 3) for pl in st.placements)
            for st in caches) and bool(caches)
        for s in prompts:
            states = _prefill_decode(out, f"serve_{key}_{s}", (m0, m1),
                                     (p, ps), {"tokens": _tokens(4, s, s)},
                                     64)
        # the last states hold a prompt and 3 decoded tokens: fill them in
        # place with a shorter prompt (slots past it keep what they held)
        _prefill_decode(out, f"serve_{key}_{again}_into", (m0, m1), (p, ps),
                        {"tokens": _tokens(4, again, 7)}, 64, states)
    # ``serve`` itself: its static decode state refilled batch after
    # batch from prompts shorter than max_len, the layer weights placed
    # by ``layout_param_specs``
    kw = dict(config=_cfg("minitron-4b"), n_requests=4, batch_size=2,
              decode_steps=3, topk=10, max_len=64, device="cpu",
              distributed_queue=False)
    toks = [{r.rid: r.out.tolist() for r in serve_lib.serve(
        "minitron-4b", policy=pol, **kw)[0]} for pol in (None, sv)]
    out["serve_layout_serve_requests"] = len(toks[1])
    out["serve_layout_serve_tokens_differ"] = sum(
        toks[0][rid] != toks[1].get(rid) for rid in toks[0])
    cp = ShardingPolicy(mesh=mesh, seq_shard=True, serve_layout=True,
                        cp_layout=True)
    cfg = _cfg("whisper-tiny", enc_seq=15)
    m0, m1, p, ps = _serve_pair(cfg, cp)
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": _tokens(2, 8, 8),
             "frames": torch.randn((2, 15, cfg.d_model), generator=g)}
    _prefill_decode(out, "serve_whisper_cp", (m0, m1), (p, ps), batch, 64)


def check_ssm_decode(mesh, out):
    """mamba2's SSD mixer under tensor parallelism: a prefill and 3
    decode steps, each step's recurrent update on each rank's batch rows
    (``policy.run_rows``, as the prefill's)."""
    m0, m1, p, ps = _serve_pair(_cfg("mamba2-1.3b"),
                                ShardingPolicy(mesh=mesh))
    _prefill_decode(out, "tp_mamba2", (m0, m1), (p, ps),
                    {"tokens": _tokens(4, 13, 13)}, 64)


def check_batch_of_one(mesh, out):
    """A batch of one on a (1, 4) mesh, whose 'data' axis of size 1 once
    placed it as a one-way shard that a view could not drop (fault 3h):
    minitron under tensor parallelism and under the serve layout (its
    cache sequence-sharded 4 ways, a 13-token prompt), whisper under the
    serve layout; each a prefill and 3 decode steps."""
    other = make_host_device_mesh((1, 4), device="cpu")
    for name, arch, pol in (
            ("minitron_tp", "minitron-4b", ShardingPolicy(mesh=other)),
            ("minitron_dp", "minitron-4b",
             ShardingPolicy(mesh=other, serve_layout=True)),
            ("whisper_dp", "whisper-tiny",
             ShardingPolicy(mesh=other, serve_layout=True))):
        cfg = _cfg(arch)
        m0, m1, p, ps = _serve_pair(cfg, pol)
        batch = {"tokens": _tokens(1, 13, 13)}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(
                (1, cfg.enc_seq, cfg.d_model),
                generator=torch.Generator().manual_seed(6))
        _prefill_decode(out, f"one_{name}", (m0, m1), (p, ps), batch, 64)


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

    (l0, _), (l1, _), _, _ = _prefill_pair(
        cfg, cp, tok, TOKENS, lambda m: cp.layout_param_specs(
            m.param_specs()), spy_k6)
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


def check_static_train(mesh, out):
    """The train step at static addresses (``steps.TrainGraph``, run
    uncaptured off the card) on the MoE model under the policy against
    the eager policy step: three steps, each on a batch of its own, every
    metric and every parameter and optimizer-state leaf compared shard by
    shard."""
    cfg = _cfg("moonshot-v1-16b-a3b")
    model = build(cfg, device="cpu", policy=ShardingPolicy(mesh=mesh))
    p = model.init(torch.Generator().manual_seed(0))
    opt = opt_lib.adamw(opt_lib.cosine_schedule(PEAK_LR, warmup=1,
                                                total=10), clip_norm=CLIP)
    fn = steps.build_train_step(model, opt, ShapeSpec("t", 32, 4, "train"))

    def placed():
        q = ttree.map(torch.clone, p)
        return steps.place_train_state(model, opt, q, opt.init(q))

    (pa, sa), (pb, sb) = placed(), placed()
    graph = steps.TrainGraph(model, fn)

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    metrics_differ = 0
    for step in range(3):
        tok = _tokens(4, 32, seed=20 + step)
        batch = steps.place_batch(model, {"tokens": tok,
                                          "labels": torch.roll(tok, -1, 1)})
        pa, sa, ma = fn(pa, sa, step, batch)
        pb, sb, mb = graph(pb, sb, step, batch)
        metrics_differ += sum(not torch.equal(local(ma[k]), local(mb[k]))
                              for k in ma)
    a = ttree.leaves(pa) + ttree.leaves(sa)
    b = ttree.leaves(pb) + ttree.leaves(sb)
    out["static_train_leaves"] = len(a)
    out["static_train_leaves_differ"] = sum(
        not torch.equal(local(x), local(y)) for x, y in zip(a, b))
    out["static_train_metrics_differ"] = metrics_differ
    out["static_train_placed"] = sum(hasattr(x, "to_local") for x in b)


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
    for fn, args in ((check_dense, ()), (check_serve_layout_prefill, ()),
                     (check_ssm_decode, ()), (check_batch_of_one, ()),
                     (check_flash, ()), (check_moe, ()),
                     (check_static_decode, ()),
                     (check_static_train, ()),
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
