"""Serving driver: prefill + decode with a length-sorted batch scheduler.

The port of the JAX package's ``launch/serve.py``.  Requests
are sorted by prompt length through the port's ``argsort`` so each prefill
batch is length-homogeneous; each batch is left-padded to its longest
prompt (the pad tokens are attended to, as in the reference), prefilled
(through K6 with ``--flash-prefill``), and decoded a token at a time with
top-k sampling through the port's ``topk``.  The served requests are then
accounted by prompt length with one ``relational.group_by``
(``batch_accounting``), and with obs on the SLO report is printed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
      --smoke --device cpu --requests 6 --batch-size 3 --decode-steps 8

On the card every decode step is a replay of one CUDA graph a batch size
(``steps.DecodeGraph``: the port's counterpart of the reference's jitted
step; each prefill fills the graph's static state); on the CPU the same
static step runs without a graph.  ``serve`` builds the host mesh (every
card, ``launch.mesh.make_host_mesh``; one CPU entry on the CPU):
``restore_state`` / ``snapshot_state`` carry its topology beside the
tuning profile, and with ``distributed_queue`` (on by default where the
mesh has more than one entry) the scheduler sorts a backlog of at least
its ``distributed_min`` requests over it.  With a sharding ``policy``
(``sharding.partitioning.ShardingPolicy`` on a ``DeviceMesh``, one
process a rank) the model's weights are DTensors placed by its specs and
every prefill and decode step runs sharded; the tokens come back whole
on every rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import relational
from repro_torch import sort as sorting
from repro_torch.configs.base import ShapeSpec, get_config, get_smoke_config
from repro_torch.core import topology as _topology
from repro_torch.core import tuning as _tuning
from repro_torch.core.sortspec import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model_zoo import build
from repro_torch.obs import metrics as _metrics, report as _obs_report, \
    trace as _obs
from repro_torch.sharding.partitioning import full_tensor

# where serve persists its tuning snapshot between runs (the --state-dir
# flag overrides; unset means no persistence)
SERVE_STATE_ENV = "REPRO_TORCH_SERVE_STATE_DIR"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (len,) int32
    max_new: int = 32
    out: Optional[np.ndarray] = None
    submit_t: float = 0.0       # monotonic clock at submit()


class LengthSortedScheduler:
    """Batch requests by sorted prompt length (paper technique #3).

    Each batch is anchored at the oldest queued request and filled with its
    adjacent-length neighbours from the sorted order (the window with the
    smallest length spread that contains the anchor), which bounds every
    request's wait at its arrival backlog while keeping batches
    length-homogeneous.  ``method`` is any backend name of the port's
    ``argsort`` (``"auto"``: the planner's pick); the sort runs on
    ``device``.

    With a ``mesh`` the backlog sort goes mesh-global once the mesh has
    more than one entry and the backlog reaches ``distributed_min``: a
    packed (length, position) composite is value-sorted over the mesh
    (``axis_name`` as ``distributed_sort`` takes it), and its low bits are
    the order.  ``mesh_sorts`` counts the sorts that took that path.
    """

    def __init__(self, batch_size: int, method: str = "auto", *,
                 mesh=None, axis_name=None, distributed_min: int = 4096,
                 device="cuda"):
        self.batch_size = batch_size
        self.method = method
        self.mesh = mesh
        self.axis_name = axis_name
        self.distributed_min = distributed_min
        self.device = resolve_device(device)
        self.queue: List[Request] = []
        self.mesh_sorts = 0

    def submit(self, req: Request) -> None:
        req.submit_t = time.monotonic()
        self.queue.append(req)

    def _n_dev(self) -> int:
        if self.mesh is None:
            return 1
        from repro_torch.engine import samplesort
        axes = samplesort._axes_tuple(self.mesh, self.axis_name)
        return samplesort._n_dev(self.mesh, axes)

    def _order(self, lens: np.ndarray) -> np.ndarray:
        n = lens.shape[0]
        idx_bits = max(1, (n - 1).bit_length())
        distributed = (self._n_dev() > 1 and n >= self.distributed_min
                       and int(lens.max()) < (1 << (31 - idx_bits)))
        if not distributed:
            order = sorting.argsort(torch.from_numpy(lens),
                                    method=self.method, device=self.device)
            return order.cpu().numpy()
        # the mesh path value-sorts a packed (length, position) composite
        comp = (lens.astype(np.int32) << idx_bits) \
            | np.arange(n, dtype=np.int32)
        out = sorting.sort(torch.from_numpy(comp), mesh=self.mesh,
                           axis_name=self.axis_name)
        self.mesh_sorts += 1
        if _obs.enabled():
            _metrics.counter("serve.mesh_backlog_sorts").inc()
        return out.cpu().numpy() & ((1 << idx_bits) - 1)

    def next_batch(self) -> List[Request]:
        if not self.queue:
            return []
        lens_np = np.asarray([len(r.prompt) for r in self.queue],
                             dtype=np.int32)
        order = self._order(lens_np)
        n, b = len(self.queue), min(self.batch_size, len(self.queue))
        # anchor: the oldest queued request (position 0 of the queue)
        anchor = int(np.nonzero(order == 0)[0][0])
        # lengths in schedule order ascend, so a window's spread is its
        # last minus its first
        sl = lens_np[order]
        best_start, best_spread = None, None
        for start in range(max(0, anchor - b + 1), min(anchor, n - b) + 1):
            spread = int(sl[start + b - 1] - sl[start])
            if best_spread is None or spread < best_spread:
                best_start, best_spread = start, spread
        window = order[best_start:best_start + b]
        batch = [self.queue[i] for i in window]
        picked = set(int(i) for i in window)
        self.queue = [r for i, r in enumerate(self.queue)
                      if i not in picked]
        return batch

    def padding_waste(self, batch: List[Request]) -> float:
        if not batch:
            return 0.0
        lens = [len(r.prompt) for r in batch]
        return 1.0 - sum(lens) / (len(lens) * max(lens))


def left_pad(batch: List[Request]) -> np.ndarray:
    """The batch's prompts left-padded with token 0 to the longest: (B, L)
    int32."""
    plen = max(len(r.prompt) for r in batch)
    toks = np.zeros((len(batch), plen), np.int32)
    for i, r in enumerate(batch):
        toks[i, plen - len(r.prompt):] = r.prompt
    return toks


def make_requests(vocab_size: int, n_requests: int, max_len: int,
                  decode_steps: int, rng: np.random.Generator
                  ) -> List[Request]:
    """The reference's request stream: prompt lengths in [4, max_len / 4)
    and tokens drawn from ``rng`` (``numpy.random.default_rng(seed)`` in
    ``serve``, which goes on to draw an encoder-decoder's frames), so both
    packages serve the same requests from the same seed."""
    reqs = []
    for rid in range(n_requests):
        plen = int(rng.integers(4, max_len // 4))
        reqs.append(Request(rid=rid, prompt=rng.integers(
            0, vocab_size, plen).astype(np.int32), max_new=decode_steps))
    return reqs


def resolve_state_dir(explicit: Optional[str] = None
                      ) -> Optional[pathlib.Path]:
    """The serve state directory: the explicit argument, else the
    ``REPRO_TORCH_SERVE_STATE_DIR`` environment variable, else None (no
    persistence)."""
    d = explicit if explicit is not None \
        else os.environ.get(SERVE_STATE_ENV)
    return pathlib.Path(d) if d else None


def restore_state(state_dir: os.PathLike, mesh=None) -> List[str]:
    """Restore a previous run's tuning profile (and, given the serving
    mesh, its topology) from ``state_dir`` as the active ones.
    Identity-gated: a profile whose device fingerprint differs (a snapshot
    copied from another machine), or a topology whose (fingerprint, mesh
    signature) does not match the mesh, is skipped, never trusted.
    Returns the names of what was restored."""
    restored: List[str] = []
    pp = _tuning.profile_path(state_dir)
    if pp.is_file():
        try:
            prof = _tuning.load(pp)
            if prof.fingerprint == _tuning.device_fingerprint():
                _tuning.set_active(dataclasses.replace(
                    prof, source="persisted"))
                restored.append("tuning profile")
        except _tuning.ProfileError:
            pass
    if mesh is not None:
        want = _topology.from_mesh(mesh)
        tp = _topology.topology_path(want, directory=state_dir)
        if tp.is_file():
            try:
                topo = _topology.load(tp)
                if (topo.fingerprint == want.fingerprint
                        and topo.signature() == want.signature()):
                    _topology.set_active(dataclasses.replace(
                        topo, source="persisted"))
                    restored.append("topology")
            except _topology.TopologyError:
                pass
    return restored


def snapshot_state(state_dir: os.PathLike, mesh=None) -> List[pathlib.Path]:
    """Snapshot the active tuning profile (and, given the serving mesh,
    the topology resolved for it) into ``state_dir`` so the next run
    starts from this run's calibration.  Returns the written paths."""
    prof = _tuning.active()
    paths = [_tuning.save(prof, _tuning.profile_path(state_dir,
                                                     prof.fingerprint))]
    if mesh is not None:
        topo = _topology.for_mesh(mesh)
        paths.append(_topology.save(
            topo, _topology.topology_path(topo, directory=state_dir)))
    return paths


def batch_accounting(done: List[Request], *, device="cuda"):
    """Per-prompt-length accounting of the completed requests: one
    ``relational.group_by`` (prompt length -> generated-token count) with
    ``agg=("count", "mean")`` on ``device``.  Returns ascending
    ``[(prompt_len, n_requests, mean_new_tokens), ...]``."""
    if not done:
        return []
    lens = torch.tensor([len(r.prompt) for r in done], dtype=torch.int32)
    gen = torch.tensor([0 if r.out is None else len(r.out) for r in done],
                       dtype=torch.int32)
    gb = relational.group_by(lens, gen, agg=("count", "mean"),
                             device=device)
    g = int(gb.n_groups)
    keys = gb.keys[:g].tolist()
    cnt = gb.aggregates[0][:g].tolist()
    mean = gb.aggregates[1][:g].tolist()
    return [(int(k), int(c), float(m)) for k, c, m in zip(keys, cnt, mean)]


def host_mesh(device):
    """The serving mesh: every card of this machine as a 1-D ``data`` mesh
    (``launch.mesh.make_host_mesh``), or one CPU entry on the CPU."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch.mesh import make_host_mesh
    if resolve_device(device).type == "cpu":
        return make_mesh((1,), ("data",), "cpu")
    return make_host_mesh()


def serve(arch: str, smoke: bool = True, n_requests: int = 16,
          batch_size: int = 8, decode_steps: int = 32, topk: int = 50,
          seed: int = 0, max_len: int = 256,
          distributed_queue: Optional[bool] = None,
          state_dir: Optional[str] = None, *, device="cuda",
          flash_prefill: Optional[bool] = None, policy=None, config=None):
    """Serve ``n_requests`` random requests of ``arch`` (``smoke``: its
    reduced config; ``config``: this ``ModelConfig`` instead, e.g. a depth
    cut) on ``device`` (default ``"cuda"``) with weights drawn from
    ``seed``.  ``flash_prefill`` overrides the config's flag (K6 for the
    prefill's attention).  ``distributed_queue`` (default: on where the
    host mesh, ``host_mesh(device)``, has more than one entry) sorts the
    scheduler's backlog over the host mesh once it reaches the
    scheduler's ``distributed_min``.  ``state_dir`` (or ``REPRO_TORCH_SERVE_STATE_DIR``)
    restores the snapshotted tuning profile and the mesh's topology on
    startup and snapshots the active ones on shutdown.  ``policy`` shards
    the model over its mesh (None: one device).

    Decode runs ``steps.DecodeGraph``: on the card each batch's steps
    replay one captured CUDA graph (per batch size), also under a policy;
    a capture that fails raises, and never falls back to the eager step.
    On the CPU the same static step runs uncaptured.

    Returns (requests done, stats): ``batches``, per-batch
    ``padding_waste``, ``prefill_ms`` and ``decode_tps``,
    ``length_groups`` (``batch_accounting``), ``decode_route`` ("graph"
    or "static"), ``graph_captures``, ``graph_replays`` (batches x
    (decode_steps - 1) on the card), ``graph_warmup_steps``,
    ``distributed_queue`` and ``mesh_sorts``."""
    if config is not None:
        cfg = config
    else:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if flash_prefill is not None:
        cfg = dataclasses.replace(cfg, flash_prefill=flash_prefill)
    dev = resolve_device(device)
    mesh = host_mesh(dev)
    sdir = resolve_state_dir(state_dir)
    if sdir is not None:
        got = restore_state(sdir, mesh)
        if got:
            print(f"[serve] restored {' + '.join(got)} from {sdir}")
    if distributed_queue is None:
        distributed_queue = mesh.size > 1
    model = build(cfg, device=dev, policy=policy)
    params = model.place(model.init(
        torch.Generator(device=dev).manual_seed(seed)))
    shape = ShapeSpec("serve", max_len, batch_size, "decode")
    serve_step = steps_lib.DecodeGraph(model, shape, sample_topk=topk)
    # the sampling noise: its own stream, not the weights'
    noise = torch.Generator(device=dev).manual_seed(seed + 1)

    sched = LengthSortedScheduler(
        batch_size, method=cfg.sort_method,
        mesh=mesh if distributed_queue else None, device=dev)
    # one numpy stream: the requests, then an encoder-decoder's frames
    rng = np.random.default_rng(seed)
    for req in make_requests(cfg.vocab_size, n_requests, max_len,
                             decode_steps, rng):
        sched.submit(req)

    done: List[Request] = []
    stats = {"batches": 0, "padding_waste": [], "prefill_ms": [],
             "decode_tps": []}
    try:
        _serve_loop(sched, model, params, serve_step, noise, decode_steps,
                    max_len, done, stats, rng=rng)
    finally:
        # shutdown snapshot, also on an exception mid-run
        if sdir is not None:
            for p in snapshot_state(sdir, mesh):
                print(f"[serve] state snapshot -> {p}")
    stats.update(
        decode_route="graph" if serve_step.capture else "static",
        graph_captures=serve_step.captures,
        graph_replays=serve_step.replays,
        graph_warmup_steps=serve_step.warmup_steps,
        distributed_queue=bool(distributed_queue),
        mesh_sorts=sched.mesh_sorts)
    waste = float(np.mean(stats["padding_waste"]))
    print(f"[serve] {len(done)} requests in {stats['batches']} batches on "
          f"{dev}; mean padding waste {waste:.3f}; prefill "
          f"{np.mean(stats['prefill_ms']):.1f} ms a batch; decode "
          f"{np.mean(stats['decode_tps']):.1f} tok/s")
    if serve_step.capture:
        print(f"[serve] decode: {serve_step.replays} replays of "
              f"{serve_step.captures} captured CUDA graph(s) (after "
              f"{serve_step.warmup_steps} warm-up steps)")
    else:
        print("[serve] decode: the static step, uncaptured")
    acct = batch_accounting(done, device=dev)
    stats["length_groups"] = acct
    if acct:
        head = ", ".join(f"len={k}: {c} req x {m:.0f} tok"
                         for k, c, m in acct[:8])
        more = "" if len(acct) <= 8 else f" (+{len(acct) - 8} more)"
        print(f"[serve] length accounting: {head}{more}")
    if _obs.enabled():
        print(_obs_report.slo_report())
    return done, stats


def _serve_loop(sched, model, params, serve_step, noise, decode_steps,
                max_len, done, stats, rng=None):
    """Prefill and decode the scheduler's batches until it is empty.  An
    encoder-decoder's batch gets frames (B, enc_seq, d_model) of standard
    normals x 0.1 from ``rng`` (the reference's feed).  ``serve_step``: a
    ``steps.DecodeGraph`` (each prefill fills its static state) or an
    eager ``steps.make_serve_step``."""
    dev = model.device
    cfg = model.cfg
    while True:
        batch = sched.next_batch()
        if not batch:
            break
        stats["batches"] += 1
        stats["padding_waste"].append(sched.padding_waste(batch))
        if _obs.enabled():
            now = time.monotonic()
            for r in batch:
                _metrics.histogram("serve.queue_wait_ms").observe(
                    (now - r.submit_t) * 1e3)
            _metrics.histogram("serve.padding_waste").observe(
                stats["padding_waste"][-1])
            _metrics.counter("serve.requests").inc(len(batch))
        feed = {"tokens": torch.from_numpy(left_pad(batch)).to(dev)}
        if model.is_encdec:
            feed["frames"] = torch.from_numpy(rng.standard_normal(
                (len(batch), cfg.enc_seq, cfg.d_model)) * 0.1).to(
                    device=dev, dtype=torch.float32)
        t0 = time.monotonic()
        if isinstance(serve_step, steps_lib.DecodeGraph):
            logits, state = serve_step.prefill(params, feed)
        else:
            logits, state = model.prefill(params, feed, max_len=max_len)
        nxt = torch.argmax(full_tensor(logits), dim=-1)[:, None].to(
            torch.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["prefill_ms"].append((time.monotonic() - t0) * 1e3)
        outs = [nxt]
        t0 = time.monotonic()
        for _ in range(decode_steps - 1):
            nxt, state = serve_step(params, nxt, state, noise)
            nxt = full_tensor(nxt)
            outs.append(nxt)
        gen = torch.cat(outs, dim=1).cpu().numpy()     # waits for the card
        dt = time.monotonic() - t0
        stats["decode_tps"].append(
            (decode_steps - 1) * len(batch) / max(dt, 1e-9))
        fin = time.monotonic()
        for i, r in enumerate(batch):
            r.out = gen[i]
            done.append(r)
            if _obs.enabled():
                _metrics.histogram("serve.e2e_ms").observe(
                    (fin - r.submit_t) * 1e3)
        if _obs.enabled():
            _metrics.gauge("serve.decode_tps").set(stats["decode_tps"][-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="the reduced config (--no-smoke: full width)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--flash-prefill", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="prefill attention through K6 (default: the "
                         "config's flag)")
    ap.add_argument("--distributed-queue", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="sort the request backlog over the host mesh "
                         "(--no-distributed-queue forces the local path; "
                         "default: on when the host mesh has more than one "
                         "entry)")
    ap.add_argument("--state-dir", default=None,
                    help="directory for the tuning and topology snapshot "
                         "restored on startup and written on shutdown "
                         f"(default: ${SERVE_STATE_ENV} if set)")
    args = ap.parse_args()
    serve(args.arch, smoke=args.smoke, n_requests=args.requests,
          batch_size=args.batch_size, decode_steps=args.decode_steps,
          topk=args.topk, distributed_queue=args.distributed_queue,
          state_dir=args.state_dir, device=args.device,
          flash_prefill=args.flash_prefill)


if __name__ == "__main__":
    main()
