"""Serving driver: prefill + decode with a length-sorted batch scheduler.

The port of the JAX package's ``launch/serve.py`` on one device.  Requests
are sorted by prompt length through the port's ``argsort`` so each prefill
batch is length-homogeneous; each batch is left-padded to its longest
prompt (the pad tokens are attended to, as in the reference), prefilled
(through K6 with ``--flash-prefill``), and decoded a token at a time with
top-k sampling through the port's ``topk``.  The served requests are then
accounted by prompt length with one ``relational.group_by``
(``batch_accounting``), and with obs on the SLO report is printed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
      --smoke --device cpu --requests 6 --batch-size 3 --decode-steps 8

Not carried yet: the scheduler's mesh path and the topology snapshot
(ROADMAP Queue 1 item 11).
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
from repro_torch.core import tuning as _tuning
from repro_torch.core.sortspec import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model_zoo import build
from repro_torch.obs import metrics as _metrics, report as _obs_report, \
    trace as _obs

# where serve persists its tuning snapshot between runs (the --state-dir
# flag overrides; unset means no persistence)
SERVE_STATE_ENV = "REPRO_TORCH_SERVE_STATE_DIR"

_NO_MESH = ("the scheduler's mesh path (distributed backlog sort) and the "
            "topology snapshot wait for the distributed tier (ROADMAP Queue 1 "
            "item 11)")


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
    """

    def __init__(self, batch_size: int, method: str = "auto", *,
                 mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        self.batch_size = batch_size
        self.method = method
        self.device = resolve_device(device)
        self.queue: List[Request] = []

    def submit(self, req: Request) -> None:
        req.submit_t = time.monotonic()
        self.queue.append(req)

    def _order(self, lens: np.ndarray) -> np.ndarray:
        order = sorting.argsort(torch.from_numpy(lens), method=self.method,
                                device=self.device)
        return order.cpu().numpy()

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
                  decode_steps: int, seed: int) -> List[Request]:
    """The reference's request stream: prompt lengths in [4, max_len / 4)
    and tokens from ``numpy.random.default_rng(seed)``, so both packages
    serve the same requests from the same seed."""
    rng = np.random.default_rng(seed)
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


def restore_state(state_dir: os.PathLike) -> List[str]:
    """Restore a previous run's tuning profile from ``state_dir`` as the
    active one.  Identity-gated: a profile whose device fingerprint differs
    (a snapshot copied from another machine) is skipped, never trusted.
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
    return restored


def snapshot_state(state_dir: os.PathLike) -> List[pathlib.Path]:
    """Snapshot the active tuning profile into ``state_dir`` so the next
    run starts from it.  Returns the written paths."""
    prof = _tuning.active()
    return [_tuning.save(prof, _tuning.profile_path(state_dir,
                                                    prof.fingerprint))]


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


def serve(arch: str, smoke: bool = True, n_requests: int = 16,
          batch_size: int = 8, decode_steps: int = 32, topk: int = 50,
          seed: int = 0, max_len: int = 256,
          state_dir: Optional[str] = None, *, device="cuda",
          flash_prefill: Optional[bool] = None):
    """Serve ``n_requests`` random requests of ``arch`` (``smoke``: its
    reduced config) on ``device`` (default ``"cuda"``) with weights drawn
    from ``seed``.  ``flash_prefill`` overrides the config's flag (K6 for
    the prefill's attention).  ``state_dir`` (or
    ``REPRO_TORCH_SERVE_STATE_DIR``) restores the snapshotted tuning profile
    on startup and snapshots the active one on shutdown.

    Returns (requests done, stats): ``batches``, per-batch
    ``padding_waste``, ``prefill_ms`` and ``decode_tps``, and
    ``length_groups`` (``batch_accounting``)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if flash_prefill is not None:
        cfg = dataclasses.replace(cfg, flash_prefill=flash_prefill)
    dev = resolve_device(device)
    sdir = resolve_state_dir(state_dir)
    if sdir is not None:
        got = restore_state(sdir)
        if got:
            print(f"[serve] restored {' + '.join(got)} from {sdir}")
    model = build(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    shape = ShapeSpec("serve", max_len, batch_size, "decode")
    serve_step = steps_lib.make_serve_step(model, shape, sample_topk=topk)
    # the sampling noise: its own stream, not the weights'
    noise = torch.Generator(device=dev).manual_seed(seed + 1)

    sched = LengthSortedScheduler(batch_size, method=cfg.sort_method,
                                  device=dev)
    for req in make_requests(cfg.vocab_size, n_requests, max_len,
                             decode_steps, seed):
        sched.submit(req)

    done: List[Request] = []
    stats = {"batches": 0, "padding_waste": [], "prefill_ms": [],
             "decode_tps": []}
    try:
        _serve_loop(sched, model, params, serve_step, noise, decode_steps,
                    max_len, done, stats)
    finally:
        # shutdown snapshot, also on an exception mid-run
        if sdir is not None:
            for p in snapshot_state(sdir):
                print(f"[serve] state snapshot -> {p}")
    waste = float(np.mean(stats["padding_waste"]))
    print(f"[serve] {len(done)} requests in {stats['batches']} batches on "
          f"{dev}; mean padding waste {waste:.3f}; prefill "
          f"{np.mean(stats['prefill_ms']):.1f} ms a batch; decode "
          f"{np.mean(stats['decode_tps']):.1f} tok/s")
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
                max_len, done, stats):
    dev = model.device
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
        t0 = time.monotonic()
        logits, state = model.prefill(params, feed, max_len=max_len)
        nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["prefill_ms"].append((time.monotonic() - t0) * 1e3)
        outs = [nxt]
        t0 = time.monotonic()
        for _ in range(decode_steps - 1):
            nxt, state = serve_step(params, nxt, state, noise)
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
    ap.add_argument("--state-dir", default=None,
                    help="directory for the tuning snapshot restored on "
                         "startup and written on shutdown "
                         f"(default: ${SERVE_STATE_ENV} if set)")
    args = ap.parse_args()
    serve(args.arch, smoke=args.smoke, n_requests=args.requests,
          batch_size=args.batch_size, decode_steps=args.decode_steps,
          topk=args.topk, state_dir=args.state_dir, device=args.device,
          flash_prefill=args.flash_prefill)


if __name__ == "__main__":
    main()
