"""Training driver.

The port of the JAX package's ``launch/train.py``: config
registry -> model -> train step (``steps.make_train_step``) -> synthetic
data pipeline -> async checkpointing -> fault-tolerance runtime
(preemption save, step watchdog, resume from the latest checkpoint).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch mamba2-1.3b --smoke --device cpu --steps 5

Every architecture trains: the encoder-decoder's and the vlm's batches
carry the reference's frame and vision feeds (``train_batch``), and the
model keeps only each layer's inputs through the forward (remat).  Runs
on the card unless ``--device cpu`` is given.

With a sharding ``policy`` (``sharding.partitioning.ShardingPolicy`` on a
``launch.mesh.make_host_device_mesh``; one process a rank) the parameters
and optimizer state are DTensors placed by the model's specs and the
optimizer's ``state_specs``, and each batch by ``steps.batch_specs``.  A
checkpoint holds whole tensors (gathered a leaf at a time into host
memory, written by rank 0: ``host_copies``) and is restored whole and
placed by the specs: the reference's elastic path, so a run may resume on
another mesh.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import (ModelConfig, ShapeSpec, get_config,
                                      get_smoke_config)
from repro_torch.core.sortspec import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model_zoo import build
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 StepWatchdog)
from repro_torch.sharding.partitioning import full_tensor, is_dtensor
from repro_torch import tree as _tree


def train_batch(data: SyntheticLM, cfg: ModelConfig, step: int,
                seed: int) -> Dict[str, np.ndarray]:
    """The numpy batch of ``step``, drawn as the reference's training
    loop draws it: ``data``'s tokens and labels; for the encoder-decoder
    ``frames`` (B, enc_seq, D) from ``default_rng((seed, step, 7))``; for
    the vlm ``vision_embeds`` (B, vision_prefix, D) from ``(seed, step,
    8)`` and (3, B, S) ``positions`` (t = h = w = the token's index).
    Embeddings are float32 scaled by 0.1; the model casts them."""
    out = data.global_batch_at(step)
    b, s = data.cfg.global_batch, data.cfg.seq_len
    if cfg.family == "encdec":
        rng = np.random.default_rng((seed, step, 7))
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.vision_prefix:
        rng = np.random.default_rng((seed, step, 8))
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32) * 0.1
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return out


def host_copies(tree, keep: bool):
    """``tree`` with each DTensor leaf gathered whole into host memory, a
    leaf at a time: every rank joins each gather, only a rank that
    ``keep``s holds the copies (the others get None), and the card holds
    no more than one whole leaf beyond the placed state at any time (the
    reference's checkpointer snapshots each leaf to the host alike).
    Other leaves are returned as they are (the checkpointer copies
    them)."""
    def one(t):
        if not is_dtensor(t):
            return t
        whole = t.full_tensor()
        return whole.cpu() if keep else None

    return _tree.map(one, tree)


def train(arch: str, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, microbatch: int = 1, lr: float = 3e-3,
          ckpt_dir: str = "", ckpt_every: int = 25, optimizer: str = "adamw",
          log_every: int = 5, resume: bool = True, seed: int = 0, *,
          device="cuda", policy=None) -> List[float]:
    """Train ``arch`` (``smoke``: its reduced config) for ``steps`` steps
    on ``device`` (default ``"cuda"``) from weights drawn from ``seed``,
    or from the latest checkpoint in ``ckpt_dir``; ``policy`` shards the
    model over its mesh.  Returns the losses of the steps run."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    model = build(cfg, device=dev, policy=policy)
    shape = ShapeSpec("custom", seq, batch, "train", microbatch)
    fn, optimizer_obj = steps_lib.make_train_step(
        model, cfg, shape, optimizer_name=optimizer, microbatch=microbatch,
        peak_lr=lr, total_steps=steps)

    # init or resume
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = optimizer_obj.init(params)
    if ckpt is not None and resume:
        latest = ckpt.latest_step()
        if latest is not None:
            restored, extra = ckpt.restore(
                latest, {"params": params, "opt": opt_state}, device=dev)
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(extra.get("next_step", latest))
            print(f"[train] resumed from step {latest} "
                  f"-> starting at {start_step}")
    params, opt_state = steps_lib.place_train_state(model, optimizer_obj,
                                                    params, opt_state)
    writer = policy is None or not policy.places or \
        torch.distributed.get_rank() == 0

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    preempt = PreemptionHandler().install()
    watchdog = StepWatchdog()
    losses: List[float] = []
    try:
        for step in range(start_step, steps):
            dev_batch = steps_lib.place_batch(
                model, to_device(train_batch(data, cfg, step, seed), dev))
            watchdog.start()
            params, opt_state, metrics = fn(params, opt_state, step,
                                            dev_batch)
            metrics = {k: full_tensor(v) for k, v in metrics.items()}
            loss = float(metrics["loss"])            # waits for the card
            dt = watchdog.stop(step)
            losses.append(loss)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
            should_save = ckpt is not None and (
                (step + 1) % ckpt_every == 0 or preempt.preempted
                or step == steps - 1)
            if should_save:
                whole = host_copies({"params": params, "opt": opt_state},
                                    keep=writer)
                if writer:
                    ckpt.save(step + 1, whole, extra={"next_step": step + 1})
                del whole
            if preempt.preempted:
                print(f"[train] preemption requested — saved at "
                      f"{step + 1}, exiting")
                break
        if ckpt is not None:
            ckpt.wait()
    finally:
        preempt.uninstall()
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                   batch=args.batch, seq=args.seq,
                   microbatch=args.microbatch, lr=args.lr,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   optimizer=args.optimizer, device=args.device)
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()
