"""End-to-end driver: train a small dense LM (gemma-family, 6 layers of
512, a 32768-token vocabulary: 39.2 M parameters) for a few hundred steps,
with checkpointing and the straggler watchdog active.

This is deliberately the SAME driver the pod launch uses
(``repro_torch.launch.train``) — only the config size differs.  On the card
(the default) every step after two eager warm-up steps replays the train
step captured as one CUDA graph (``launch.steps.TrainGraph``); the step
time printed at the end is the median of the replayed steps, from the
CUDA events of the ``train.step`` trace spans.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] \\
          [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import dataclasses
import os
import statistics
import sys
import tempfile
import types

import repro_torch.configs.gemma_2b as g
from repro_torch import obs
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_lib

# a narrow gemma-family model, registered as gemma_100m (its parameter
# count is printed below)
CONFIG = dataclasses.replace(
    g.CONFIG, name="gemma-100m", n_layers=6, d_model=512, n_heads=8,
    n_kv_heads=1, head_dim=64, d_ff=2048, vocab_size=32768, max_seq=4096)
# the eager warm-up steps and the one that captures: not replays
WARMUP_STEPS = steps_lib.GRAPH_WARMUP + 1


def register(cfg) -> str:
    """Make ``cfg`` a config module the train driver finds by name."""
    mod = types.ModuleType("repro_torch.configs.gemma_100m")
    mod.CONFIG = cfg
    mod.smoke = lambda: cfg
    sys.modules[mod.__name__] = mod
    return "gemma_100m"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train a small dense LM")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)

    print(f"model: {CONFIG.name}, ~{CONFIG.n_params()/1e6:.0f}M params")
    arch = register(CONFIG)
    obs.clear()
    with obs.tracing():
        losses = train_lib.train(arch, smoke=False, steps=args.steps,
                                 batch=args.batch, seq=args.seq, lr=1e-3,
                                 ckpt_dir=args.ckpt_dir, ckpt_every=100,
                                 device=args.device)
    steps = [s for s in obs.spans() if s["name"] == "train.step"]
    obs.clear()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    assert losses[-1] < losses[0], "loss did not decrease"
    timed = [s["device_ms"] for s in steps[WARMUP_STEPS:]
             if s["device_ms"] is not None]
    step_ms = statistics.median(timed) if timed else None
    if step_ms is None:
        print("step time: not measured (no card: no CUDA events)")
    else:
        print(f"step time: {step_ms:.3f} ms a step (median of {len(timed)} "
              f"replayed steps, CUDA events)")
    return {"config": CONFIG, "losses": losses, "step_ms": step_ms,
            "step_wall_ms": [s["wall_ms"] for s in steps]}


if __name__ == "__main__":
    main()
