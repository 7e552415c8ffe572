#!/usr/bin/env python3
"""Whether K6's time at the wide heads shows in a prefill: the models that
run K6 at H = 192 / 256, served warm, with K6's bf16 kernel as it is and
with the wide heads on the first-version ``mma.sync`` kernel, in turns.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 scripts/k6_prefill.py

Builds ``scripts/k6_ablation.py``'s ``kernel`` and ``mma_sync`` variants of
``src/repro_torch/csrc/flash_attention.cu``, then for gemma-2b,
recurrentgemma-2b and nemotron-4-340b (cut to 2 layers, as
``chip_smoke.py``'s families phase serves it) builds the bf16 model with
random weights from the seed and prefills the families phase's batch (its
8 requests from the same stream, left-padded) with K6 on: one cold
prefill, then 6 rounds of (mma_sync, kernel, kernel, mma_sync), the
first dropped, each timed on the host clock around work that ends in a
synchronize.  One JSON line a model: the median ms of each and their
difference, and every run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

MODELS = (("gemma-2b", None), ("recurrentgemma-2b", None),
          ("nemotron-4-340b", 2))
ROUNDS = 6


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    import k6_ablation
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.models import model_zoo
    if not torch.cuda.is_available():
        print("k6_prefill: no CUDA device", file=sys.stderr)
        return 2
    libs = {name: lib for name, (lib, _) in
            k6_ablation.build(["mma_sync", "kernel"]).items()}
    print(cs.card(), flush=True)
    fs = cs.FAMILY_SERVE
    for arch, layers in MODELS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, flash_prefill=True)
        model = model_zoo.build(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda")
                            .manual_seed(cs.SEED))
        reqs = srv.make_requests(cfg.vocab_size, fs["n_requests"],
                                 fs["max_len"], fs["decode_steps"],
                                 np.random.default_rng(cs.SEED))
        feed = {"tokens": torch.from_numpy(srv.left_pad(reqs)).cuda()}

        def prefill_ms(lib) -> float:
            fa._lib_handle = lib
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, feed, max_len=fs["max_len"])
            torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        cold = prefill_ms(libs["kernel"])
        runs = {"mma_sync": [], "kernel": []}
        for r in range(ROUNDS):
            for name in ("mma_sync", "kernel", "kernel", "mma_sync"):
                ms = prefill_ms(libs[name])
                if r:
                    runs[name].append(ms)
        med = {k: statistics.median(v) for k, v in runs.items()}
        print(json.dumps({"model": arch, "layers": cfg.n_layers,
                          "tokens": list(feed["tokens"].shape),
                          "cold_ms": cold, "median_ms": med,
                          "mma_sync_minus_kernel_ms":
                              med["mma_sync"] - med["kernel"],
                          "runs_ms": runs}), flush=True)
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
