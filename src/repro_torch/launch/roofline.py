"""Roofline of a dry-run record on one H100 (the port's §Roofline).

The port's counterpart of the JAX package's ``launch/roofline.py``, which
holds a cell against a TPU v5e's peaks.  Here the chip is an NVIDIA H100
SXM (NVIDIA's data sheet, dense rates, at its 700 W limit):

    compute    = flops / PEAK_FLOPS        (989e12 flop/s, bf16 tensor cores)
    memory     = bytes / HBM_BW            (3.35e12 B/s)
    collective = collective bytes / NVLINK_BW   (450e9 B/s a direction;
                 0 on one card)

On a production mesh (a ``--mesh 16x16`` or ``2x16x16`` record) every term
is one device's: the flops and collective bytes of rank 0's local program
(``hlo_analysis``), and for memory its traced op-by-op bytes (the
analytic model below is one card's: it has no FSDP gather and no
sharded activation).  A 16-wide ``model`` axis spans two 8-card NVLink
domains on H100 nodes (8 cards a node), so part of its traffic crosses
the slower inter-node network: ``NVLINK_BW`` makes the collective term a
lower bound there.

``flops`` is the dry run's count (``hlo_analysis``: the flop counter over
every aten op of the traced step, remat recompute included).  ``bytes`` is
``analytic_bytes_per_device``, a model of what the port's step moves; the
traced op-by-op bytes (every eager op's operands + result) stay beside it
as the upper bound.

MODEL_FLOPS (the useful flops): 6 * N_active * tokens to train, 2 *
N_active * tokens to prefill, 2 * N_active * batch to decode (N_active
without an untied input embedding, ``model_flops_per_device``); MODEL/HLO
catches remat and routing overheads.  The bound on MFU is MODEL time /
max(term): a step measured at ``t`` seconds has MFU = MODEL time / t.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # B/s
NVLINK_BW = 450e9            # B/s a direction (NVLink 4, 18 links)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results"


def _shape_of(rec: dict):
    from repro_torch.configs.base import SHAPES, ShapeSpec
    if "seq_len" in rec:
        return ShapeSpec(rec["shape"], rec["seq_len"], rec["global_batch"],
                         rec["kind"])
    return SHAPES[rec["shape"]]


def _config_of(rec: dict):
    from repro_torch.configs.base import get_config
    cfg = get_config(rec["arch"])
    if rec.get("n_layers", cfg.n_layers) != cfg.n_layers:
        cut = {"n_layers": rec["n_layers"]}
        if cfg.family == "encdec":
            cut["n_enc_layers"] = rec["n_layers"]
        cfg = dataclasses.replace(cfg, **cut)
    return cfg


def model_flops_per_device(rec: dict) -> float:
    """6 (train) or 2 (prefill, decode) x N_active x tokens, where N_active
    leaves out an untied input embedding: its lookup does no product (the
    reference counts it, which a depth cut to a layer or two makes most of
    N)."""
    shape = _shape_of(rec)
    cfg = _config_of(rec)
    n_act = rec["n_active_params"]
    if not cfg.tie_embeddings:
        n_act -= cfg.vocab_size * cfg.d_model
    if rec["kind"] == "train":
        total = 6.0 * n_act * shape.tokens
    elif rec["kind"] == "prefill":
        total = 2.0 * n_act * shape.tokens
    else:  # decode: one token per sequence per step
        total = 2.0 * n_act * shape.global_batch
    return total / rec["n_devices"]


def analytic_bytes_per_device(rec: dict) -> Dict[str, float]:
    """The HBM traffic of the port's step on one card (B/step).

    Terms: weight reads (bf16; under remat twice forward, the forward and
    its recompute, and once backward, for each microbatch); gradients
    (written and read in bf16 a microbatch, summed in float32 across
    microbatches); the optimizer's in-place update (the gradient read for
    the global norm and again for the update; AdamW reads master, m and v
    and writes them; Adafactor reads and writes the master, its factored
    moments ~0; then the bf16 refresh from the master); the remat-saved
    layer inputs; attention scores (the training and einsum-prefill paths
    materialise (B, heads, S, keys) float32 scores; a flash prefill
    through K6 reads q, k, v and writes o only); MoE dispatch buffers, and ``relational.group_ranks`` reading
    the (token, expert) ids; KV cache and recurrent state; float32 logits.
    No FSDP gather: the card holds every weight.
    """
    cfg = _config_of(rec)
    shape = _shape_of(rec)
    plan = rec.get("plan", {})
    m = max(1, plan.get("microbatch", 1)) if shape.kind == "train" else 1
    P = rec["n_params"]
    L, D = cfg.n_layers + cfg.n_enc_layers, cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S if shape.kind != "decode" else B
    attn_layers = sum(1 for i in range(cfg.n_layers)
                      if cfg.layer_kind(i) == "attn") + 2 * cfg.n_enc_layers
    kv_eff = S if not cfg.window else min(S, cfg.window)
    out: Dict[str, float] = {}
    if shape.kind == "train":
        passes = 3                     # forward + remat recompute + backward
        out["weights"] = passes * 2.0 * P * m
        out["grads"] = 2 * 2.0 * P * m + (8.0 * P * m if m > 1 else 0.0)
        g = 4.0 if m > 1 else 2.0      # the summed gradients are float32
        if plan.get("optimizer", "adamw") == "adamw":
            out["optimizer"] = (2 * g + 12 + 12 + 4 + 2) * P
        else:
            out["optimizer"] = (2 * g + 4 + 4 + 4 + 2) * P
        out["activations"] = 2 * L * tokens * D * 2.0
        out["attn_scores"] = (passes * attn_layers * B * cfg.n_heads * S
                              * kv_eff * 4.0)
        out["logits"] = 3 * tokens * cfg.padded_vocab * 4.0
        if cfg.moe:
            cap = S * cfg.moe.top_k * cfg.moe.capacity_factor \
                / cfg.moe.n_experts
            moe_layers = cfg.n_layers - cfg.moe.first_dense_layers
            out["moe_buffers"] = (passes * 2 * moe_layers * B
                                  * cfg.moe.n_experts * cap * D * 2.0)
            out["group_ranks"] = (passes * moe_layers * tokens
                                  * cfg.moe.top_k * 4.0 * 2)
    elif shape.kind == "prefill":
        out["weights"] = 2.0 * P
        out["activations"] = 2 * L * tokens * D * 2.0
        if plan.get("flash"):
            out["attn_scores"] = (attn_layers * B * cfg.n_heads * S
                                  * cfg.resolved_head_dim * 2 * 4)
        else:
            out["attn_scores"] = (attn_layers * B * cfg.n_heads * S
                                  * kv_eff * 4.0)
        out["kv_cache_write"] = (attn_layers * B * S * cfg.n_kv_heads
                                 * cfg.resolved_head_dim * 2 * 2.0)
        out["logits"] = B * cfg.padded_vocab * 4.0
        if cfg.moe:
            out["group_ranks"] = ((cfg.n_layers - cfg.moe.first_dense_layers)
                                  * tokens * cfg.moe.top_k * 4.0 * 2)
    else:  # decode: stream weights + cache once per token
        out["weights"] = 2.0 * P
        out["kv_cache_read"] = (attn_layers * B * kv_eff * cfg.n_kv_heads
                                * cfg.resolved_head_dim * 2 * 2.0)
        if cfg.ssm:
            d_state = (cfg.ssm.expand * D // cfg.ssm.head_dim
                       * cfg.ssm.head_dim * cfg.ssm.d_state)
            out["ssm_state"] = 2 * cfg.n_layers * B * d_state * 4.0
        out["logits"] = B * cfg.padded_vocab * 4.0
    out["total"] = sum(out.values())
    return out


def analyze_record(rec: dict) -> Optional[dict]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    h = rec.get("hlo_analysis", {})
    flops = h.get("flops", 0.0)
    hbm_upper = h.get("hbm_bytes", 0.0)
    analytic = analytic_bytes_per_device(rec)
    hbm = analytic["total"] if rec.get("n_devices", 1) == 1 else hbm_upper
    coll = h.get("collective_total_bytes", 0.0)
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm / HBM_BW
    t_coll = coll / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    t_bound = max(terms.values())
    mfu_bound = (mf / PEAK_FLOPS) / t_bound if t_bound > 0 else 0.0
    mem_top = max((k for k in analytic if k != "total"),
                  key=analytic.get) if analytic else ""
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_memory_upper_s": hbm_upper / HBM_BW,
        "t_bound_s": t_bound,
        "dominant": dominant,
        "memory_breakdown": analytic,
        "memory_top_term": mem_top,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": flops,
        "useful_ratio": mf / flops if flops else 0.0,
        "mfu_bound": mfu_bound,
        "collective_bytes_by_kind": h.get("collective_bytes", {}),
        "plan": rec.get("plan", {}),
    }


def mfu(row: dict, step_s: float) -> float:
    """The MFU of a step measured at ``step_s`` seconds: its model flops'
    time at the peak over the measured time."""
    return (row["model_flops_per_dev"] / PEAK_FLOPS) / step_s


_FIX_HINTS = {
    ("compute", "train"): "more useful-flops share: trim the remat "
                          "recompute (keep attention outputs) or run the "
                          "einsum attention's backward through a fused "
                          "kernel",
    ("compute", "prefill"): "compute-bound as desired; route the prefill "
                            "through K6 to drop the score products' "
                            "float32 round trips",
    ("compute", "decode"): "decode should be memory-bound; compute "
                           "domination means routing/sampling overhead",
    ("memory", "train"): "raise arithmetic intensity: larger microbatch, "
                         "fuse the optimizer update into one kernel, keep "
                         "the logits in bf16 or chunk the cross-entropy",
    ("memory", "prefill"): "route the attention through K6 (--flash) to "
                           "drop the HBM score matrices",
    ("memory", "decode"): "expected regime (weights + cache streaming); "
                          "batch more sequences or shrink the KV cache",
    ("collective", "train"): "overlap the gradient all-reduce over NVLink "
                             "with the next microbatch",
    ("collective", "prefill"): "reshard activations less often over "
                               "NVLink",
    ("collective", "decode"): "fewer tensor-parallel all-reduces a token "
                              "over NVLink",
}


def fix_hint(row: dict) -> str:
    return _FIX_HINTS.get((row["dominant"], row["kind"]), "")


def load_all(tag: str = "", results_dir=None) -> List[dict]:
    base = (pathlib.Path(results_dir) if results_dir is not None
            else RESULTS / "dryrun_torch")
    rows = []
    for p in sorted(base.glob("*.json")):
        if tag and not p.stem.endswith(tag):
            continue
        if not tag and any(p.stem.endswith(t) for t in ("_opt", "_exp")):
            continue
        row = analyze_record(json.loads(p.read_text()))
        if row is not None:
            rows.append(row)
    return rows


def markdown_table(rows: List[dict], mesh: str = "1") -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | MFU bound | what would move it |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['mfu_bound']*100:.1f}% | {fix_hint(r)} |\n")
    return "".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="1")
    args = ap.parse_args()
    rows = load_all(args.tag)
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "roofline_torch.json").write_text(json.dumps(rows, indent=1))
    print(markdown_table(rows, args.mesh))
    if rows:
        worst = min(rows, key=lambda r: r["mfu_bound"])
        print(f"\nworst MFU bound: {worst['arch']}/{worst['shape']} "
              f"({worst['mfu_bound']*100:.1f}%)")


if __name__ == "__main__":
    main()
