"""Dry run: trace the exact step of an (arch x shape) cell on one card or
on a production mesh.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles every cell on a production mesh.  ``--mesh 1`` (the
default) is one H100; ``--mesh 16x16`` / ``2x16x16`` the reference's
production meshes (``launch.mesh.make_production_mesh``: axes ``data`` x
``model``, or ``pod`` x ``data`` x ``model``, over a ``fake`` process group
whose collectives carry no data), with the reference's ``ShardingPolicy``
from the cell's plan: ``seq_shard`` for train cells, ``layout`` ``tp`` |
``dp`` | ``cp`` (the DP-heavy serve layouts transform the layer weights'
specs, ``serve_param_specs``; ``cp`` also shards the prefill's queries
over ``model``).  On a mesh the trace is rank 0's local program: the
record's bytes (arguments, temporaries, peak) are one device's, its flops
the local ops' (``hlo_analysis.OpTrace.flops``), its collectives rank 0's
by kind.  Per cell this module:

  1. builds the model and the EXACT step function of ``launch/steps.py``
     (``make_train_step`` with the cell's plan, ``make_prefill_step``, or
     ``make_serve_step(sample_topk=50)`` on a decode state);
  2. runs the step once under ``FakeTensorMode``: tensors carry shapes and
     dtypes and no storage, so nothing is allocated on any device, and a
     full-size nemotron-4-340b ``train_4k`` step traces on a CPU;
  3. counts, in that one pass, the step's flops
     (``torch.utils.flop_counter``), its op-by-op bytes and the bytes of
     the storages alive at each op (``hlo_analysis.OpTrace``);
  4. records the reference's keys (``memory``, ``flops``,
     ``hlo_analysis``, ...) into ``results/dryrun_torch/<cell>.json``.  A
     cell whose peak exceeds the card's capacity (80 GB unless given
     another) gets ``ok: false`` with the bytes in ``reason``: the
     reference's compile-time OOM.  The dry run does not cut a cell.

Top-k routes are the card's: the router's and the sampling top-k go to
the method the planner picks on the card (K5's ``cuda`` for the shapes
here), whose wrapper runs its plain version on the fake (CPU) tensors with
the kernel's output shapes and dtypes.  A ``--flash`` prefill runs K6's
custom op, whose fake implementation gives its output's shape and dtype
and whose flop formula counts the query-key pairs it sees.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch nemotron-4-340b \
      --shape train_4k --mesh 16x16 [--seq-shard 0]
  python -m repro_torch.launch.dryrun --arch whisper-tiny \
      --shape decode_32k --both-meshes --layout dp
  python -m repro_torch.launch.dryrun --all [--mesh 16x16] [--tag baseline]

``--all`` sweeps every cell on the one ``--mesh`` given (one card by
default), or on both production meshes with ``--both-meshes``; the
reference's ``--all`` always takes both meshes, as it has no one-card
mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import difflib
import functools
import json
import pathlib
import sys
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as _tree
from repro_torch.configs.base import (ALIASES, ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeSpec, cell_is_supported,
                                      get_config)
from repro_torch.kernels import flash_attention as _k6  # noqa: F401 (flops)
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model_zoo import build
from repro_torch.sharding.partitioning import ShardingPolicy

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")
H100_BYTES = 80e9              # the H100 SXM's 80 GB of device memory
MESH = "1"                     # one card (the default)
MESHES = {"1": None, "16x16": False, "2x16x16": True}   # -> multi_pod
SAMPLE_TOPK = 50


# Per-arch training knobs, as the reference's: microbatch count, sequence
# parallelism, optimizer, grad-accumulation dtype.  ``seq_shard`` and
# ``layout`` are mesh fields, kept in the record and inert on one card.
@dataclasses.dataclass(frozen=True)
class CellPlan:
    microbatch: int = 1
    seq_shard: bool = False
    optimizer: str = "adamw"
    accum: str = "float32"
    flash: bool = False        # prefill attention through K6
    layout: str = "tp"         # tp | dp | cp (DP-heavy serve layouts)


TRAIN_PLAN = {
    "whisper_tiny": CellPlan(microbatch=8),
    "deepseek_67b": CellPlan(microbatch=2, seq_shard=True),
    "minitron_4b": CellPlan(microbatch=2, seq_shard=True),
    "gemma_2b": CellPlan(microbatch=4, seq_shard=True),
    "nemotron_4_340b": CellPlan(microbatch=8, seq_shard=True,
                                optimizer="adafactor", accum="bfloat16"),
    "moonshot_v1_16b": CellPlan(microbatch=4),
    "dbrx_132b": CellPlan(microbatch=16, optimizer="adafactor"),
    "recurrentgemma_2b": CellPlan(microbatch=4),
    "qwen2_vl_72b": CellPlan(microbatch=2, seq_shard=True),
    "mamba2_13b": CellPlan(microbatch=8),
}


def arch_id(arch: str) -> str:
    """The module id of a display name (``gemma-2b`` -> ``gemma_2b``)."""
    return ALIASES.get(arch, arch.replace("-", "_"))


def train_plan(arch: str, shape: Optional[ShapeSpec] = None) -> CellPlan:
    """The reference's plan of ``arch``'s train cell (``train_4k``); for
    another ``shape`` its microbatches hold the plan's tokens a
    microbatch at most: ceil(tokens x microbatch / train_4k's tokens),
    raised to a divisor of the batch.  A step of 4 x 1024 tokens is then
    one microbatch for every architecture."""
    plan = TRAIN_PLAN[arch_id(arch)]
    if shape is not None:
        full = SHAPES["train_4k"].tokens
        m = max(1, -(-shape.tokens * plan.microbatch // full))
        while shape.global_batch % m:
            m += 1
        plan = dataclasses.replace(plan, microbatch=m)
    return plan


def card_routes(cfg: ModelConfig, shape: ShapeSpec, microbatch: int = 1):
    """(cfg with its ``auto`` top-k routes resolved as the card's planner
    resolves them, the routes): the router's top-k over ``n_experts`` for
    each token of a microbatch, and the sampling top-k over the padded
    vocabulary for each row of a decode batch."""
    from repro_torch import engine
    routes = {}
    if cfg.moe is not None and cfg.moe.router_method == "auto":
        rows = shape.tokens // microbatch if shape.kind != "decode" \
            else shape.global_batch
        m = engine.choose(cfg.moe.n_experts, rows, torch.float32,
                          k=cfg.moe.top_k, device="cuda").method
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_method=m))
        routes["router"] = m
    if shape.kind == "decode" and cfg.sort_method == "auto":
        m = engine.choose(cfg.padded_vocab, shape.global_batch,
                          torch.float32, k=SAMPLE_TOPK, device="cuda").method
        cfg = dataclasses.replace(cfg, sort_method=m)
        routes["sampling"] = m
    return cfg, routes


def _fake_inputs(model, shape: ShapeSpec):
    """Zero tensors standing in for the step's batch (``input_specs``)."""
    return {name: torch.zeros(spec.shape, dtype=spec.dtype)
            for name, spec in model.input_specs(shape).items()}


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (a DTensor's: its
    local shard's)."""
    seen = {}
    for t in _tree.leaves(trees):
        if isinstance(t, torch.Tensor):
            st = hlo_analysis._local(t).untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def make_policy(mesh, plan: CellPlan, shape: ShapeSpec):
    """The reference's ``ShardingPolicy`` of a cell on ``mesh`` (None on
    one card)."""
    if mesh is None:
        return None
    return ShardingPolicy(
        mesh=mesh, dp_axes=mesh_lib.dp_axes_of(mesh),
        seq_shard=(plan.seq_shard and shape.kind == "train")
        or plan.layout == "cp",
        serve_layout=plan.layout in ("dp", "cp"),
        cp_layout=plan.layout == "cp")


def depth_units(cfg: ModelConfig):
    """(units, cut): the repeating units of ``cfg``'s depth and
    ``cut(u)``, the config with ``u`` of them.  A unit is a layer after
    the MoE's dense prefix; a whole block pattern of the hybrid (its
    leftover layers kept); an encoder and a decoder layer of the
    encoder-decoder.  ``units`` is None where the depth does not repeat
    evenly (the step is then traced whole)."""
    if cfg.family == "encdec":
        if cfg.n_enc_layers != cfg.n_layers:
            return None, None
        return cfg.n_layers, lambda u: dataclasses.replace(
            cfg, n_layers=u, n_enc_layers=u)
    if cfg.family == "hybrid" and cfg.rglru is not None:
        pat = len(cfg.rglru.block_pattern)
        rest = cfg.n_layers % pat
        return cfg.n_layers // pat, lambda u: dataclasses.replace(
            cfg, n_layers=rest + pat * u)
    first = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    return cfg.n_layers - first, lambda u: dataclasses.replace(
        cfg, n_layers=first + u)


def _extrapolate(vals: dict, us, ms, units: int, micro: int) -> float:
    """The value at (units, micro) of a quantity traced at the points
    ``us`` x ``ms``: linear in each where two points are given (bilinear
    with both), the traced value where one is."""
    def lin(x, x1, x2, y1, y2):
        return y1 + (x - x1) * (y2 - y1) / (x2 - x1)

    def at(m):
        if len(us) == 1:
            return vals[(us[0], m)]
        return lin(units, us[0], us[1], vals[(us[0], m)], vals[(us[1], m)])

    if len(ms) == 1:
        return at(ms[0])
    return lin(micro, ms[0], ms[1], at(ms[0]), at(ms[1]))


def _step(cfg: ModelConfig, shape: ShapeSpec, plan: CellPlan, mesh=None):
    """(step function, its arguments) of the cell, built on the fake
    tensors of the active ``FakeTensorMode``: the train step with params,
    optimizer state and batch; the prefill with params and batch; the
    decode step with params, a token, the decode state (the
    encoder-decoder's from a 32-token prefill) and sampling uniforms.  On
    a ``mesh`` the model carries the cell's policy and every argument is
    a DTensor placed by its specs (each rank's shard its own storage)."""
    policy = make_policy(mesh, plan, shape)
    if plan.flash:
        cfg = dataclasses.replace(cfg, flash_prefill=True)
    model = build(cfg, device="cpu", policy=policy)
    params, specs = steps_lib.abstract_init(
        model, torch.Generator().manual_seed(0))
    specs = None if policy is None else policy.layout_param_specs(specs)
    if shape.kind == "train":
        accum = torch.bfloat16 if plan.accum == "bfloat16" else torch.float32
        fn, optimizer = steps_lib.make_train_step(
            model, cfg, shape, optimizer_name=plan.optimizer,
            microbatch=plan.microbatch, accum_dtype=accum)
        opt_state = optimizer.init(params)
        params, opt_state = steps_lib.place_train_state(
            model, optimizer, params, opt_state, specs)
        return fn, (params, opt_state, 0, steps_lib.place_batch(
            model, _fake_inputs(model, shape)))
    params = model.place(params, specs)
    if shape.kind == "prefill":
        return (steps_lib.make_prefill_step(model, shape),
                (params, steps_lib.place_batch(model,
                                               _fake_inputs(model, shape))))
    b = shape.global_batch
    if model.is_encdec:
        with torch.no_grad():
            state = model.prefill(params, steps_lib.place_batch(model, {
                "tokens": torch.zeros((b, 32), dtype=torch.int32),
                "frames": torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.bfloat16)}),
                max_len=shape.seq_len)[1]
    else:
        state = model.decode_state(b, shape.seq_len)
    return (steps_lib.make_serve_step(model, shape, sample_topk=SAMPLE_TOPK),
            (params, torch.zeros((b, 1), dtype=torch.int32), state,
             torch.full((b, SAMPLE_TOPK), 0.5)))


def _mesh(mesh_name: str):
    """The production mesh of ``mesh_name`` (None for one card)."""
    if MESHES[mesh_name] is None:
        return None
    return mesh_lib.make_production_mesh(multi_pod=MESHES[mesh_name])


@functools.lru_cache(maxsize=32)
def _trace(cfg: ModelConfig, shape: ShapeSpec, plan: CellPlan,
           mesh_name: str = MESH) -> dict:
    """One step of ``cfg`` at ``shape`` under ``FakeTensorMode``, traced:
    its flops, op bytes and ops, the bytes of its arguments, its peak of
    live bytes, the bytes of its outputs (fresh, and aliasing an
    argument), its largest results and (on a mesh) its collectives."""
    t0 = time.time()
    mesh = _mesh(mesh_name)
    with FakeTensorMode():
        fn, args = _step(cfg, shape, plan, mesh)
        t_lower = time.time() - t0
        trace = hlo_analysis.OpTrace(local=mesh is not None)
        held = trace.hold(args)
        t0 = time.time()
        counter = FlopCounterMode(display=False) if mesh is None else None
        with (counter or contextlib.nullcontext()), trace:
            out = fn(*args)
        t_compile = time.time() - t0
        arg_ids = {id(t.untyped_storage())
                   for t in hlo_analysis._tensors(args)}
        outs = {}
        for t in hlo_analysis._tensors(out):
            st = t.untyped_storage()
            outs[id(st)] = st.nbytes()
        del out
    return {"flops": float(counter.get_total_flops() if counter is not None
                           else trace.flops),
            "hbm_bytes": trace.hbm_bytes, "n_ops": trace.n_ops,
            "held": held, "peak": trace.peak, "timeline": trace.timeline,
            "output": sum(b for k, b in outs.items() if k not in arg_ids),
            "alias": sum(b for k, b in outs.items() if k in arg_ids),
            "top": hlo_analysis.top_tensors(trace, 10),
            "collective_counts": dict(trace.collective_counts),
            "collective_bytes": dict(trace.collective_bytes),
            "lower_s": t_lower, "compile_s": t_compile}


def _argument_bytes(cfg: ModelConfig, shape: ShapeSpec,
                    plan: CellPlan, mesh_name: str = MESH) -> int:
    """The bytes the whole-depth step is handed (one device's on a mesh),
    counted on fake tensors."""
    mesh = _mesh(mesh_name)
    with FakeTensorMode():
        return tree_bytes(_step(cfg, shape, plan, mesh)[1])


def _extrapolate_peak(traces: dict, us, m: int, units: int) -> float:
    """The peak at ``units`` depth units from the timelines traced at
    ``us``: the update phase, where its ops do not grow with the depth (a
    stacked body's leaves), op by op, its ops paired by name (``difflib``:
    a torch build may add an op in one trace); every other phase (the
    forward and backward repeat a layer's ops, which no pairing by name
    can tell apart) by its own peak; each linearly in the units; the
    largest.  A
    single peak could not: where the optimizer's largest leaf is a stacked
    body leaf its temporaries grow with the depth faster than the step's
    peak at 2 and 3 units, which sits in the loss."""
    if len(us) == 1:
        return traces[(us[0], m)]["peak"]
    lo, hi = (traces[(u, m)]["timeline"] for u in us)

    def at(a, b):
        return a + (units - us[0]) * (b - a) / (us[1] - us[0])

    peak = 0.0
    for name in set(lo) | set(hi):
        a, b = lo.get(name, [("", 0)]), hi.get(name, [("", 0)])
        if name == "update" and abs(len(a) - len(b)) <= max(2,
                                                             len(a) // 20):
            match = difflib.SequenceMatcher(None, [x[0] for x in a],
                                            [x[0] for x in b], autojunk=False)
            for i, j, n in match.get_matching_blocks():
                for k in range(n):
                    peak = max(peak, at(a[i + k][1], b[j + k][1]))
        else:
            peak = max(peak, at(max(x[1] for x in a), max(x[1] for x in b)))
    return peak


def lower_cell(*args, mesh: str = MESH, **kw) -> dict:
    """``_lower_cell``; a production mesh's ``fake`` process group is
    destroyed after the cell (nothing of it outlives the call)."""
    try:
        return _lower_cell(*args, mesh=mesh, **kw)
    finally:
        if mesh != MESH:
            mesh_lib.release_fake_world()


def _lower_cell(arch: str, shape_name: str, plan: CellPlan = None,
                seq_shard=None, microbatch=None, flash=None, *,
                cfg: ModelConfig = None,
                shape: ShapeSpec = None, capacity_bytes: float = H100_BYTES,
                exact: bool = False, verbose: bool = True,
                mesh: str = MESH, layout: Optional[str] = None) -> dict:
    """Build and trace one cell's step; return its record.  ``cfg`` (a
    cut of ``arch``'s config) and ``shape`` (a ShapeSpec in place of
    ``SHAPES[shape_name]``) size another model with the same code;
    ``capacity_bytes`` is the card's memory the peak is held to.
    ``mesh``: ``"1"`` (one card), ``"16x16"`` or ``"2x16x16"``;
    ``seq_shard``, ``microbatch``, ``flash`` and ``layout`` override the
    plan's, as the reference's do.

    The scan correction (the reference's trip-count correction): a depth
    of more than 3 repeating units (``depth_units``) is traced at 2 and 3
    units, more than 2 microbatches at 2 and 3 microbatches of the cell's
    size, and every count is extrapolated linearly in each (the units are
    the same layers, the microbatches the same ops).  The peak is
    extrapolated phase by phase (``_extrapolate_peak``) at the larger
    microbatch count: from the second microbatch on, the live tensors
    repeat.  The arguments are counted at the whole depth.  ``exact`` traces the whole step instead."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": why}
    plan = plan or (train_plan(arch, shape) if shape.kind == "train"
                    else CellPlan())
    if seq_shard is not None:
        plan = dataclasses.replace(plan, seq_shard=bool(seq_shard))
    if microbatch is not None:
        plan = dataclasses.replace(plan, microbatch=microbatch)
    if flash:
        plan = dataclasses.replace(plan, flash=True)
    if layout is not None:
        plan = dataclasses.replace(plan, layout=layout)
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r} is not one of {list(MESHES)}")
    limits = []
    micro = plan.microbatch if shape.kind == "train" else 1
    if shape.global_batch % micro:
        raise ValueError(f"a batch of {shape.global_batch} does not split "
                         f"into {micro} microbatches")
    cfg, routes = card_routes(cfg, shape, micro)

    units, cut = depth_units(cfg)
    us = (units,) if exact or units is None or units <= 3 else (2, 3)
    ms = (micro,) if exact or micro <= 2 else (2, 3)
    per = shape.global_batch // micro
    traces = {}
    for u in us:
        for m in ms:
            traces[(u, m)] = _trace(
                cfg if u == units else cut(u),
                dataclasses.replace(shape, global_batch=per * m),
                dataclasses.replace(plan, microbatch=m), mesh)
    if len(us) > 1 or len(ms) > 1:
        limits.append(f"scan correction: traced at {list(us)} of "
                      f"{units} depth units x {list(ms)} of {micro} "
                      f"microbatches, extrapolated linearly")

    def ext(key, m_points=ms):
        return _extrapolate({k: v[key] for k, v in traces.items()}, us,
                            m_points, units, micro)

    kinds = sorted({k for t in traces.values()
                    for k in t["collective_counts"]})

    def ext_kind(key, kind):
        return _extrapolate({k: v[key].get(kind, 0)
                             for k, v in traces.items()}, us, ms, units,
                            micro)

    analysis = hlo_analysis.analyze(
        ext("flops"), ext("hbm_bytes"), ext("n_ops"),
        {k: ext_kind("collective_counts", k) for k in kinds},
        {k: ext_kind("collective_bytes", k) for k in kinds})
    peak = _extrapolate_peak(traces, us, ms[-1], units)
    argument_bytes = (traces[(us[0], ms[0])]["held"] if len(traces) == 1
                      else _argument_bytes(cfg, shape, plan, mesh))
    memory = {"argument_bytes": int(argument_bytes),
              "output_bytes": int(round(ext("output"))),
              "temp_bytes": int(round(peak - argument_bytes)),
              "alias_bytes": int(round(ext("alias"))),
              "code_bytes": 0,
              "peak_bytes": int(round(peak))}
    n_devices = 1
    for n in (mesh_lib.PRODUCTION_SHAPES[MESHES[mesh]][0]
              if MESHES[mesh] is not None else ()):
        n_devices *= n
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "n_devices": n_devices,
        "kind": shape.kind, "plan": dataclasses.asdict(plan),
        "n_layers": cfg.n_layers, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "flops": analysis["flops"], "bytes_accessed": analysis["hbm_bytes"],
        "memory": memory,
        "capacity_bytes": float(capacity_bytes),
        "collectives": {"counts": analysis["collective_counts"],
                        "bytes": analysis["collective_bytes"],
                        "total_bytes": analysis["collective_total_bytes"]},
        "hlo_analysis": analysis,
        "top_tensors": traces[(us[-1], ms[-1])]["top"],
        "traced": {"depth_units": units, "units": list(us),
                   "microbatches": list(ms)},
        "routes": routes, "limits": limits,
        "lower_s": round(sum(t["lower_s"] for t in traces.values()), 2),
        "compile_s": round(sum(t["compile_s"] for t in traces.values()), 2),
    }
    record["ok"] = memory["peak_bytes"] <= capacity_bytes
    if not record["ok"]:
        record["oom"] = True
        record["reason"] = (f"peak {memory['peak_bytes']} bytes "
                            f"({memory['peak_bytes'] / 1e9:.2f} GB) > "
                            f"capacity {capacity_bytes:.0f} bytes "
                            f"({capacity_bytes / 1e9:.2f} GB)")
    if verbose:
        print(f"  memory: {memory}")
        print(f"  flops={record['flops']:.3e} "
              f"bytes={record['bytes_accessed']:.3e} "
              f"ops={analysis['n_ops']}")
    return record


def fit_depth(arch: str, shape: ShapeSpec, plan: CellPlan,
              limit_bytes: float, cfg: ModelConfig = None,
              mesh: str = MESH):
    """(cfg, record): the deepest cut of ``arch`` (whole depth units,
    ``depth_units``) whose dry-run peak at ``shape`` under ``plan`` is at
    most ``limit_bytes``, and that cut's record.  The peak is affine in
    the units (each adds its weights, state and saved input), so the
    records at 2 and 3 units give the depth, which its own record then
    confirms (one unit less while it does not fit).  ``ValueError`` when
    not even one unit fits."""
    base = cfg or get_config(arch)
    units, cut = depth_units(base)

    def record(u):
        return lower_cell(arch, shape.name, plan=plan,
                          cfg=base if u == units else cut(u), shape=shape,
                          capacity_bytes=limit_bytes, verbose=False,
                          mesh=mesh)

    rec = record(units)
    if not rec.get("oom"):
        return base, rec
    if units is None or units <= 1:
        raise ValueError(f"{arch}: {rec['reason']}")
    u = units - 1
    if units > 3:
        p2, p3 = (record(v)["memory"]["peak_bytes"] for v in (2, 3))
        if p3 > p2:
            u = min(u, max(1, 2 + int((limit_bytes - p2) // (p3 - p2))))
    while u >= 1:
        rec = record(u)
        if not rec.get("oom"):
            return cut(u), rec
        u -= 1
    raise ValueError(f"{arch}: one depth unit does not fit: "
                     f"{rec['reason']}")


def cell_name(arch: str, shape_name: str, tag: str = "",
              mesh: str = MESH) -> str:
    return f"{arch}_{shape_name}_{mesh}" + (f"_{tag}" if tag else "")


def run_cell(arch: str, shape_name: str, tag: str = "",
             results_dir: Optional[pathlib.Path] = None, **kw) -> dict:
    """``lower_cell`` with its failure recorded, written to
    ``results_dir`` (default ``results/dryrun_torch``)."""
    name = cell_name(arch, shape_name, tag, kw.get("mesh", MESH))
    print(f"[dryrun] {name} ...", flush=True)
    t0 = time.time()
    try:
        rec = lower_cell(arch, shape_name, **kw)
        rec.setdefault("ok", False)               # a skipped cell
        status = ("SKIP" if rec.get("skipped") else
                  "OOM" if rec.get("oom") else "OK")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec = {"arch": arch, "shape": shape_name,
               "mesh": kw.get("mesh", MESH),
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        status = "FAIL"
    rec["wall_s"] = round(time.time() - t0, 1)
    out = pathlib.Path(results_dir) if results_dir is not None else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {name}: {status} ({rec['wall_s']}s)", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--mesh", default=MESH, choices=list(MESHES),
                    help="1 (one card, default), 16x16 or 2x16x16 (the "
                         "production meshes over a fake process group)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run each cell on 16x16 and on 2x16x16 (in "
                         "place of --mesh)")
    ap.add_argument("--seq-shard", type=int, default=None, choices=(0, 1),
                    help="override the plan's sequence parallelism")
    ap.add_argument("--layout", default=None, choices=("tp", "dp", "cp"),
                    help="the serve layout of a prefill or decode cell")
    ap.add_argument("--capacity-gb", type=float, default=H100_BYTES / 1e9,
                    help="device memory the peak is held to (default 80)")
    args = ap.parse_args()

    kw = {"capacity_bytes": args.capacity_gb * 1e9}
    if args.seq_shard is not None:
        kw["seq_shard"] = bool(args.seq_shard)
    if args.layout is not None:
        kw["layout"] = args.layout
    if args.microbatch is not None:
        kw["microbatch"] = args.microbatch
    if args.flash:
        kw["flash"] = True
    archs = ARCH_IDS if args.all or not args.arch else [arch_id(args.arch)]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["16x16", "2x16x16"] if args.both_meshes else [args.mesh]
    failed = 0
    for a in archs:
        for s in shapes:
            for m in meshes:
                rec = run_cell(a, s, tag=args.tag, mesh=m, **kw)
                if "error" in rec:
                    failed += 1
    print(f"[dryrun] done: {len(archs) * len(shapes) * len(meshes)} cells, "
          f"{failed} failures")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
