"""The one-card dry run, its cost analysis, the roofline and the report.

``configs.base.cell_is_supported`` against the reference's for all 40
(arch x shape) cells; the full-size nemotron-4-340b ``train_4k`` cell
traced on fake tensors (nothing allocated) with its arguments equal to a
reckoning of its parameters, Adafactor state and batch; the scan
correction against a whole trace; ``hlo_analysis``'s flops and bytes on a
hand-built chain of products; ``roofline.analyze_record`` on a hand-built
record with the H100's constants; the report's tests of the reference
(``tests/test_launch_report.py``) on the port's module.
"""
import dataclasses
import json
import resource
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_is_supported as jcell_is_supported
from repro.configs.base import get_config as jget_config
from repro_torch import tree as ttree
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeSpec,
                                      cell_is_supported, get_config)
from repro_torch.launch import dryrun, hlo_analysis, report, roofline
from repro_torch.models import model_zoo


def test_cell_is_supported_matches_reference_for_all_40_cells():
    cells = 0
    for arch in ARCH_IDS:
        for name in SHAPES:
            got = cell_is_supported(get_config(arch), SHAPES[name])
            want = jcell_is_supported(jget_config(arch), JSHAPES[name])
            assert got == want, (arch, name)
            cells += 1
    assert cells == 40


def test_train_plan_is_the_references_and_scales_by_tokens():
    for arch in ARCH_IDS:
        assert dryrun.train_plan(arch) == dryrun.TRAIN_PLAN[arch]
        assert dryrun.train_plan(arch, SHAPES["train_4k"]) == \
            dryrun.TRAIN_PLAN[arch]
        small = dryrun.train_plan(arch, ShapeSpec("t", 1024, 4, "train"))
        assert small.microbatch == 1
        assert small.optimizer == dryrun.TRAIN_PLAN[arch].optimizer
    # half the tokens of train_4k: half the microbatches (dbrx's 16 -> 8)
    half = dryrun.train_plan("dbrx-132b", ShapeSpec("t", 4096, 128, "train"))
    assert half.microbatch == 8 and half.optimizer == "adafactor"


def _reckoned_argument_bytes(cfg, shape):
    """Params in their dtypes, Adafactor's float32 master and moments
    (factored rows and columns for a leaf whose last two dims are >= 128,
    else a whole float32 moment), and the int32 tokens and labels."""
    with FakeTensorMode():
        params = model_zoo.build(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        total = 0
        for p in ttree.leaves(params):
            total += p.numel() * p.element_size() + 4 * p.numel()
            if p.dim() >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128:
                rows = p.numel() // p.shape[-1]
                cols = p.numel() // p.shape[-2]
                total += 4 * (rows + cols)
            else:
                total += 4 * p.numel()
    return total + 2 * shape.global_batch * shape.seq_len * 4


def test_full_size_nemotron_train_4k_dry_run_allocates_nothing():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.lower_cell("nemotron_4_340b", "train_4k", verbose=False)
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown_kib < 4 << 20             # 340 B params would be 680 GB
    mem = rec["memory"]
    cfg = get_config("nemotron_4_340b")
    assert mem["argument_bytes"] == _reckoned_argument_bytes(
        cfg, SHAPES["train_4k"])
    # about 2 + 4 B a parameter and a few factored moments
    assert mem["argument_bytes"] == pytest.approx(6 * cfg.n_params(),
                                                  rel=0.02)
    assert not rec["ok"] and rec["oom"]
    assert str(mem["peak_bytes"]) in rec["reason"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["alias_bytes"] >= mem["argument_bytes"] - (8 << 30)
    assert set(mem) >= {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "code_bytes"}
    assert (rec["mesh"], rec["n_devices"], rec["kind"]) == ("1", 1, "train")
    assert rec["plan"]["optimizer"] == "adafactor"
    assert rec["plan"]["microbatch"] == 8 and rec["plan"]["seq_shard"]
    assert rec["traced"] == {"depth_units": 96, "units": [2, 3],
                             "microbatches": [2, 3]}
    h = rec["hlo_analysis"]
    assert h["collective_total_bytes"] == 0.0 and h["collective_counts"] == {}
    # the flop counter's total: at least the 6 N T of the model, remat adds
    # a forward
    row = roofline.model_flops_per_device({**rec, "ok": True})
    assert row < h["flops"] < 1.6 * row


@pytest.mark.parametrize("arch,microbatch", [("gemma-2b", 4),
                                             ("moonshot-v1-16b-a3b", 1)])
def test_scan_correction_matches_the_whole_trace(arch, microbatch):
    """Traced at 2 and 3 depth units (and 2 and 3 microbatches), then
    extrapolated: the flops exactly the whole trace's, the ops within a
    few (the first microbatch and layer set up a few tensors more), the
    peak within 1%.  moonshot: a dense prefix layer, then the units."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=5)
    shape = ShapeSpec("t", 32, 8, "train")
    plan = dataclasses.replace(dryrun.TRAIN_PLAN[dryrun.arch_id(arch)],
                               microbatch=microbatch)
    kw = dict(plan=plan, cfg=cfg, shape=shape, verbose=False)
    got = dryrun.lower_cell(arch, "t", **kw)
    want = dryrun.lower_cell(arch, "t", exact=True, **kw)
    assert got["traced"]["units"] == [2, 3]
    assert got["traced"]["microbatches"] == ([2, 3] if microbatch > 2
                                             else [microbatch])
    assert want["traced"]["microbatches"] == [microbatch]
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-9)
    assert got["hlo_analysis"]["n_ops"] == pytest.approx(
        want["hlo_analysis"]["n_ops"], abs=8)
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    assert got["memory"]["peak_bytes"] == pytest.approx(
        want["memory"]["peak_bytes"], rel=0.01)


def test_scan_correction_follows_the_optimizer_past_the_traced_depth():
    """mamba2-1.3b at full width: at 2 and 3 layers the step peaks in the
    loss, at 12 in the optimizer's update of the stacked ``in_proj``
    (12 x 2048 x 8512 float32 temporaries outgrow the embedding's), so one
    peak extrapolated from 2 and 3 layers falls short; the phase-by-phase
    extrapolation gives the whole trace's peak."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=12)
    kw = dict(cfg=cfg, shape=ShapeSpec("t", 128, 1, "train"), verbose=False)
    got = dryrun.lower_cell("mamba2-1.3b", "t", **kw)
    want = dryrun.lower_cell("mamba2-1.3b", "t", exact=True, **kw)
    assert got["traced"]["units"] == [2, 3]
    assert got["memory"]["peak_bytes"] == pytest.approx(
        want["memory"]["peak_bytes"], rel=1e-3)


def test_peak_extrapolation_pairs_the_update_ops_by_name():
    """Timelines of a step at 2 and 3 units: the forward grows by a
    layer's ops, the update keeps its ops but one that only the deeper
    trace runs.  The update is extrapolated op by op over the ops both
    ran (its 40 -> 60 op reaches 440 at 22 units, above the forward's 200
    -> 210 that reaches 400), the extra op left out."""
    def trace(fwd, upd):
        return {"peak": 0, "timeline": {"forward": fwd, "update": upd}}

    two = trace([("mm", 100), ("mm", 200), ("sum", 150)],
                [("mul", 30), ("add", 40), ("sqrt", 35)])
    three = trace([("mm", 100), ("mm", 205), ("mm", 210), ("sum", 160)],
                  [("mul", 33), ("neg", 900), ("add", 60), ("sqrt", 50)])
    peak = dryrun._extrapolate_peak({(2, 1): two, (3, 1): three}, (2, 3),
                                    1, 22)
    assert peak == 40 + 20 * 20


def test_prefill_and_decode_cells_trace_on_the_cards_routes(tmp_path):
    """A MoE prefill and decode plan the router and the sampling top-k as
    the card would (K5's ``cuda``); an encoder-decoder decode starts from
    its prefill's state; a flash prefill traces through K6's custom op
    (its fake implementation; its flop formula counts the causal pairs,
    fewer than the einsum's whole score blocks).  ``run_cell`` writes each
    record where ``report`` and the roofline read them."""
    cells = [("moonshot-v1-16b-a3b", ShapeSpec("prefill_t", 64, 2,
                                               "prefill")),
             ("moonshot-v1-16b-a3b", ShapeSpec("decode_t", 64, 2,
                                               "decode")),
             ("whisper-tiny", ShapeSpec("decode_w", 64, 2, "decode"))]
    recs = []
    for arch, shape in cells:
        rec = dryrun.run_cell(arch, shape.name, results_dir=tmp_path,
                              cfg=get_smoke_config(arch), shape=shape,
                              verbose=False)
        recs.append(rec)
        assert rec["ok"], rec
        assert rec["kind"] == shape.kind and rec["flops"] > 0
        if arch.startswith("moonshot"):
            assert rec["routes"]["router"] == "cuda"
        if shape.kind == "decode":
            assert rec["routes"]["sampling"] == "cuda"
    assert report.status_counts("1", results_dir=tmp_path) == (3, 0, 0)
    assert "| moonshot-v1-16b-a3b | prefill_t | ok |" in report.markdown(
        "1", results_dir=tmp_path)
    rows = roofline.load_all(results_dir=tmp_path)
    assert len(rows) == 3 and all(r["mesh"] == "1" for r in rows)
    flash = dryrun.lower_cell("moonshot-v1-16b-a3b", "prefill_t",
                              flash=True,
                              cfg=get_smoke_config("moonshot-v1-16b-a3b"),
                              shape=cells[0][1], verbose=False)
    assert flash["ok"] and flash["plan"]["flash"], flash
    assert 0 < flash["flops"] < recs[0]["flops"]


def test_hlo_analysis_counts_2mnk_and_op_bytes_over_a_chain():
    m, k1, k2, k3 = 4096, 1024, 2048, 1024
    with FakeTensorMode():
        x = torch.empty(m, k1)
        w1, w2 = torch.empty(k1, k2), torch.empty(k2, k3)
        trace = hlo_analysis.OpTrace()
        held = trace.hold(x, w1, w2)
        with FlopCounterMode(display=False) as fc, trace:
            h = x @ w1
            y = h @ w2
            y.t()                          # a view moves no byte
        analysis = hlo_analysis.analyze(fc.get_total_flops(),
                                        trace.hbm_bytes, trace.n_ops)
    assert analysis["flops"] == 2 * m * k1 * k2 + 2 * m * k2 * k3
    f = 4
    assert analysis["hbm_bytes"] == f * ((m * k1 + k1 * k2 + m * k2)
                                         + (m * k2 + k2 * k3 + m * k3))
    assert held == f * (m * k1 + k1 * k2 + k2 * k3)
    assert trace.peak == held + f * (m * k2 + m * k3)
    assert analysis["collective_total_bytes"] == 0.0
    top = hlo_analysis.top_tensors(trace)
    assert [row[0] for row in top] == [f * m * k2, f * m * k3]
    assert top[0][2] == "mm" and top[0][3] == f"float32[{m}, {k2}]"


def test_roofline_of_a_hand_built_record_on_the_h100():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    cfg = get_config("gemma-2b")
    rec = {"arch": "gemma_2b", "shape": "train_4k", "mesh": "1",
           "n_devices": 1, "kind": "train", "ok": True,
           "plan": dataclasses.asdict(dryrun.TRAIN_PLAN["gemma_2b"]),
           "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(),
           "hlo_analysis": {"flops": 5.0e16, "hbm_bytes": 4.0e14,
                            "collective_total_bytes": 0.0}}
    row = roofline.analyze_record(rec)
    analytic = roofline.analytic_bytes_per_device(rec)
    assert row["t_compute_s"] == pytest.approx(5.0e16 / 989e12)
    assert row["t_memory_s"] == pytest.approx(analytic["total"] / 3.35e12)
    assert row["t_memory_upper_s"] == pytest.approx(4.0e14 / 3.35e12)
    assert row["t_collective_s"] == 0.0
    assert row["dominant"] == "compute"
    # gemma ties its embeddings: N_active is all of n_active_params
    model = 6.0 * cfg.n_active_params() * SHAPES["train_4k"].tokens
    assert row["model_flops_per_dev"] == pytest.approx(model)
    assert row["mfu_bound"] == pytest.approx(
        (model / 989e12) / row["t_compute_s"])
    assert roofline.mfu(row, 2 * row["t_compute_s"]) == pytest.approx(
        row["mfu_bound"] / 2)
    assert "remat" in roofline.fix_hint(row)
    # 16 microbatches x 3 weight passes of bf16 weights
    assert analytic["weights"] == pytest.approx(3 * 2.0 * cfg.n_params() * 4)
    assert roofline.analyze_record({**rec, "ok": False}) is None


def test_new_launch_modules_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "from repro_torch.launch import dryrun, hlo_analysis, "
            "roofline, report\n"
            "from repro_torch.launch.steps import abstract_init\n"
            "from repro_torch.core import bitonic_sort, cost_model\n"
            "from repro_torch.engine import choose_method\n"
            "from repro_torch.configs.base import cell_is_supported\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# the report: the reference's tests/test_launch_report.py on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def results_dir(tmp_path):
    recs = [
        {"arch": "gemma-2b", "shape": "decode", "mesh": "1", "ok": True,
         "memory": {"temp_bytes": 2.0e9, "argument_bytes": 1.0e9},
         "hlo_analysis": {"flops": 1e12, "collective_total_bytes": 0.0},
         "compile_s": 12},
        {"arch": "gemma-2b", "shape": "decode", "mesh": "8x8", "ok": False},
        {"arch": "moe-8x1b", "shape": "prefill", "skipped": True,
         "reason": "host RAM exceeded while building the dry-run params"},
    ]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    # suffix-filtered variants must never show up
    (tmp_path / "r9_flash.json").write_text(json.dumps(recs[0]))
    return tmp_path


def test_rows_filters_by_mesh(results_dir):
    all_rows = report.rows(results_dir=results_dir)
    assert len(all_rows) == 3                        # _flash variant dropped
    r1 = report.rows("1", results_dir=results_dir)
    assert {r.get("mesh") for r in r1 if not r.get("skipped")} == {"1"}
    assert any(r.get("skipped") for r in r1)         # skips survive
    r8 = report.rows("8x8", results_dir=results_dir)
    assert {r.get("mesh") for r in r8 if not r.get("skipped")} == {"8x8"}


def test_markdown_respects_mesh(results_dir):
    md1 = report.markdown("1", results_dir=results_dir)
    assert "| gemma-2b | decode | ok |" in md1
    assert "**FAIL**" not in md1                     # the 8x8 failure
    assert "SKIP" in md1
    md8 = report.markdown("8x8", results_dir=results_dir)
    assert "**FAIL**" in md8
    assert "| ok |" not in md8


def test_status_counts(results_dir):
    assert report.status_counts(results_dir=results_dir) == (1, 1, 1)
    assert report.status_counts("8x8", results_dir=results_dir) == (0, 1, 1)


def test_default_results_dir_is_the_ports():
    assert report.RESULTS.parts[-2:] == ("results", "dryrun_torch")
    assert dryrun.RESULTS == report.RESULTS


def test_the_record_of_a_step_that_runs_out_of_memory_says_so(tmp_path):
    cfg = get_smoke_config("gemma-2b")
    rec = dryrun.run_cell("gemma-2b", "t", results_dir=tmp_path, cfg=cfg,
                          shape=ShapeSpec("t", 16, 2, "train"),
                          capacity_bytes=1e5, verbose=False)
    assert not rec["ok"] and rec["oom"] and "capacity 100000" in rec["reason"]
    assert "**OOM**" in report.markdown("1", results_dir=tmp_path)
    assert report.status_counts("1", results_dir=tmp_path) == (0, 1, 0)
    assert roofline.load_all(results_dir=tmp_path) == []
    with pytest.raises(ValueError, match="does not fit"):
        shape = ShapeSpec("t", 16, 2, "train")
        dryrun.fit_depth("gemma-2b", shape,
                         dryrun.train_plan("gemma-2b", shape), 1e5, cfg=cfg)


def test_fit_depth_finds_the_deepest_cut_that_fits():
    cfg = dataclasses.replace(get_smoke_config("gemma-2b"), n_layers=8)
    shape = ShapeSpec("t", 32, 4, "train")
    plan = dryrun.train_plan("gemma-2b", shape)
    five = dryrun.lower_cell("gemma-2b", "t", plan=plan, shape=shape,
                             cfg=dataclasses.replace(cfg, n_layers=5),
                             verbose=False)["memory"]["peak_bytes"]
    cut, rec = dryrun.fit_depth("gemma-2b", shape, plan, five + 1, cfg=cfg)
    assert cut.n_layers == 5 and rec["ok"] and rec["n_layers"] == 5
    assert rec["memory"]["peak_bytes"] == pytest.approx(five, rel=0.01)
    whole, rec = dryrun.fit_depth("gemma-2b", shape, plan, 1e12, cfg=cfg)
    assert whole == cfg and rec["ok"]
