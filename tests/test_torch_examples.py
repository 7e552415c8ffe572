"""The six examples of the port (``examples/torch/*.py``) run in-process on
the CPU, each held against the JAX package's own functions called
directly (not its examples, which would add XLA compiles of whole
programs): the paper's claims and the in-memory sort's accounting, the
planner's choices and the engine's layouts, the CAS program cycle by
cycle on the reference's simulated array, the distributed plan and its
exchange volumes, the served requests, and the trained config's size.
"""
import dataclasses
import math
import pathlib
import runpy
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs.gemma_2b as jgemma
import repro.sort as jsort
import repro_torch
from _torch_parity import assert_same
from repro.core import cost_model as jcm
from repro.core import distributed_sort as jds
from repro.core import gates as jgates
from repro.core import imc_array as jarr
from repro.core import sorter as jsorter
from repro.engine import planner as jplanner
from repro.engine import runs as jruns
from repro.engine import samplesort as jsamplesort
from repro.engine import segmented as jsegmented

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ("quickstart", "engine_sort_demo", "imc_sort_demo",
         "distributed_sort_demo", "serve_decode", "train_lm")
PORT_NAME = {**repro_torch.BACKEND_NAMES, "select": "select"}


def run_example(name, argv, capsys):
    """``main(argv)`` of the example -> (its result, what it printed)."""
    main = runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]
    result = main(argv)
    return result, capsys.readouterr().out


def test_every_example_of_the_reference_has_a_port():
    ref = {p.stem for p in (EXAMPLES.parent).glob("*.py")}
    assert ref == set(NAMES) == {p.stem for p in EXAMPLES.glob("*.py")}


def test_quickstart(capsys):
    res, out = run_example("quickstart", ["--device", "cpu"], capsys)
    for m in ("torch", "bitonic", "cuda", "merge", "radix", "auto"):
        assert f"sort(method={m!r}): ok" in out
    want = jcm.validate_claims()
    assert res["claims"].rows == want.rows and want.all_pass()
    assert f"all {len(want.rows)} claims pass: True" in out
    # the top-k and the in-memory sort, on the same seeded inputs
    x = np.random.default_rng(0).standard_normal((4, 100)).astype(np.float32)
    for w, g in zip(jsort.topk(jnp.asarray(x), 5, method="xla"),
                    res["topk"]):
        assert_same(w, g)
    v = np.random.default_rng(1).integers(0, 16, size=(2, 8))
    ref = jsorter.sort_in_memory(v, width=4)
    got = res["in_memory"]
    assert np.array_equal(np.array(ref.values), got.values.numpy())
    for f in ("cycles", "compute_cycles", "movement_cycles", "array_rows",
              "array_cols", "n_partitions", "n_temp_rows"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.cycles == 192
    assert f"cycles: {ref.cycles} (= {ref.compute_cycles} compute " \
        f"+ {ref.movement_cycles} movement)" in out
    assert f"latency: {jcm.sort_latency_ns(8):.1f} ns" in out
    assert "latency: 105.6 ns" in out


def test_engine_sort_demo(capsys):
    res, out = run_example("engine_sort_demo", ["--device", "cpu"], capsys)
    assert res["plans"] == {n: PORT_NAME[jplanner.choose(n, batch=1).method]
                            for n in res["plans"]}
    n = (1 << 20) + 12345
    plan = jplanner.choose(n, 1, requested="merge")
    n_tiles, padded = jruns.run_layout(n, plan.run_len)
    assert f"n={n}: {n_tiles} runs of {padded // n_tiles}, " \
        f"{int(np.log2(n_tiles))} merge levels" in out
    assert "topk(50) over vocab 152064: ok" in out
    assert "5 ragged groups sorted independently in one pass: ok" in out
    # the MoE grouping's ids: the demo's generator after its other draws
    rng = np.random.default_rng(0)
    rng.standard_normal(n)
    rng.standard_normal((4, 152064))
    rng.standard_normal(64)
    rng.integers(0, 5, 64)
    ids = rng.integers(0, 8, 256).astype(np.int32)
    _, splits = jsegmented.group_tokens_by_expert(jnp.asarray(ids), 8)
    assert res["row_splits"] == np.array(splits).tolist()
    assert f"row_splits={np.array(splits).tolist()}" in out


def _reference_cycles(a, b):
    """The reference's array after each cycle of the W=4 program."""
    prog = jgates.build_cas_program(4)
    state = jarr.make_array(1, prog.n_rows, 4)
    for row, word in ((jarr.ROW_A, a), (jarr.ROW_B, b)):
        state = jarr.write_word(state, row, jarr.int_to_bits(
            jnp.asarray([word], jnp.uint32), 4))
    counter = jarr.CycleCounter()
    rows = []
    for op in prog.ops:
        state = jarr.step(state, op, counter)
        rows.append("".join(map(str, np.array(state[0, op.dst]
                                              .astype(np.int32)))))
    return prog, rows, counter.as_dict()


@pytest.mark.parametrize("a,b", [(None, None), (5, 3)])
def test_imc_sort_demo(a, b, capsys):
    argv = [] if a is None else [str(a), str(b)]
    res, out = run_example("imc_sort_demo", argv + ["--device", "cpu"],
                           capsys)
    a, b = (0b1000, 0b0001) if a is None else (a, b)
    prog, rows, mix = _reference_cycles(a, b)
    assert res["phases"] == (prog.compare_cycles, prog.mux_cycles,
                             prog.writeback_cycles) == (18, 8, 2)
    assert "phases: compare=18 mux=8 writeback=2" in out
    assert res["op_mix"] == mix
    assert sum(mix[k] for k in ("NOR", "NOT", "AND", "COPY")) == 28
    assert "paper Table I: NOR 14 NOT 8 AND 3 COPY 3" in out
    for cyc, (op, row) in enumerate(zip(prog.ops, rows), start=1):
        assert f"cycle {cyc:2d}  {op.kind.value:4s} -> row {op.dst:2d} " \
            f"[{row}]  {op.label}" in out
    assert (res["lo"], res["hi"]) == (min(a, b), max(a, b))


def test_distributed_sort_demo(capsys):
    res, out = run_example("distributed_sort_demo", ["--device", "cpu"],
                           capsys)
    n_dev, local = 8, 4096
    assert res["mesh"].shape == {"data": n_dev}
    assert res["plan"].strategy == \
        jplanner.choose_distributed(n_dev * local, n_dev).strategy
    oe = jds.collective_bytes_per_device(n_dev, local, 4)
    ss = jsamplesort.alltoall_bytes_per_device(n_dev, local, 4)
    assert f"odd-even {oe/1e3:.1f} kB" in out
    assert f"vs sample {ss/1e3:.1f} kB" in out
    for strategy in ("oddeven", "sample"):
        assert f"strategy={strategy!r}: the same {n_dev * local} keys" in out
    assert f"kv/descending/uneven: {n_dev * local - 3} elements OK" in out
    assert "device order is globally ascending: True" in out


def test_serve_decode(capsys):
    res, out = run_example("serve_decode", ["--device", "cpu"], capsys)
    done, stats = res["done"], res["stats"]
    assert len(done) == 20 and stats["batches"] == 3
    assert stats["decode_route"] == "static"
    vocab = jgemma.smoke().vocab_size
    for r in done:
        assert len(r.out) == 24 and 0 <= r.out.min() and r.out.max() < vocab
    for r in done[:3]:
        assert f"request {r.rid}: prompt len {len(r.prompt)}, generated " \
            f"{r.out[:10].tolist()}..." in out


def test_train_lm(tmp_path, capsys):
    """Two steps of 2 x 32 tokens: one AdamW update's gain on the next
    batch (~0.36) is well above the loss's spread between two batches;
    at 1 x 16 tokens it is not (the step-1 loss came out 0.002 above the
    first), and the example asserts a falling loss."""
    ckpt = tmp_path / "ckpt"
    try:
        res, out = run_example(
            "train_lm", ["--steps", "2", "--batch", "2", "--seq", "32",
                         "--device", "cpu", "--ckpt-dir", str(ckpt)], capsys)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = dataclasses.replace(
        jgemma.CONFIG, name="gemma-100m", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=1, head_dim=64, d_ff=2048, vocab_size=32768,
        max_seq=4096)
    assert res["config"].n_params() == want.n_params()
    assert f"model: gemma-100m, ~{want.n_params()/1e6:.0f}M params" in out
    losses = res["losses"]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert res["step_ms"] is None
    assert "step time: not measured" in out
