"""Parity of the port's paper model and ``imc`` backend with the JAX
package: the gate programs, the bitonic network and its partition plans,
the cycle-accurate IMC array, the CAS block, K7's plain version, the
in-memory sorter with its cycle accounting, the paper's claims, the
``imc`` sort/argsort, and the v1 ``sort_api`` shims.  The same seeded
numpy inputs go through both packages; every comparison is bit-exact
(``top_p_mask`` holds its inputs 1e-5 away from the mass ``p``, see
there).  Everything runs on the CPU: the simulator, and K7's plain
version where the reference runs its Pallas kernel in interpret mode.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sort as jsort
import repro_torch.sort as tsort
from _torch_parity import assert_same, keys, to_torch
from repro.core import cas as jcas
from repro.core import cost_model as jcm
from repro.core import gates as jgates
from repro.core import imc_array as jarr
from repro.core import keycodec as jkc
from repro.core import network as jnet
from repro.core import sort_api as japi
from repro.core import sorter as jsorter
from repro.kernels import bitserial_cas as jbc
from repro.kernels import ops as jops
from repro_torch.core import cas as tcas
from repro_torch.core import cost_model as tcm
from repro_torch.core import gates as tgates
from repro_torch.core import imc_array as tarr
from repro_torch.core import keycodec as tkc
from repro_torch.core import network as tnet
from repro_torch.core import sort_api as tapi
from repro_torch.core import sorter as tsorter
from repro_torch.kernels import _build
from repro_torch.kernels import bitserial_cas as tbc
from repro_torch.kernels import ops as tops

WIDTHS = [2, 4, 8, 16, 32]
INT_DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32"]


@pytest.fixture(autouse=True)
def _no_kernel_build(monkeypatch):
    """CPU tensors must never reach a CUDA build or launch."""
    def _refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel path")
    monkeypatch.setattr(_build, "load", _refuse)


def _words(rng, shape, width):
    """Unsigned W-bit words (uint32) with 0, 2^W - 1, the top bit and
    equal operands mixed in."""
    w = rng.integers(0, 1 << width, size=shape, dtype=np.uint64)
    flat = w.reshape(-1)
    flat[0::13] = 0
    flat[1::13] = (1 << width) - 1
    flat[2::13] |= 1 << (width - 1)
    return w.astype(np.uint32)


def _t(words):
    """uint32 numpy words -> the port's int32 carriers, same bits."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _op_fields(op):
    return (op.kind.value, op.src1, op.dst, op.src2, op.movement.value,
            op.fill, op.bcast_col, op.label)


# ---------------------------------------------------------------------------
# gates, network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
def test_gate_programs_match_reference_op_for_op(width):
    jp, tp = jgates.build_cas_program(width), tgates.build_cas_program(width)
    assert [_op_fields(o) for o in tp.ops] == [_op_fields(o) for o in jp.ops]
    for f in ("width", "n_rows", "compare_cycles", "mux_cycles",
              "writeback_cycles", "row_s", "row_ns", "total_cycles"):
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("width", [0, 3, 6])
def test_gate_program_rejects_non_power_of_two_widths(width):
    with pytest.raises(ValueError, match="power of two"):
        jgates.build_cas_program(width)
    with pytest.raises(ValueError, match="power of two"):
        tgates.build_cas_program(width)


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_network_stages_and_partition_plans_match_reference(n):
    assert tnet.bitonic_stages(n) == jnet.bitonic_stages(n)
    tp, jp = tnet.plan_partitions(n), jnet.plan_partitions(n)
    assert tp.residency == jp.residency
    assert (tp.raw_moving_transitions, tp.moving_transitions,
            tp.extra_cycles, tp.n_partitions) == \
        (jp.raw_moving_transitions, jp.moving_transitions, jp.extra_cycles,
         jp.n_partitions)
    for f in ("n_cas_blocks", "n_stages", "n_temp_rows", "movement_cycles",
              "total_extra_cycles"):
        assert getattr(tnet, f)(n) == getattr(jnet, f)(n), f
    vals = list(np.random.default_rng(n).integers(0, 9, n))
    assert tnet.apply_network(vals, tnet.bitonic_stages(n)) == \
        jnet.apply_network(vals, jnet.bitonic_stages(n)) == sorted(vals)


# ---------------------------------------------------------------------------
# the IMC array
# ---------------------------------------------------------------------------

_KINDS = ["NOR", "AND", "NOT", "COPY"]
_MOVES = ["same", "shift_right", "bcast_last", "bcast_col"]


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("move", _MOVES)
def test_imc_array_step_matches_reference(kind, move):
    rng = np.random.default_rng(4 * _KINDS.index(kind) + _MOVES.index(move))
    state = rng.integers(0, 2, size=(5, 9, 8)).astype(bool)
    state[:, tarr.ROW_ZERO] = False
    state[:, tarr.ROW_ONE] = True
    for fill in (0, 1):
        kw = dict(src1=4, dst=6, src2=5 if kind in ("NOR", "AND") else None,
                  fill=fill, bcast_col=3, label="t")
        jop = jarr.Op(kind=jarr.OpKind(kind), movement=jarr.Movement(move),
                      **kw)
        top = tarr.Op(kind=tarr.OpKind(kind), movement=tarr.Movement(move),
                      **kw)
        jc, tc = jarr.CycleCounter(), tarr.CycleCounter()
        want = np.array(jarr.step(jnp.asarray(state), jop, jc))
        before = torch.from_numpy(state.copy())
        got = tarr.step(before, top, tc)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(before.numpy(), state)  # functional
        assert tc.as_dict() == jc.as_dict()
        # dst == src1: the result is written over its own source
        jop2 = dataclasses.replace(jop, dst=4)
        top2 = dataclasses.replace(top, dst=4)
        np.testing.assert_array_equal(
            tarr.run_program(torch.from_numpy(state), [top2, top]).numpy(),
            np.array(jarr.run_program(jnp.asarray(state), [jop2, jop])))


@pytest.mark.parametrize("width", WIDTHS)
def test_imc_array_words_and_bits_match_reference(width):
    rng = np.random.default_rng(width)
    w = _words(rng, (40,), width)
    jb = np.array(jarr.int_to_bits(jnp.asarray(w), width))
    tb = tarr.int_to_bits(_t(w), width)
    np.testing.assert_array_equal(tb.numpy(), jb)
    assert_same(np.array(jarr.bits_to_int(jnp.asarray(jb))),
                tarr.bits_to_int(tb))
    js = jarr.write_word(jarr.make_array(40, 6, width), jarr.ROW_B,
                         jnp.asarray(jb))
    ts = tarr.write_word(tarr.make_array(40, 6, width), tarr.ROW_B, tb)
    np.testing.assert_array_equal(ts.numpy(), np.array(js))
    np.testing.assert_array_equal(tarr.read_word(ts, tarr.ROW_ONE).numpy(),
                                  np.array(jarr.read_word(js, jarr.ROW_ONE)))


# ---------------------------------------------------------------------------
# the CAS block and K7's plain version
# ---------------------------------------------------------------------------

def test_run_cas_w4_all_256_pairs():
    a = np.repeat(np.arange(16), 16).astype(np.uint32)
    b = np.tile(np.arange(16), 16).astype(np.uint32)
    jr = jcas.run_cas(a, b, width=4)
    tr = tcas.run_cas(_t(a), _t(b), width=4, device="cpu")
    assert_same(np.array(jr.lo), tr.lo)
    assert_same(np.array(jr.hi), tr.hi)
    np.testing.assert_array_equal(tr.lo.numpy(), np.minimum(a, b))
    np.testing.assert_array_equal(tr.hi.numpy(), np.maximum(a, b))
    assert tr.cycles == jr.cycles == 28
    assert tr.op_counts == jr.op_counts


@pytest.mark.parametrize("width", [8, 16, 32])
def test_run_cas_wide_words_with_the_top_bit_set(width):
    rng = np.random.default_rng(width)
    a, b = _words(rng, (300,), width), _words(rng, (300,), width)
    b[::7] = a[::7]
    jr = jcas.run_cas(a, b, width=width)
    # numpy int64 input: the port keeps the low 32 bits, as the reference
    # casts to uint32
    tr = tcas.run_cas(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64)), width=width,
                      device="cpu")
    assert_same(np.array(jr.lo), tr.lo)
    assert_same(np.array(jr.hi), tr.hi)
    assert_same(np.minimum(a, b), tr.lo)
    assert_same(np.maximum(a, b), tr.hi)
    assert (tr.cycles, tr.op_counts) == (jr.cycles, jr.op_counts)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", [700, 128, 5])
def test_k7_plain_matches_reference_kernel_in_interpret_mode(width, n):
    """``ops.bitserial_cas`` on CPU tensors (K7's plain version) against
    the reference's Pallas kernel run in interpret mode, as
    ``tests/test_kernels.py`` runs it; lengths that are not a multiple of
    the 128 lanes included, which the reference pads and the port does
    not."""
    rng = np.random.default_rng(width * 1000 + n)
    a, b = _words(rng, (n,), width), _words(rng, (n,), width)
    a[3::11] = b[3::11]
    jlo, jhi = jops.bitserial_cas(jnp.asarray(a), jnp.asarray(b),
                                  width=width)
    tlo, thi = tops.bitserial_cas(_t(a), _t(b), width=width)
    assert_same(np.array(jlo), tlo)
    assert_same(np.array(jhi), thi)
    assert_same(np.minimum(a, b), tlo)
    assert_same(np.maximum(a, b), thi)


@pytest.mark.parametrize("width", WIDTHS)
def test_k7_plain_matches_reference_exec_program(width):
    """The transcription itself, on a (rows, lanes) block and on a 3-D
    block, against the reference's ``_exec_program``."""
    rng = np.random.default_rng(width + 7)
    a, b = _words(rng, (3, 128), width), _words(rng, (3, 128), width)
    jlo, jhi = jbc._exec_program(jnp.asarray(a.view(np.int32)),
                                 jnp.asarray(b.view(np.int32)), width)
    tlo, thi = tbc.exec_program_plain(_t(a), _t(b), width)
    assert_same(np.array(jlo), tlo)
    assert_same(np.array(jhi), thi)
    tlo3, thi3 = tbc.cas_blocks(_t(a).view(3, 2, 64), _t(b).view(3, 2, 64),
                                width=width)
    assert torch.equal(tlo3.reshape(3, 128), tlo)
    assert torch.equal(thi3.reshape(3, 128), thi)


def _emulate_k7(table, a, b, width):
    """The kernels' bit layout in Python integers: one uint32 row mask per
    SRAM row, column c at bit W-1-c, every op read from the int32 table
    that ``csrc/cas_programs.cuh`` is generated from."""
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    lo, hi = [], []
    for x, y in zip(a.tolist(), b.tolist()):
        row = {0: 0, 1: mask, 2: x & mask, 3: y & mask}
        for kind, s1, s2, dst, mv, fill, col in table.tolist():
            u, w = row[s1], row[s2]
            v = (~(u | w) & mask) if kind in (0, 2) else (u & w)
            if mv == 1:
                v = ((v >> 1) | (top if fill else 0)) & mask
            elif mv == 2:
                v = mask if v & 1 else 0
            elif mv == 3:
                v = mask if (v >> (width - 1 - col)) & 1 else 0
            row[dst] = v
        lo.append(row[2])
        hi.append(row[3])
    return np.array(lo, np.uint32), np.array(hi, np.uint32)


@pytest.mark.parametrize("width", WIDTHS)
def test_k7_op_table_runs_the_gate_program(width):
    """The op table the kernels' code is generated from encodes the
    program (constant rows as NOT's and COPY's second input), and the
    kernels' bit layout, emulated here, computes (min, max)."""
    prog, table = tgates.build_cas_program(width), tbc.program_table(width)
    assert table.dtype == torch.int32
    assert table.shape == (len(prog.ops), 7)
    const = {"NOT": tarr.ROW_ZERO, "COPY": tarr.ROW_ONE}
    kinds = {"NOR": 0, "AND": 1, "NOT": 2, "COPY": 3}
    moves = {"same": 0, "shift_right": 1, "bcast_last": 2, "bcast_col": 3}
    for op, rec in zip(prog.ops, table.tolist()):
        assert rec == [kinds[op.kind.value], op.src1,
                       const.get(op.kind.value, op.src2), op.dst,
                       moves[op.movement.value], op.fill, op.bcast_col]
    rng = np.random.default_rng(width)
    a, b = _words(rng, (200,), width), _words(rng, (200,), width)
    a[::9] = b[::9]
    lo, hi = _emulate_k7(table, a, b, width)
    np.testing.assert_array_equal(lo, np.minimum(a, b))
    np.testing.assert_array_equal(hi, np.maximum(a, b))


def test_k7_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="width"):
        tbc.cas_blocks(a, a, width=64)
    with pytest.raises(TypeError, match="int32"):
        tbc.cas_blocks(a.long(), a.long(), width=4)
    with pytest.raises(ValueError, match="shapes"):
        tbc.cas_blocks(a, a[:4], width=4)
    v = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="width"):
        tbc.cas_stages(v, [(2, 1)], 3)
    with pytest.raises(TypeError, match="int32"):
        tbc.cas_stages(v.long(), [(2, 1)], 4)
    for k, j in ((4, 4), (16, 1), (6, 2), (4, 3)):
        with pytest.raises(ValueError, match="powers of two"):
            tbc.cas_stages(v, [(k, j)], 4)
    with pytest.raises(ValueError, match="powers of two"):
        tbc.cas_stages(torch.zeros(2, 6, dtype=torch.int32), [(2, 1)], 4)


# ---------------------------------------------------------------------------
# K7's generated gate programs and its stage kernel (plain version)
# ---------------------------------------------------------------------------

def _header_section(text, width):
    """The lines of one width's ``cas_program`` in the header text."""
    lines = text.splitlines()
    first = lines.index(f"// W = {width}: "
                        f"{len(tgates.build_cas_program(width).ops)} ops on "
                        f"{tgates.build_cas_program(width).n_rows} rows")
    return lines[first:lines.index("}", first) + 1]


@pytest.mark.parametrize("width", WIDTHS)
def test_k7_header_is_generated_from_the_programs(width):
    """The checked-in ``csrc/cas_programs.cuh`` is ``program_header()``
    byte for byte: the card runs the programs of ``core/gates.py``.
    Regenerate with ``python -m repro_torch.kernels.bitserial_cas``."""
    text = tbc.HEADER.read_text()
    assert _header_section(text, width) == \
        _header_section(tbc.program_header(), width)
    assert text == tbc.program_header()


def _run_header(text, width, a, b):
    """Execute one width's straight-line C as Python integers: the C
    operators used (~ | & >> << ?:) read the same in both once the
    ternaries are turned round and the ``u`` suffixes dropped."""
    import re
    env = {"a": 0, "b": 0}
    body = []
    for line in _header_section(text, width)[3:-1]:
        code = line.split("//")[0].strip().rstrip(";")
        code = re.sub(r"\b(0x[0-9A-F]+|\d+)u\b", r"\1", code)
        code = re.sub(r"^(?:constexpr|const) uint32_t ", "", code)
        code = re.sub(r"= (.*) \? m : 0$", r"= (m if \1 else 0)", code)
        body += code.split(", ") if code.startswith(("r0", "r2")) \
            else [code]
    if body[-1] != "b = " + body[-1][4:] or not body[-2].startswith("a = "):
        raise AssertionError(body[-2:])
    lo, hi = [], []
    for x, y in zip(a.tolist(), b.tolist()):
        env.update(a=x, b=y)
        for stmt in body:
            exec(stmt, {}, env)
        lo.append(env["a"])
        hi.append(env["b"])
    return np.array(lo, np.uint32), np.array(hi, np.uint32)


@pytest.mark.parametrize("width", WIDTHS)
def test_k7_header_code_computes_min_max(width):
    """The generated straight-line code, run as written (every gate, no
    comparison of a with b), gives (min, max) of W-bit words; each of its
    ops is one or two logic operations."""
    text = tbc.HEADER.read_text()
    code = _header_section(text, width)
    assert len([c for c in code if c.startswith("  const uint32_t o")]) == \
        len(tgates.build_cas_program(width).ops)
    import re
    ops = "\n".join(c.split("//")[0] for c in code[3:])
    assert not re.search(r"[^<]<[^<]|[^>]>[^>]|<=|>=|==|min|max", ops)
    rng = np.random.default_rng(width + 11)
    a, b = _words(rng, (300,), width), _words(rng, (300,), width)
    a[::7] = b[::7]
    lo, hi = _run_header(text, width, a, b)
    np.testing.assert_array_equal(lo, np.minimum(a, b))
    np.testing.assert_array_equal(hi, np.maximum(a, b))


@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_stage_pairs_match_the_network(n):
    """The stage kernel's pair arithmetic (i with i & j == 0, its partner
    i ^ j, ascending where i & k == 0) over ``network.stage_schedule(n)``
    is ``network.bitonic_stages(n)``, stage for stage and pair for pair."""
    schedule = tnet.stage_schedule(n)
    stages = jnet.bitonic_stages(n)
    assert len(schedule) == len(stages) == tnet.n_stages(n)
    for (k, j), pairs in zip(schedule, stages):
        i, p, asc = tbc.stage_pairs(n, k, j)
        assert list(zip(i.tolist(), p.tolist(), asc.tolist())) == \
            [tuple(q) for q in pairs]
        assert sorted(i.tolist() + p.tolist()) == list(range(n))


def _reference_stage(v, stage, width):
    """One stage of the reference's loop (``src/repro/core/sorter.py``
    :67-80), its compare-and-swap through the reference's Pallas K7
    (``kernels/ops.bitserial_cas`` -> ``cas_blocks``) in interpret mode."""
    batch = v.shape[0]
    idx_i = np.array([p[0] for p in stage])
    idx_j = np.array([p[1] for p in stage])
    asc = jnp.asarray(np.array([p[2] for p in stage]))[None, :]
    lo, hi = jops.bitserial_cas(v[:, idx_i].reshape(-1),
                                v[:, idx_j].reshape(-1), width=width,
                                interpret=True)
    lo, hi = lo.reshape(batch, -1), hi.reshape(batch, -1)
    return v.at[:, idx_i].set(jnp.where(asc, lo, hi)) \
        .at[:, idx_j].set(jnp.where(asc, hi, lo))


@pytest.mark.parametrize("n", [2, 8, 64])
@pytest.mark.parametrize("width", WIDTHS)
def test_stage_plain_matches_reference_stage_loop(n, width):
    """``stage_plain`` (the stage kernel's plain version) over every stage
    of the network, and ``cas_stage`` in place on the CPU, against the
    reference's stage loop on the same seeded words, stage by stage; bit
    for bit.  The end is the sorted rows."""
    rng = np.random.default_rng(n * 100 + width)
    x = _words(rng, (3, n), width)
    x[1, ::2] = x[1, 0]                       # ties
    jv = jnp.asarray(x.view(np.int32))
    tv = _t(x).clone()
    inplace = tv.clone()
    for (k, j), stage in zip(tnet.stage_schedule(n), jnet.bitonic_stages(n)):
        jv = _reference_stage(jv, stage, width)
        tv = tbc.stage_plain(tv, k, j, width)
        assert_same(np.array(jv), tv, f"stage ({k}, {j})")
        assert tbc.cas_stages(inplace, [(k, j)], width) is inplace
        assert torch.equal(inplace, tv)
    assert_same(np.sort(x, axis=-1), tv)
    whole = _t(x).clone()
    assert tbc.cas_stages(whole, tnet.stage_schedule(n), width) is whole
    assert torch.equal(whole, tv)


# ---------------------------------------------------------------------------
# the in-memory sorter and the paper's cost model
# ---------------------------------------------------------------------------

_SORT_FIELDS = ("cycles", "compute_cycles", "movement_cycles",
                "n_partitions", "n_temp_rows", "array_rows", "array_cols",
                "op_counts")


@pytest.mark.parametrize("n", [2, 8, 64, 256])
@pytest.mark.parametrize("width", [4, 8, 16, 32])
def test_sort_in_memory_matches_reference(n, width):
    rng = np.random.default_rng(n * 64 + width)
    x = _words(rng, (3, n), width)
    x[1, ::2] = x[1, 0]                       # ties
    jr = jsorter.sort_in_memory(x, width=width)
    tr = tsorter.sort_in_memory(_t(x), width=width, device="cpu")
    assert_same(np.array(jr.values), tr.values)
    assert_same(np.sort(x, axis=-1), tr.values)
    for f in _SORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert tsorter.array_geometry(n, width) == \
        jsorter.array_geometry(n, width)


def test_sort_in_memory_paper_unit_accounting():
    """N=8, W=4: 6 stages x 28 + 24 movement cycles = 192; 1-D input."""
    x = np.array([9, 3, 15, 0, 7, 7, 12, 1], np.uint32)
    tr = tsorter.sort_in_memory(_t(x), device="cpu")
    jr = jsorter.sort_in_memory(x)
    assert (tr.cycles, tr.compute_cycles, tr.movement_cycles) == \
        (192, 168, 24)
    assert tr.values.shape == (1, 8)
    assert_same(np.array(jr.values), tr.values)
    assert tr.op_counts == jr.op_counts
    assert tsorter.array_geometry(8) == jsorter.array_geometry(8) == \
        {"rows": 22, "cols": 16, "temp_rows": 2, "bits": 352}


def test_validate_claims_rows_equal_reference():
    tc, jc = tcm.validate_claims(), jcm.validate_claims()
    assert tc.rows == jc.rows
    assert tc.all_pass() and jc.all_pass()


@pytest.mark.parametrize("n", [2, 8, 64, 1024])
@pytest.mark.parametrize("width", [4, 8, 32])
def test_paper_cost_model_matches_reference(n, width):
    for f in ("sort_cycles", "sort_latency_ns", "throughput_gops",
              "memsort_cycles", "memsort_latency_ns",
              "off_memory_latency_ns", "memory_bits"):
        assert getattr(tcm, f)(n, width) == getattr(jcm, f)(n, width), f
    # the port counts the gate program at every width; the reference's
    # paper count (W=4) and its program count agree with it
    assert tcm.cas_cycles(width) == jcm.cas_cycles(width) \
        == jcm.cas_cycles(width, use_paper_counts=False)
    assert tcm.stage_op_totals(n) == jcm.stage_op_totals(n)
    assert tcm.bubble_sort_comparisons(n) == jcm.bubble_sort_comparisons(n)
    for c in ("CYCLE_NS", "OPERATING_FREQ_GHZ", "TABLE1_CAS_OPS",
              "CAS_CYCLES_W4", "MEMSORT_CYCLE_RATIO",
              "MEMSORT_LATENCY_RATIO", "OFF_MEMORY_LATENCY_RATIO"):
        assert getattr(tcm, c) == getattr(jcm, c), c


# ---------------------------------------------------------------------------
# the imc backend through the front door
# ---------------------------------------------------------------------------

def _imc_keys(name, n, seed):
    """Ties, negatives and both dtype extremes."""
    x = keys(name, (3, n), "mixed", seed)
    info = np.iinfo(x.dtype)
    x[1, :4] = [info.min, info.max, info.min, info.max]
    x[2, ::3] = x[2, 1]
    return x


@pytest.mark.parametrize("name", INT_DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_imc_sort_matches_reference(name, descending):
    x = _imc_keys(name, 32, seed=len(name))
    want = jsort.sort(x, method="imc", descending=descending)
    got = tsort.sort(to_torch(x), method="imc", descending=descending,
                     device="cpu")
    assert_same(want, got, name)


@pytest.mark.parametrize("name", INT_DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_imc_argsort_matches_reference(name, descending):
    """Through the (key, index) composite: W=16 for 8-bit keys and W=32 for
    16-bit keys at n=64; 32-bit keys cannot pack an index and raise in
    both packages."""
    x = _imc_keys(name, 64, seed=len(name) + 1)
    if not jkc.composite_fits(x.dtype, 64):
        with pytest.raises(ValueError, match="composite"):
            jsort.argsort(x, method="imc", descending=descending)
        with pytest.raises(ValueError, match="composite"):
            tsort.argsort(to_torch(x), method="imc", descending=descending,
                          device="cpu")
        return
    want = jsort.argsort(x, method="imc", descending=descending)
    got = tsort.argsort(to_torch(x), method="imc", descending=descending,
                        device="cpu")
    assert_same(want, got, name)
    assert_same(np.argsort(-x.astype(np.int64) if descending else x,
                           kind="stable", axis=-1).astype(np.int32), got)


@pytest.mark.parametrize("name", INT_DTYPES)
@pytest.mark.parametrize("n", [1, 64, 4096, 1 << 16])
@pytest.mark.parametrize("descending", [False, True])
def test_argsort_composite_matches_reference(name, n, descending):
    x = keys(name, (2, min(n, 64)), "mixed", seed=n)
    x = np.resize(x, (2, n))
    t = to_torch(x)
    assert tkc.composite_index_bits(n) == jkc.composite_index_bits(n)
    assert tkc.composite_fits(t.dtype, n) == jkc.composite_fits(x.dtype, n)
    if not jkc.composite_fits(x.dtype, n):
        with pytest.raises(ValueError, match="32-bit word"):
            tkc.argsort_composite(t, descending=descending)
        return
    jc, jb = jkc.argsort_composite(jnp.asarray(x), descending=descending)
    tc, tb = tkc.argsort_composite(t, descending=descending)
    assert tb == jb and tc.dtype == torch.int32
    assert_same(np.array(jc), tc)


@pytest.mark.parametrize("case", ["odd_n", "int32_argsort", "float",
                                  "topk", "sort_kv"])
def test_imc_errors_match_reference(case):
    """The reference's errors: the network is not padded, a composite over
    32 bits does not pack, and the spec layer and backend refuse floats,
    top-k and payloads; all ValueError in both packages."""
    xi = np.arange(6, dtype=np.int8)[None]
    calls = {
        "odd_n": lambda m, kw: m.sort(xi, method="imc", **kw),
        "int32_argsort": lambda m, kw: m.argsort(
            np.arange(2, dtype=np.int32), method="imc", **kw),
        "float": lambda m, kw: m.sort(np.zeros(4, np.float32),
                                      method="imc", **kw),
        "topk": lambda m, kw: m.topk(np.arange(4, dtype=np.int8), 2,
                                     method="imc", **kw),
        "sort_kv": lambda m, kw: m.sort_kv(
            np.arange(4, dtype=np.int8), np.arange(4, dtype=np.int32),
            method="imc", **kw),
    }
    with pytest.raises(ValueError) as je:
        calls[case](jsort, {})
    with pytest.raises(ValueError) as te:
        calls[case](tsort, {"device": "cpu"})
    jm, tm = str(je.value), str(te.value)
    assert jm.split(" ")[:3] == tm.split(" ")[:3], (jm, tm)


def test_imc_backend_capabilities_match_reference():
    from repro.core import sortspec as jspec
    from repro_torch.core import sortspec as tspec
    jcaps = jspec.get_backend("imc").capabilities
    tcaps = tspec.get_backend("imc").capabilities
    shared = {f.name for f in dataclasses.fields(tcaps)} \
        & {f.name for f in dataclasses.fields(jcaps)}
    assert {"dtypes", "stable", "supports_kv", "supports_topk",
            "supports_segments", "auto_dispatch", "substrate"} <= shared
    assert {k: getattr(tcaps, k) for k in shared} == \
        {k: getattr(jcaps, k) for k in shared}
    assert tcaps.substrate == "sram" and not tcaps.auto_dispatch
    assert "imc" not in tspec.NOT_PORTED


# ---------------------------------------------------------------------------
# the v1 shims and the paper's unit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form,jmethod,descending", [
    (f, m, d) for f, m in (("sort", "xla"), ("sort", "imc"),
                           ("sort", "bitonic"), ("argsort", "xla"),
                           ("argsort", "imc"))
    for d in (False, True)] + [("topk", "xla", True),
                               ("topk", "pallas", True)])
def test_sort_api_shims_forward_bit_exact(form, jmethod, descending):
    import repro_torch
    tmethod = repro_torch.BACKEND_NAMES[jmethod]
    x = _imc_keys("int16", 64, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if form == "topk":
            want = japi.topk(jnp.asarray(x), 5, method=jmethod)
            got = tapi.topk(to_torch(x), 5, method=tmethod, device="cpu")
            for w, g in zip(want, got):
                assert_same(w, g)
            return
        want = getattr(japi, form)(jnp.asarray(x), method=jmethod,
                                   descending=descending)
        got = getattr(tapi, form)(to_torch(x), method=tmethod,
                                  descending=descending, device="cpu")
    assert_same(want, got)


def test_sort_api_warns_once_per_form(monkeypatch):
    monkeypatch.setattr(tapi, "_warned", set())
    x = torch.tensor([3, 1, 2, 0], dtype=torch.int8)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(3):
            tapi.sort(x, device="cpu")
            tapi.argsort(x, device="cpu")
            tapi.topk(x, 2, device="cpu")
            tapi.top_p_mask(x.float(), 0.5, device="cpu")
    dep = [str(w.message) for w in rec
           if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 3, dep
    assert {m.split(" ")[0] for m in dep} == {
        f"repro_torch.core.sort_api.{f}" for f in ("sort", "argsort", "topk")}
    assert tapi.METHODS == tuple(
        {"xla": "torch", "pallas": "cuda"}.get(m, m) for m in japi.METHODS)


@pytest.mark.parametrize("p", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("axis", [-1, 0])
def test_top_p_mask_matches_reference(p, axis):
    """Equal masks where every row's exclusive cumulative mass stays at
    least 1e-5 from ``p``: the two softmaxes and cumsums round in other
    orders (float32, ~1e-7 here), so closer than that the kept count could
    differ by one.  The inputs are checked against that bound first."""
    rng = np.random.default_rng(int(p * 10) + axis)
    logits = (rng.standard_normal((6, 96)) * 2).astype(np.float32)
    probs = np.exp(np.moveaxis(logits, axis, -1).astype(np.float64))
    probs /= probs.sum(-1, keepdims=True)
    s = -np.sort(-probs, axis=-1)
    excl = np.cumsum(s, axis=-1) - s
    assert np.abs(excl - p).min() >= 1e-5
    want = japi.top_p_mask(jnp.asarray(logits), p, axis=axis)
    got = tapi.top_p_mask(to_torch(logits), p, axis=axis, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_paper_unit_config():
    from repro.configs.adsimc_paper import PAPER_UNIT as JUNIT
    from repro_torch.configs.adsimc_paper import PAPER_UNIT, SortUnitConfig
    assert dataclasses.asdict(PAPER_UNIT) == dataclasses.asdict(JUNIT) == \
        {"n_inputs": 8, "width": 4, "method": "imc"}
    assert isinstance(PAPER_UNIT, SortUnitConfig)
    x = np.random.default_rng(0).integers(
        0, 1 << PAPER_UNIT.width, (4, PAPER_UNIT.n_inputs)).astype(np.int8)
    got = tsort.sort(to_torch(x), method=PAPER_UNIT.method, device="cpu")
    assert_same(np.sort(x, axis=-1), got)
    assert tcm.sort_cycles(PAPER_UNIT.n_inputs, PAPER_UNIT.width) == 192
