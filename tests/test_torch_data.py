"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's ``repro.data.pipeline``: batches bit for bit (the generation is
the same numpy code from the same seeds), fingerprints equal, and the
dedup keep-masks equal, the crafted fingerprint collision of the
reference's ``tests/test_data.py`` included, through the port's
``relational.unique`` and spill tier on the CPU.  Everything here is
exact: no tolerance.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


def _cfgs(**kw):
    base = dict(vocab_size=512, seq_len=48, global_batch=8, seed=7)
    base.update(kw)
    return jpipe.DataConfig(**base), tpipe.DataConfig(**base)


@pytest.mark.parametrize("kw", [{}, dict(vocab_size=163840, seq_len=64),
                                dict(seq_len=8, motif_len=4, seed=3)])
def test_batches_are_bit_equal(kw):
    jc, tc = _cfgs(**kw)
    j, t = jpipe.SyntheticLM(jc), tpipe.SyntheticLM(tc)
    np.testing.assert_array_equal(t.motifs, j.motifs)
    for step in (0, 1, 17):
        a, b = j.global_batch_at(step), t.global_batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(b[k], a[k])
        for shard in range(4):
            sa, sb = j.shard_at(step, shard, 4), t.shard_at(step, shard, 4)
            for k in sa:
                np.testing.assert_array_equal(sb[k], sa[k])


def test_shard_at_rejects_bad_layouts_as_the_reference():
    t = tpipe.SyntheticLM(_cfgs()[1])
    with pytest.raises(ValueError, match="global_batch=8.*n_shards=3"):
        t.shard_at(0, 0, 3)
    with pytest.raises(ValueError, match="shard index 4"):
        t.shard_at(0, 4, 4)


def test_iterate_with_dedup_matches_reference():
    jc, tc = _cfgs(seq_len=4, global_batch=32, vocab_size=4, seed=1,
                   motif_len=4, n_motifs=2)
    ji = jpipe.SyntheticLM(jc).iterate(start_step=2, dedup=True)
    ti = tpipe.SyntheticLM(tc).iterate(start_step=2, dedup=True,
                                       device="cpu")
    shrunk = False
    for _ in range(3):
        a, b = next(ji), next(ti)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
        shrunk |= a["tokens"].shape[0] < 32
    assert shrunk


def test_row_fingerprints_equal():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 163840, (64, 33)).astype(np.int32)
    np.testing.assert_array_equal(tpipe.row_fingerprints(t),
                                  jpipe.row_fingerprints(t))


def _colliding_rows():
    # [0, 1000003] and [1, 0] share the fingerprint 1000003
    return (np.array([0, 1000003], np.int32), np.array([1, 0], np.int32))


DEDUPS = {
    "dedup_rows": (jpipe.dedup_rows,
                   lambda t: tpipe.dedup_rows(t, device="cpu")),
    "dedup_rows_radix": (jpipe.dedup_rows,
                         lambda t: tpipe.dedup_rows(t, method="radix",
                                                    device="cpu")),
    "global_dedup": (lambda t: jpipe.global_dedup(t, chunk_bytes=1024),
                     lambda t: tpipe.global_dedup(t, chunk_bytes=1024,
                                                  device="cpu")),
    "global_dedup_radix": (
        lambda t: jpipe.global_dedup(t, chunk_bytes=1024),
        lambda t: tpipe.global_dedup(t, chunk_bytes=256, method="radix",
                                     device="cpu")),
}


@pytest.mark.parametrize("which", sorted(DEDUPS))
def test_dedup_keeps_both_rows_of_a_fingerprint_collision(which):
    ref, port = DEDUPS[which]
    a, b = _colliding_rows()
    tokens = np.stack([a, b, a, b, np.array([5, 6], np.int32)])
    want = ref(tokens)
    np.testing.assert_array_equal(want, [True, True, False, False, True])
    np.testing.assert_array_equal(port(tokens), want)


@pytest.mark.parametrize("which", sorted(DEDUPS))
def test_dedup_masks_match_reference_and_brute_force(which):
    ref, port = DEDUPS[which]
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, size=(300, 3)).astype(np.int32)
    seen, brute = set(), np.zeros(len(t), bool)
    for i, row in enumerate(map(tuple, t)):
        if row not in seen:
            brute[i] = True
            seen.add(row)
    np.testing.assert_array_equal(port(t), brute)
    np.testing.assert_array_equal(ref(t), brute)


def test_dedup_empty():
    empty = np.zeros((0, 4), np.int32)
    assert tpipe.dedup_rows(empty, device="cpu").shape == (0,)
    assert tpipe.global_dedup(empty, device="cpu").shape == (0,)


def test_to_device_keeps_dtypes_and_values():
    b = tpipe.SyntheticLM(_cfgs()[1]).global_batch_at(0)
    d = tpipe.to_device(b, "cpu")
    for k in b:
        assert d[k].dtype == torch.int32 and d[k].device.type == "cpu"
        np.testing.assert_array_equal(d[k].numpy(), b[k])
