"""Sorted shards and splitters that reach the edges of K3's bucket search
(``radix_bucket_hist`` searches a sorted shard for each splitter, 33-ary:
32 evenly spaced keys a round, then the last 32 or fewer at once).

Made with numpy from a seed, so the card tests (against the plain
version) and the CPU tests (against the JAX package) share them.
"""
import numpy as np

# (case, keys in the big cases)
CASES = ("n1", "n20", "n33", "n100", "all_equal", "below", "above",
         "repeated", "probe_edges", "s1022")


def probe_positions(n: int) -> np.ndarray:
    """The first round's 32 probes over n > 32 keys: n (i + 1) // 33."""
    return np.arange(1, 33, dtype=np.int64) * n // 33


def bucket_case(case: str, n: int, lo: int, hi: int, seed: int):
    """(ascending keys, ascending splitters), int64 within [lo, hi] (the
    carrier's range; lo <= -128 and hi >= 127), for ``case``; ``n`` keys
    in the cases that do not fix their own count."""
    rng = np.random.default_rng(seed)
    clip = lambda a: np.sort(np.clip(np.asarray(a, np.int64), lo, hi))  # noqa: E731

    def sorted_keys(m, a, b):
        return np.sort(rng.integers(a, b + 1, m)).astype(np.int64)

    if case == "n1":
        return np.array([5], np.int64), clip([lo, 4, 5, 5, 6, hi, hi])
    if case in ("n20", "n33", "n100"):
        k = sorted_keys(int(case[1:]), -30, 30)
        return k, clip(rng.integers(-35, 36, 7))
    if case == "all_equal":
        return np.full(n, 7, np.int64), clip([lo, 6, 7, 7, 7, 8, hi])
    if case == "below":
        return sorted_keys(n, 0, 50), clip(rng.integers(lo, 0, 7))
    if case == "above":
        return sorted_keys(n, -50, 0), clip(rng.integers(1, hi + 1, 7))
    if case == "repeated":
        k = sorted_keys(n, -100, 100)
        runs = rng.choice(k, 4, replace=False)
        return k, clip(np.repeat(runs, [3, 1, 2, 4]))
    if case == "probe_edges":
        # a run of ties ends at each first-round probe; a splitter on every
        # run's value and one just below it
        k = 2 * np.searchsorted(probe_positions(n), np.arange(n),
                                side="right").astype(np.int64) - 40
        vals = np.unique(k)
        return k, clip(np.concatenate([vals, vals - 1]))
    if case == "s1022":
        k = sorted_keys(n, lo, hi)
        return k, clip(rng.choice(k, 1022))
    raise ValueError(case)
