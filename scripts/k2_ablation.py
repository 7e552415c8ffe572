#!/usr/bin/env python3
"""K2's design choices, measured: variants of its merge-path source built
and timed side by side on one CUDA card.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 scripts/k2_ablation.py

Each variant is ``src/repro_torch/csrc/merge_path.cu`` with a textual
edit, compiled with the port's own ``nvcc`` flags into
``build/k2_ablation/`` and called through the port's wrappers (its
library handle swapped in):

  kernel        the source as it is: the partition launch (a binary search
                a tile boundary, one thread each) and the merge, two
                stages of windows in flight a CTA
  warp_search   the partition by a warp-cooperative search instead: one
                warp a boundary, 32 probes a round (6 rounds at L = 2^27,
                3 at 4096), the other option for K2's cut search
  three_stages  three stages of windows in flight a CTA instead of two
  tile_8192     CTAs of 512 threads: tiles of 8192 outputs, half the
                boundaries (one CTA an SM key-value, two key-only)
  tile_2048     8 outputs a thread: tiles of 2048 outputs

Every variant's output is held bit for bit against the plain version
(``rank_merge``, ``partition_plain``).  One JSON line a (variant, shape):
the mean ms of the whole wrapper (partition + merge) and of the partition
launch alone over 20 launches, with the card held back while the host
queues them (``chip_smoke.kernel_ms``), run in the order kernel, variant,
variant, kernel; at the first and the last merge level of the 2^28
float32 sort (key-only) and of the 2^26 int32 argsort (key-value), both
directions.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "k2_ablation"

# the warp-cooperative partition kernel, in place of the body of
# merge_partition_kernel: the largest i in [lo, hi] with a[i-1] before
# b[d-i] (or i == lo), a lane a probe, the highest true lane bounding the
# next round (the predicate is monotone in i)
_WARP_SEARCH = '''
  const long long w = i >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_cuts) return;
  const long long row = w / (tpr + 1);
  const int t = static_cast<int>(w - row * (tpr + 1));
  const int d = static_cast<int>(
      min(static_cast<long long>(t) * kTile, 2LL * L));
  const typename TR::S* ar = a + row * sa;
  const typename TR::S* br = b + row * sb;
  int lo = max(0, d - L), hi = min(d, L);
  while (lo < hi) {
    const long long span = hi - lo;
    const int m = lo + static_cast<int>(((lane + 1) * span + 31) / 32);
    const unsigned yes = __ballot_sync(
        0xffffffffu, a_first<TR, DESC>(ar[m - 1], br[d - m]));
    const int k = 31 - __clz(yes);
    const int mk = k >= 0 ? lo + static_cast<int>(((k + 1) * span + 31) / 32)
                          : lo;
    hi = k < 31 ? lo + static_cast<int>(((k + 2) * span + 31) / 32) - 1 : hi;
    lo = mk;
  }
  if (lane == 0) cuts[w] = lo;
}
'''

_PARTITION_BODY = '''  if (i >= n_cuts) return;
  const long long row = i / (tpr + 1);
  const int t = static_cast<int>(i - row * (tpr + 1));
  const int d = static_cast<int>(
      min(static_cast<long long>(t) * kTile, 2LL * L));
  cuts[i] = diag_search<TR, DESC>(a + row * sa, b + row * sb, L, L, d);
}
'''
_PARTITION_GRID = (
    "  const long long grid = (n_cuts + kThreads - 1) / kThreads;",
    "  const long long grid = (32 * n_cuts + kThreads - 1) / kThreads;")

# name -> (edits of the source, its tile in outputs)
VARIANTS = {
    "kernel": ([], 4096),
    "warp_search": ([(_PARTITION_BODY, _WARP_SEARCH), _PARTITION_GRID],
                    4096),
    "three_stages": ([("constexpr int kStages = 2;",
                       "constexpr int kStages = 3;")], 4096),
    "tile_8192": ([("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;"),
                   ("return KV ? (sizeof(S) == 2 ? 2 : 3) : 4;",
                    "return KV ? 1 : 2;")], 8192),
    "tile_2048": ([("constexpr int kItems = 16;",
                    "constexpr int kItems = 8;")], 2048),
}


def build(variants) -> dict:
    """Compile every variant at once (one ``nvcc`` each): name -> library
    path; raises if one fails or spills."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, OUT / f.name)
    jobs = {}
    for name, (edits, _) in variants.items():
        text = (CSRC / "merge_path.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: edit target not in the source: "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        src.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, errors = {}, []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        if proc.returncode != 0 or spills:
            errors.append(f"{name}: exit {proc.returncode}, spills "
                          f"{spills[:3]}\n{log[-2000:]}")
        libs[name] = lib
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def main() -> int:
    import torch
    from chip_smoke import card, emit, kernel_ms, same_bits
    from repro_torch.kernels import _build
    from repro_torch.kernels import merge_path as mp
    if not torch.cuda.is_available():
        print("k2_ablation: no CUDA device", file=sys.stderr)
        return 2
    emit({"card": card()})
    libs = {}
    for name, path in build(VARIANTS).items():
        load = _build.load
        _build.load = lambda _name, _p=path: ctypes.CDLL(str(_p))
        try:
            mp._lib_handle = None
            libs[name] = mp._lib()
        finally:
            _build.load = load
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kv, total in ((False, 1 << 28), (True, 1 << 26)):
        for level, l in (("first", 4096), ("last", total // 2)):
            for desc in (False, True):
                shape = (total // (2 * l), 2, l)
                pairs = torch.randint(0, 4096, shape, generator=gen,
                                      device="cuda", dtype=torch.int32) \
                    if kv else torch.randn(shape, generator=gen,
                                           device="cuda")
                pairs = torch.sort(pairs, dim=-1, descending=desc).values
                a, b = pairs[:, 0, :], pairs[:, 1, :]
                va = torch.arange(l, dtype=torch.int32, device="cuda") \
                    .expand(a.shape).contiguous()
                vb = va + l
                if kv:
                    merge = lambda: mp.merge_pairs_kv_blocks(  # noqa: E731
                        a, b, va, vb, descending=desc)
                    want = mp.rank_merge(a, b, va, vb, descending=desc)
                else:
                    merge = lambda: (mp.merge_pairs_blocks(  # noqa: E731
                        a, b, descending=desc),)
                    want = mp.rank_merge(a, b, descending=desc)[:1]
                part = lambda: mp.merge_path_partition(  # noqa: E731
                    a, b, descending=desc)
                for name in VARIANTS:
                    if name == "kernel":
                        continue
                    res = {"kernel": [], name: []}
                    for turn in ("kernel", name, name, "kernel"):
                        mp._lib_handle = libs[turn]
                        mp.KERNEL_TILE = VARIANTS[turn][1]
                        for g, w in zip(merge(), want):
                            same_bits(g, w, f"{turn} {level} kv={kv}")
                        same_bits(part(), mp.partition_plain(
                            a, b, descending=desc), f"{turn} partition")
                        res[turn].append({"ms": kernel_ms(merge, 20)[0],
                                          "partition_ms":
                                          kernel_ms(part, 20)[0]})
                    emit({"variant": name, "kv": kv, "level": level,
                          "descending": desc, "shape": list(shape), **res})
                del pairs, a, b, va, vb, want
    mp._lib_handle = None
    mp.KERNEL_TILE = VARIANTS["kernel"][1]
    return 0


if __name__ == "__main__":
    sys.exit(main())
