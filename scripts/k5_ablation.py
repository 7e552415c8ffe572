#!/usr/bin/env python3
"""K5's design choices, measured: variants of its one-pass top-k source
built and timed side by side on one CUDA card.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 scripts/k5_ablation.py

Each variant is ``src/repro_torch/csrc/bitonic_topk.cu`` with a textual
edit, compiled with the port's own ``nvcc`` flags into
``build/k5_ablation/`` and called through the port's wrapper
(``bitonic_topk.topk_rows``, its library handle swapped in):

  kernel        the source as it is
  step_16       the stream kernel takes 16 keys a lane a step at every k
                (the source takes 32 at k <= 64: twice the bytes in flight)
  no_seed       no first bound from each lane's best pairs of the first
                step: the bound starts at nothing and rises only as the
                warps' runs fill
  no_prefilter  no step or key slot is skipped on the bound's key: every
                key is packed and compared as a 64-bit composite
  short_8_keys  the short kernel with 8 keys a lane (8 lanes a row of 64,
                twice the warps) in place of 16

Every output is held bit for bit against the plain version
(``topk_rows_plain``).  One JSON line a (variant, shape): the mean ms of
the whole call over 20 calls with the card held back while the host
queues them (``chip_smoke.kernel_ms``), run in the order kernel, variant,
variant, kernel; at the MoE routing rows (16384, 64) k = 8 (the short
kernel), the vocabulary rows (64, 128256) k = 50, the serve's sampling
rows (8, 256000) k = 50 and one row of 2^24 k = 64 (the stream kernel and
its merge launch), the last three also ascending (every key admitted).
Then, for the source, the stream launch alone and the merge launch alone
over the same partial runs at merge CTAs of 4, 8 and 16 warps.
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
OUT = ROOT / "build" / "k5_ablation"

# name -> (textual edits, which kernel the variant changes)
VARIANTS = {
    "kernel": ([], None),
    "step_16": ([("return R <= 2 && !std::is_same<S, uint32_t>::value ? 32 "
                  ": 16;", "return 16;")], "stream"),
    "no_seed": ([("if (lane == 0 && kth > 1) s_bound = kth - 1;",
                  "if (false) s_bound = kth - 1;"),
                 ("if (kth > 1) ws.raise(kth - 1);",
                  "if (false) ws.raise(kth - 1);")], "stream"),
    "no_prefilter": ([("if (__any_sync(kFull, any)) {", "if (true) {"),
                      ("if (__any_sync(kFull, vi < nvec && "
                       "ws.may_pass(key)))", "if (true)")], "stream"),
    "short_8_keys": ([("constexpr int kShortKeys = 16;",
                       "constexpr int kShortKeys = 8;"),
                      ("return launch_short<TR, 16>(kin, kout, iout, rows, "
                       "n, k, log_p, s);",
                       "return launch_short<TR, 8>(kin, kout, iout, rows, n, "
                       "k, log_p, s);")], "short"),
}


def build(variants) -> dict:
    """Compile every variant at once (one ``nvcc`` each): name -> library
    path; raises if one fails, or if a float32 kernel spills."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, OUT / f.name)
    jobs = {}
    for name, (edits, _) in variants.items():
        text = (CSRC / "bitonic_topk.cu").read_text()
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
        entry, spills = "", []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln
            elif "spill" in ln and " 0 bytes spill stores" not in ln \
                    and "KF32" in entry:
                spills.append(entry)
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
    from repro_torch.kernels import bitonic_topk as btk
    if not torch.cuda.is_available():
        print("k5_ablation: no CUDA device", file=sys.stderr)
        return 2
    emit({"card": card()})
    libs = {}
    for name, path in build(VARIANTS).items():
        load = _build.load
        _build.load = lambda _name, _p=path: ctypes.CDLL(str(_p))
        try:
            btk._lib_handle = None
            libs[name] = btk._lib()
        finally:
            _build.load = load
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = (((16384, 64), 8), ((64, 128256), 50), ((8, 256000), 50),
              ((1, 1 << 24), 64))
    for (rows, n), k in shapes:
        x = torch.randn((rows, n), generator=gen, device="cuda")
        up = torch.arange(n, dtype=torch.float32, device="cuda") \
            .expand(rows, n).contiguous()
        route = btk.plan(rows, n, k).route
        for order, keys in (("random", x), ("ascending", up)):
            if route == "short" and order == "ascending":
                continue
            want = btk.topk_rows_plain(keys, k)
            for name, (_, kernel) in VARIANTS.items():
                if kernel != route:
                    continue
                plan = btk.RowPlan("short", lanes=8) \
                    if name == "short_8_keys" else None
                res = {"kernel": [], name: []}
                for turn in ("kernel", name, name, "kernel"):
                    btk._lib_handle = libs[turn]
                    p = plan if turn == name else None
                    for g, w in zip(btk.topk_rows(keys, k, p), want):
                        same_bits(g, w, f"{turn} {rows}x{n} {order}")
                    res[turn].append(kernel_ms(
                        lambda: btk.topk_rows(keys, k, p), 20)[0])
                emit({"variant": name, "shape": [rows, n], "k": k,
                      "order": order, **res})
        p = btk.plan(rows, n, k)
        if p.ctas > 1:
            # the source's two launches apart, on one partial buffer
            btk._lib_handle = libs["kernel"]
            lib, ptr = libs["kernel"], _build.ptr
            part = torch.empty((rows, p.ctas, btk.run_len(k)),
                               dtype=torch.int64, device="cuda")
            v = torch.empty((rows, k), device="cuda")
            i = torch.empty((rows, k), dtype=torch.int32, device="cuda")
            stream = _build.stream_of(x)

            def launch_stream():
                _build.check(lib.topk_rows_stream(
                    0, ptr(x), ptr(v), ptr(i), ptr(part), rows, n, k,
                    p.stripe, p.warps_per_row, p.ctas, stream), "stream")

            def launch_merge(warps):
                _build.check(lib.topk_rows_merge(
                    0, ptr(part), ptr(v), ptr(i), rows, p.ctas, warps, k,
                    stream), "merge")
            launch_stream()
            res = {"stream_ms": kernel_ms(launch_stream, 20)[0]}
            for warps in (4, 8, 16):
                if warps <= p.ctas:
                    launch_merge(warps)
                    same_bits(i, btk.topk_rows_plain(x, k)[1],
                              f"merge {warps} warps")
                    res[f"merge_ms_{warps}_warps"] = kernel_ms(
                        lambda: launch_merge(warps), 20)[0]
            emit({"launches_apart": [rows, n], "k": k, "ctas": p.ctas, **res})
            del part, v, i
        del x, up
    btk._lib_handle = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
