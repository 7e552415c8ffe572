#!/usr/bin/env python3
"""Where K6's time goes: variants of its bf16 wgmma kernel, built and
timed side by side on one CUDA card.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 scripts/k6_ablation.py [--heads 192,256] [variant ...]

``--heads`` keeps the rows of those head dims (default: every row of
``chip_smoke.K6_ROWS``); variants default to all of them.

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with a few
textual edits, compiled with the port's own ``nvcc`` flags into
``build/k6_ablation/`` and called through its C entry point.  Most drop a
part of the work, so their outputs are wrong by design and only timed:

  kernel          the kernel as it is (its output held to K6's limits)
  no_kv_loads     the producer issues no K/V loads (the barriers still run)
  no_softmax      the online softmax skipped (P is the raw scores)
  no_products     no wgmma issued: softmax, barriers and glue alone
  two_stages      a K/V ring of 2 stages at every H (correct output; the
                  kernel's own at H = 256)
  wait_in_fence   the V wait moved between wgmma.fence and the products
                  (correct output; ptxas then serialises every wgmma)
  mma_sync        bf16 at H = 16, 32, 192 and 256 on the first-version
                  mma.sync kernel, the route before the wgmma kernel took
                  these widths (correct output)
  tile_128        H = 16 / 32 on 128-key tiles in 3 stages and one CTA an
                  SM, as at H = 64 / 128 (correct output)
  one_cta         H = 16 / 32 on one CTA an SM (registers 40 / 232), the
                  64-key tiles and 4 stages kept (correct output)

One JSON line a (shape, variant): mean ms over 10 launches with the card
held back while the host queues them (``chip_smoke.kernel_ms``), K6's
rows beside SDPA, and the ptxas notes on serialised wgmma of each build.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "k6_ablation"

_QK = ("    Wgmma<T>::qk(s, sw_desc<R>(qa + off, 16, 8 * R),",
       "    if (qa == 0xffffffffu)\n"
       "    Wgmma<T>::qk(s, sw_desc<R>(qa + off, 16, 8 * R),")
_PV = ("    Wgmma<T>::pv(acc, pa[kk],",
       "    if (va == 0xffffffffu)\n    Wgmma<T>::pv(acc, pa[kk],")
_KTILE = "kKTile = H == 64 || H == 128 ? kKBlock : 64;"
_CTAS = "kCtas = H <= 32 ? 2 : 1;"
_STAGES = "kStages = H == 256 ? 2 : H <= 32 ? 4 : 3;"
_V_WAIT = "      mbar_wait(vfull0 + 8 * st, (c / kStages) & 1);\n"
_FENCE = ("      turn_wait(my_turn);\n      wgmma_fence();\n"
          "      issue_qk<T, H, kKTile>(s, qa, kv0 + nst * 2 * L::kKVBytes);\n")

VARIANTS = {
    "kernel": [],
    "no_kv_loads": [
        ("        mbar_expect_tx(full, L::kKVBytes);",
         "        mbar_expect_tx(full, 0);\n        if (false)"),
        ("        mbar_expect_tx(vfull, L::kKVBytes);",
         "        mbar_expect_tx(vfull, 0);\n        if (false)"),
    ],
    "no_softmax": [
        ("    auto softmax = [&](int k0) {\n",
         "    auto softmax = [&](int k0) {\n"
         "      if (k0 >= 0) { corr[0] = corr[1] = 1.f; return; }\n"),
    ],
    "no_products": [_QK, _PV],
    "two_stages": [(_STAGES, "kStages = 2;")],
    "wait_in_fence": [
        (_V_WAIT + _FENCE, _FENCE.replace(
            "      issue_qk", _V_WAIT + "      issue_qk", 1)),
    ],
    "mma_sync": [("template <int H>\nconstexpr bool kOnWgmma = true;",
                  "template <int H>\n"
                  "constexpr bool kOnWgmma = H == 64 || H == 128;")],
    "tile_128": [(_KTILE, "kKTile = H <= 128 ? kKBlock : 64;"),
                 (_CTAS, "kCtas = 1;"),
                 (_STAGES, "kStages = H == 256 ? 2 : 3;")],
    "one_cta": [(_CTAS, "kCtas = 1;")],
}
CORRECT = ("kernel", "two_stages", "wait_in_fence", "mma_sync", "tile_128",
           "one_cta")


def variant_source(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant edit no longer matches the "
                               f"source: {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


def build(names):
    """Compile every variant at once; {name: (library, serialised notes)}."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(VARIANTS[name]))
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
             "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.flash_attention_fwd.argtypes = [i, i, vp, vp, vp, vp, ll, i, i,
                                            i, i, i, i, f, vp]
        lib.flash_attention_fwd.restype = i
        libs[name] = (lib, sum("serialized" in ln for ln in log.splitlines()))
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("k6_ablation: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    heads = None
    if args[:1] == ["--heads"]:
        heads = {int(h) for h in args[1].split(",")}
        args = args[2:]
    names = args or list(VARIANTS)
    rows = [(bs, nrh) for bs, nrh in cs.K6_ROWS
            if heads is None or nrh[2] in heads]
    libs = build(names)
    print(cs.card(), flush=True)

    def run(lib, q, k, v):
        out = torch.empty_like(q)
        rq, s, h = q.shape
        status = lib.flash_attention_fwd(
            1, h, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            rq, s, k.shape[1], rq // k.shape[0], 0, 1, 0, 1.0 / math.sqrt(h),
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"launch failed: cudaError_t {status}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for (b, s), (n, r, h) in rows:
        q, k, v = cs.attn_rows(gen, b * r, n // r, s, s, h, torch.bfloat16)
        q4, k4, v4 = (x.view(b, -1, s, h) for x in (q, k, v))
        sdpa = cs.kernel_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), 10)[0]
        want = fa.flash_rows_plain(q, k, v)
        for name in names:
            lib, serialised = libs[name]
            got = run(lib, q, k, v)
            err = None
            if name in CORRECT:
                err = cs.attn_within(got, want, f"K6 {name}")
            del got
            ms = cs.kernel_ms(lambda: run(lib, q, k, v), 10)[0]
            print(json.dumps({"shape": [b, s, n, r, h], "variant": name,
                              "ms": ms, "sdpa_ms": sdpa,
                              "serialised_notes": serialised,
                              "max_abs_and_row_rel_err": err}), flush=True)
        del q, k, v, q4, k4, v4, want
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
