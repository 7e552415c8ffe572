"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries land in
``<repo>/build/kernels/`` under a name that carries a hash of the source,
so an edited source is rebuilt and a stale library is never loaded;
``ptxas -v``'s report of each build is kept beside its library
(:func:`ptxas_usage` reads it; :func:`sass` lists the machine code).
The first use builds; :func:`build_all` starts one ``nvcc`` per source at
once so a cold process pays for the slowest file, not the sum.

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

import torch

SOURCES = ("bitonic_sort", "merge_path", "radix_sort", "radix_select",
           "bitonic_topk", "bitserial_cas", "flash_attention")

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# src/repro_torch/kernels/_build.py -> <repo>/build/kernels
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype -> code of csrc/keys.cuh's KEY_DISPATCH
KEY_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
    torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.uint16: 6,
    torch.int32: 7, torch.uint32: 8,
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

# launches per kernel wrapper: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels it went through
launches: Dict[str, int] = {}
# while a CUDA graph is captured (``capture_tally``) a wrapper's launch is
# recorded into the graph's tally instead: nothing runs at capture, and
# each replay adds the tally (``count_replay``)
_tally: Optional[Dict[str, int]] = None


def count_launch(name: str) -> None:
    counts = launches if _tally is None else _tally
    counts[name] = counts.get(name, 0) + 1


def reset_launches() -> None:
    launches.clear()


@contextlib.contextmanager
def capture_tally():
    """Record the launches of the wrappers called in this block into a
    fresh tally (yielded) instead of ``launches``: the block captures a
    CUDA graph, whose kernels run only when it is replayed."""
    global _tally
    prev, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = prev


def count_replay(tally: Dict[str, int]) -> None:
    """Add one replay of a captured graph's ``tally`` to ``launches``."""
    for name, n in tally.items():
        launches[name] = launches.get(name, 0) + n


def capturing() -> bool:
    """Is a CUDA graph being captured on the current stream?"""
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are compiled on first use on a machine with the CUDA "
            "toolkit")
    return found


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source into a temporary file; None if the
    library for this exact source already exists."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)        # atomic: a concurrent loader sees all or none


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes running at once; raises on the first failure after
    every process has ended."""
    names = list(names)
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        errors = []
        for n, job in jobs:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def ptxas_usage(name: str) -> List[dict]:
    """What ``ptxas -v`` said of each kernel of ``csrc/<name>.cu`` when it
    was built: its (demangled) name, registers, stack frame and spill
    bytes.  Builds the library if needed."""
    build_all([name])
    log = _lib_path(name).with_suffix(".log").read_text()
    usage: List[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            usage.append({"kernel": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and usage:
            usage[-1].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and usage:
            usage[-1]["registers"] = int(m.group(1))
    filt = pathlib.Path(_nvcc()).with_name("cu++filt")
    if usage and filt.is_file():
        names = subprocess.run([str(filt)], input="\n".join(
            u["kernel"] for u in usage), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for u, readable in zip(usage, names):
            u["kernel"] = readable
    return usage


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the library of ``csrc/<name>.cu``: the
    machine code of each of its kernels.  Builds the library if needed."""
    build_all([name])
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s card, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")
