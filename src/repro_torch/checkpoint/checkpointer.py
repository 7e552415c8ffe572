"""Async, atomic checkpointing of trees of tensors.

The port of the JAX package's ``checkpoint/checkpointer.py`` on one
device, with its on-disk layout:

  * one ``.npy`` per tree leaf under ``step_XXXXXXXX/``, named by the
    leaf's path as ``jax.tree_util.keystr`` prints it (``repro_torch.tree``
    visits leaves in the reference's order), plus ``manifest.json`` (step,
    structure, each leaf's shape and dtype, the caller's ``extra``).
    bfloat16 leaves are stored as their raw uint16 bits with dtype
    ``"bfloat16"`` in the manifest, as the reference stores them;
  * atomicity: everything is written into ``step_XXXXXXXX.tmp`` and renamed
    at the end, so a preempted save never corrupts the latest checkpoint;
  * async: ``save()`` copies the tree to host memory synchronously and
    writes the files on a daemon thread; ``wait()`` joins it (and raises
    what the write raised);
  * retention: the newest ``keep`` checkpoints stay.

``restore`` loads onto a given device, or onto each leaf's device in the
tree it is given.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype name)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"leaf stored as {a.dtype}, manifest says {dtype}")
    return torch.from_numpy(a.copy())


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` (nested dicts/lists of tensors) at ``step``."""
        self.wait()
        host = {}
        dtypes = {}
        for k, leaf in _tree.leaves_with_path(tree):
            host[k], dtypes[k] = _to_host(leaf)
        manifest = {
            "step": int(step),
            "treedef": repr(_tree.map(lambda _: "*", tree)),
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
        }

        def _write():
            try:
                final = self.dir / f"step_{step:08d}"
                tmp = self.dir / f"step_{step:08d}.tmp"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for k, v in host.items():
                    np.save(tmp / (self._fname(k) + ".npy"), v)
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}")

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, like_tree, device=None) -> Tuple[Any, dict]:
        """Restore into the structure of ``like_tree`` -> (tree, extra).
        Each leaf lands on ``device``, or where ``like_tree``'s leaf lies;
        a shape that differs from ``like_tree``'s raises ``ValueError``."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        out = []
        for k, leaf in _tree.leaves_with_path(like_tree):
            arr = np.load(d / (self._fname(k) + ".npy"))
            t = _from_host(arr, manifest["leaves"][k]["dtype"])
            want = getattr(leaf, "shape", None)
            if want is not None and tuple(t.shape) != tuple(want):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(t.shape)} vs {tuple(want)}")
            dev = device if device is not None else getattr(leaf, "device",
                                                            "cpu")
            out.append(t.to(dev))
        return _tree.unflatten(like_tree, out), manifest["extra"]

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _fname(key: str) -> str:
        return re.sub(r"[^A-Za-z0-9_.-]", "_", key)[:180]

    def _gc(self) -> None:
        steps = sorted(p for p in self.dir.glob("step_*")
                       if re.fullmatch(r"step_\d+", p.name))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
