"""Fault-tolerance runtime: preemption handling, step watchdog, straggler
detection, and elastic-restart planning.

The port's copy of the JAX package's ``runtime/fault_tolerance.py``: plain
Python (clocks and signals), the same on the CPU and on a card.

  * PreemptionHandler — converts SIGTERM/SIGINT into a "save-and-exit"
    request the train loop polls once a step (the async checkpointer makes
    the final save cheap).
  * StepWatchdog — EWMA of step wall-times; flags steps slower than
    ``threshold`` x the moving average.
  * ElasticPlan — given the surviving device count, the largest usable
    (pod, data, model) mesh with the model axis intact, and the
    grad-accumulation that keeps the global batch: single-process
    arithmetic; ``launch.train`` restores a checkpoint whole and places it
    on whatever mesh its policy holds, so a plan's mesh can resume it.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, List, Optional, Tuple


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._old = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old.clear()

    def _handler(self, signum, frame) -> None:
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


@dataclasses.dataclass
class StepWatchdog:
    """EWMA step timer with straggler flagging."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup_steps: int = 5

    def __post_init__(self):
        self.ewma: Optional[float] = None
        self.count = 0
        self.flagged: List[Tuple[int, float, float]] = []
        self._t0: Optional[float] = None
        self.on_straggler: Optional[Callable[[int, float, float], None]] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
        is_straggler = (self.count > self.warmup_steps
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self.ewma)
        # slow steps should not poison the baseline
        w = self.alpha if not is_straggler else self.alpha * 0.25
        self.ewma = (1 - w) * self.ewma + w * dt
        return dt


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    usable_devices: int
    dropped_devices: int
    global_batch: int

    @staticmethod
    def plan(n_devices: int, model_parallel: int, global_batch: int,
             want_pods: int = 1) -> "ElasticPlan":
        """Largest (pod, data, model) mesh with the model axis intact.

        The model axis must survive (parameters are TP-sharded at a fixed
        degree); elasticity comes from the data axis.  The batch stays the
        GLOBAL batch — fewer devices just means more grad-accumulation
        (handled by the train loop), so the training trajectory is
        unchanged across restarts.
        """
        if n_devices < model_parallel:
            raise ValueError(
                f"cannot keep model_parallel={model_parallel} with only "
                f"{n_devices} devices")
        data = n_devices // model_parallel
        # keep data a power of two for collective efficiency
        while data & (data - 1):
            data -= 1
        usable = data * model_parallel
        if want_pods > 1 and data % want_pods == 0:
            shape = (want_pods, data // want_pods, model_parallel)
            names = ("pod", "data", "model")
        else:
            shape = (data, model_parallel)
            names = ("data", "model")
        return ElasticPlan(mesh_shape=shape, axis_names=names,
                           usable_devices=usable,
                           dropped_devices=n_devices - usable,
                           global_batch=global_batch)

    def microbatch_for(self, reference_devices: int,
                       reference_microbatch: int) -> int:
        """Scale grad-accumulation so per-device memory stays constant."""
        scale = max(1, reference_devices // self.usable_devices)
        return reference_microbatch * scale
