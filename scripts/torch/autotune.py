"""Calibrate this machine's tuning profile for the PyTorch/CUDA port and
persist it.

A thin CLI over ``repro_torch.engine.planner.calibrate(persist=True)``:
probes every registered backend, sweeps the discrete knobs (radix digit
width on the card, run length, the spill tier's merge fan-in), fits the
cost constants, and writes the ``repro_torch.core.tuning`` profile as
JSON.  It runs on the card unless ``--device cpu`` is given; a profile is
keyed by the machine's fingerprint, so the CPU is measured only where
there is no card.

  PYTHONPATH=src python scripts/torch/autotune.py              # default grid
  ... --tile-n 512 --batch 8 --reps 1                          # tiny grid
  ... --out /tmp/profile.json --check                          # validate it
  ... --no-sweeps                                              # constants only
  ... --device cpu                                             # no card

Without ``--out`` the profile goes to the port's search path
(``$REPRO_TORCH_TUNING_DIR``, else ``~/.cache/repro_torch/profiles``),
where every later process of the port loads it.  ``--check`` reloads the
written file through ``tuning.load`` and checks its schema, its device
fingerprint and that its constants round-trip; it exits 1 on any
mismatch.
"""
from __future__ import annotations

import argparse
import pathlib
import sys


def check(path, prof) -> int:
    """0 if the profile file at ``path`` reloads with this machine's
    fingerprint and ``prof``'s constants, else 1 (the reason on
    stderr)."""
    from repro_torch.core import tuning
    try:
        loaded = tuning.load(path)
    except tuning.ProfileError as e:
        print(f"[autotune] CHECK FAILED: reload rejected: {e}",
              file=sys.stderr)
        return 1
    if loaded.fingerprint != tuning.device_fingerprint():
        print(f"[autotune] CHECK FAILED: fingerprint "
              f"{loaded.fingerprint!r} != device "
              f"{tuning.device_fingerprint()!r}", file=sys.stderr)
        return 1
    if loaded.constants != prof.constants:
        print("[autotune] CHECK FAILED: constants did not round-trip",
              file=sys.stderr)
        return 1
    print("[autotune] check OK: profile reloads with matching "
          "fingerprint and constants")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile-n", type=int, default=2048,
                    help="probe tile length (power of two)")
    ap.add_argument("--batch", type=int, default=64,
                    help="probe batch rows")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per probe")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="profile path (default: tuning search path)")
    ap.add_argument("--no-sweeps", action="store_true",
                    help="fit cost constants only, keep default knobs")
    ap.add_argument("--include-kernels", action="store_true",
                    help="time the kernel backends off the card too (their "
                         "plain versions; slow, and they say nothing of "
                         "the kernels)")
    ap.add_argument("--check", action="store_true",
                    help="reload the written profile and verify schema, "
                         "device fingerprint and constants")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (a machine without a card)")
    args = ap.parse_args(argv)

    from repro_torch.core import tuning
    from repro_torch.engine import planner

    prof = planner.calibrate(
        tile_n=args.tile_n, batch=args.batch, reps=args.reps,
        include_kernels=True if args.include_kernels else None,
        sweep_params=not args.no_sweeps, persist=True, path=args.out,
        device=args.device)

    path = (pathlib.Path(args.out) if args.out
            else tuning.profile_path(fingerprint=prof.fingerprint))
    print(f"[autotune] fingerprint   {prof.fingerprint}")
    print(f"[autotune] digit_bits    {prof.digit_bits}")
    print(f"[autotune] run_len       {prof.run_len}")
    print(f"[autotune] capacity_slack {prof.capacity_slack}")
    print(f"[autotune] select_min_n  {prof.select_min_n}")
    print(f"[autotune] wrote {path}")
    return check(path, prof) if args.check else 0


if __name__ == "__main__":
    sys.exit(main())
