"""repro_torch — the ADS-IMC sort engine on PyTorch and hand-written CUDA.

The port of the JAX package ``repro``, module by module.  It imports
``torch`` and never ``jax`` or ``repro``.

Backend names (the one mapping; the parity tests read it from here):

    JAX ``repro``     ``repro_torch``
    -------------     -----------------------------------------------------
    ``xla``           ``torch``    ``torch.sort(stable=True)`` reference
    ``pallas``        ``cuda``     hand-written whole-row bitonic kernel
    ``bitonic``       ``bitonic``  the network in plain PyTorch ops
    ``merge``         ``merge``    runs + merge tree (merge-path kernel)
    ``radix``         ``radix``    LSD radix kernels over encoded keys
    ``imc``           ``imc``      the 28-cycle gate program; on a card one
                                   K7 launch per network stage

``Plan.run_method``/``Plan.merge_backend`` take ``"torch"``/``"cuda"`` where
the JAX package has ``"xla"``/``"pallas"``.

Device rule: every public entry point (``repro_torch.sort.*``,
``repro_torch.engine.*``) takes ``device=`` (default ``"cuda"``), moves its
input there and returns on it.  ``device="cuda"`` without a card raises
``RuntimeError``.  A kernel wrapper given a CPU tensor runs its plain
PyTorch version; given a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

BACKEND_NAMES = {"xla": "torch", "pallas": "cuda", "bitonic": "bitonic",
                 "merge": "merge", "radix": "radix", "imc": "imc"}
