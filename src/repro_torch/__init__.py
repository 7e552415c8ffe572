"""repro_torch — ADS-IMC on PyTorch and hand-written CUDA.

The port of the JAX package ``repro``, module by module.  It imports
``torch`` and never ``jax`` or ``repro``.  It carries the sort engine
(``sort``, ``engine``, ``core``), the paper's in-memory sorter (``core``'s
``sorter`` and the ``imc`` backend), and the serving path of one model
(``configs``, ``models``, ``launch``: minitron-4b, its prefill attention on
the flash-attention kernel).  Every TPU kernel of the JAX package has a
hand-written counterpart in ``csrc/`` beside its plain PyTorch version in
``kernels/``.

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
``repro_torch.engine.*``, ``models.build``, ``launch.serve.serve``) takes
``device=`` (default ``"cuda"``) and runs there; the sorts move their input
there and return on it.  ``device="cuda"`` without a card raises
``RuntimeError``.  A kernel wrapper given a CPU tensor runs its plain
PyTorch version; given a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

BACKEND_NAMES = {"xla": "torch", "pallas": "cuda", "bitonic": "bitonic",
                 "merge": "merge", "radix": "radix", "imc": "imc"}
