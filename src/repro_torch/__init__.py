"""PyTorch / CUDA port of the Bayesian RNN serving stack (``repro``).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``serve/``,
``data/``, ``launch/``) module for module, so each file has a counterpart of
the same name in the JAX reference.  It imports ``torch`` and ``numpy`` and
never ``jax`` nor anything of ``repro``.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; without a GPU and without ``device="cpu"`` they raise —
nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says CPU.

    ``None`` means ``"cuda"``.  Asking for CUDA on a machine without a GPU
    raises instead of quietly serving from the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain-PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # Tensors report "cuda:N"; name the index so device checks compare.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
