"""PyTorch/CUDA port of ``tf_operator_tpu``'s compute path.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``serve/``) so each module has a counterpart of the same name there. It
imports torch and numpy only: nothing of JAX and nothing of the JAX
package. What it needs from that package's jax-free modules (the block
allocators, the prefix cache) it keeps as its own copies.

Every public entry point takes an explicit ``device``. ``None`` means
the CUDA card, and resolving it raises when no CUDA device is present;
the CPU is used only when a caller asks for it (the tests do), and then
each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``. A CUDA
    device raises ``RuntimeError`` when torch sees no card, rather than
    quietly running on the CPU."""
    # Imported here so that importing the package stays light: an entry
    # point installs its signal handler before torch loads.
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
