"""PyTorch + CUDA port of QED-Splatter (``qed_splatter_tpu`` is the JAX
reference it is checked against).

Module paths mirror the JAX package. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/`` (built with ``nvcc`` on first use, see :mod:`.cuda`), with its plain
PyTorch version beside the wrapper. Wrappers run the kernel on CUDA tensors
and the plain version on CPU tensors; nothing falls back silently.

Entry points take ``device="cuda"`` by default and raise when no GPU is
present unless the caller asks for ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises for
    CUDA on a machine without a usable GPU instead of drifting to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch path"
        )
    return dev

