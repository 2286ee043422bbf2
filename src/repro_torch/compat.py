"""Device selection and numeric settings shared by the port.

TF32 is switched off for float32 matrix products and convolutions: TF32
keeps about three decimal digits, and the port is held to the JAX
reference at float32 tolerances (2e-4 on the models, 1e-4 on the kernels).
PyTorch already defaults matmuls to full float32, but cuDNN convolutions
default to TF32, so both are pinned here rather than left to the default.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def have_cuda() -> bool:
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The card, or an error: the port never carries on on the CPU unasked."""
    if not have_cuda():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card (or raise); anything else is taken as given."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not have_cuda():
        return default_device()  # raises
    return device
