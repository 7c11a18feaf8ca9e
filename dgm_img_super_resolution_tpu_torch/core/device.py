"""Device and dtype policy of the port.

Entry points run on ``cuda`` unless the caller asks for another device; with
no CUDA device and no device asked for they raise instead of carrying on
quietly on the CPU. Under a ``torch.distributed`` process group the card
is the rank's own, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA device, or under a process group the
    rank's (``cuda:LOCAL_RANK``); raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            from dgm_img_super_resolution_tpu_torch.parallel.mesh import local_cuda_device

            return local_cuda_device()
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def compute_dtype(hp) -> torch.dtype:
    """The activation dtype named by ``hp['compute_dtype']``."""
    name = hp.get("compute_dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"compute_dtype {name!r} not supported by the port: {sorted(DTYPES)}")
    return DTYPES[name]
