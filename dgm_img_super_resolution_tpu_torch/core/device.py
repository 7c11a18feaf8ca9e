"""Device and dtype policy of the port.

Entry points run on ``cuda`` unless the caller asks for another device; with
no CUDA device and no device asked for they raise instead of carrying on
quietly on the CPU. Under a ``torch.distributed`` process group the card
is the rank's own, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import subprocess

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


def card_description(device: torch.device) -> str:
    """What a measurement on ``device`` is reported beside: a card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (a card may be held below its
    maximum power, and then runs slower), else the device type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def compute_dtype(hp) -> torch.dtype:
    """The activation dtype named by ``hp['compute_dtype']``."""
    name = hp.get("compute_dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"compute_dtype {name!r} not supported by the port: {sorted(DTYPES)}")
    return DTYPES[name]
