"""The comparison that decides ``correct``.

Images are compared in the 0-255 scale: the program's output (uint8, or a
float in [0, 1]) against the reference's float image before any rounding.
Each number below is computed over the sampled requests; a cell's file
names the ones it compares and each one's limit (``check.limits``), set from
the program's readings on many seeds and the control's, as ``PERF.md``
records them.

- ``rms``: the root mean square of the difference over every pixel;
- ``worst_image_rms``: the largest of each image's own root mean square,
  so that one image served wrong shows however many are sampled;
- ``p999_abs``: the 99.9th percentile of the absolute difference;
- ``max_abs``: the widest gap;
- ``mean_abs``: the mean absolute difference.
"""

from __future__ import annotations

import torch

NUMBERS = ("rms", "worst_image_rms", "p999_abs", "max_abs", "mean_abs")


def to_255(img: torch.Tensor) -> torch.Tensor:
    img = img.detach().cpu()
    return img.double() if img.dtype == torch.uint8 else img.double() * 255.0


def image_numbers(outputs: list[torch.Tensor], refs: list[torch.Tensor]) -> dict[str, float]:
    """Every number of ``NUMBERS`` over the pairs (each NHWC, one request)."""
    diffs = [to_255(o) - to_255(r) for o, r in zip(outputs, refs, strict=True)]
    per_image = torch.cat([d.flatten(1).pow(2).mean(1).sqrt() for d in diffs])
    flat = torch.cat([d.flatten() for d in diffs]).abs()
    k = max(1, int(round(0.999 * flat.numel())))
    return {"rms": float(flat.pow(2).mean().sqrt()), "worst_image_rms": float(per_image.max()),
            "p999_abs": float(flat.kthvalue(k).values), "max_abs": float(flat.max()),
            "mean_abs": float(flat.mean())}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> list[dict]:
    """Each limited number beside its limit, and whether it holds."""
    return [{"name": name, "value": numbers[name], "limit": float(limit), "ok": numbers[name] <= float(limit)}
            for name, limit in limits.items()]
