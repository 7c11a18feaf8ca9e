"""The trainer's checkpoint store (counterpart of the JAX package's
``ckpt/orbax_io.py``), with the reference's names, retention and schema
(``model.py:1405-1496``).

A checkpoint is one ``torch.save`` file ``<work_dir>/model_ckpt_steps_<N>.ckpt``
holding ``{"global_step": N, "state_dict": {"model": ...}, "optimizer_states":
[...]}`` (plus ``"ema"`` when the trainer keeps one): the reference's own
schema, which ``ckpt/torch_import.py`` and ``SRDiffPipeline(ckpt_path=...)``
read. Where the JAX package writes an Orbax directory
``model_ckpt_steps_<N>`` of a param pytree, the port writes that single
file of ``state_dict``s under the reference's names. A file is written
beside its final name and renamed into place, so a run cut mid-save leaves
the last whole checkpoint newest. Files come from the trainer itself, so
they load as full pickles (``weights_only=False``).
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch
import torch.nn as nn

_CKPT_RE = re.compile(r"model_ckpt_steps_(\d+)\.ckpt$")


def ckpt_path(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")


def get_all_ckpts(work_dir: str, steps: int | None = None) -> list[str]:
    """Checkpoint files sorted by step, newest first."""
    if steps is not None:
        return [ckpt_path(work_dir, steps)]
    if not os.path.isdir(work_dir):
        return []
    found = [(int(m.group(1)), os.path.join(work_dir, n)) for n in os.listdir(work_dir)
             if (m := _CKPT_RE.match(n))]
    return [p for _, p in sorted(found, reverse=True)]


def _read(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (OSError, RuntimeError, EOFError):
        return None


def get_last_checkpoint(work_dir: str, steps: int | None = None) -> tuple[Any, str | None]:
    """(the newest readable checkpoint, its path), or (None, None)."""
    for path in get_all_ckpts(work_dir, steps):
        ckpt = _read(path)
        if ckpt is not None:
            return ckpt, path
    return None, None


def save_checkpoint(state: dict, work_dir: str, global_step: int, num_ckpt_keep: int = 100) -> str:
    """Write ``state`` as step ``global_step`` and delete the checkpoints
    beyond the newest ``num_ckpt_keep`` (reference ``model.py:1439-1450``)."""
    os.makedirs(work_dir, exist_ok=True)
    path = ckpt_path(work_dir, global_step)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in get_all_ckpts(work_dir)[num_ckpt_keep:]:
        os.remove(old)
        print(f"| Delete ckpt: {os.path.basename(old)}")
    return path


def load_checkpoint(work_dir: str, steps: int | None = None) -> tuple[Any, int]:
    """The newest (or the step-``steps``) checkpoint -> ``(state, step)``;
    ``(None, 0)`` when there is none (a fresh run)."""
    ckpt, path = get_last_checkpoint(work_dir, steps)
    if ckpt is None:
        return None, 0
    return ckpt, int(_CKPT_RE.search(path).group(1))


def _source_state_dict(ckpt_base_dir: str, steps: int | None):
    """The flat state dict of a checkpoint file (the port's, or an upstream
    ``.ckpt/.pt/.pth``: the ``state_dict``/``model`` wrappers and the
    ``model.`` prefix unwrapped, the diffusion buffers dropped), or of the
    newest checkpoint of a work dir; None when there is none."""
    from dgm_img_super_resolution_tpu_torch.ckpt.torch_import import _SKIP_BUFFERS

    if os.path.isfile(ckpt_base_dir):
        ckpt = _read(ckpt_base_dir)
    else:
        ckpt, _ = get_last_checkpoint(ckpt_base_dir, steps)
    if ckpt is None:
        return None
    sd = ckpt.get("state_dict", ckpt)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    names = ((k.removeprefix("model."), v) for k, v in sd.items())
    return {k: torch.as_tensor(v) for k, v in names if not _SKIP_BUFFERS.match(k)}


def load_ckpt(module: nn.Module, ckpt_base_dir: str, model_name: str = "", force: bool = True,
              strict: bool = True, steps: int | None = None) -> nn.Module:
    """Merge a checkpoint's matching entries into ``module`` in place (the
    reference's ``load_ckpt``, ``model.py:1463-1496``): ``model_name``
    selects a sub-model's entries (e.g. ``"rrdb"``: the ``rrdb.*`` names,
    prefix dropped); under ``strict=False`` entries the checkpoint lacks
    keep their values and shape-mismatched ones are skipped. The source is
    a checkpoint file (the port's, or an upstream ``.ckpt/.pt/.pth``) or a
    work dir, whose newest checkpoint is read."""
    src = _source_state_dict(ckpt_base_dir, steps)
    if src is None:
        if force:
            raise FileNotFoundError(f"no checkpoint under {ckpt_base_dir!r}")
        return module
    if model_name:
        prefix = model_name.replace("/", ".") + "."
        src = {k[len(prefix):]: v for k, v in src.items() if k.startswith(prefix)}
        if not src and strict:
            raise KeyError(f"sub-model {model_name!r} not in checkpoint")
    merged, skipped = {}, []
    for name, v in module.state_dict().items():
        s = src.get(name)
        if s is None:
            if strict:
                raise KeyError(f"checkpoint missing param {name}")
            merged[name] = v
        elif tuple(s.shape) != tuple(v.shape):
            if strict:
                raise ValueError(f"shape mismatch at {name}: {tuple(s.shape)} vs {tuple(v.shape)}")
            skipped.append(name)
            merged[name] = v
        else:
            merged[name] = s
    if skipped:
        print(f"| load_ckpt: skipped {len(skipped)} shape-mismatched params (e.g. {skipped[:3]})")
    module.load_state_dict(merged, strict=True)
    return module
