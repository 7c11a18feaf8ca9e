"""Importer of the upstream SRDiff checkpoint and of torch LPIPS weights
(counterpart of the JAX package's ``ckpt/torch_import.py``).

The upstream ``model_ckpt_steps_400000.ckpt`` is a torch pickle whose
``state_dict["model"]`` holds the ``GaussianDiffusion`` weights under
``model.denoise_fn.*`` (the UNet) and ``model.rrdb.*`` (the encoder), with
the diffusion buffers (``betas``, ``alphas_cumprod``, ...) beside them. The
port's modules carry exactly those names, so importing is unwrapping,
dropping the buffers (the port recomputes them from the schedule) and a
strict ``load_state_dict`` in ``SRDiffPipeline``; no layout changes. For the
same reason the JAX package's ``export_srdiff_to_torch_keys`` has no
counterpart here: the port's ``GaussianDiffusion.state_dict()`` already is
the reference's key schema.

``convert_lpips_state_dict`` maps an ``lpips.LPIPS(net='alex')`` state
dict onto the port's LPIPS (``metrics/lpips.py``), checking the scaling
layer's constants.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_SKIP_BUFFERS = re.compile(
    r"^(betas|alphas_cumprod|alphas_cumprod_prev|sqrt_alphas_cumprod|"
    r"sqrt_one_minus_alphas_cumprod|log_one_minus_alphas_cumprod|"
    r"sqrt_recip_alphas_cumprod|sqrt_recipm1_alphas_cumprod|posterior_variance|"
    r"posterior_log_variance_clipped|posterior_mean_coef1|posterior_mean_coef2|"
    r"ssim_loss\..*)$"
)

# the upstream parameter names, the rules of the JAX importer's key table
_WB = r"\.(weight|bias)$"
_RESNET = r"(mlp\.1|block[12]\.block\.[12]|res_conv)"
_KNOWN = re.compile("|".join([
    r"^denoise_fn\.(cond_proj|mlp\.[02]|up_proj\.1|final_conv\.0\.block\.[12]|final_conv\.1)" + _WB,
    r"^denoise_fn\.(downs|ups)\.\d+\.[01]\." + _RESNET + _WB,
    r"^denoise_fn\.downs\.\d+\.2\.conv\.1" + _WB,
    r"^denoise_fn\.ups\.\d+\.2\.conv\.0" + _WB,
    r"^denoise_fn\.mid_block[12]\." + _RESNET + _WB,
    r"^denoise_fn\.mid_attn\.fn\.g$",
    r"^denoise_fn\.mid_attn\.fn\.fn\.(to_qkv|to_out)" + _WB,
    r"^rrdb\.RRDB_trunk\.\d+\.RDB\d\.conv\d" + _WB,
    r"^rrdb\.(conv_first|trunk_conv|upconv[123]|HRconv|conv_last)" + _WB,
]))


def convert_srdiff_state_dict(state_dict: dict, strict: bool = True) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A torch SRDiff ``GaussianDiffusion`` state dict (keys optionally
    under ``model.``) -> (the port's float32 ``state_dict``, unused keys).
    Diffusion buffers are dropped; a key outside the upstream schema raises
    ``KeyError`` when ``strict``, else it is left out and listed."""
    out: dict[str, torch.Tensor] = {}
    unused: list[str] = []
    for key, value in state_dict.items():
        k = key[len("model."):] if key.startswith("model.") else key
        if _SKIP_BUFFERS.match(k):
            continue
        if not _KNOWN.match(k):
            unused.append(key)
            if strict:
                raise KeyError(f"cannot translate checkpoint key {key!r}")
            continue
        out[k] = torch.as_tensor(value).detach().to("cpu", torch.float32)
    return out, unused


def import_srdiff_checkpoint(path: str, strict: bool = True) -> tuple[dict[str, torch.Tensor], int]:
    """Load the upstream ``model_ckpt_steps_*.ckpt`` -> ``(state_dict,
    global_step)``. The file is a full pickle (``weights_only=False``, as
    the upstream file may hold objects other than tensors), so it must come
    from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    if isinstance(state_dict.get("model"), dict):
        state_dict = state_dict["model"]
    params, unused = convert_srdiff_state_dict(state_dict, strict=strict)
    if unused:
        print(f"| torch import: {len(unused)} unused keys (e.g. {unused[:3]})")
    return params, int(ckpt.get("global_step", 0))


# The `lpips` package's layout: scaling_layer.shift/scale (fixed constants,
# checked, not stored), net.slice{1..5}.{idx}.weight/bias (torchvision
# alexnet convs at their `features` indices 0, 3, 6, 8, 10) and
# lin{0..4}.model.1.weight (the 1x1 heads without bias).
_LPIPS_SLICES = {"slice1": (0, "conv1"), "slice2": (3, "conv2"), "slice3": (6, "conv3"),
                 "slice4": (8, "conv4"), "slice5": (10, "conv5")}
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def convert_lpips_state_dict(state_dict: dict, strict: bool = True) -> dict[str, torch.Tensor]:
    """An ``lpips.LPIPS(net='alex')`` state dict -> the port's LPIPS
    ``state_dict``. Raises ``ValueError`` on a wrong layer index, scaling
    constants that are not LPIPS's, a missing parameter, or (when
    ``strict``) an unrecognised key."""
    out: dict[str, torch.Tensor] = {}
    unused: list[str] = []
    for key, v in state_dict.items():
        v = torch.as_tensor(v).detach().to("cpu", torch.float32)
        m = re.match(r"^net\.(slice\d)\.(\d+)\.(weight|bias)$", key)
        if m:
            sl, idx, kind = m.group(1), int(m.group(2)), m.group(3)
            if sl not in _LPIPS_SLICES:
                raise ValueError(f"unrecognised LPIPS slice in key {key}")
            want_idx, conv = _LPIPS_SLICES[sl]
            if idx != want_idx:
                raise ValueError(f"unexpected layer index in {key} (want {want_idx})")
            out[f"alex.{conv}.{kind}"] = v
            continue
        m = re.match(r"^lin(\d)\.model\.(\d+)\.weight$", key)
        if m:
            out[f"lin{m.group(1)}.weight"] = v
            continue
        if key in ("scaling_layer.shift", "scaling_layer.scale"):
            want = _LPIPS_SHIFT if key.endswith("shift") else _LPIPS_SCALE
            if not np.allclose(v.reshape(-1).numpy(), want, atol=1e-6):
                raise ValueError(f"{key} {v.reshape(-1).tolist()} != LPIPS constants")
            continue
        unused.append(key)
    if strict and unused:
        raise ValueError(f"unrecognised LPIPS keys: {unused[:5]}")
    expected = {f"alex.{c}.{p}" for _, c in _LPIPS_SLICES.values() for p in ("weight", "bias")}
    expected |= {f"lin{i}.weight" for i in range(5)}
    missing = expected - set(out)
    if missing:
        raise ValueError(f"LPIPS state_dict missing params: {sorted(missing)[:5]}")
    return out


def import_lpips(path: str, device: str | torch.device | None = None):
    """A torch ``lpips``-package checkpoint (the full ``LPIPS(net='alex')``
    state dict, a trusted pickle) -> a ready ``metrics.lpips.LPIPS``."""
    from dgm_img_super_resolution_tpu_torch.metrics.lpips import LPIPS

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return LPIPS(convert_lpips_state_dict(sd), device)
