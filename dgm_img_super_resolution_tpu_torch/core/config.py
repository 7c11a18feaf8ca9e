"""Configuration system (the port's own copy of the JAX package's
``core/config.py``, so that the port imports nothing of that package).

Keeps the *surface* of the reference config system (YAML files with recursive
``base_config`` inheritance, dotted-key CLI overrides with type coercion, and
persistence of the merged config into the experiment work dir — see reference
``srdiff/model.py:273-395``) but replaces the global mutable ``hparams`` dict
with an explicit, immutable-by-convention :class:`Hparams` object that is
passed to constructors.

Every key of the reference's effective config (``srdiff/config.yaml:1-81``)
has a default here, so ``Hparams()`` alone reproduces the SRDiff pretrained
setup.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Iterator, Mapping

import yaml

# Defaults mirror the reference's effective flat config
# (/root/reference/srdiff/config.yaml:1-81). Keys the reference leaves to its
# absent base configs keep the values hard-coded in its code paths.
DEFAULTS: dict[str, Any] = {
    # optimisation
    "accumulate_grad_batches": 1,
    "amp": False,
    "batch_size": 64,
    "eval_batch_size": 1,
    "test_batch_size": 1,
    "lr": 2e-4,
    "decay_steps": 200000,
    "max_epochs": 1000,
    "max_updates": 400000,
    "clip_grad_norm": 10.0,
    "weight_decay": 0.0,
    "seed": 1234,
    # losses
    "loss_type": "l1",
    "aux_l1_loss": True,
    "aux_percep_loss": False,
    "aux_ssim_loss": False,
    # diffusion
    "timesteps": 100,
    "beta_schedule": "cosine",
    "beta_s": 0.008,
    "beta_start": 1e-4,
    "beta_end": 0.02,
    "res": True,
    "res_rescale": 2.0,
    "clip_input": True,
    "pred_noise": True,
    "sample_timesteps": 0,  # 0 => full `timesteps`; <T enables DDIM striding
    "sampler": "ddpm",  # ddpm | ddim
    "ddim_eta": 0.0,
    # >1: recompute the UNet encoder every K-th DDIM step, reuse between
    # (training-free acceleration, arXiv 2312.09608; quality-validate first)
    "enc_interval": 1,
    # serving memory budget: max total HR pixels (batch*H*W) per device
    # call. Default 2^21 = one 8x512x512 batch (the serving operating
    # point). 0 disables the guard (reference behaviour: OOM).
    "max_native_hr_pixels": 2097152,
    "infer_patch_size": 128,  # LR tile size for auto-tiled large-image SR
    "infer_patch_overlap": 16,  # LR overlap for feather-blended seams
    # model
    "denoise_fn": "unet",
    "hidden_size": 64,
    "unet_dim_mults": "1|2|3|4",
    "use_attn": False,
    "use_wn": False,
    "weight_init": False,
    "gn_groups": 0,
    "up_input": False,
    "use_rrdb": True,
    "fix_rrdb": True,
    "rrdb_num_block": 8,
    "rrdb_num_feat": 32,
    "rrdb_ckpt": "pretrained/rrdb_df_1",
    "sr_scale": 4,
    # data
    "binary_data_dir": "data/binary/df2k4x",
    "data_interp": "bicubic",
    "data_augmentation": False,
    "crop_size": 320,
    "patch_size": 160,
    "thresh_size": 160,
    "test_crop_size": [2040, 2040],
    "test_thresh_size": 0,
    "ds_workers": 1,
    "num_workers": 8,
    "endless": False,
    # checkpointing / validation
    "work_dir": "checkpoints/srdiff_pretrained_div2k",
    "num_ckpt_keep": 100,
    "save_best": True,
    "save_intermediate": False,
    "resume_from_checkpoint": 0,
    "load_ckpt": "",
    "val_check_interval": 4000,
    "check_val_every_n_epoch": 10,
    "valid_monitor_key": "val_loss",
    "valid_monitor_mode": "min",
    "valid_steps": 4,
    "num_sanity_val_steps": 4,
    # logging / misc
    "tb_log_interval": 100,
    "print_arch": False,
    "print_nan_grads": False,
    "show_training_process": False,
    "save_codes": ["configs", "models", "tasks", "utils"],
    "gen_dir_name": "",
    "test_input_dir": "",
    "test_save_png": True,
    "style_interp": False,
    "trainer_cls": "tasks.srdiff_df2k.SRDiffDf2k",
    "infer": False,
    "validate": False,
    "debug": False,
    "exp_name": "",
    # additions of this framework (not in the reference)
    "compute_dtype": "bfloat16",  # dtype for conv/matmul activations
    "param_dtype": "float32",
    "mesh_shape": "",  # e.g. "dp=8" or "dp=4,sp=2"; "" => all devices on dp
    "ema_decay": 0.0,  # 0 disables EMA
}


class Hparams(dict):
    """Typed-by-default hyperparameter mapping with attribute access.

    Behaves as a plain ``dict`` (so code written against the reference's
    ``hparams['key']`` idiom keeps working) but is constructed explicitly and
    passed to model constructors instead of living in a module-level global.
    """

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(copy.deepcopy(DEFAULTS))
        if args:
            for a in args:
                self.update(a)
        self.update(kwargs)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def replace(self, **kwargs: Any) -> "Hparams":
        new = Hparams(self)
        new.update(kwargs)
        return new

    @property
    def unet_dim_mults_tuple(self) -> tuple[int, ...]:
        v = self["unet_dim_mults"]
        if isinstance(v, str):
            return tuple(int(m) for m in v.split("|"))
        return tuple(v)


def override_config(old_config: dict, new_config: Mapping) -> None:
    """Deep-merge ``new_config`` into ``old_config`` in place.

    Mirrors reference ``model.py:283-288``.
    """
    for k, v in new_config.items():
        if isinstance(v, Mapping) and k in old_config and isinstance(old_config[k], dict):
            override_config(old_config[k], v)
        else:
            old_config[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v


def load_config(config_fn: str, *, _seen: set[str] | None = None) -> dict:
    """Load a YAML config, recursively resolving ``base_config`` inheritance.

    Relative base paths resolve against the including file's directory; a file
    visited twice in one cascade is loaded once (cycle avoidance). Missing
    files yield ``{}`` — matching the reference's silent-skip behaviour
    (``model.py:316-337``) so its config.yaml (whose bases are absent) loads.
    """
    seen = _seen if _seen is not None else set()
    config_fn = os.path.abspath(config_fn) if config_fn else config_fn
    if not config_fn or not os.path.exists(config_fn) or config_fn in seen:
        return {}
    seen.add(config_fn)
    with open(config_fn) as f:
        hparams_ = yaml.safe_load(f) or {}
    ret = {}
    for base in hparams_.get("base_config", []):
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(config_fn), base)
        override_config(ret, load_config(base, _seen=seen))
    hparams_.pop("base_config", None)
    override_config(ret, hparams_)
    return ret


def _coerce(old: Any, new_str: str) -> Any:
    """Coerce a dotted-override string to the type of the existing value.

    Mirrors the reference's type-coercion rules (``model.py:358-374``):
    bools accept true/false/1/0; lists/dicts/tuples are literal-eval'd;
    everything else is cast via the old value's type.
    """
    if old is None:
        try:
            return ast.literal_eval(new_str)
        except (ValueError, SyntaxError):
            return new_str
    if isinstance(old, bool):
        return new_str.lower() in ("true", "1", "yes")
    if isinstance(old, (list, tuple, dict)):
        return ast.literal_eval(new_str)
    if isinstance(old, str):
        return new_str
    return type(old)(new_str)


def _split_overrides(dotted: str) -> list[str]:
    """Split ``a=1,b=[2,3]`` on top-level commas only (brackets nest)."""
    items, buf, depth = [], [], 0
    for ch in dotted:
        if ch in "[({":
            depth += 1
        elif ch in "])}":
            depth -= 1
        if ch == "," and depth == 0:
            items.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        items.append("".join(buf))
    return items


def _apply_dotted(config: dict, dotted: str) -> None:
    for item in _split_overrides(dotted):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"hparams override {item!r} must be key=value")
        key, value = item.split("=", 1)
        node: dict = config
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        node[leaf] = _coerce(node.get(leaf), value.strip())


def set_hparams(
    config: str = "",
    exp_name: str = "",
    hparams_str: str = "",
    print_hparams: bool = False,
    argv: list[str] | None = None,
) -> Hparams:
    """Build an :class:`Hparams` from a YAML cascade + overrides.

    Same surface as reference ``set_hparams`` (``model.py:291-395``):

    - ``config``: path to a YAML file (with optional ``base_config`` cascade).
    - ``exp_name``: experiment name; a previously saved
      ``checkpoints/<exp>/config.yaml`` is merged in (unless ``--reset``).
    - ``hparams_str``: dotted-key overrides, e.g. ``"lr=1e-4,res=false"``.
    - ``argv``: optional CLI args (``--config/--exp_name/-hp/--infer/...``);
      pass ``[]`` to disable CLI parsing (the programmatic path).

    Unlike the reference this never mutates a global; the returned object is
    the single source of truth.
    """
    args = None
    if argv is not None:
        parser = argparse.ArgumentParser(description="dgm_img_super_resolution_tpu_torch")
        parser.add_argument("--config", type=str, default=config)
        parser.add_argument("--exp_name", type=str, default=exp_name)
        parser.add_argument("-hp", "--hparams", type=str, default=hparams_str)
        parser.add_argument("--infer", action="store_true")
        parser.add_argument("--validate", action="store_true")
        parser.add_argument("--reset", action="store_true")
        parser.add_argument("--debug", action="store_true")
        args, _ = parser.parse_known_args(argv)
        config, exp_name, hparams_str = args.config, args.exp_name, args.hparams

    merged: dict = {}
    saved_config_path = ""
    if exp_name:
        work_dir = os.path.join("checkpoints", exp_name)
        saved_config_path = os.path.join(work_dir, "config.yaml")
        if os.path.exists(saved_config_path) and not (args and args.reset):
            override_config(merged, load_config(saved_config_path))
    if config:
        override_config(merged, load_config(config))
    if hparams_str:
        _apply_dotted(merged, hparams_str)

    hp = Hparams(merged)
    if exp_name:
        hp["exp_name"] = exp_name
        hp["work_dir"] = os.path.join("checkpoints", exp_name)
        os.makedirs(hp["work_dir"], exist_ok=True)
        with open(os.path.join(hp["work_dir"], "config.yaml"), "w") as f:
            yaml.safe_dump({k: v for k, v in hp.items()}, f)
    if args:
        hp["infer"] = bool(args.infer)
        hp["validate"] = bool(args.validate)
        hp["debug"] = bool(args.debug)
    if print_hparams:
        print("| Hparams: ")
        for k in sorted(hp):
            print(f"|   {k}: {hp[k]}")
    return hp
