"""SRDiff training task (counterpart of the JAX package's
``train/tasks/srdiff.py``; the reference config's ``trainer_cls:
tasks.srdiff_df2k.SRDiffDf2k``, ``srdiff/config.yaml:70``): the diffusion
loss on the residual, plus the RRDB's auxiliary losses when the encoder
trains, driven by :class:`~..trainer.Trainer`.

Batches are the DIV2K loader's ``{"hr", "lr", "lr_up"}`` in [-1, 1]
(``data/div2k.py``), NCHW on the device by the time ``loss_fn`` sees them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import GaussianDiffusion
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.models.layers import routing_key
from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer, TrainState, batch_to_device


class SRDiffTask:
    """The diffusion model with its loss and init for the Trainer."""

    def __init__(self, hp: Hparams, diffusion: GaussianDiffusion | None = None):
        self.hp = hp
        self.diffusion = diffusion or build_srdiff(hp)
        # use_wn: the optimizer steps the UNet's weight-norm (g, v) pairs and
        # the forward merges them (reference model.py:812-818, 849-856)
        self.use_wn = bool(hp.get("use_wn", False))

    def loss_fn(self, model: GaussianDiffusion, batch: dict, generator: torch.Generator | None = None,
                t=None, noise=None):
        """(the summed losses, each loss) of one batch; ``t`` and ``noise``
        as ``GaussianDiffusion.training_losses`` takes them."""
        losses, _, _ = model.training_losses(batch["hr"], batch["lr"], batch["lr_up"], t=t, noise=noise,
                                             generator=generator)
        return sum(losses.values()), dict(losses)

    def init_params(self, seed: int = 0) -> GaussianDiffusion:
        """The seeded init (He-normal UNet under ``weight_init``), the
        encoder from ``rrdb_ckpt`` when that file or dir exists (upstream
        SRDiff trains the RRDB apart, config.yaml:46), then weight norm
        under ``use_wn``."""
        init_srdiff_params(self.diffusion, seed=seed, weight_init=bool(self.hp.get("weight_init", False)))
        rrdb_ckpt = str(self.hp.get("rrdb_ckpt", ""))
        if self.diffusion.use_rrdb and rrdb_ckpt and os.path.exists(rrdb_ckpt):
            from dgm_img_super_resolution_tpu_torch.ckpt.ckpt_io import load_ckpt

            load_ckpt(self.diffusion.rrdb, rrdb_ckpt, model_name="rrdb", strict=False)
        if self.use_wn:
            from dgm_img_super_resolution_tpu_torch.models.param_transforms import apply_weight_norm

            apply_weight_norm(self.diffusion.denoise_fn)
        return self.diffusion

    def make_trainer(self, device: str | torch.device | None = None, mesh=None) -> Trainer:
        """The trainer on ``device`` over ``mesh`` (``make_mesh(hp['mesh_shape'])`` by default)."""
        return Trainer(self.hp, loss_fn=self.loss_fn, init_params_fn=self.init_params, device=device, mesh=mesh)

    def make_val_fn(self, val_batches: list, sample_metrics: bool = False):
        """Validation for ``Trainer.fit``: the mean loss over ``valid_steps``
        batches, batch i's timesteps and noise drawn from a generator seeded
        i; with ``sample_metrics`` also PSNR and SSIM (the port's ``Measure``)
        of the T-step ancestral ``sample`` of the first batch's first four
        images (the reference's ``valid_monitor_key: val_loss`` and sample
        machinery, config.yaml:37-38,76-79). On the card at world 1 the
        loss and the sample are captured graphs (JAX's ``val_loss_fn`` and
        ``sample_fn``, ``train/tasks/srdiff.py:96-102``), one per batch
        shape, kept by the returned function and keyed by the model's
        tensors' addresses too (:func:`graphs.storage_key`): an update in
        place is read by the next replay, a model swapped captures anew."""
        n_batches = min(len(val_batches), int(self.hp.get("valid_steps", 4)))
        cache = graphs.GraphCache()

        def run(name, fn, model, batch, dev, seed):
            """``fn(model, batch, generator)`` through the cache's graph."""
            gen = torch.Generator(device=dev).manual_seed(seed)
            batch = {k: batch[k] for k in ("hr", "lr", "lr_up")}
            if not graphs.enabled(dev) or (dist.is_initialized() and dist.get_world_size() > 1):
                return fn(model, batch, gen)
            key = (name, graphs.signature(batch), graphs.storage_key(model), routing_key())
            return cache.run(key, lambda inputs, g: fn(model, graphs.rebuild("batch", batch, inputs), g),
                             graphs.tensor_inputs("batch", batch), gen)

        def loss(model, b, g):
            return self.loss_fn(model, b, g)[0]

        def sample(model, b, g):
            return model.sample(b["lr"], b["lr_up"], generator=g)[0]

        @torch.no_grad()
        def val_fn(state: TrainState) -> dict:
            model = state.model
            dev = next(model.parameters()).device
            losses = [float(run("loss", loss, model, batch_to_device(val_batches[i], dev), dev, i))
                      for i in range(n_batches)]
            out = {"loss": float(np.mean(losses))}
            if sample_metrics:
                from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure

                measure = Measure(device=dev)
                b = batch_to_device(val_batches[0], dev)
                sr = run("sample", sample, model, b, dev, 0)
                hwc = lambda x, j: x[j].permute(1, 2, 0).float()  # noqa: E731
                res = [measure.measure(hwc(sr, j), hwc(b["hr"], j), hwc(b["lr"], j), self.hp["sr_scale"])
                       for j in range(min(4, sr.shape[0]))]
                out["psnr"] = float(np.mean([r["psnr"] for r in res]))
                out["ssim"] = float(np.mean([r["ssim"] for r in res]))
            return out

        val_fn.graphs = cache
        return val_fn
