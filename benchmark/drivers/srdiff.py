"""Driver of the SRDiff x4 serve: ``SRDiffPipeline.upscale_batch_device``
(``dgm_img_super_resolution_tpu_torch/inference.py``) with uint8 out.

A request is a batch of ``batch`` LR images of ``lr`` x ``lr`` uint8 pixels
made on the host from the seed (what a client sends), and the sampler's
noise made on the card from the seed: the initial state and one tensor a
noisy DDIM step, handed to the entry as its noise hook so that the plain
reference can follow the same draws. The weights are made on the card from
the seed, in float32 (the pipeline keeps its parameters in float32 and
casts them to the compute dtype in every forward), and loaded by name.
"""

from __future__ import annotations

import torch

from benchmark.harness import client, weights
from benchmark.reference import srdiff as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, device):
        self.cfg, self.traffic, self.device = config, traffic, torch.device(device)
        self.batch, self.lr = int(traffic["batch"]), int(traffic["lr"])
        self.hr = self.lr * config["sr_scale"]
        self.noisy = ref.noise_timesteps(config)
        self.pipe = None

    @property
    def images_per_request(self) -> int:
        return self.batch

    def reference_model(self, device) -> ref.SRDiff:
        with torch.device(device):
            return ref.SRDiff(self.cfg)

    def weights(self, seed: int) -> dict:
        return weights.make(self.reference_model("meta"), seed, self.device, torch.float32, weights.lecun)

    def build(self, seed: int) -> None:
        from dgm_img_super_resolution_tpu_torch.core.config import Hparams
        from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

        c = self.cfg
        hp = Hparams(hidden_size=c["hidden_size"], unet_dim_mults=c["unet_dim_mults"],
                     rrdb_num_block=c["rrdb_num_block"], rrdb_num_feat=c["rrdb_num_feat"], sr_scale=c["sr_scale"],
                     timesteps=c["timesteps"], beta_schedule=c["beta_schedule"], beta_s=c["beta_s"],
                     res_rescale=c["res_rescale"], compute_dtype=c["dtype"], sampler=c["sampler"],
                     sample_timesteps=c["steps"], ddim_eta=c["eta"], enc_interval=1, seed=0)
        self.pipe = SRDiffPipeline(hp, params=self.weights(seed), device=self.device)

    def load(self, seed: int) -> None:
        """Draw seed ``seed``'s weights into the built program, in place (its
        captured graphs read them by address)."""
        self.pipe.model.load_state_dict(self.weights(seed), strict=True)

    def request(self, seed: int, index: int) -> dict:
        g = torch.Generator().manual_seed(client.request_seed(seed, index, 0))
        lr = torch.randint(0, 256, (self.batch, self.lr, self.lr, 3), generator=g, dtype=torch.uint8)
        gd = torch.Generator(device=self.device).manual_seed(client.request_seed(seed, index, 1))
        z = torch.randn((1 + len(self.noisy), self.batch, 3, self.hr, self.hr), generator=gd, device=self.device)
        return {"lr": lr, "x_t": z[0], "steps": {t: z[1 + k] for k, t in enumerate(self.noisy)}}

    def call(self, req: dict) -> torch.Tensor:
        return self.pipe.upscale_batch_device(req["lr"], as_uint8=True, noise=(req["x_t"], req["steps"]))

    def fetch(self, out: torch.Tensor) -> torch.Tensor:
        return out.cpu()

    def expected(self) -> tuple[tuple, torch.dtype]:
        return (self.batch, self.hr, self.hr, 3), torch.uint8

    def capture_s(self) -> float | None:
        entries = list(self.pipe._graphs.entries.values())
        return sum(e.capture_s for e in entries) if entries else None

    def free(self) -> None:
        self.pipe = None

    # ---------------------------------------------------------- the check
    def reference(self, model: ref.SRDiff, req: dict) -> torch.Tensor:
        """The reference's SR batch, NHWC float in [0, 1], on the host."""
        lr = req["lr"].to(self.device)
        return ref.serve(model, lr, req["x_t"], req["steps"]).cpu()

    def flops_per_request(self) -> float:
        from torch.utils.flop_counter import FlopCounterMode

        model = self.reference_model("meta")
        lr = torch.empty((self.batch, self.lr, self.lr, 3), dtype=torch.uint8, device="meta")
        z = torch.empty((self.batch, 3, self.hr, self.hr), device="meta")
        with FlopCounterMode(display=False) as fc:
            ref.serve(model, lr, z, {t: z for t in self.noisy})
        return float(fc.get_total_flops())

    def launches(self, deltas: dict) -> list:
        """(roofline kernel, shape, launches) of the port's SRDiff regions
        in ``deltas`` (the counters' gains by ``wrapper.attribute``)."""
        b, hr = self.batch, self.hr
        out = []
        if deltas.get("block_chain3_stem.launches"):
            out.append(("block_chain3_stem", {"b": b, "h": hr, "w": hr}, deltas["block_chain3_stem.launches"]))
        for (c, h, w), n in deltas.get("block_chain3.launches_by_shape", {}).items():
            out.append(("block_chain3", {"b": b, "c": c, "h": h, "w": w}, n))
        if deltas.get("tail_fuse.launches"):
            out.append(("tail_fuse", {"b": b, "h": hr, "w": hr}, deltas["tail_fuse.launches"]))
        return out
