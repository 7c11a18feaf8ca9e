"""Driver of the Stable Diffusion x4-upscaler serve:
``StableDiffusionUpscalePipeline.upscale_device``
(``dgm_img_super_resolution_tpu_torch/models/sd/pipeline.py``), the flash
kernel on.

A request is ``batch`` LR images of ``lr`` x ``lr`` uint8 pixels made on
the host from the seed, a prompt drawn from the seed out of the traffic's
list, and the initial latents and the LR augmentation noise made on the
card from the seed and handed to the entry as its noise hook (DDIM at eta 0
draws nothing more). The weights are made on the card from the seed in
bfloat16, the type the pipeline serves them in, and loaded by name.
"""

from __future__ import annotations

import torch

from benchmark.harness import client, weights
from benchmark.reference import sd as ref
from benchmark.reference.tokenizer import token_ids

PARTS = ("unet", "vae", "text_encoder")


class Driver:
    def __init__(self, config: dict, traffic: dict, device):
        self.cfg, self.traffic, self.device = config, traffic, torch.device(device)
        self.batch, self.lr = int(traffic["batch"]), int(traffic["lr"])
        self.serving = config["serving"]
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]
        self.pipe = None

    @property
    def images_per_request(self) -> int:
        return self.batch

    def reference_model(self, device) -> ref.SDUpscaler:
        with torch.device(device):
            return ref.SDUpscaler(self.cfg)

    def weights(self, seed: int) -> dict:
        model = self.reference_model("meta")
        return {part: weights.make(getattr(model, part), seed + k, self.device, self.dtype, weights.sd_rule)
                for k, part in enumerate(PARTS)}

    def build(self, seed: int) -> None:
        from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

        c = self.cfg
        self.pipe = StableDiffusionUpscalePipeline(
            self.weights(seed), unet_config=c["unet"], vae_config=c["vae"], text_config=c["text_encoder"],
            dtype=self.dtype, device=self.device, seed=0, scheduler_config=c["scheduler"],
            low_res_scheduler_config=c["low_res_scheduler"], use_flash=bool(self.serving["flash"]))

    def load(self, seed: int) -> None:
        """Draw seed ``seed``'s weights into the built program, in place (its
        captured graphs read them by address)."""
        for part, w in self.weights(seed).items():
            getattr(self.pipe, part).load_state_dict(w, strict=True)

    def prompts(self, seed: int, index: int) -> list[str]:
        g = torch.Generator().manual_seed(client.request_seed(seed, index, 2))
        pool = self.traffic["prompts"]
        return [pool[int(i)] for i in torch.randint(0, len(pool), (self.batch,), generator=g)]

    def request(self, seed: int, index: int) -> dict:
        g = torch.Generator().manual_seed(client.request_seed(seed, index, 0))
        lr = torch.randint(0, 256, (self.batch, self.lr, self.lr, 3), generator=g, dtype=torch.uint8)
        gd = torch.Generator(device=self.device).manual_seed(client.request_seed(seed, index, 1))
        lat = torch.randn((self.batch, self.cfg["vae"]["latent_channels"], self.lr, self.lr), generator=gd,
                          device=self.device)
        aug = torch.randn((self.batch, 3, self.lr, self.lr), generator=gd, device=self.device)
        return {"lr": lr, "latents": lat, "aug": aug, "prompts": self.prompts(seed, index)}

    def call(self, req: dict) -> torch.Tensor:
        s = self.serving
        return self.pipe.upscale_device(req["prompts"], req["lr"], num_inference_steps=s["steps"],
                                        guidance_scale=s["guidance_scale"], noise_level=s["noise_level"],
                                        eta=s["eta"], noise=(req["latents"], req["aug"], {}))

    def fetch(self, out: torch.Tensor) -> torch.Tensor:
        return out.cpu()

    def expected(self) -> tuple[tuple, torch.dtype]:
        f = 2 ** (len(self.cfg["vae"]["block_out_channels"]) - 1)
        return (self.batch, self.lr * f, self.lr * f, 3), torch.float32

    def capture_s(self) -> float | None:
        entries = list(self.pipe._graphs.entries.values())
        return sum(e.capture_s for e in entries) if entries else None

    def free(self) -> None:
        self.pipe = None

    # ---------------------------------------------------------- the check
    def ids(self, prompts: list[str]) -> torch.Tensor:
        t = self.cfg["text_encoder"]
        return torch.from_numpy(token_ids(list(prompts) + [""] * len(prompts), t["vocab_size"],
                                          t["max_position_embeddings"]))

    def reference(self, model: ref.SDUpscaler, req: dict) -> torch.Tensor:
        """The reference's images, NHWC float in [0, 1], on the host."""
        out = ref.serve(model, self.ids(req["prompts"]).to(self.device), req["lr"].to(self.device),
                        req["latents"], req["aug"])
        return out.cpu()

    def flops_per_request(self) -> float:
        from torch.utils.flop_counter import FlopCounterMode

        model = self.reference_model("meta")
        n, lat = self.batch, self.cfg["vae"]["latent_channels"]
        ids = torch.empty((2 * n, self.cfg["text_encoder"]["max_position_embeddings"]), dtype=torch.long,
                          device="meta")
        with FlopCounterMode(display=False) as fc:
            ref.serve(model, ids, torch.empty((n, self.lr, self.lr, 3), dtype=torch.uint8, device="meta"),
                      torch.empty((n, lat, self.lr, self.lr), device="meta"),
                      torch.empty((n, 3, self.lr, self.lr), device="meta"))
        return float(fc.get_total_flops())

    def launches(self, deltas: dict) -> list:
        """(roofline kernel, shape, launches) of the flash kernel in
        ``deltas``: the self-attention of the UNet's deepest level, over the
        guidance batch."""
        n = deltas.get("flash_attention.launches", 0)
        if not n:
            return []
        u = self.cfg["unet"]
        side = self.lr // 2 ** (len(u["block_out_channels"]) - 1)
        heads = u["attention_head_dim"]
        return [("flash_attention", {"b": 2 * self.batch, "l": side * side, "h": heads,
                                     "d": u["block_out_channels"][-1] // heads}, n)]
