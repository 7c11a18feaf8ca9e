"""Tiny cells for the CPU tests: the published configurations' shapes at
widths a test run can hold, with the same drivers, traffic generator,
reference and check."""

from __future__ import annotations

import copy

from benchmark.harness import spec

SRDIFF = {"hidden_size": 16, "unet_dim_mults": "1|2", "rrdb_num_block": 2, "rrdb_num_feat": 8, "timesteps": 10,
          "steps": 4}
SD_UNET = {"block_out_channels": [32, 32, 64, 64], "attention_head_dim": 2, "cross_attention_dim": 32,
           "num_class_embeds": 64}
SD_VAE = {"block_out_channels": [16, 32, 32]}
SD_TEXT = {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 2}


# The check's limits at these widths, set as the cells' are (PERF.md): the
# sound bf16 program's largest reading over 8 seeds (rms or worst image's
# rms, 0-255 scale) and the float8 control's smallest over 3, on this CPU:
# SRDiff 3.19 and 9.97, SD 4.76 and 29.43.
TINY_LIMITS = {"srdiff": 6.8, "sd": 17.5}


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration cut to
    tiny widths, its LR images to 8x8 pixels (16x16 for SD) and its limits
    to ``TINY_LIMITS``."""
    cell = spec.resolve(name)
    cfg, traffic, work = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic), copy.deepcopy(cell.workload)
    if cfg["driver"] == "srdiff":
        cfg.update(SRDIFF)
        traffic.update(lr=8, batch=min(traffic["batch"], 2))
    else:
        cfg["unet"].update(SD_UNET)
        cfg["vae"].update(SD_VAE)
        cfg["text_encoder"].update(SD_TEXT)
        cfg["serving"]["steps"] = 2
        traffic.update(lr=16)
    traffic.update(warmup=1, trace_requests=2)
    work["check"]["limits"] = {k: TINY_LIMITS[cfg["driver"]] for k in work["check"]["limits"]}
    return spec.Cell(cell.name, cell.entry, work, cfg, traffic, cell.end_to_end, cell.per_layer)
