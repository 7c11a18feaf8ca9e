#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: SRDiff x4 and SD x4 serving, training, data parallelism.

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository; it needs one CUDA device and nvcc.

1. Print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build the hand-written kernels from
   ``dgm_img_super_resolution_tpu_torch/ops/kernels/csrc``.
2. Hold each SRDiff kernel against its plain PyTorch version on the card: in
   bf16 at the main path's shapes (batch 8, 512x512 HR; the wide chain at
   the five shapes configuration C runs it at), and in float32 with TF32 off
   at edge shapes (the chain at C = 32 and 96-256 on a ragged 13x21; and
   bf16 at C = 96, the wide kernel's remaining bf16 route); time both with
   CUDA events, and the one PyTorch call that computes the same function
   where there is one. conv3x3 in bf16 at C = 64 runs the
   warpgroup-MMA kernel (``csrc/conv3x3_wgmma.cu``): its counter must count
   every such call, a single non-zero tap at dx = 1 and 2 checks its shifted
   operand descriptors, and it is also timed at zero border without Mish
   (``ms_zero``, in turns with ``F.conv2d``, the same function) and at
   configuration B's up-stage shape (8, 64, 256, 256). The chain regions'
   bf16 C = 64 chain runs on the same conv core
   (``csrc/block_chain_wgmma.cu``): each region is also held at every edge
   of the core's tiles, and the route's two front pieces, the stem launch
   writing h1 and the h1 pass, are checked and timed alone (``stem_ms``,
   ``h1_ms``). So does the bf16 chain at C = 128, 192 and 256 (the wide
   core, ``csrc/conv_wgmma_wide.cuh``): it too is held at every tile edge,
   with and without its condition, and its h1 pass is timed at each shape.
   The bf16 tail runs on the same core (``csrc/tail_fuse_wgmma.cu``: a
   ConvT launch, then the core's 3x3 with Mish and the 1x1 in its
   epilogue): it is held at every tile edge of its input, each of its two
   launches is checked and timed alone against its plain piece
   (``convt_ms``, ``conv_1x1_ms``), and ``tail_fuse.cu``'s tiled conv, its
   route before, is timed on the same inputs (``tile_ms``); float32, and
   bf16 with 12 outputs, must still run ``tail_fuse.cu``. The bf16
   Downsample of the Downsample fold and the head of the head region run
   on the core too (``csrc/head_ds_wgmma.cu``: the stride-2 conv, and the
   head's 3x3 and 1x1 over [x || skip] writing h1 and r1): each launch is
   held against its plain piece at the main shapes and at every tile edge
   (the head at C_s = 64 and 128) and timed alone (``ds_ms``,
   ``head_ms``) beside its bound, ``block_chain.cu``'s streamed conv on the
   same inputs (``*_stream_ms``) and its ``F.conv2d`` yardstick in turns
   (``*_library_ms``).
3. Serve the default full-width config (hidden 64, mults 1|2|3|4, RRDB nb 8,
   seeded random weights) with DDIM 20 steps, eta 1, bf16: batch 8 of
   128x128 uint8 -> (8, 512, 512, 3) uint8, under four configurations of
   the kernel switches (``models/layers.py``): the defaults; A,
   ``DGMSR_PALLAS_DS=1 DGMSR_PALLAS_HEAD=1``; B, ``DGMSR_PALLAS_FUSED=0
   DGMSR_PALLAS_TAIL=0 DGMSR_PALLAS_CONV=1``; C, ``DGMSR_CHAIN_C=64,128,192,256``
   (every ResnetBlock pair through the chain kernel). Each is warmed up,
   then the kernels' launch counters are set to 0 just before its timed
   batch and read just after, and must equal the counts each configuration
   implies (the chain's per width, and under C per shape). A fifth serve
   with every region off (``CUDNN_ENV``) launches none; each
   configuration's uint8 images are bounded against the default's and the
   cuDNN serve's (``UINT8_*``). Then one bf16 UNet forward at the serve's
   shapes under each configuration against the cuDNN bf16 and the float32
   forward of the same weights (``FWD_*``; the reasons of every bound are
   written beside it).
4. Run the full-width model in float32 at LR 32x32 on the card (kernels) and
   on the CPU (plain versions) with the same weights and injected noise: one
   UNet forward and a ddim4 serve on the card under the defaults, A, B and
   C; for a hidden-32 model under the defaults, with
   ``DGMSR_PALLAS_CONV=1`` and with ``DGMSR_CHAIN_C=32,64,96,128``; and for a
   hidden-128 model with mults 1|2 under ``DGMSR_CHAIN_C=128,256``; each
   against one CPU reference per model.
5. Backward: the full-width UNet forward and backward in float32 on the card
   under each configuration (B=2 at 64x64 HR), every parameter's gradient
   against the CPU's on the same weights and inputs. The forward's launch
   counts must be one UNet call's share of the serve's; the backward
   recomputes the regions' plain versions (``ops/kernels/_autograd.py``) and
   launches nothing.
6. Hold the flash-attention kernel against its plain version: bf16 at the SD
   path's shape (2, 1024, 8, 128), at a ragged L = 1089, at D = 64, at
   Lq != Lk both ways and with logits x8; float32 at a ragged L, D = 64 and
   one short tile. Time it in turns with ``F.scaled_dot_product_attention``
   (the yardstick only; the port never calls it), 5 rounds of 50 calls
   each: launched one by one with CUDA events, as every kernel row is timed
   (the row's ``ms`` and ``library_ms``), and replayed from a CUDA graph
   (``ms_graph``, ``library_ms_graph``: device time without the host's
   launch overhead); and once beside its plain version.
7. Hold ``fused_group_norm`` against its plain version: float32 at edge
   shapes in both layouts, with and without SiLU; bf16 + SiLU at the SD
   UNet's (2, 256, 256, 256) and the SD VAE decoder's (1, 128, 1024, 1024)
   in both layouts, timed beside its plain version and
   ``F.silu(F.group_norm(...))`` in turns; then at every (shape, groups,
   eps, SiLU or not) of the SD serves at LR 256 and 128 (``gn_sweep``:
   forward hooks on one UNet forward and one decode of the published-width
   modules on the meta device), NCHW bf16, timed in turns with
   ``F.group_norm`` (and ``F.silu``). Every case checks the route counter
   (``launches_resident``, ``launches_streamed``) against ``plan_for`` and
   that two calls are bit-equal. Nothing calls it on a serve path.
8. Serve the SD x4-upscaler at the published widths (seeded random weights,
   bf16, DDIM 20 steps eta 0, guidance 9, noise level 20): one 256x256
   uint8 image -> (1, 1024, 1024, 3), where the flash kernel runs 120 times
   (6 level-3 and mid self-attentions of 1024 tokens per UNet call), then
   the app's 128x128 point -> (1, 512, 512, 3), where it runs 0 times.
   Each size is warmed up with a 2-step serve; the launch counters are set
   to 0 just before each timed serve and read just after.
9. The published-width UNet in float32 on the card and on the CPU at latent
   32x32 (plain attention), and one level-3 Transformer2D on 32x32 tokens
   (the flash kernel on the card, its plain version on the CPU); the
   published-width VAE's ``forward(x, noise=...)`` (the sampled posterior's
   decode) at 64x64.
10. From a checkpoint file to a scored image (``phase_checkpoint_cli``): an
   upstream-format SRDiff checkpoint of the full-width model (seeded random
   weights, the diffusion buffers beside them) loaded by
   ``SRDiffPipeline(ckpt_path=...)`` serves a batch of 8 and one image at
   128 -> 512 (ddim20 eta 1, bf16) bit for bit as the pipeline built from
   the same state dict, 20 launches of rows 1-3 a batch; the CLI's
   ``infer``, ``eval``, ``test --check-op-point`` (2 images) and ``interp``
   run on the card from that file, each with its launches counted (20 a
   ddim20 serve, 100 + 20 an image of the operating-point check, 99 the
   interpolation chain from t = 98 to 0) and its wall time; ``psnr``,
   ``ssim_eval`` and LPIPS (seeded random weights from an ``.npz``) on the
   card against the CPU in float32 (``METRIC_TOL``), and the time of
   ``Measure.measure`` at 512x512.
11. The SD x4-upscaler from a local diffusers directory
   (``phase_sd_local_checkpoint``): the published-width random weights
   written as float16 safetensors with the scheduler configs, loaded by
   ``load_sd_x4_pipeline`` on the card and served at LR 256 bit for bit as
   the pipeline built in memory from the same float16-rounded weights, with
   120 flash launches; write, load and serve seconds.
12. SRDiff training (``phase_train``) at full width, batch 64 of 160x160
   HR crops in bf16, through ``SRDiffTask``, ``Trainer.fit``,
   ``DIV2KDataset`` and ``DataLoader``: one training loss and its
   gradients at B = 2 with two different timesteps, float32 on the card
   against the CPU and bf16 against the same step with every region off;
   ``fit`` over 64 PNGs written from a seed (12 updates, validation at 0, 6
   and 12, keep 2), then a resume to 16 (the restored state equal to the
   saved one, Adam's count and the learning rate going on, two checkpoints
   left); ten updates on one batch lowering its loss; the launches of rows
   1-3 (rows 4, 5 and 3 under A) exactly one per training forward and per
   validation batch, none from backward; the step's time fed by the loader
   and with the batch ready, HR crops/s, the loader's share, the peak
   memory and the checkpoint save.
13. The repaired SRDiff sampler API and SD class embedding
   (``phase_sampler_api``), float32 card vs CPU: ``sample(...,
   save_intermediate=True)`` (the image, each step's image and x0) and
   ``p_sample`` at per-row timesteps on a small model (hidden 16, T = 8, HR
   64), ``ddim_sample(shape=...)`` at the full width (two draws for a
   batch-1 condition, 4 steps: 4 launches each of rows 1-3), and the
   published-width SD UNet with ``num_class_embeds=None`` and class labels
   (the timestep-style class embedding) at latent 32x32.
14. The educational models (``phase_edu``) at the JAX defaults' widths on
   ``synthetic_mnist``: for the AE, VAE, DDPM, simple GAN, DCGAN and
   WGAN-GP tasks, one float32 loss and its gradients card vs CPU (a GAN's
   whole round, update by update, with its BatchNorm statistics, Adam's
   moments and the parameters after each), ten updates on one batch
   lowering the loss, and the step's (round's) time with the batch on the
   card at batch 128 (the DDPM at 64); ``GANTask.fit`` with validation and
   its model IO round trip; the VAE and DDPM samplers (T = 250, batch 16;
   phase_graphs replays the DDPM chain) timed. Every kernel counter must read 0 across the phase.
   Then the example scripts (``phase_examples``, ``examples_torch/``) through
   their ``main`` on the card at JAX's default widths (batch 128, VAE
   latent 16, DDPM dim 64 and T = 1000), 100 steps each: ``train_vae``
   with the VAE and the AE, ``train_gan`` for the three kinds,
   ``train_ddpm``; each grid at JAX's name and size, finite losses, 0
   launches of every kernel, wall s and steps/s.
   Then the benchmark scripts (``phase_bench``) at the JAX scripts' full
   widths and default knobs: ``dgmsr-torch bench`` in process
   (``bench_torch.py``: 28 ddim20 serves and 4 of the T = 100 chain, 960
   launches of rows 1-3), ``tools/torch_port_sd_bench.py`` at LR 128 (no
   flash launch) and at LR 256 with ``SD_FLASH=0`` (the UNet without the
   kernel: none either), ``tools/torch_port_train_bench.py`` (21 steps, 21
   launches of rows 1-3); each JSON line with its JAX script's keys and the
   card line, its numbers printed.
   Then the DDIM operating-point study (``phase_operating_point``,
   ``tools/torch_port_ddim_operating_point.py`` through its ``main``) at a
   reduced depth: 200 updates of the full-width model at batch 4 of 160^2
   crops of its two synthetic images, the 256^2 centre regions served with
   ``ddpm100``, ``ddpm100_seed2``, ``ddim20_eta1`` and
   ``ddim20_eta1_ep2``, and ``ddim20_eta1`` served again with every region
   on its plain version. The record must hold the JAX tool's keys and the
   port's four, every PSNR and SSIM finite; rows 1-3 launched exactly once a
   training update, 100 times a ``ddpm100`` serve, 20 a ddim20 serve, at
   ``enc_interval`` 2 row 1 10 times and rows 2-3 20, none on the plain
   versions and no other kernel; and at ``ddim20_eta1`` the kernels'
   PSNR-vs-HR within 0.1 dB of the plain versions' (the tolerance the study
   chooses by).
15. The native imresize (``phase_native``): the port's C++ library builds
   on the card's host, ``imresize`` takes it by default and equals the
   matrix path (uint8 exactly, float64 to 1e-12), and ``Measure.measure``
   at 512x512 is timed with the matrix path and with the library in turns.

16. Data parallelism (``phase_dp``, ``parallel/mesh.py``): two ranks share
   the card over gloo (NCCL refuses two ranks on one device), spawned with
   ``torch.multiprocessing`` in the environment ``torchrun`` sets. The
   full-width ddim20 serve of a batch of 8 (4 a rank), bf16 and float32
   with TF32 off, gathered on both ranks and held against the world-1 serve
   of the same weights and seed (rank 0 alone); each rank's launches of
   rows 1-3, 20 a serve; bf16 img/s and the batch-1 p50 (split by rows) at
   both worlds in turns. SRDiff training at full width, bf16, global batch
   64 of 160^2: 3 steps from one state against world 1 (loss, gradient
   norm, parameters in units of the learning rates applied), both ranks
   equal, the launches, rank 0's one checkpoint resumed by both ranks,
   ``reduce_metrics``, the step's and the gradient all-reduce's ms. Then
   NCCL at world = the card count (the serve through the mesh code; with 2
   or more cards the training too, at world min(count, 4)), and
   ``dgmsr-torch train`` under ``torchrun --standalone`` for 4 updates
   and one checkpoint.
17. Spatial sharding (``phase_sp``, ``parallel/mesh.py``'s ``sp`` axis):
   four ranks share the card over gloo on mesh ``dp=2,sp=2``. The
   full-width ddim20 serve of batch 1 at LR 128 splits its image rows over
   the four ranks (32 LR, 128 HR rows a rank; the convs exchange halo rows,
   the regions run their plain versions): float32 (TF32 off) against the
   world-1 serve, bf16 against world 1 under ``kernels_disabled()`` (the
   same route; phase 3's uint8 bounds), every kernel's launches 0 on every
   rank; a batch of 4 on the same mesh stays on dp (20 launches of rows 1-3
   a rank). One float32 training step at batch 64 of 160^2, the batch over
   dp and the image rows over sp, against world 1 (``phase_dp``'s bounds),
   every rank equal. Timed in turns against world 1: the batch-1 p50, the
   bf16 step, and a UNet step's halo exchanges (count and ms).
18. The captured paths (``phase_graphs``, ``core/graphs.py``). Every phase
   above that serves or trains at world 1 runs through the captured CUDA
   graphs (the first call of a shape eager, then replays), and its launch
   counts are the replays' captured counts. That these are what a replay
   launches is checked on the card: phase 3 (each configuration) and this
   phase (each path) trace one eager call and one replay under
   ``torch.profiler`` and hold the replay's kernels, by the ``__global__``
   names of the port's CUDA sources, and the counts the cache added,
   against the eager call's kernels and the counts its wrappers made at
   launch (the T = 100 serve against five times the batch-1 ddim20
   serve's: the profiler loses records of an eager call that long). Here
   each path is replayed against ``graphs.eager()`` at the same generator
   state: the default
   uint8 SRDiff serve at batch 8 and 1 and the T = 100 ancestral serve at
   batch 1 (bit-equal, 20 or 100 launches of rows 1-3 a replay), the SD
   serve at LR 128 and 256 (bit-equal, 0 or 120 flash launches), three
   SRDiff training steps at batch 64 of 160^2 in bf16 with accumulation 2
   (the parameters and the EMA bit-equal; a state rewound in place replays
   all three graphs) and one WGAN-GP round (compared under cuDNN's
   deterministic algorithms); each timed in turns (eager s and replayed s a
   call), with its capture s and the bytes its graphs added to the cache's
   shared pool. Then the paths captured as segmented programs or whole
   (``_graph_path``; the call after the capture must capture nothing, the
   host callbacks' sequence must be the eager one): the SRDiff progress
   path at batch 1 with ``callback_steps`` 10 (the apps' and the CLI's)
   and 3 (a remainder segment), the SD callback path at LR 128 and 256
   with ``callback_steps`` 1 (one entry of 22 graphs; 120 flash launches at
   256), ``interpolate`` at 512^2 (99 launches of rows 1-3; another mixing
   weight replays), SRDiff validation with ``sample_metrics`` at
   ``phase_train``'s hparams (2 batches of 16 and the T = 100 sample: 102
   launches of rows 1-3), a WGAN-GP ``val_step``, the DDPM sampler at T =
   100 and batch 16 (one graph over the chain, compared under cuDNN's
   deterministic algorithms; its eager calls and two replays timed) and
   LPIPS at 512^2; and the CLI's ``infer --progress`` wall, eager and
   through the graphs, in turns. Interpolation, the DDPM sampler and LPIPS
   capture at a key's second call: their first call must run eagerly and
   capture nothing. Each path's own eager call is traced against a replay;
   interpolation's and validation's at 20 steps, the DDPM sampler's at T =
   10 (a long eager trace loses records).

Any failure exits non-zero. The line before the last is the kernel table
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
``--out DIR`` also writes the full results and the compiler's resource
reports there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12     # H100 SXM float32 FLOP/s outside the tensor cores (the same)
HBM_BPS = 3.35e12    # H100 SXM HBM3 bytes/s
BF16_TOL = 3e-2      # max |kernel - plain| / max(1, max |plain|) in bf16
F32_TOL = 1e-4       # the same in float32 (TF32 off on both sides)
# Card vs CPU, float32 SR output in [0, 1]. The first DDIM step (t=99 of the
# cosine T=100 schedule) maps eps to x0 through sqrt((1 - a_t) / a_t) ~ 65,
# and the output is x / 2 + the bicubic LR, so an eps difference d reaches
# the output as up to ~32 d. Float32 sum-order differences in eps are held
# at F32_TOL on one UNet forward; with eps of the random-weight model a few
# units large they come to ~1e-5, and this bound leaves 3x room over ~32x
# that. A broken kernel moves the output by 1e-1 or more.
E2E_TOL = 1e-2
# The served bf16 path end to end (C1). Each configuration's bf16 UNet
# forward of the full-width model at the serve's shapes (B=8, 512x512 HR) is
# held against the same weights' bf16 forward with every region off
# (CUDNN_ENV: cuDNN throughout) and the float32 forward (cuDNN, TF32 off):
# max |eps - ref| / max |ref| and mean |eps - ref| / mean |ref|. The plain
# versions round where the kernels do, and on the CPU (128x128 and 256x256
# HR, B=2) every configuration's bf16 forward lay 1.0-1.25% (max) and
# 0.85-0.90% (mean) from both references, the cuDNN bf16 forward itself
# 1.15% and 0.87% from float32; the kernels differ from the plain versions
# in float32 sum order only. The bounds leave about 3x (max) and 2.3x (mean)
# of that, and a configuration may be at most 2x (max) and 1.5x (mean) as
# far from float32 as the cuDNN bf16 forward is. A wrong tap, channel or
# border in one conv moves eps by tens of percent.
FWD_MAX_REL, FWD_MEAN_REL = 0.04, 0.02
FWD_F32_RATIO_MAX, FWD_F32_RATIO_MEAN = 2.0, 1.5
CUDNN_ENV = {"DGMSR_PALLAS_FUSED": "0", "DGMSR_PALLAS_TAIL": "0"}
# The served uint8 images (phase 3) of each configuration against the
# default's and against the cuDNN bf16 serve's, same noise. On the CPU (ddim20
# eta 1, B=2, 128x128 and 256x256 HR) the mean |diff| was 0.11-0.13 levels
# and the 99.9th percentile 3 (4 against float32); the max grew with the
# image (8-13 at 128x128, 19-31 at 256x256): a few pixels where the clamp of
# x0 to [-1, 1] or the uint8 rounding flips early in the chain. So the mean
# and the 99.9th percentile are bounded, at about 4x and 2.5x of that, and
# the max is reported.
UINT8_MEAN_MAX, UINT8_P999_MAX = 0.5, 8
# Flash attention against its plain version, relative to max |plain| alone
# (outputs are convex mixes of v). bf16: the kernel rounds p to bf16 against
# the running max of each 128-key tile, the plain version against the row max.
FLASH_SHAPE = (2, 1024, 8, 128)  # (B, L, H, D): CFG batch, level-3 tokens at LR 256, 8 heads of 128
FLASH_F32_SHAPES = ((1, 1089, 8, 128), (2, 1024, 4, 64), (1, 70, 2, 64))  # ragged L, D=64, one short tile
# bf16 beyond the main shape, (B, Lq, Lk, H, D, logit scale): ragged L (LR 264),
# D = 64, Lq != Lk both ways, and logits x8 (q scaled), whose running max
# moves from tile to tile
FLASH_BF16_CASES = ((1, 1089, 1089, 8, 128, 1), (2, 1024, 1024, 4, 64, 1), (1, 100, 333, 2, 64, 1),
                    (1, 333, 100, 2, 128, 1), (2, 1024, 1024, 8, 128, 8))
FLASH_ROUNDS, FLASH_CALLS = 5, 50  # kernel and SDPA timed in turns
SD_PROMPT = "a photo of a cat, high resolution, detailed"
# The kernel switches of models/layers.py, and the configurations served.
SWITCHES = ("DGMSR_PALLAS_FUSED", "DGMSR_PALLAS_STEM", "DGMSR_PALLAS_TAIL", "DGMSR_PALLAS_DS",
            "DGMSR_PALLAS_HEAD", "DGMSR_PALLAS_CONV", "DGMSR_CHAIN_C")
CONFIGS = {
    "default": {},
    "A": {"DGMSR_PALLAS_DS": "1", "DGMSR_PALLAS_HEAD": "1"},
    "B": {"DGMSR_PALLAS_FUSED": "0", "DGMSR_PALLAS_TAIL": "0", "DGMSR_PALLAS_CONV": "1"},
    "C": {"DGMSR_CHAIN_C": "64,128,192,256"},
}
# Launches per 20-step batch of the full-width model: a UNet call runs the
# stem, chain and tail regions once each by default; under A the stem with
# the Downsample folded in, the head-fused chain and the tail; under B seven
# C->C Block convs (3 in down stage 0, 3 in the last up stage, the final
# Block) and no region; under C the stem, the tail and seven chains (down
# stages 1-3, the mid pair, up stages 0-2). block_chain3_c<C> counts the
# chain's launches at width C; <wrapper>_wgmma counts a wrapper's calls on
# the warpgroup-MMA conv core: conv3x3's bf16 C = 64 kernel, the chain
# regions whose bf16 chain runs there (every stem, stem_ds and head call,
# and block_chain3's at C = 64, 128, 192 and 256) and the bf16 tail;
# ds_wgmma and head_wgmma count the bf16 Downsample and head launches on the
# core (csrc/head_ds_wgmma.cu, ``EXTRA_COUNTERS``).
SERVE_LAUNCHES = {
    "default": {"block_chain3_stem": 20, "block_chain3_stem_wgmma": 20, "block_chain3": 20,
                "block_chain3_wgmma": 20, "block_chain3_c64": 20, "tail_fuse": 20, "tail_fuse_wgmma": 20},
    "A": {"block_chain3_stem_ds": 20, "block_chain3_stem_ds_wgmma": 20, "block_chain3_head": 20,
          "block_chain3_head_wgmma": 20, "ds_wgmma": 20, "head_wgmma": 20, "tail_fuse": 20, "tail_fuse_wgmma": 20},
    "B": {"conv3x3": 140, "conv3x3_wgmma": 140},
    "C": {"block_chain3_stem": 20, "block_chain3_stem_wgmma": 20, "block_chain3": 140, "block_chain3_wgmma": 140,
          "block_chain3_c64": 20, "block_chain3_c128": 40, "block_chain3_c192": 40, "block_chain3_c256": 40,
          "tail_fuse": 20, "tail_fuse_wgmma": 20},
}
# The bf16 C = 64 kernels on the conv core (conv3x3 and the chain of rows 1,
# 2, 4 and 5) also at every edge of its 2-row x 64-pixel tiles: W one pixel
# short of, at and past a tile (and two tiles), H at the reflect minimum,
# odd and ragged, one image and three. The tail takes them as its input's
# (B, H, W): the ConvT's tiles are 2 input rows x 64 input pixels, the
# 3x3's then run over (2H, 2W).
CONV64_EDGES = [(b, h, w) for b in (1, 3) for h in (2, 3, 17) for w in (3, 63, 64, 65, 130)]
# Counters of one launch inside a region wrapper, read as <key>: (wrapper,
# attribute): the bf16 Downsample and head on the conv core; row 8's
# launches by route.
EXTRA_COUNTERS = {"ds_wgmma": ("block_chain3_stem_ds", "launches_ds_wgmma"),
                  "head_wgmma": ("block_chain3_head", "launches_head_wgmma"),
                  "fused_group_norm_resident": ("fused_group_norm", "launches_resident"),
                  "fused_group_norm_streamed": ("fused_group_norm", "launches_streamed")}
CORE_REGIONS = ("stem", "stem_ds", "chain", "chain_cond", "head")
# The wide chain's shapes on C's path at batch 8, 512x512 HR (B, C, H, W)
# and its launches there a batch: down stage 1 and up stage 1 at C = 128,
# down stage 2 and up stage 0 at 192, down stage 3 and the mid pair at 256.
WIDE_SHAPES = ((8, 128, 256, 256), (8, 128, 128, 128), (8, 192, 128, 128), (8, 192, 64, 64), (8, 256, 64, 64))
WIDE_LAUNCHES = {(128, 256, 256): 20, (128, 128, 128): 20, (192, 128, 128): 20, (192, 64, 64): 20,
                 (256, 64, 64): 40}
WIDE_F32_WIDTHS = (32, 96, 128, 192, 256)  # on a ragged (2, C, 13, 21); 32 is the resident kernel's
# The bf16 chain widths on the wide core, each also at the conv core's tile
# edges (CONV64_EDGES), with and without the condition.
WIDE_CORE_WIDTHS = (128, 192, 256)
# The serving paths over the HR-pixel budget (default 2,097,152 = 8 x 512^2,
# ``core/config.py``), at the default configuration: a batch of 9 at 128x128
# LR is served in sub-batches of 8 (the last one padded to 8 by repeating
# its final image); one 384x384 LR image (1536^2 HR) goes to feathered tiles
# of ``infer_patch_size`` with ``infer_patch_overlap``, served as a batch in
# sub-batches of 8. Each sub-batch is one ddim20 serve: SERVE_LAUNCHES
# ["default"] each.
SERVE_LR, BUDGET_BATCH, TILED_LR = 128, 9, 384
# Encoder propagation on the ddim20 serve, (configuration, K): an encode at
# the first step of each group of K and at each step of the remainder K
# does not divide, and a decode at every step. The encode runs down stage
# 0's region (the stem; under A the stem with the Downsample and its launch
# on the core), the decode the last up stage's (the chain; under A the
# head) and the tail.
ENCPROP_RUNS = (("default", 2), ("default", 3), ("A", 2))
ENCODE_COUNTERS = {"default": ("block_chain3_stem", "block_chain3_stem_wgmma"),
                   "A": ("block_chain3_stem_ds", "block_chain3_stem_ds_wgmma", "ds_wgmma")}


def encprop_launches(cfg: str, k: int, steps: int = 20) -> dict:
    """The launches of one encoder-propagation serve of ``steps`` steps."""
    encodes = steps // k + steps % k
    return {key: encodes if key in ENCODE_COUNTERS[cfg] else n * steps // 20
            for key, n in SERVE_LAUNCHES[cfg].items()}


# The SD serve's options at LR 256: encoder propagation at K = 2, and a
# negative prompt (K = 1).
SD_LR, SD_ENC_INTERVAL, SD_NEGATIVE = 256, 2, "blurry, low quality, jpeg artifacts"
# The SD path's GroupNorm shapes: a UNet level-0 ResBlock at LR 256 (CFG
# batch 2) and the VAE decoder's last up block at 1024x1024.
GN_SHAPES = (((2, 256, 256, 256), 1e-5), ((1, 128, 1024, 1024), 1e-6))
GN_F32_SHAPES = (((2, 64, 13, 7), 32), ((2, 256, 16, 16), 32), ((1, 64, 128, 128), 32), ((1, 48, 33, 31), 16))
GN_SWEEP_LRS = (256, 128)  # the SD serves whose GroupNorm calls make the sweep
GN_STEPS = 20  # DDIM steps of one SD serve


def sd_group_norm_calls(lr: int, steps: int = GN_STEPS, unet_cfg: dict | None = None,
                        vae_cfg: dict | None = None) -> dict:
    """{(shape, groups, eps, act): calls} of the ``nn.GroupNorm`` modules in
    one SD x4 serve of one LR ``lr``-square image under guidance: ``steps``
    UNet calls on the CFG batch of 2 at latent ``lr``, then one VAE decode.
    Counted by ``hooked_group_norm_calls`` on one UNet forward (times
    ``steps``) and one decode of the modules built from the configs (the
    published ones by default) on the meta device, where nothing is
    allocated or computed; the attention there is the plain one, whose
    shapes are flash's."""
    from collections import Counter
    from unittest import mock

    import torch

    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_UNET_CONFIG, X4_VAE_CONFIG
    from dgm_img_super_resolution_tpu_torch.models.sd import attention
    from dgm_img_super_resolution_tpu_torch.models.sd.unet import UNet2DCondition
    from dgm_img_super_resolution_tpu_torch.models.sd.vae import AutoencoderKL

    ucfg, vcfg = unet_cfg or X4_UNET_CONFIG, vae_cfg or X4_VAE_CONFIG
    with torch.device("meta"), mock.patch.object(attention, "flash_attention", attention.attention):
        unet, vae = UNet2DCondition(ucfg), AutoencoderKL(vcfg)
        x = torch.empty(2, ucfg["in_channels"], lr, lr)
        t = torch.zeros(2, dtype=torch.long)
        ctx = torch.empty(2, 77, ucfg["cross_attention_dim"])
        per_call = hooked_group_norm_calls([unet], lambda: unet(x, t, ctx, t))
        calls = Counter({key: steps * n for key, n in per_call.items()})
        z = torch.empty(1, vcfg["latent_channels"], lr, lr)
        calls.update(hooked_group_norm_calls([vae], lambda: vae.decode(z)))
    return dict(calls)


def hooked_group_norm_calls(modules, run) -> dict:
    """{(shape, groups, eps, act): calls} of every ``nn.GroupNorm`` inside
    ``modules`` while ``run()`` runs, counted by forward hooks (removed
    after); ``act`` is "silu" where SiLU follows the norm (the ResBlocks'
    and the output norms), None for the attentions' (``attention.py``
    Transformer2D, ``vae.py`` VAEAttention), from the module holding it."""
    from collections import Counter

    import torch.nn as nn

    from dgm_img_super_resolution_tpu_torch.models.sd.attention import Transformer2D
    from dgm_img_super_resolution_tpu_torch.models.sd.vae import VAEAttention

    acts = {}
    for m in modules:
        for parent in m.modules():
            for child in parent.children():
                if isinstance(child, nn.GroupNorm):
                    acts[child] = None if isinstance(parent, (Transformer2D, VAEAttention)) else "silu"
    calls = Counter()

    def hook(mod, inputs, output):
        calls[(tuple(inputs[0].shape), mod.num_groups, mod.eps, acts[mod])] += 1

    handles = [gn.register_forward_hook(hook) for gn in acts]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return dict(calls)


def gn_sweep() -> list[tuple[tuple, int, float, str | None, dict]]:
    """Every distinct (shape, groups, eps, act) of the SD serves at
    ``GN_SWEEP_LRS``, with its calls per serve at each LR; largest first."""
    per_lr = {lr: sd_group_norm_calls(lr) for lr in GN_SWEEP_LRS}
    keys = sorted({key for calls in per_lr.values() for key in calls},
                  key=lambda key: (-key[0][0] * key[0][1] * key[0][2] * key[0][3], str(key)))
    return [(*key, {f"lr{lr}": per_lr[lr].get(key, 0) for lr in GN_SWEEP_LRS}) for key in keys]


@contextlib.contextmanager
def switches(**env):
    """Set the kernel switches (and unset the others) for the block; restore
    them after."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph and
    replayed, so that the host's launch overhead (some 12-20 us a call
    through Python, more than half of what flash takes) is not counted."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fn_a, fn_b, timer) -> tuple[list[float], list[float]]:
    """``FLASH_ROUNDS`` readings of ``timer(fn, iters=FLASH_CALLS)`` for each
    of two functions, taken in turns (a b a b ...), so that both see the
    same clocks and the same neighbours on the card."""
    a, b = [], []
    for _ in range(FLASH_ROUNDS):
        a.append(timer(fn_a, iters=FLASH_CALLS))
        b.append(timer(fn_b, iters=FLASH_CALLS))
    return a, b


def median(xs):
    return sorted(xs)[len(xs) // 2]


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max(1, max |b|)); the larger of each over the
    parts of a tuple result."""
    if isinstance(a, tuple):
        errs = [rel_err(x, y) for x, y in zip(a, b)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(1.0, b.float().abs().max().item())


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


class Regions:
    """Random inputs for the SRDiff kernels (rows 1-6) at one HR shape and
    dtype, with their FLOP and byte counts."""

    def __init__(self, b, h, w, dtype, device, seed=0):
        import torch

        g = torch.Generator().manual_seed(seed)
        c = 64
        self.dtype = dtype

        def act(*shape, scale=1.0):
            t = torch.randn(shape, generator=g) * scale
            return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)

        def param(*shape, fan_in=None, scale=None):
            s = scale if scale is not None else 1.0 / fan_in**0.5
            return (torch.randn(shape, generator=g) * s).to(device)

        def vec(*shape, scale):
            return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dtype)

        convw = lambda: param(c, c, 3, 3, fan_in=9 * c)  # noqa: E731
        bias = lambda: param(c, scale=0.1)  # noqa: E731
        esize = torch.finfo(dtype).bits // 8
        # block_chain3_stem at (b, h, w)
        self.stem = (act(b, 3, h, w), param(c, 3, 3, 3, fan_in=27), bias(), param(c, 3, 1, 1, fan_in=3),
                     bias(), vec(b, c, scale=0.5), vec(b, c, scale=0.5), convw(), bias(), convw(), bias(),
                     convw(), bias(), act(b, c, h, w))
        self.stem_work = (2.0 * b * h * w * (27 * c + 3 * c + 27 * c * c),
                          esize * b * h * w * (3 + 2 * c) + 4 * (30 * c + 27 * c * c))
        # block_chain3 at (b, h/2, w/2), no cond (the last up stage)
        h2, w2 = h // 2, w // 2
        self.chain = (act(b, c, h2, w2), act(b, c, h2, w2), vec(b, c, scale=0.5), vec(b, c, scale=0.5),
                      convw(), bias(), convw(), bias(), convw(), bias())
        self.chain_work = (2.0 * b * h2 * w2 * 27 * c * c, esize * b * h2 * w2 * 3 * c + 4 * 27 * c * c)
        # tail_fuse: (b, c, h/2, w/2) -> (b, 3, h, w)
        self.tail = (act(b, c, h2, w2), param(c, c, 4, 4, fan_in=4 * c), bias(), convw(), bias(),
                     param(3, c, 1, 1, fan_in=c), param(3, scale=0.1))
        self.tail_work = (2.0 * b * h * w * (4 * c * c + 9 * c * c + 3 * c),
                          esize * (b * h2 * w2 * c + b * h * w * 3) + 4 * (25 * c * c + 3 * c))
        # block_chain3_stem_ds: the stem region and down stage 0's stride-2 conv
        self.stem_ds = self.stem + (convw(), bias())
        self.stem_ds_work = (self.stem_work[0] + 2.0 * b * h2 * w2 * 9 * c * c,
                             self.stem_work[1] + esize * b * h2 * w2 * c + 4 * 9 * c * c)
        # block_chain3_head at (b, h/2, w/2): x and skip of 2c channels (the last up stage)
        cs = 2 * c
        self.head = (act(b, cs, h2, w2), act(b, cs, h2, w2), param(c, 2 * cs, 3, 3, fan_in=18 * cs), bias(),
                     param(c, 2 * cs, 1, 1, fan_in=2 * cs), bias()) + self.chain[2:]
        self.head_work = (2.0 * b * h2 * w2 * (9 * 2 * cs * c + 2 * cs * c + 27 * c * c),
                          esize * b * h2 * w2 * (2 * cs + c) + 4 * (20 * cs * c + 27 * c * c))
        # conv3x3 at (b, h, w), reflect + Mish (a Block of down stage 0 under DGMSR_PALLAS_CONV)
        self.conv3x3 = (act(b, c, h, w), convw(), bias(), "reflect", True)
        self.conv3x3_work = (2.0 * b * h * w * 9 * c * c, esize * 2 * b * h * w * c + 4 * 9 * c * c)


def chain_inputs(b, c, h, w, dtype, device, seed=0, cond=False):
    """Random arguments of ``block_chain3`` at width ``c`` (a_pre, r1, tv1,
    tv2, wb, bb, wc, bc, wd, bd, cond), and its FLOP and byte counts."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def act():
        t = torch.randn(b, c, h, w, generator=g)
        return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)

    def param(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(device)

    def vec():
        return (torch.randn(b, c, generator=g) * 0.5).to(device=device, dtype=dtype)

    convs = [t for _ in range(3) for t in (param(c, c, 3, 3, scale=(9 * c) ** -0.5), param(c, scale=0.1))]
    args = (act(), act(), vec(), vec(), *convs, act() if cond else None)
    esize = torch.finfo(dtype).bits // 8
    return args, (2.0 * b * h * w * 27 * c * c, esize * b * h * w * (3 + cond) * c + 4 * 27 * c * c)


def tail_args(b, h, w, dtype, device, seed=0, cout=3):
    """Random arguments of ``tail_fuse`` (x, wt, bt, wf, bf, wo, bo) over x
    (b, 64, h, w), as ``Regions`` makes them; ``cout`` other than 3 draws
    its own 1x1 weight and bias."""
    import torch

    args = Regions(b, 2 * h, 2 * w, dtype, device, seed=seed).tail
    if cout == 3:
        return args
    g = torch.Generator().manual_seed(seed + cout)
    wo, bo = torch.randn(cout, 64, 1, 1, generator=g) / 8, torch.randn(cout, generator=g) * 0.1
    return args[:5] + (wo.to(device), bo.to(device))


def core_edge_args(region, b, h, w, device="cuda"):
    """bf16 arguments of a chain region (``CORE_REGIONS``) whose chain runs
    at (b, 64, h, w): the stem's and the chain's own shape (the chain with
    and without its condition), the head's input at that shape, the
    Downsample fold at the next even H and W (it halves them)."""
    import torch

    seed = h * w + b
    if region.startswith("chain"):
        return chain_inputs(b, 64, h, w, torch.bfloat16, device, seed=seed, cond=region == "chain_cond")[0]
    if region == "head":  # Regions makes the head at half its HR shape
        return Regions(b, 2 * h, 2 * w, torch.bfloat16, device, seed=seed).head
    if region == "stem_ds":
        h, w = h + h % 2, w + w % 2
    return getattr(Regions(b, h, w, torch.bfloat16, device, seed=seed), region)


def ptxas_report(log: str) -> list[str]:
    """One line per kernel compiled (its mangled name shortened to the
    kernel and its template arguments; registers, spills, static shared
    memory), then every "Performance Loss" warning (a serialised wgmma:
    C7518, C7514), from an ``nvcc -Xptxas -v`` log."""
    import re

    lines, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            i, ident = 3 if mangled.startswith("_ZN") else 2, mangled
            while i < len(mangled) and mangled[i].isdigit():  # the (nested) name: <length><identifier>...
                n = re.match(r"\d+", mangled[i:]).group()
                ident, i = mangled[i + len(n):i + len(n) + int(n)], i + len(n) + int(n)
            args = re.findall(r"Li(\d+)E|Lb([01])E|\d((?:Y1|H2|Out|BiasAct|Tail)(?:ILb[01]E)?)", mangled[i:])
            name = ident + "<" + ",".join(a or b or c for a, b, c in args) + ">"
        elif "spill stores" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}")
            name = None
        elif "Performance Loss" in ln or "C7518" in ln or "C7514" in ln:
            lines.append(ln.strip())
    return lines


def phase_build(out_dir):
    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {sorted(libs)}", flush=True)
    for path in libs.values():
        log = Path(f"{path}.log")
        if log.exists():
            report = ptxas_report(log.read_text())
            print("\n".join(f"  ptxas {path.name.split('-')[0]}: {ln}" for ln in report), flush=True)
            if out_dir:
                shutil.copy(log, out_dir / log.name)


KERNEL_SRC = "dgm_img_super_resolution_tpu_torch/ops/kernels/csrc/"
TPU_SRC = "dgm_img_super_resolution_tpu/ops/pallas/"


def _srdiff_kernels():
    """name -> (wrapper, plain version, Regions attribute, source, the TPU
    kernel it replaces), rows 1-6 of the kernel table."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    return {
        "block_chain3_stem": (bc.block_chain3_stem, bc.block_chain3_stem_plain, "stem",
                              KERNEL_SRC + "block_chain_wgmma.cu", TPU_SRC + "block_chain.py:733"),
        "block_chain3": (bc.block_chain3, bc.block_chain3_plain, "chain",
                         KERNEL_SRC + "block_chain_wgmma.cu", TPU_SRC + "block_chain.py:311"),
        "tail_fuse": (tf.tail_fuse, tf.tail_fuse_plain, "tail",
                      KERNEL_SRC + "tail_fuse_wgmma.cu", TPU_SRC + "tail_fuse.py:281"),
        "block_chain3_stem_ds": (bc.block_chain3_stem_ds, bc.block_chain3_stem_ds_plain, "stem_ds",
                                 KERNEL_SRC + "head_ds_wgmma.cu", TPU_SRC + "block_chain.py:733"),
        "block_chain3_head": (bc.block_chain3_head, bc.block_chain3_head_plain, "head",
                              KERNEL_SRC + "head_ds_wgmma.cu", TPU_SRC + "block_chain.py:1194"),
        "conv3x3": (k3.conv3x3, k3.conv3x3_plain, "conv3x3",
                    KERNEL_SRC + "conv3x3_wgmma.cu", TPU_SRC + "conv3x3.py:186"),
    }


def _check(label, got, want, tol, failures) -> float:
    err, rel = rel_err(got, want)
    ok = rel <= tol
    print(f"{label}: max_abs_err {err:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'} (tol {tol})", flush=True)
    if not ok:
        failures.append(label)
    return err


def _timed_row(name, kern, plain, args, work, source, replaces, failures, label, library=None) -> dict:
    """Hold a kernel against its plain version in bf16, time both (and the
    library call, if any) and return its table row."""
    err = _check(f"bf16 {name:20s} {label}", kern(*args), plain(*args), BF16_TOL, failures)
    ms = cuda_ms(lambda: kern(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = None if library is None else cuda_ms(library)
    flops, nbytes = work
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
    print(f"bf16 {name:20s} {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
          f"{'none' if library_ms is None else f'{library_ms:.3f} ms'}, bound {bound_ms:.3f} ms ({bound_by}); "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB", flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_kernels():
    """Each SRDiff kernel against its plain version; returns the table rows."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = _srdiff_kernels()
    rows, failures = [], []
    # float32 at edge shapes: batch 1 at 8x8 and 40x72, and a ragged batch 2
    # (H, W not multiples of the 8x16 tile) -- the sizes are the HR sizes.
    for b, h, w in ((1, 8, 8), (1, 40, 72), (2, 26, 38)):
        r = Regions(b, h, w, torch.float32, "cuda", seed=h * w)
        for name, (kern, plain, attr, *_rest) in fns.items():
            args = getattr(r, attr)
            _check(f"f32  {name:20s} B={b} {h}x{w}", kern(*args), plain(*args), F32_TOL, failures)
    # conv3x3 also at C = 32, with the zero border, at odd H and W
    g = torch.Generator().manual_seed(5)
    for c, (b, h, w), border, act in ((32, (2, 13, 21), "reflect", True), (32, (1, 9, 40), "zero", False),
                                      (64, (2, 17, 7), "zero", True), (64, (1, 2, 3), "reflect", False)):
        x = torch.randn(b, c, h, w, generator=g).cuda().contiguous(memory_format=torch.channels_last)
        wc, bc_ = torch.randn(c, c, 3, 3, generator=g).cuda() / (3 * c**0.5), torch.randn(c, generator=g).cuda()
        _check(f"f32  conv3x3 C={c} {border} mish={act} B={b} {h}x{w}", k3.conv3x3(x, wc, bc_, border, act),
               k3.conv3x3_plain(x, wc, bc_, border, act), F32_TOL, failures)
    # the chain at the other widths: C = 32 on the resident kernel, 96-256 on
    # the wide one (NB = 32 at 96), with the condition, on a ragged shape
    for c in WIDE_F32_WIDTHS:
        args, _ = chain_inputs(2, c, 13, 21, torch.float32, "cuda", seed=c, cond=True)
        _check(f"f32  block_chain3 C={c} cond B=2 13x21", bc.block_chain3(*args), bc.block_chain3_plain(*args),
               F32_TOL, failures)
    # bf16 at C = 96 stays on the wide kernel (chain_wide.cu), off the core
    args, _ = chain_inputs(2, 96, 13, 21, torch.bfloat16, "cuda", seed=96, cond=True)
    before = bc.block_chain3.launches, bc.block_chain3.launches_wgmma
    _check("bf16 block_chain3 C=96 cond B=2 13x21", bc.block_chain3(*args), bc.block_chain3_plain(*args),
           BF16_TOL, failures)
    if (bc.block_chain3.launches - before[0], bc.block_chain3.launches_wgmma - before[1]) != (1, 0):
        failures.append("bf16 block_chain3 at C = 96 did not run chain_wide.cu")
    # bf16 at the main path's shapes
    r = Regions(8, 512, 512, torch.bfloat16, "cuda", seed=1)
    for name, (kern, plain, attr, source, replaces) in fns.items():
        # the regions' plain versions are compositions of cuDNN calls and
        # elementwise ops: no single PyTorch call computes one; conv3x3's
        # yardstick is set by _conv3x3_extra
        rows.append(_timed_row(name, kern, plain, getattr(r, attr), getattr(r, f"{attr}_work"), source, replaces,
                               failures, "main shape"))
    _chain_pieces(r, {row["name"]: row for row in rows}, failures)
    _head_ds_pieces(r, {row["name"]: row for row in rows}, failures)
    _tail_pieces(r, next(row for row in rows if row["name"] == "tail_fuse"), failures)
    del r
    torch.cuda.empty_cache()
    _core_edges(failures)
    _head_ds_edges(failures)
    _tail_edges(failures)
    _wide_core_edges(failures)
    _conv3x3_extra(next(row for row in rows if row["name"] == "conv3x3"), failures)
    # the wide chain at configuration C's shapes (row 2's wide mode), on the
    # wide core: an h1 pass (also timed alone) and three conv launches; and
    # chain_wide.cu's three launches on the same inputs (``chain_wide_ms``)
    for b, c, h, w in WIDE_SHAPES:
        args, work = chain_inputs(b, c, h, w, torch.bfloat16, "cuda", seed=c + h)
        before = bc.block_chain3.launches_wgmma
        row = _timed_row(f"block_chain3_c{c}_{h}x{w}", bc.block_chain3, bc.block_chain3_plain, args, work,
                         KERNEL_SRC + "block_chain_wgmma.cu", TPU_SRC + "block_chain.py:311", failures,
                         str((b, c, h, w)))
        if bc.block_chain3.launches_wgmma == before:
            failures.append(f"bf16 block_chain3 {(b, c, h, w)} did not run on the conv core")
        a_pre, _, tv1 = args[:3]
        h1_ms = cuda_ms(lambda: bc._launch_h1(a_pre, tv1))
        h1_bound, _ = bound(8.0 * a_pre.numel(), 2 * 2 * a_pre.numel() + 4 * tv1.numel(), PEAK_F32)
        # the kernel this shape ran before the core took it, on the same inputs
        wide_err = _check(f"bf16 chain_wide.cu {(b, c, h, w)}", bc._launch_chain(*args), bc.block_chain3_plain(*args),
                          BF16_TOL, failures)
        wide_ms = cuda_ms(lambda: bc._launch_chain(*args))
        print(f"bf16 {(b, c, h, w)}: h1 piece {h1_ms:.4f} ms (bound {h1_bound:.4f} ms, bytes); chain_wide.cu "
              f"{wide_ms:.3f} ms", flush=True)
        rows.append(dict(row, shape=[b, c, h, w], sources=[KERNEL_SRC + "block_chain_wgmma.cu",
                                                           KERNEL_SRC + "conv_wgmma_wide.cuh"],
                         h1_ms=h1_ms, h1_bound_ms=h1_bound, chain_wide_ms=wide_ms, chain_wide_max_abs_err=wide_err))
        del args, a_pre, tv1
    torch.cuda.empty_cache()
    return rows, failures


def _chain_pieces(r, rows, failures):
    """The front pieces of the chain's route onto the conv core, each
    checked against its plain version and timed alone at the main path's
    shapes: the stem launch writing (h1, r1) at (8, 3, 512, 512) (rows 1 and
    4, ``stem_ms``) and the h1 pass over an a_pre made outside the chain at
    (8, 64, 256, 256) (rows 2 and 5, ``h1_ms``). Both are bound by their
    bytes."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    x, wa, ba, wr, br, tv1 = r.stem[:6]
    b, _, h, w = x.shape
    a_pre, _, tv1_c = r.chain[:3]
    # operations: the stem's 30 multiply-adds an output channel, and about 8
    # float32 operations an element for Mish and the time-vector add (the h1
    # pass's only work); bytes: bf16 activations, float32 weights and tv1
    pieces = {
        "stem": (lambda: bc._launch_stem(x, wa, ba, wr, br, tv1), lambda: bc.stem_h1_plain(x, wa, ba, wr, br, tv1),
                 tuple(x.shape), (2.0 * b * h * w * 30 * 64 + 8.0 * b * h * w * 64,
                                  2 * b * h * w * (3 + 2 * 64) + 4 * (32 * 64 + b * 64)),
                 ("block_chain3_stem", "block_chain3_stem_ds")),
        "h1": (lambda: bc._launch_h1(a_pre, tv1_c), lambda: bc.h1_plain(a_pre, tv1_c), tuple(a_pre.shape),
               (8.0 * a_pre.numel(), 2 * 2 * a_pre.numel() + 4 * tv1_c.numel()), ("block_chain3", "block_chain3_head")),
    }
    for piece, (kern, plain, shape, (flops, nbytes), names) in pieces.items():
        err = _check(f"bf16 {piece + ' piece':20s} {shape}", kern(), plain(), BF16_TOL, failures)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        print(f"bf16 {piece + ' piece':20s} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB", flush=True)
        for name in names:
            rows[name].update({f"{piece}_ms": ms, f"{piece}_plain_ms": plain_ms, f"{piece}_bound_ms": bound_ms,
                               f"{piece}_max_abs_err": err})


def head_piece_args(b, cs, h, w, device="cuda", seed=0):
    """Random bf16 arguments of the head launch (x, skip, wa, ba, wr, br,
    tv1) with C_s = ``cs`` input channels from each source and 64 outputs,
    as ``Regions`` makes them."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def act():
        t = torch.randn(b, cs, h, w, generator=g)
        return t.to(device=device, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def param(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(device)

    return (act(), act(), param(64, 2 * cs, 3, 3, scale=(18 * cs) ** -0.5), param(64, scale=0.1),
            param(64, 2 * cs, 1, 1, scale=(2 * cs) ** -0.5), param(64, scale=0.1),
            param(b, 64, scale=0.5).to(torch.bfloat16))


def _head_ds_pieces(r, rows, failures):
    """The two launches that this route runs on the conv core from
    ``csrc/head_ds_wgmma.cu``, each checked against its plain piece and
    timed alone at the main path's shapes beside its bound, its plain
    piece, ``block_chain.cu``'s streamed conv on the same inputs (its route
    before, ``*_stream_ms``) and the PyTorch calls that compute the same
    function (``*_library_ms``, in turns, 5 rounds of 50 calls): the
    Downsample over the chain's output (8, 64, 512, 512) (row 4,
    ``ds_ms``), against ``F.conv2d`` over ``F.pad(..., "reflect")`` at
    stride 2; the head writing h1 and r1 from x and skip (8, 128, 256, 256)
    (row 5, ``head_ms``), against the two ``F.conv2d`` over the
    reflect-padded ``torch.cat([x, skip])`` (3x3 with its bias, 1x1 with
    its), which stop at a_pre and r1. The head's old route also needs the
    h1 pass (``h1_ms``), counted in its ``head_stream_ms``."""
    import torch
    import torch.nn.functional as F

    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    g = torch.Generator(device="cuda").manual_seed(3)
    out = torch.randn(r.stem[0].shape[:1] + (64,) + r.stem[0].shape[2:], device="cuda", generator=g)
    out = out.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)  # the chain's output
    wds, bds = r.stem_ds[-2:]
    x, skip, wa, ba, wr, br, tv1 = r.head[:7]
    b, cs, h, w = x.shape  # the head's shape, and the Downsample's output
    dt = torch.bfloat16
    wds16, bds16 = wds.to(dt), bds.to(dt)
    wa16, ba16, wr16, br16 = wa.to(dt), ba.to(dt), wr.to(dt), br.to(dt)

    def head_stream():
        a_pre, r1 = bc._launch_head(x, skip, wa, ba, wr, br)
        return bc._launch_h1(a_pre, tv1), r1

    def head_library():
        xs = torch.cat([x, skip], dim=1)
        return F.conv2d(F.pad(xs, (1, 1, 1, 1), mode="reflect"), wa16, ba16), F.conv2d(xs, wr16, br16)

    pieces = {
        "ds": (lambda: bc._launch_ds(out, wds, bds), lambda: bc.ds_plain(out, wds, bds),
               lambda: _stream_ds(out, wds, bds),
               lambda: F.conv2d(F.pad(out, (1, 1, 1, 1), mode="reflect"), wds16, bds16, stride=2),
               (2.0 * b * h * w * 9 * 64 * 64, 2 * (out.numel() + b * h * w * 64) + 2 * 9 * 64 * 64 + 4 * 64),
               "block_chain3_stem_ds", tuple(out.shape)),
        "head": (lambda: bc._launch_head(x, skip, wa, ba, wr, br, tv1),
                 lambda: bc.head_h1_plain(x, skip, wa, ba, wr, br, tv1), head_stream, head_library,
                 (2.0 * b * h * w * (9 * 2 * cs * 64 + 2 * cs * 64),
                  2 * (2 * x.numel() + 2 * b * h * w * 64) + 2 * 10 * 2 * cs * 64 + 4 * (2 * 64 + b * 64)),
                 "block_chain3_head", tuple(x.shape)),
    }
    for piece, (kern, plain, stream, library, (flops, nbytes), name, shape) in pieces.items():
        err = _check(f"bf16 {piece + ' piece':20s} {shape}", kern(), plain(), BF16_TOL, failures)
        stream_err = _check(f"bf16 {piece + ' block_chain.cu':20s} {shape}", stream(), plain(), BF16_TOL, failures)
        ks, ls = time_in_turns(kern, library, cuda_ms)
        ms, library_ms = median(ks), median(ls)
        plain_ms, stream_ms = cuda_ms(plain), cuda_ms(stream)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        print(f"bf16 {piece + ' piece':20s} {shape}: kernel {ms:.4f} ms ({min(ks):.4f}-{max(ks):.4f}), library "
              f"{library_ms:.4f} ms ({min(ls):.4f}-{max(ls):.4f}) in turns, plain {plain_ms:.4f} ms, "
              f"block_chain.cu {stream_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB", flush=True)
        rows[name].update({f"{piece}_ms": ms, f"{piece}_plain_ms": plain_ms, f"{piece}_bound_ms": bound_ms,
                           f"{piece}_bound_by": bound_by, f"{piece}_library_ms": library_ms,
                           f"{piece}_stream_ms": stream_ms, f"{piece}_max_abs_err": err,
                           f"{piece}_stream_max_abs_err": stream_err, f"{piece}_ms_rounds": ks,
                           f"{piece}_library_ms_rounds": ls,
                           "sources": [KERNEL_SRC + "block_chain_wgmma.cu", KERNEL_SRC + "head_ds_wgmma.cu"]})


def _stream_ds(out, wds, bds):
    """``block_chain.cu``'s streamed stride-2 conv over bf16 ``out``: the
    Downsample's route before the conv core took it (timed beside it)."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    b, c, h, w = out.shape
    ds = torch.empty((b, c, h // 2, w // 2), dtype=out.dtype, device=out.device, memory_format=torch.channels_last)
    fn = bc.function("block_chain", "dgmsr_stem_ds", 4, 3)
    rc = fn(K.dtype_code(out), out.data_ptr(), bc.stream_taps(wds, out.dtype).data_ptr(),
            K.f32(bds, out.dtype).data_ptr(), ds.data_ptr(), b, h, w, K.stream_ptr())
    K.raise_on_error(rc, "block_chain.cu Downsample")
    return ds


def _tail_pieces(r, row, failures):
    """The bf16 tail beyond its main-shape row: the row's call must have run
    on the conv core; ``tail_fuse.cu``'s tiled conv, its route before the
    core took it, on the same inputs (``tile_ms``); and the core route's two
    launches alone against their plain pieces, each timed with its bound:
    the ConvT writing y (``convt_ms``) and the 3x3 + Mish + 1x1 over y
    (``conv_1x1_ms``)."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    x, wt, bt, wf, bf, wo, bo = r.tail
    before = tf.tail_fuse.launches_wgmma
    tf.tail_fuse(*r.tail)
    if tf.tail_fuse.launches_wgmma != before + 1:
        failures.append("bf16 tail_fuse at the main shape did not run on the conv core")
    row["tile_max_abs_err"] = _check(f"bf16 {'tail_fuse.cu':20s} {tuple(x.shape)}", tf._launch_tile(*r.tail),
                                     tf.tail_fuse_plain(*r.tail), BF16_TOL, failures)
    row["tile_ms"] = cuda_ms(lambda: tf._launch_tile(*r.tail))
    y = tf.convt_plain(x, wt, bt)
    b, c, h2, w2 = y.shape
    cout = wo.shape[0]
    pieces = {
        "convt": (lambda: tf._launch_convt(x, wt, bt), lambda: tf.convt_plain(x, wt, bt),
                  (2.0 * b * h2 * w2 * 4 * c * c, 2 * (x.numel() + y.numel()) + 2 * 16 * c * c + 4 * c)),
        "conv_1x1": (lambda: tf._launch_conv_mish_1x1(y, wf, bf, wo, bo),
                     lambda: tf.conv_mish_1x1_plain(y, wf, bf, wo, bo),
                     (2.0 * b * h2 * w2 * (9 * c * c + c * cout),
                      2 * (y.numel() + b * h2 * w2 * cout) + 2 * 9 * c * c + 4 * (c + c * cout + cout))),
    }
    for piece, (kern, plain, (flops, nbytes)) in pieces.items():
        err = _check(f"bf16 {piece + ' piece':20s} {tuple(x.shape if piece == 'convt' else y.shape)}", kern(),
                     plain(), BF16_TOL, failures)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        print(f"bf16 {piece + ' piece':20s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB", flush=True)
        row.update({f"{piece}_ms": ms, f"{piece}_plain_ms": plain_ms, f"{piece}_bound_ms": bound_ms,
                    f"{piece}_max_abs_err": err})
    print(f"bf16 tail_fuse {tuple(x.shape)}: conv core {row['ms']:.4f} ms (ConvT {row['convt_ms']:.4f} + 3x3 and "
          f"1x1 {row['conv_1x1_ms']:.4f}), tail_fuse.cu {row['tile_ms']:.4f} ms", flush=True)


def _tail_edges(failures):
    """The bf16 tail at every ``CONV64_EDGES`` shape of its input against its
    plain version, every call on the conv core; then a float32 tail and a
    bf16 tail with 12 outputs, which must run ``tail_fuse.cu`` (counted in
    ``launches``, not ``launches_wgmma``), against theirs."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    worst, before = 0.0, tf.tail_fuse.launches_wgmma
    for b, h, w in CONV64_EDGES:
        args = tail_args(b, h, w, torch.bfloat16, "cuda", seed=h * w + b)
        _, rel = rel_err(tf.tail_fuse(*args), tf.tail_fuse_plain(*args))
        worst = max(worst, rel)
        if rel > BF16_TOL:
            failures.append(f"bf16 tail at the core's tile edge B={b} {h}x{w}: rel {rel:.3e}")
    torch.cuda.synchronize()
    calls = tf.tail_fuse.launches_wgmma - before
    if calls != len(CONV64_EDGES):
        failures.append(f"bf16 tail at the tile edges: {calls} calls on the conv core")
    print(f"bf16 tail at the conv core's {len(CONV64_EDGES)} tile-edge shapes: worst rel err {worst:.3e} "
          f"(tol {BF16_TOL}); calls on the core {calls}", flush=True)
    for dtype, cout, tol in ((torch.float32, 3, F32_TOL), (torch.bfloat16, 12, BF16_TOL)):
        args = tail_args(2, 17, 65, dtype, "cuda", seed=cout, cout=cout)
        before = tf.tail_fuse.launches, tf.tail_fuse.launches_wgmma
        _check(f"{str(dtype)[6:]:4s} tail_fuse.cu cout={cout} B=2 17x65", tf.tail_fuse(*args),
               tf.tail_fuse_plain(*args), tol, failures)
        counted = tf.tail_fuse.launches - before[0], tf.tail_fuse.launches_wgmma - before[1]
        if counted != (1, 0):
            failures.append(f"{dtype} tail with cout={cout}: counters {counted}, expected (+1, +0)")


def _core_edges(failures):
    """Each chain region in bf16 at every ``CONV64_EDGES`` shape against its
    plain version; every call must run its chain on the conv core, and the
    Downsample fold's and the head's their Downsample or head too."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    fns = {"stem": (bc.block_chain3_stem, bc.block_chain3_stem_plain),
           "stem_ds": (bc.block_chain3_stem_ds, bc.block_chain3_stem_ds_plain),
           "chain": (bc.block_chain3, bc.block_chain3_plain), "chain_cond": (bc.block_chain3, bc.block_chain3_plain),
           "head": (bc.block_chain3_head, bc.block_chain3_head_plain)}
    worst, calls = {}, {}
    for region in CORE_REGIONS:
        kern, plain = fns[region]
        extra = {"stem_ds": "launches_ds_wgmma", "head": "launches_head_wgmma"}.get(region)
        before = kern.launches_wgmma
        before_extra = getattr(kern, extra) if extra else 0
        for b, h, w in CONV64_EDGES:
            args = core_edge_args(region, b, h, w)
            _, rel = rel_err(kern(*args), plain(*args))
            worst[region] = max(worst.get(region, 0.0), rel)
            if rel > BF16_TOL:
                failures.append(f"bf16 {region} at the core's tile edge B={b} {h}x{w}: rel {rel:.3e}")
        torch.cuda.synchronize()
        calls[region] = kern.launches_wgmma - before
        if calls[region] != len(CONV64_EDGES):
            failures.append(f"bf16 {region} at the tile edges: {calls[region]} calls on the conv core")
        if extra and getattr(kern, extra) - before_extra != len(CONV64_EDGES):
            failures.append(f"bf16 {region} at the tile edges: {getattr(kern, extra) - before_extra} {extra}")
    print(f"bf16 chain regions at the conv core's {len(CONV64_EDGES)} tile-edge shapes: worst rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {BF16_TOL}); calls on the core {calls}", flush=True)


def _head_ds_edges(failures):
    """The two launches of ``csrc/head_ds_wgmma.cu`` alone against their
    plain pieces at every edge of the conv core's tiles: the head writing
    (h1, r1) at each ``CONV64_EDGES`` shape (odd and even H and W) for each
    C_s it takes (``HEAD_CORE_WIDTHS``), and the Downsample where its output has each of
    those shapes (its input at twice them, so even)."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    worst = {}
    for b, h, w in CONV64_EDGES:
        for cs in bc.HEAD_CORE_WIDTHS:
            args = head_piece_args(b, cs, h, w, seed=h * w + b + cs)
            _, rel = rel_err(bc._launch_head(*args), bc.head_h1_plain(*args))
            worst[f"head C_s={cs}"] = max(worst.get(f"head C_s={cs}", 0.0), rel)
            if rel > BF16_TOL:
                failures.append(f"bf16 head launch C_s={cs} at the tile edge B={b} {h}x{w}: rel {rel:.3e}")
        g = torch.Generator(device="cuda").manual_seed(h * w + b)
        out = torch.randn(b, 64, 2 * h, 2 * w, device="cuda", generator=g).to(torch.bfloat16)
        out = out.contiguous(memory_format=torch.channels_last)
        wds = torch.randn(64, 64, 3, 3, device="cuda", generator=g) / 24
        bds = torch.randn(64, device="cuda", generator=g) * 0.1
        _, rel = rel_err(bc._launch_ds(out, wds, bds), bc.ds_plain(out, wds, bds))
        worst["ds"] = max(worst.get("ds", 0.0), rel)
        if rel > BF16_TOL:
            failures.append(f"bf16 Downsample launch at the tile edge B={b} {2 * h}x{2 * w}: rel {rel:.3e}")
    torch.cuda.synchronize()
    print(f"bf16 head and Downsample launches at the conv core's {len(CONV64_EDGES)} tile-edge shapes: worst rel "
          "err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {BF16_TOL})", flush=True)


def _wide_core_edges(failures):
    """The bf16 chain at C = 128, 192 and 256 at every ``CONV64_EDGES``
    shape, with and without its condition, against its plain version; every
    call must run on the conv core."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc

    worst, n = {}, 0
    before = bc.block_chain3.launches_wgmma
    for c in WIDE_CORE_WIDTHS:
        for cond in (False, True):
            for b, h, w in CONV64_EDGES:
                args = chain_inputs(b, c, h, w, torch.bfloat16, "cuda", seed=h * w + b + c, cond=cond)[0]
                _, rel = rel_err(bc.block_chain3(*args), bc.block_chain3_plain(*args))
                worst[c] = max(worst.get(c, 0.0), rel)
                n += 1
                if rel > BF16_TOL:
                    failures.append(f"bf16 chain C={c} cond={cond} at the tile edge B={b} {h}x{w}: rel {rel:.3e}")
    torch.cuda.synchronize()
    calls = bc.block_chain3.launches_wgmma - before
    if calls != n:
        failures.append(f"bf16 wide chain at the tile edges: {calls} of {n} calls on the conv core")
    print(f"bf16 wide chain at the conv core's {len(CONV64_EDGES)} tile-edge shapes, with and without cond: "
          "worst rel err " + ", ".join(f"C={k} {v:.3e}" for k, v in worst.items())
          + f" (tol {BF16_TOL}); {calls} of {n} calls on the core", flush=True)


def _conv3x3_inputs(b, h, w, seed):
    """Random bf16 (x, w, b) of conv3x3 at C = 64, as ``Regions`` makes
    them, and the call's FLOP and byte counts."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 64, h, w, generator=g).to("cuda", torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wc = (torch.randn(64, 64, 3, 3, generator=g) / 24).cuda()
    return x, wc, (torch.randn(64, generator=g) * 0.1).cuda(), (2.0 * b * h * w * 9 * 64 * 64,
                                                                  2.0 * 2 * b * h * w * 64 + 4 * 9 * 64 * 64)


def _conv3x3_extra(row, failures):
    """The bf16 C = 64 conv3x3 kernel beyond its main-shape row: its counter
    counts each such call and no other; a single non-zero tap at dx = 1 and
    2 (the A operand's descriptor starts dx pixels into a 128-byte-swizzled
    halo row) against the plain version; at the main shape its time at zero
    border without Mish (``ms_zero``) in turns with ``F.conv2d``, which
    computes that function (``library_ms``); and the row's numbers at
    configuration B's up-stage shape (8, 64, 256, 256) under ``shapes``."""
    import torch
    import torch.nn.functional as F

    from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3

    x, wc, _, _ = _conv3x3_inputs(2, 34, 130, seed=7)
    zero_b = torch.zeros(64, device="cuda")
    for dx in (1, 2):
        w1 = torch.zeros_like(wc)
        w1[:, :, 1, dx] = wc[:, :, 1, dx] * 3
        for border in ("zero", "reflect"):
            _check(f"bf16 conv3x3 one tap (dy, dx) = (1, {dx}) {border} B=2 34x130", k3.conv3x3(x, w1, zero_b, border),
                   k3.conv3x3_plain(x, w1, zero_b, border), BF16_TOL, failures)
    before = k3.conv3x3.launches, k3.conv3x3.launches_wgmma
    for t in (x, x.float(), x[:, :32].contiguous(memory_format=torch.channels_last)):
        c = t.shape[1]
        k3.conv3x3(t, wc[:c, :c], zero_b[:c], "reflect", True)
    counted = k3.conv3x3.launches - before[0], k3.conv3x3.launches_wgmma - before[1]
    print(f"conv3x3 counters over bf16 C=64, f32 C=64 and bf16 C=32 calls: launches +{counted[0]}, "
          f"launches_wgmma +{counted[1]} {'ok' if counted == (3, 1) else 'FAIL'} (expected +3, +1)", flush=True)
    if counted != (3, 1):
        failures.append(f"conv3x3 counters {counted}")
    span = lambda xs: f"{min(xs):.4f}-{max(xs):.4f}"  # noqa: E731
    row["counter"], row["shapes"] = "conv3x3_wgmma", {}
    for b, h, w in ((8, 512, 512), (8, 256, 256)):
        x, wc, bc, (flops, nbytes) = _conv3x3_inputs(b, h, w, seed=h)
        w16, b16 = wc.to(x.dtype).contiguous(memory_format=torch.channels_last), bc.to(x.dtype)
        zero = lambda: k3.conv3x3(x, wc, bc, "zero", False)  # noqa: E731
        err = _check(f"bf16 conv3x3 zero no Mish B={b} {h}x{w}", zero(), k3.conv3x3_plain(x, wc, bc, "zero", False),
                     BF16_TOL, failures)
        zs, ls = time_in_turns(zero, lambda: F.conv2d(x, w16, b16, padding=1), cuda_ms)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        shape = {"max_abs_err_zero": err, "ms_zero": median(zs), "library_ms": median(ls), "ms_zero_rounds": zs,
                 "library_ms_rounds": ls, "bound_ms": bound_ms, "bound_by": bound_by}
        if (h, w) == (512, 512):
            row.update(shape)
        else:
            served = lambda: k3.conv3x3(x, wc, bc, "reflect", True)  # noqa: E731
            shape["max_abs_err"] = _check(f"bf16 conv3x3 reflect Mish B={b} {h}x{w}", served(),
                                          k3.conv3x3_plain(x, wc, bc, "reflect", True), BF16_TOL, failures)
            shape["ms"] = cuda_ms(served)
            shape["plain_ms"] = cuda_ms(lambda: k3.conv3x3_plain(x, wc, bc, "reflect", True))
            row["shapes"][str((b, 64, h, w))] = shape
        print(f"bf16 conv3x3 B={b} {h}x{w}: zero border, no Mish {median(zs):.4f} ms ({span(zs)}), F.conv2d "
              f"{median(ls):.4f} ms ({span(ls)}) in {FLASH_ROUNDS} rounds of {FLASH_CALLS} calls in turns; "
              + (f"reflect + Mish {shape['ms']:.4f} ms, plain {shape['plain_ms']:.4f} ms; " if "ms" in shape else "")
              + f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        del x
    torch.cuda.empty_cache()


def _reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_wgmma"):
            fn.launches_wgmma = 0
    for name, attr in EXTRA_COUNTERS.values():
        setattr(counters[name], attr, 0)
    counters["block_chain3"].launches_by_shape.clear()


def _read_counts(counters) -> dict:
    """The launches of every wrapper, of block_chain3 at each width C as
    block_chain3_c<C>, a wrapper's calls on the conv core as
    <wrapper>_wgmma, and the ``EXTRA_COUNTERS``."""
    got = {name: fn.launches for name, fn in counters.items()}
    got.update({key: getattr(counters[name], attr) for key, (name, attr) in EXTRA_COUNTERS.items()})
    by_c = {}
    for (c, _, _), n in counters["block_chain3"].launches_by_shape.items():
        by_c[c] = by_c.get(c, 0) + n
    got.update({f"block_chain3_c{c}": n for c, n in sorted(by_c.items())})
    got.update({f"{name}_wgmma": fn.launches_wgmma for name, fn in counters.items() if hasattr(fn, "launches_wgmma")})
    return got


def port_kernel_names() -> tuple[str, ...]:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for src in sorted(Path(KERNEL_SRC).glob("*.cu*")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src.read_text()))
    return tuple(sorted(names))


def traced_port_kernels(run) -> dict[str, int]:
    """``run()`` under ``torch.profiler``: how many times each of the port's
    kernels ran on the card, by its ``__global__`` name. A replayed graph's
    kernels show here as an eager call's do."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(port_kernel_names()) + r")(?![A-Za-z0-9_])")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device's activity alone: quick to read
        run()
        torch.cuda.synchronize()
    out: dict[str, int] = {}
    for a in prof.key_averages():
        m = pat.search(a.key) if a.device_type == DeviceType.CUDA else None
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + a.count
    return out


def replay_trace_check(label, run, counters, failures, eager_ref=None) -> dict:
    """``run()`` (a call whose graph is captured) traced once under
    ``graphs.eager()``, where each wrapper counts where it launches, and
    once replayed, where the cache adds the capture's counts. Fails unless
    the replay ran the same port kernels as many times as the eager call,
    the cache added the counts the wrappers made, and a call that counted
    launches shows kernels in its trace. ``eager_ref`` (``{"kernels_eager":
    ..., "counts_eager": ...}``) stands for the eager call where its trace
    is too long to trust: the profiler lost 2 of the port's 1000 kernel
    records of one eager T = 100 serve (some 180k launches; its replay's
    trace had them all)."""
    from dgm_img_super_resolution_tpu_torch.core import graphs

    def eager():
        with graphs.eager():
            run()

    out = dict(eager_ref or {})
    for path, fn in (() if eager_ref else (("eager", eager),)) + (("replay", run),):
        _reset_counts(counters)
        out[f"kernels_{path}"] = traced_port_kernels(fn)
        out[f"counts_{path}"] = {k: v for k, v in _read_counts(counters).items() if v}
    ok = (out["kernels_replay"] == out["kernels_eager"] and out["counts_replay"] == out["counts_eager"]
          and bool(out["kernels_eager"]) == bool(out["counts_eager"]))
    print(f"{label}: traced port kernels a replay {out['kernels_replay']}, an eager call {out['kernels_eager']}; "
          f"counts {'as the eager call' if out['counts_replay'] == out['counts_eager'] else 'DIFFER'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{label}: a replay's traced kernels or counts are not the eager call's: {out}")
    return out


def _serve(pipe, imgs, counters):
    """One timed serve with every launch counter set to 0 just before it;
    (output, seconds, launches)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)  # the same noise in every configuration
    torch.cuda.synchronize()
    _reset_counts(counters)
    t0 = time.perf_counter()
    out = pipe.upscale_batch_device(imgs, generator=gen, as_uint8=True)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _read_counts(counters)


def _uint8_check(label, a, b, failures, max_bound=None) -> dict:
    """The uint8 differences of two serves: mean and 99.9th percentile
    bounded (``UINT8_*``), the max reported, and bounded by ``max_bound``
    where one is given."""
    import torch

    d = (a.int() - b.int()).abs()
    hist = torch.bincount(d.flatten().long(), minlength=256).cumsum(0).cpu()
    p999 = int((hist < 0.999 * d.numel()).sum())
    mean, top = d.float().mean().item(), int(d.max().item())
    ok = mean <= UINT8_MEAN_MAX and p999 <= UINT8_P999_MAX and (max_bound is None or top <= max_bound)
    print(f"{label}, uint8 output: mean |diff| {mean:.4f} (bound {UINT8_MEAN_MAX}), 99.9th percentile {p999} "
          f"(bound {UINT8_P999_MAX}), max {top}" + (f" (bound {max_bound})" if max_bound is not None else "")
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{label}: uint8 mean {mean:.4f}, p99.9 {p999}, max {top}")
    return {"mean": mean, "p999": p999, "max": top}


def phase_pipeline(rows):
    """Full-width ddim20 serve in bf16 under each configuration of the
    switches; fills the SRDiff rows' ``launches`` from the configuration
    whose path runs them."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    hp = Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype="bfloat16")
    pipe = SRDiffPipeline(hp)
    imgs = np.random.default_rng(0).integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    counters = _counters()
    failures, res, outs = [], {}, {}
    for cfg, env in dict(CONFIGS, cudnn=CUDNN_ENV).items():
        with switches(**env):
            pipe.upscale_batch_device(imgs, as_uint8=True)  # warm-up: the first call, then the capture
            torch.cuda.reset_peak_memory_stats()
            out, dt, launches = _serve(pipe, imgs, counters)
            by_shape = dict(counters["block_chain3"].launches_by_shape)
            peak, reserved = torch.cuda.max_memory_allocated() / 2**30, torch.cuda.max_memory_reserved() / 2**30
            traced = replay_trace_check(f"config {cfg}", lambda: pipe.upscale_batch_device(imgs, as_uint8=True),
                                        counters, failures)
        launches = {k: v for k, v in launches.items() if v}
        if launches != SERVE_LAUNCHES.get(cfg, {}):  # the cuDNN serve launches none of the port's kernels
            failures.append(f"config {cfg}: launches {launches}, expected {SERVE_LAUNCHES.get(cfg, {})}")
        wide = {k: v for k, v in by_shape.items() if k[0] in WIDE_CORE_WIDTHS}
        if cfg == "C" and wide != WIDE_LAUNCHES:
            failures.append(f"config C: the wide chain's launches by (C, H, W) {wide}, expected {WIDE_LAUNCHES}")
        if tuple(out.shape) != (8, 512, 512, 3) or out.dtype != torch.uint8 or not out.is_cuda:
            failures.append(f"config {cfg}: pipeline output {tuple(out.shape)} {out.dtype} {out.device}")
        for row in rows:  # each row's count from the first configuration whose path runs it
            if row["launches"] is None and "shape" in row and cfg == "C":  # the wide chain's, by shape
                row["launches"] = by_shape.get(tuple(row["shape"][1:]), 0)
                row["launches_config"] = cfg
            if row["launches"] is None and SERVE_LAUNCHES.get(cfg, {}).get(row["name"]):
                row["launches"] = launches.get(row.get("counter", row["name"]), 0)
                row["launches_config"] = cfg
                if f"{row['name']}_wgmma" in SERVE_LAUNCHES[cfg]:
                    row["launches_wgmma"] = launches.get(f"{row['name']}_wgmma", 0)
                for key, (name, attr) in EXTRA_COUNTERS.items():
                    if name == row["name"]:
                        row[attr] = launches.get(key, 0)
        outs[cfg] = out
        res[cfg] = {"img_per_s": 8 / dt, "batch8_s": dt, "launches": launches, "peak_mem_gib": peak,
                    "peak_reserved_gib": reserved, "out_mean": float(out.float().mean()), "traced": traced}
        print(f"pipeline ddim20 eta=1 bf16 B=8 128->512, config {cfg} {env}: {8 / dt:.2f} img/s "
              f"({dt:.3f} s/batch), peak {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved (the graph pools "
              f"included), launches {launches}"
              + (f", wide chain by (C, H, W) {wide}" if cfg == "C" else ""), flush=True)
    for cfg in CONFIGS:
        # bf16 rounds at other places in each configuration: the mean and
        # the 99.9th percentile of the uint8 differences are bounded
        # (UINT8_MEAN_MAX, UINT8_P999_MAX), the max reported
        for ref in ("default", "cudnn"):
            if cfg != ref:
                res[cfg][f"uint8_vs_{ref}"] = _uint8_check(f"config {cfg} vs {ref}", outs[cfg], outs[ref], failures)
    lat = []
    for _ in range(5):
        t1 = time.perf_counter()
        one = pipe.upscale_batch_device(imgs[:1])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
    if tuple(one.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(one).all()):
        failures.append("batch-1 output not finite or of the wrong shape")
    res["default"]["batch1_latency_s"] = sorted(lat)[2]
    print(f"pipeline default config, batch-1 latency {sorted(lat)[2]:.3f} s", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return res, failures


def phase_bf16_forward():
    """The served bf16 path end to end (C1): one bf16 UNet forward of the
    full-width model at the serve's shapes (x (8, 3, 512, 512) at eight
    timesteps of the ddim20 chain, cond (8, 96, 128, 128)) under each
    configuration, held against the same weights' bf16 forward with every
    region off (``CUDNN_ENV``) and their float32 forward (the same, TF32
    off), within ``FWD_MAX_REL`` / ``FWD_MEAN_REL`` and the ratio bounds."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = SRDiffPipeline(Hparams(compute_dtype="bfloat16"))
    f32 = SRDiffPipeline(Hparams(compute_dtype="float32"), params=pipe.model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(8, 3, 512, 512, device="cuda", generator=g)
    cond = torch.randn(8, 96, 128, 128, device="cuda", generator=g)
    t = torch.tensor([99, 94, 89, 64, 49, 24, 9, 4], device="cuda")
    counters = _counters()

    def forward(model, env):
        with switches(**env), torch.inference_mode():
            _reset_counts(counters)
            eps = model.model.denoise_fn(x, t, cond).float()
            torch.cuda.synchronize()
        return eps, {k: v for k, v in _read_counts(counters).items() if v}

    def dist(a, b):
        d = (a - b).abs()
        return d.max().item() / b.abs().max().item(), d.mean().item() / b.abs().mean().item()

    ref32, _ = forward(f32, CUDNN_ENV)
    ref16, launched = forward(pipe, CUDNN_ENV)
    failures, res = [], {}
    if launched:
        failures.append(f"bf16 forward with every region off launched {launched}")
    base = dist(ref16, ref32)
    print(f"bf16 UNet forward B=8 512x512, regions off (cuDNN) vs float32: max rel {base[0]:.3e}, "
          f"mean rel {base[1]:.3e}", flush=True)
    res["cudnn"] = {"vs_f32": base}
    for cfg, env in CONFIGS.items():
        eps, launched = forward(pipe, env)
        want = {k: v // 20 for k, v in SERVE_LAUNCHES[cfg].items()}
        vs16, vs32 = dist(eps, ref16), dist(eps, ref32)
        ok = (bool(torch.isfinite(eps).all()) and vs16[0] <= FWD_MAX_REL and vs16[1] <= FWD_MEAN_REL
              and vs32[0] <= FWD_MAX_REL and vs32[1] <= FWD_MEAN_REL
              and vs32[0] <= FWD_F32_RATIO_MAX * base[0] and vs32[1] <= FWD_F32_RATIO_MEAN * base[1])
        print(f"bf16 UNet forward B=8 512x512, config {cfg}: vs cuDNN bf16 max rel {vs16[0]:.3e} mean rel "
              f"{vs16[1]:.3e}; vs float32 max rel {vs32[0]:.3e} ({vs32[0] / base[0]:.2f}x cuDNN bf16's) mean rel "
              f"{vs32[1]:.3e} ({vs32[1] / base[1]:.2f}x) {'ok' if ok else 'FAIL'} (bounds {FWD_MAX_REL}, "
              f"{FWD_MEAN_REL}; {FWD_F32_RATIO_MAX}x, {FWD_F32_RATIO_MEAN}x); launches "
              f"{'ok' if launched == want else f'{launched} FAIL'}", flush=True)
        if not ok:
            failures.append(f"bf16 UNet forward config {cfg}: vs cuDNN bf16 {vs16}, vs float32 {vs32}")
        if launched != want:
            failures.append(f"bf16 UNet forward config {cfg}: launches {launched}, expected {want}")
        res[cfg] = {"vs_cudnn_bf16": vs16, "vs_f32": vs32}
    del pipe, f32
    torch.cuda.empty_cache()
    return res, failures


def _note_launches(rows, path, launches):
    """Record a path's launches on the table rows of the kernels it ran
    (rows 1-5 by name; the wide chain's rows are configuration C's)."""
    for row in rows:
        if "shape" not in row and launches.get(row["name"]):
            row.setdefault("launches_paths", {})[path] = launches[row["name"]]


def _timed_serve(pipe, imgs, counters, **kw):
    """One serve after the counters are set to 0, synchronised; (output,
    seconds, the non-zero launches)."""
    import torch

    torch.cuda.synchronize()
    _reset_counts(counters)
    t0 = time.perf_counter()
    out = pipe.upscale_batch_device(imgs, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: v for k, v in _read_counts(counters).items() if v}


def _launch_check(label, launches, want, failures):
    ok = launches == want
    print(f"{label}: launches {launches} {'ok' if ok else f'FAIL, expected {want}'}", flush=True)
    if not ok:
        failures.append(f"{label}: launches {launches}, expected {want}")


def phase_serving_paths(rows):
    """The SRDiff serving paths of the full-width bf16 ddim20 model beyond
    one batch of 8: a batch over the HR-pixel budget (sub-batches; chunk 0
    against the unchunked batch of its images with the same noise; a
    progress callback), one LR image over it (feathered tiles through
    ``upscale``), and encoder propagation (``ENCPROP_RUNS``: launches, the
    uint8 output against the same serve with every region off, img/s beside
    K = 1's; and float32 card vs CPU)."""
    import math

    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import as_noise_hook
    from dgm_img_super_resolution_tpu_torch.inference import ChunkNoise, SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.ops.image import tile_positions

    hp = Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype="bfloat16")
    pipe = SRDiffPipeline(hp)
    counters = _counters()
    failures, res = [], {}
    per_batch = SERVE_LAUNCHES["default"]

    # -- a batch over the budget
    dev, hr = pipe.device, 4 * SERVE_LR
    budget = int(hp["max_native_hr_pixels"])
    sub = budget // hr**2
    chunks = math.ceil(BUDGET_BATCH / sub)
    imgs = np.random.default_rng(9).integers(0, 256, (BUDGET_BATCH, SERVE_LR, SERVE_LR, 3), dtype=np.uint8)
    noise = ChunkNoise(lambda path, shape: as_noise_hook(
        None, shape, dev, torch.Generator(device=dev).manual_seed(100 + sum(path))))
    print(f"over-budget batch: {BUDGET_BATCH} x {SERVE_LR}^2 -> {hr}^2 under the budget {budget}: sub-batches of {sub}, "
          f"{chunks} of them; expected launches {{k: {chunks} x v}} of {per_batch}", flush=True)
    pipe.upscale_batch_device(imgs[:sub])  # warm-up
    seen = []
    out, dt, launches = _timed_serve(pipe, imgs, counters, noise=noise,
                                     progress_cb=lambda done, total: seen.append((done, total)))
    _launch_check(f"over-budget batch of {BUDGET_BATCH}", launches, {k: chunks * v for k, v in per_batch.items()},
                  failures)
    _note_launches(rows, f"batch{BUDGET_BATCH}_over_budget", launches)
    ok_out = (tuple(out.shape) == (BUDGET_BATCH, hr, hr, 3) and bool(torch.isfinite(out).all())
              and 0.0 <= float(out.min()) and float(out.max()) <= 1.0)
    dones = [d for d, _ in seen]
    ok_progress = (bool(seen) and dones == sorted(dones) and len({t for _, t in seen}) == 1
                   and seen[-1][0] == seen[-1][1] == chunks * 20)
    whole0 = pipe.upscale_batch_device(imgs[:sub], noise=noise.fold_in(0).hook((sub, 3, hr, hr)))
    err0 = (out[:sub] - whole0).abs().max().item()
    ok0 = err0 <= BF16_TOL
    print(f"over-budget batch of {BUDGET_BATCH}: {dt:.3f} s ({BUDGET_BATCH / dt:.2f} img/s), output "
          f"{tuple(out.shape)} {'ok' if ok_out else 'FAIL'}; progress {len(seen)} calls to {seen[-1] if seen else None} "
          f"{'ok' if ok_progress else 'FAIL'}; chunk 0 vs the unchunked batch of its {sub} images, same noise: "
          f"max_abs_err {err0:.3e} {'ok' if ok0 else 'FAIL'} (tol {BF16_TOL})", flush=True)
    failures += [f"over-budget batch: {what}" for what, good in
                 (("output", ok_out), ("progress", ok_progress), ("chunk 0", ok0)) if not good]
    res["over_budget"] = {"batch": BUDGET_BATCH, "sub": sub, "chunks": chunks, "s": dt, "img_per_s": BUDGET_BATCH / dt,
                          "launches": launches, "progress_calls": len(seen), "chunk0_max_abs_err": err0}
    del out, whole0

    # -- one image over the budget: feathered tiles
    patch, overlap = int(hp["infer_patch_size"]), int(hp["infer_patch_overlap"])
    n_tiles = len(tile_positions(TILED_LR, patch, patch - overlap)) ** 2
    tile_chunks = math.ceil(n_tiles / sub)
    want = {k: tile_chunks * v for k, v in per_batch.items()}
    print(f"tiled image: LR {TILED_LR}^2 -> {4 * TILED_LR}^2 ({(4 * TILED_LR) ** 2} HR px > {budget}): "
          f"{n_tiles} tiles of {patch} overlapping by {overlap}, {tile_chunks} sub-batches of {sub}; "
          f"expected launches {want}", flush=True)
    img = np.random.default_rng(10).integers(0, 256, (TILED_LR, TILED_LR, 3), dtype=np.uint8)
    torch.cuda.synchronize()
    _reset_counts(counters)
    t0 = time.perf_counter()
    sr = pipe.upscale(img)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    _launch_check(f"tiled LR {TILED_LR}^2", launches, want, failures)
    _note_launches(rows, f"tiled_lr{TILED_LR}", launches)
    ok = (sr.shape == (4 * TILED_LR, 4 * TILED_LR, 3) and bool(np.isfinite(sr).all())
          and 0.0 <= float(sr.min()) and float(sr.max()) <= 1.0)
    print(f"tiled LR {TILED_LR}^2 through upscale: {dt:.3f} s, output {sr.shape} in [{sr.min():.3f}, "
          f"{sr.max():.3f}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"tiled LR {TILED_LR}: output {sr.shape}")
    res["tiled"] = {"lr": TILED_LR, "tiles": n_tiles, "chunks": tile_chunks, "s": dt, "launches": launches}

    # -- encoder propagation
    imgs = imgs[:8]
    outs, times = {}, {}
    for k in sorted({1} | {k for _, k in ENCPROP_RUNS}):
        pipe.hp = hp.replace(enc_interval=k)
        for cfg, env in [("default", {}), ("A", CONFIGS["A"]), ("cudnn", CUDNN_ENV)]:
            if cfg != "cudnn" and (cfg, k) not in ENCPROP_RUNS and not (cfg == "default" and k == 1):
                continue
            with switches(**env):
                pipe.upscale_batch_device(imgs, as_uint8=True)  # warm-up
                out, dt, launches = _timed_serve(pipe, imgs, counters, as_uint8=True,
                                                 generator=torch.Generator(device=dev).manual_seed(0))
            outs[cfg, k], times[cfg, k] = out, dt
            if cfg == "cudnn":
                _launch_check(f"ddim20 enc_interval {k} every region off", launches, {}, failures)
            elif k > 1:
                _launch_check(f"ddim20 enc_interval {k} config {cfg}", launches, encprop_launches(cfg, k), failures)
                _note_launches(rows, f"encprop_k{k}" + ("" if cfg == "default" else f"_{cfg}"), launches)
                res[f"encprop_{cfg}_k{k}"] = {"img_per_s": 8 / dt, "launches": launches}
    for cfg, k in ENCPROP_RUNS:
        res[f"encprop_{cfg}_k{k}"]["uint8_vs_cudnn"] = _uint8_check(
            f"ddim20 enc_interval {k} config {cfg} vs every region off", outs[cfg, k], outs["cudnn", k], failures)
        if cfg == "default":  # how far the reuse moves the images from the exact chain: reported, not bounded
            d = (outs[cfg, k].int() - outs[cfg, 1].int()).abs().float()
            res[f"encprop_{cfg}_k{k}"]["uint8_vs_k1"] = {"mean": d.mean().item(), "max": int(d.max().item())}
            print(f"ddim20 enc_interval {k} config {cfg} vs enc_interval 1, uint8 output: mean |diff| "
                  f"{d.mean().item():.3f}, max {int(d.max().item())} (the reuse's approximation; reported)", flush=True)
    res["encprop_img_per_s"] = {f"{cfg}_k{k}": 8 / dt for (cfg, k), dt in times.items()}
    print(f"ddim20 eta 1 bf16 B=8 {SERVE_LR}->{hr}, img/s by enc_interval: "
          + ", ".join(f"{cfg} K={k} {8 / dt:.2f}" for (cfg, k), dt in sorted(times.items())), flush=True)
    del pipe, outs
    torch.cuda.empty_cache()

    # -- float32 card vs CPU at K = 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp32 = Hparams(sampler="ddim", sample_timesteps=4, ddim_eta=1.0, compute_dtype="float32", enc_interval=2)
    cpu = SRDiffPipeline(hp32, device="cpu")
    gpu = SRDiffPipeline(hp32, params=cpu.model.state_dict())
    g = torch.Generator().manual_seed(3)
    shape = (2, 3, 128, 128)
    ts, _ = cpu.model.ddim_timesteps(4)
    noise32 = (torch.randn(shape, generator=g), {t: torch.randn(shape, generator=g) for t in ts})
    lr = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ref = cpu.upscale_batch(lr, noise=noise32)
    for cfg in ("default", "A"):
        with switches(**CONFIGS[cfg]):
            got = gpu.upscale_batch(lr, noise=noise32)
        err = float(np.abs(got - ref).max())
        ok = err <= E2E_TOL and bool(np.isfinite(got).all())
        print(f"card vs CPU, f32 hidden64 config {cfg} ddim4 eta 1 enc_interval 2, serve B=2 32->128: max_abs_err "
              f"{err:.3e} {'ok' if ok else 'FAIL'} (tol {E2E_TOL})", flush=True)
        if not ok:
            failures.append(f"card vs CPU encprop {cfg}")
        res[f"encprop_card_vs_cpu_{cfg}"] = err
    del cpu, gpu
    torch.cuda.empty_cache()
    return res, failures


def phase_card_vs_cpu():
    """Models in float32 on the card (kernels) and on the CPU (plain
    versions), same weights: one UNet forward on the same inputs, then the
    whole serve (DDIM 4 steps, eta 1) with the same injected noise. The
    full-width model runs on the card under each configuration; a hidden-32
    model (whose C = 64 stages reach the chain kernel, whose C = 32 Blocks
    the conv3x3 kernel under DGMSR_PALLAS_CONV=1, and whose every pair the
    chain at C = 32, 64, 96 and 128 under C32) under three; a hidden-128
    model with mults 1|2 under C128 (its down stage 0 fails the stem gate
    and takes the cuDNN head and the chain at C = 128); each against one CPU
    reference per model (in float32 the CPU's result does not depend on the
    switches)."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _counters()
    chain = lambda *widths: ("block_chain3",) + tuple(f"block_chain3_c{c}" for c in widths)  # noqa: E731
    models = {
        "hidden64": ({}, {"default": ("block_chain3_stem", *chain(64), "tail_fuse"),
                          "A": ("block_chain3_stem_ds", "block_chain3_head", "tail_fuse"),
                          "B": ("conv3x3",),
                          "C": ("block_chain3_stem", *chain(64, 128, 192, 256), "tail_fuse")}),
        "hidden32": ({"hidden_size": 32}, {"default": chain(64), "conv": (*chain(64), "conv3x3"),
                                           "C32": chain(32, 64, 96, 128)}),
        "hidden128": ({"hidden_size": 128, "unet_dim_mults": "1|2"}, {"C128": chain(128, 256)}),
    }
    envs = dict(CONFIGS, conv={"DGMSR_PALLAS_CONV": "1"}, C32={"DGMSR_CHAIN_C": "32,64,96,128"},
                C128={"DGMSR_CHAIN_C": "128,256"})
    res, failures = {}, []
    for model, (over, runs) in models.items():
        hp = Hparams(sampler="ddim", sample_timesteps=4, ddim_eta=1.0, compute_dtype="float32", **over)
        cpu = SRDiffPipeline(hp, device="cpu")
        gpu = SRDiffPipeline(hp, params=cpu.model.state_dict())
        g = torch.Generator().manual_seed(2)
        shape = (2, 3, 128, 128)
        x, cond = torch.randn(shape, generator=g), torch.randn(2, 96, 32, 32, generator=g)
        t = torch.tensor([99, 33])
        imgs = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
        ts, _ = cpu.model.ddim_timesteps(4)
        noise = (torch.randn(shape, generator=g), {t_: torch.randn(shape, generator=g) for t_ in ts})
        t0 = time.perf_counter()
        with torch.inference_mode():
            eps_ref = cpu.model.denoise_fn(x, t, cond)
        ref = cpu.upscale_batch(imgs, noise=noise)
        t_cpu = time.perf_counter() - t0
        for cfg, want in runs.items():
            with switches(**envs[cfg]):
                _reset_counts(counters)
                with torch.inference_mode():
                    eps = gpu.model.denoise_fn(x.cuda(), t.cuda(), cond.cuda()).cpu()
                got = gpu.upscale_batch(imgs, noise=noise)
            launched = {k: v for k, v in _read_counts(counters).items() if v}
            eps_err, eps_rel = rel_err(eps, eps_ref)
            err = float(np.abs(got - ref).max())
            ok_eps = eps_rel <= F32_TOL
            ok = err <= E2E_TOL and bool(np.isfinite(got).all())
            ok_path = sorted(launched) == sorted(want)
            print(f"card vs CPU, f32 {model} config {cfg}: one UNet forward B=2 128x128 max_abs_err "
                  f"{eps_err:.3e} rel {eps_rel:.3e} {'ok' if ok_eps else 'FAIL'} (tol {F32_TOL}); "
                  f"serve B=2 32->128 ddim4 eta 1 max_abs_err {err:.3e} {'ok' if ok else 'FAIL'} "
                  f"(tol {E2E_TOL}); kernels launched {launched} {'ok' if ok_path else 'FAIL'} "
                  f"(CPU reference {t_cpu:.1f} s)", flush=True)
            failures += [f"card vs CPU {model} {cfg} {what}"
                         for what, good in (("UNet forward", ok_eps), ("serve", ok), ("kernel path", ok_path))
                         if not good]
            res[f"{model}_{cfg}"] = {"eps_max_abs_err": eps_err, "eps_rel_err": eps_rel, "max_abs_err": err,
                                     "launches": launched, "cpu_s": t_cpu}
        del cpu, gpu
        torch.cuda.empty_cache()
    return res, failures


GRAD_TOL = 1e-3  # card vs CPU float32 gradients, of max |CPU grad| per parameter
BACKWARD_HR = 64  # HR side of the backward phase (down stages at 64, 32, 16, 8)


def forward_launches(cfg) -> dict:
    """The launches of one float32 UNet call under ``cfg``: its share of the
    bf16 serve's (``SERVE_LAUNCHES`` / 20), less the calls on the bf16-only
    conv core."""
    return {k: v // 20 for k, v in SERVE_LAUNCHES[cfg].items() if not k.endswith("_wgmma")}


def unet_grads(unet, x, t, cond, r, counters=None):
    """With grad on, eps = unet(x, t, cond) and the gradient of sum(eps * r)
    with respect to every parameter; (eps, {name: grad}, the kernels'
    launches in the forward alone) when ``counters`` is given."""
    import torch

    unet.zero_grad(set_to_none=True)
    if counters is not None:
        _reset_counts(counters)
    with torch.enable_grad():
        eps = unet(x, t, cond)
        launched = {k: v for k, v in _read_counts(counters).items() if v} if counters is not None else None
        (eps.float() * r).sum().backward()
    return eps.detach(), {n: p.grad for n, p in unet.named_parameters()}, launched


def grad_errors(got, want) -> tuple[float, list[str]]:
    """The largest max |got - want| / max |want| over the parameters, and
    the names of those that are missing, not finite or past GRAD_TOL."""
    import torch

    worst, bad = 0.0, []
    for name, w in want.items():
        g = got.get(name)
        if g is None or not bool(torch.isfinite(g).all()):
            bad.append(name)
            continue
        rel = (g.detach().float().cpu() - w.float()).abs().max().item() / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if rel > GRAD_TOL:
            bad.append(name)
    return worst, bad


def backward_inputs(seed=5):
    """x, t, cond and the cotangent r of the backward phase, on the CPU."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hr, lr = BACKWARD_HR, BACKWARD_HR // 4
    x, cond = torch.randn(2, 3, hr, hr, generator=g), torch.randn(2, 96, lr, lr, generator=g)
    return x, torch.tensor([99, 33]), cond, torch.randn(2, 3, hr, hr, generator=g)


def phase_backward():
    """The full-width (hidden 64) UNet forward and backward in float32 on
    the card under each configuration, against the CPU's gradients on the
    same weights and inputs. The forward's launch counts are one UNet call's
    share of the serve's (``forward_launches``), so the path went through
    the kernels; the backward recomputes the plain versions and launches
    none."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = Hparams(compute_dtype="float32")
    cpu = SRDiffPipeline(hp, device="cpu").model
    gpu = SRDiffPipeline(hp, params=cpu.state_dict()).model.denoise_fn
    cpu = cpu.denoise_fn
    x, t, cond, r = backward_inputs()
    eps_ref, want, _ = unet_grads(cpu, x, t, cond, r)
    counters = _counters()
    res, failures = {}, []
    for cfg, env in CONFIGS.items():
        with switches(**env):
            t0 = time.perf_counter()
            eps, got, launched = unet_grads(gpu, x.cuda(), t.cuda(), cond.cuda(), r.cuda(), counters)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        after = {k: v for k, v in _read_counts(counters).items() if v}
        expect = forward_launches(cfg)
        _, eps_rel = rel_err(eps.cpu(), eps_ref)
        worst, bad = grad_errors(got, want)
        ok = not bad and eps_rel <= F32_TOL and launched == expect and after == launched
        print(f"backward f32 hidden64 config {cfg}: B=2 {BACKWARD_HR}x{BACKWARD_HR}, {len(want)} parameters, "
              f"max grad err {worst:.3e} of max |CPU grad| (tol {GRAD_TOL}), eps rel {eps_rel:.3e}, forward "
              f"launches {launched} (expected {expect}), after backward {after}, {dt * 1e3:.1f} ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"backward {cfg}: bad grads {bad[:5]}, launches {launched} / {after}")
        res[cfg] = {"max_grad_rel_err": worst, "bad": bad, "eps_rel_err": eps_rel, "launches": launched,
                    "fwd_bwd_s": dt}
    del cpu, gpu
    torch.cuda.empty_cache()
    return res, failures


def flash_inputs(b, l, h, d, dtype, seed, lk=None, scale=1.0):
    """q (B, L, H, D) times ``scale``, k and v (B, lk or L, H, D)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, l, h, d, generator=g) * scale
    k, v = (torch.randn(b, lk or l, h, d, generator=g) for _ in range(2))
    return [t.to("cuda", dtype) for t in (q, k, v)]


def phase_flash():
    """The flash-attention kernel against its plain version; returns its
    table row (``launches`` filled by the SD serve) and failures."""
    import torch
    import torch.nn.functional as F

    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    for shape in FLASH_F32_SHAPES:
        q, k, v = flash_inputs(*shape, torch.float32, seed=shape[1])
        want = fa.flash_attention_reference(q, k, v)
        err = (fa.flash_attention(q, k, v) - want).abs().max().item()
        ok = err <= F32_TOL * want.abs().max().item()
        print(f"f32  flash_attention     {shape}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'} (tol {F32_TOL} of max |plain|)", flush=True)
        if not ok:
            failures.append(f"flash_attention f32 {shape}")
    for b, lq, lk, h, d, sc in FLASH_BF16_CASES:
        q, k, v = flash_inputs(b, lq, h, d, torch.bfloat16, seed=lq + lk, lk=lk, scale=sc)
        want = fa.flash_attention_reference(q, k, v).float()
        err = (fa.flash_attention(q, k, v).float() - want).abs().max().item()
        ok = err <= BF16_TOL * want.abs().max().item()
        print(f"bf16 flash_attention     B={b} Lq={lq} Lk={lk} H={h} D={d} logits x{sc}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'} (tol {BF16_TOL} of max |plain|)", flush=True)
        if not ok:
            failures.append(f"flash_attention bf16 {(b, lq, lk, h, d, sc)}")
    b, l, h, d = FLASH_SHAPE
    q, k, v = flash_inputs(b, l, h, d, torch.bfloat16, seed=1)
    want = fa.flash_attention_reference(q, k, v)
    err = (fa.flash_attention(q, k, v).float() - want.float()).abs().max().item()
    ok = err <= BF16_TOL * want.float().abs().max().item()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, L, D), as views
    kern = lambda: fa.flash_attention(q, k, v)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    # ms and library_ms: launched one by one (CUDA events over FLASH_CALLS
    # calls), as every row is timed; beside them the device time alone
    eager, eager_sdpa = time_in_turns(kern, sdpa, cuda_ms)
    graph, graph_sdpa = time_in_turns(kern, sdpa, graph_ms)
    ms, sdpa_ms, ms_graph, sdpa_ms_graph = (median(x) for x in (eager, eager_sdpa, graph, graph_sdpa))
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
    flops, nbytes = 4.0 * b * h * l * l * d, 4 * b * l * h * d * 2
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
    span = lambda xs: f"{min(xs):.4f}-{max(xs):.4f}"  # noqa: E731
    print(f"bf16 flash_attention     {FLASH_SHAPE}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'} "
          f"(tol {BF16_TOL} of max |plain|); {FLASH_ROUNDS} rounds of {FLASH_CALLS} calls in turns, medians: "
          f"kernel {ms:.4f} ms ({span(eager)}), SDPA {sdpa_ms:.4f} ms ({span(eager_sdpa)}) launched one by one; "
          f"kernel {ms_graph:.4f} ms ({span(graph)}, {flops / ms_graph / 1e9:.0f} TFLOP/s), SDPA "
          f"{sdpa_ms_graph:.4f} ms ({span(graph_sdpa)}) by CUDA-graph replay; plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB", flush=True)
    if not ok:
        failures.append("flash_attention bf16 main shape")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "dgm_img_super_resolution_tpu_torch/ops/kernels/csrc/flash_attention.cu",
           "replaces": "dgm_img_super_resolution_tpu/ops/pallas/attention.py:59",
           "launches": None, "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_ms,
           "ms_rounds": eager, "library_ms_rounds": eager_sdpa, "ms_graph": ms_graph,
           "library_ms_graph": sdpa_ms_graph, "ms_graph_rounds": graph, "library_ms_graph_rounds": graph_sdpa}
    return row, failures


def _counters():
    """Every kernel wrapper of the port, by its table name."""
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa
    from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn

    wrappers = {name: fns[0] for name, fns in _srdiff_kernels().items()}
    return dict(wrappers, flash_attention=fa.flash_attention, fused_group_norm=gn.fused_group_norm)


def _gn_inputs(shape, dtype, seed, channels_last=False):
    import torch

    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2.0 + 0.5).to("cuda", dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    scale = (1.0 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    return x, scale, bias


def _gn_bound(x) -> tuple[float, str]:
    """x read once, out written once; about 12 float32 operations an
    element (two sums, normalise, affine, SiLU)."""
    n = x.numel()
    return bound(12.0 * n, 2.0 * n * x.element_size(), PEAK_F32)


def _gn_case(x, sc, bi, groups, eps, act, label, tol, failures) -> tuple[float, object]:
    """One (shape, layout, dtype, act) of ``fused_group_norm``: the kernel
    against its plain version, the output's layout, the route counter
    against the plan, and two calls bit for bit; (max_abs_err, plan)."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn

    fgn = gn.fused_group_norm
    p = gn.plan_for(x, groups)
    before = (fgn.launches, fgn.launches_resident, fgn.launches_streamed)
    got = fgn(x, sc, bi, groups, eps, act)
    again = fgn(x, sc, bi, groups, eps, act)
    torch.cuda.synchronize()
    resident = 2 if p.route == "resident" else 0
    routed = (fgn.launches, fgn.launches_resident, fgn.launches_streamed) == (
        before[0] + 2, before[1] + resident, before[2] + 2 - resident)
    same = bool(torch.equal(got, again))
    cl = gn._channels_last(x)
    layout = got.is_contiguous(memory_format=torch.channels_last if cl else torch.contiguous_format)
    err = _check(f"{label} {'NHWC' if cl else 'NCHW'} act={act} ({p.route}, cluster {p.cluster}, "
                 f"{p.slice_units * p.unit_bytes} B a CTA, units of {p.unit_bytes} B; bit-equal {same})",
                 got, gn.fused_group_norm_plain(x, sc, bi, groups, eps, act), tol, failures)
    for ok, what in ((routed, "route counters"), (same, "two calls differ"), (layout, "output layout")):
        if not ok:
            failures.append(f"{label} {tuple(x.shape)} channels_last={cl}: {what}")
    return err, p


def phase_group_norm():
    """``fused_group_norm`` against its plain version; returns its table row
    (``launches`` filled by the SD serve, where nothing calls it) and
    failures. float32 at edge shapes in both layouts, with and without SiLU;
    bf16 + SiLU at ``GN_SHAPES`` in both layouts, timed beside its plain
    version and ``F.silu(F.group_norm(...))`` in turns; then the SD sweep:
    every (shape, groups, eps, act) of the SD serves at ``GN_SWEEP_LRS``
    (``gn_sweep``), NCHW bf16, each checked as above and timed in turns with
    ``F.group_norm`` (and ``F.silu`` where the model applies it). Every case
    also checks the route counter against ``plan_for`` and that two calls
    are bit-equal."""
    import torch
    import torch.nn.functional as F

    from dgm_img_super_resolution_tpu_torch.ops.kernels import group_norm as gn

    failures = []
    for shape, groups in GN_F32_SHAPES:
        for cl in (False, True):
            for act in (None, "silu"):
                x, sc, bi = _gn_inputs(shape, torch.float32, seed=shape[-1], channels_last=cl)
                _gn_case(x, sc, bi, groups, 1e-5, act, f"f32  fused_group_norm {shape} G={groups}", F32_TOL, failures)
    span = lambda xs: f"{min(xs):.4f}-{max(xs):.4f}"  # noqa: E731

    def library(x, sc, bi, groups, eps, act):
        """The yardstick: one PyTorch call of the same function (the port never calls it)."""
        sc, bi = sc.to(x.dtype), bi.to(x.dtype)
        if act == "silu":
            return lambda: F.silu(F.group_norm(x, groups, sc, bi, eps))
        return lambda: F.group_norm(x, groups, sc, bi, eps)

    row, per_shape = None, {}
    for shape, eps in GN_SHAPES:
        x, sc, bi = _gn_inputs(shape, torch.bfloat16, seed=1)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        err, p = _gn_case(x, sc, bi, 32, eps, "silu", f"bf16 fused_group_norm {shape}", BF16_TOL, failures)
        _, p_cl = _gn_case(x_cl, sc, bi, 32, eps, "silu", f"bf16 fused_group_norm {shape}", BF16_TOL, failures)
        kern = lambda: gn.fused_group_norm(x, sc, bi, 32, eps, "silu")  # noqa: E731
        kern_cl = lambda: gn.fused_group_norm(x_cl, sc, bi, 32, eps, "silu")  # noqa: E731
        ks, ls = time_in_turns(kern, library(x, sc, bi, 32, eps, "silu"), cuda_ms)
        ks_cl, ls_cl = time_in_turns(kern_cl, library(x_cl, sc, bi, 32, eps, "silu"), cuda_ms)
        gs, gls = time_in_turns(kern, library(x, sc, bi, 32, eps, "silu"), graph_ms)
        ms, library_ms, ms_cl, library_ms_cl = (median(v) for v in (ks, ls, ks_cl, ls_cl))
        plain_ms = cuda_ms(lambda: gn.fused_group_norm_plain(x, sc, bi, 32, eps, "silu"), iters=5)
        bound_ms, bound_by = _gn_bound(x)
        print(f"bf16 fused_group_norm {shape} + SiLU: NCHW {p.route} (cluster {p.cluster}) kernel {ms:.4f} ms "
              f"({span(ks)}), F.silu(F.group_norm) {library_ms:.4f} ms ({span(ls)}); channels_last {p_cl.route} "
              f"(cluster {p_cl.cluster}) kernel {ms_cl:.4f} ms ({span(ks_cl)}), library {library_ms_cl:.4f} ms "
              f"({span(ls_cl)}); in {FLASH_ROUNDS} rounds of {FLASH_CALLS} calls in turns; by CUDA-graph replay "
              f"NCHW {median(gs):.4f} ms, library {median(gls):.4f} ms; plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f}% of it); "
              f"{2.0 * x.numel() * x.element_size() / 1e6:.1f} MB", flush=True)
        per_shape[str(shape)] = {"max_abs_err": err, "route": p.route, "cluster": p.cluster, "ms": ms,
                                 "ms_rounds": ks, "library_ms": library_ms, "library_ms_rounds": ls,
                                 "route_channels_last": p_cl.route, "ms_channels_last": ms_cl,
                                 "ms_channels_last_rounds": ks_cl, "library_ms_channels_last": library_ms_cl,
                                 "ms_graph": median(gs), "library_ms_graph": median(gls),
                                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        if row is None:  # the UNet's shape heads the row; the VAE's goes beside it
            row = {"name": "fused_group_norm", "route": "cuda", "source": KERNEL_SRC + "group_norm.cu",
                   "replaces": TPU_SRC + "groupnorm.py:62", "launches": None, "max_abs_err": err, "ms": ms,
                   "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        del x, x_cl
    row["shapes"] = per_shape
    torch.cuda.empty_cache()
    # the SD sweep, NCHW bf16
    sweep, saved = [], {f"lr{lr}": 0.0 for lr in GN_SWEEP_LRS}
    for shape, groups, eps, act, calls in gn_sweep():
        x, sc, bi = _gn_inputs(shape, torch.bfloat16, seed=shape[1] + shape[2])
        err, p = _gn_case(x, sc, bi, groups, eps, act, f"bf16 fused_group_norm {shape} G={groups} eps={eps}",
                          BF16_TOL, failures)
        kern = lambda: gn.fused_group_norm(x, sc, bi, groups, eps, act)  # noqa: E731
        ks, ls = time_in_turns(kern, library(x, sc, bi, groups, eps, act), cuda_ms)
        gs, gls = time_in_turns(kern, library(x, sc, bi, groups, eps, act), graph_ms)
        ms, library_ms = median(ks), median(ls)
        bound_ms, _ = _gn_bound(x)
        for key, n in calls.items():
            saved[key] += n * (library_ms - ms)
        print(f"  sweep {shape} eps {eps} act {act} calls {calls}: {p.route} cluster {p.cluster}, kernel "
              f"{ms:.4f} ms ({span(ks)}), library {library_ms:.4f} ms ({span(ls)}); by graph replay kernel "
              f"{median(gs):.4f} ms, library {median(gls):.4f} ms; bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / median(gs):.1f}% by replay)", flush=True)
        sweep.append({"shape": shape, "groups": groups, "eps": eps, "act": act, "calls": calls, "route": p.route,
                      "cluster": p.cluster, "slice_bytes": p.slice_units * p.unit_bytes, "max_abs_err": err,
                      "ms": ms, "ms_rounds": ks, "library_ms": library_ms, "library_ms_rounds": ls,
                      "ms_graph": median(gs), "library_ms_graph": median(gls), "bound_ms": bound_ms})
        del x
    print("SD GroupNorm sweep: calls x (library - kernel) per serve, " + ", ".join(
        f"{key} {v:.2f} ms ({sum(s['calls'][key] for s in sweep)} calls)" for key, v in saved.items()), flush=True)
    row["sd_sweep"] = sweep
    row["sd_sweep_saved_ms"] = saved
    torch.cuda.empty_cache()
    return row, failures


def _sd_serve(pipe, lr: int, steps: int, **kw):
    """One timed SD serve of a ``lr``-square uint8 image with every launch
    counter set to 0 just before it; (output, seconds, launches)."""
    import numpy as np
    import torch

    img = np.random.default_rng(lr).integers(0, 256, (lr, lr, 3), dtype=np.uint8)
    counters = _counters()
    torch.cuda.synchronize()
    _reset_counts(counters)
    t0 = time.perf_counter()
    out = pipe.upscale_device(SD_PROMPT, img, num_inference_steps=steps, guidance_scale=9.0,
                              noise_level=20, eta=0.0, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, _read_counts(counters)


def phase_sd_serve(rows):
    """The SD x4-upscaler at the published widths in bf16: LR 256 (the flash
    kernel's path), then the app's LR 128, each timed once after a short
    warm-up serve. Fills the flash row's ``launches`` from the LR 256 serve."""
    import torch

    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    t0 = time.perf_counter()
    pipe = StableDiffusionUpscalePipeline(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    failures, res = [], {"init_s": init_s}
    steps = 20
    for lr, want_flash in ((256, 6 * steps), (128, 0)):
        _sd_serve(pipe, lr, 2)  # warm-up at this size (first-call set-up of its convs and matmuls)
        torch.cuda.reset_peak_memory_stats()
        out, dt, launches = _sd_serve(pipe, lr, steps)
        shape_ok = tuple(out.shape) == (1, 4 * lr, 4 * lr, 3) and out.is_cuda
        finite = bool(torch.isfinite(out).all())
        in_range = bool(((out >= 0) & (out <= 1)).all())
        if not (shape_ok and finite and in_range):
            failures.append(f"SD LR {lr}: output {tuple(out.shape)} finite {finite} in [0, 1] {in_range}")
        want = {name: 0 for name in launches}
        want["flash_attention"] = want_flash
        if launches != want:
            failures.append(f"SD LR {lr}: launches {launches}, expected {want}")
        r = {"wall_s": dt, "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "out_mean": float(out.mean()), "out_std": float(out.std())}
        # one CFG UNet call and one decode at this size, on the serve's own shapes
        lat = torch.randn(2, 7, lr, lr, device="cuda", dtype=pipe.dtype)
        ctx = torch.randn(2, 77, 1024, device="cuda", dtype=pipe.dtype)
        tt, nl = torch.full((2,), 951, device="cuda"), torch.full((2,), 20, device="cuda")
        with torch.inference_mode():
            r["unet_step_ms"] = cuda_ms(lambda: pipe.unet(lat, tt, ctx, nl), iters=5)
            r["vae_decode_ms"] = cuda_ms(lambda: pipe.vae.decode(lat[:1, :4]), iters=2)
        if lr == 256:
            for row in rows:
                row["launches"] = launches[row["name"]]
        res[f"lr{lr}"] = r
        print(f"SD x4 ddim{steps} eta 0 cfg 9 bf16 LR {lr} -> {4 * lr}: {dt:.3f} s, UNet step (CFG batch 2) "
              f"{r['unet_step_ms']:.2f} ms, VAE decode {r['vae_decode_ms']:.2f} ms, peak {r['peak_mem_gib']:.2f} GiB, "
              f"launches {launches}, out mean {r['out_mean']:.4f} std {r['out_std']:.4f}"
              + ("" if shape_ok and finite and in_range else " FAIL"), flush=True)
    print(f"SD pipeline init (published widths, random weights on the card): {init_s:.2f} s", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return res, failures


def sd_flash_per_call(unet, lr: int) -> tuple[int, int]:
    """The flash launches of one SD UNet call at LR ``lr``, (down path,
    mid block and up path), from the block layout: a Transformer2D whose
    first attention attends to itself (not ``only_cross``) at a level of at
    least ``FLASH_MIN_TOKENS`` tokens (the latent is the LR size, halved
    per level) launches the kernel once, where the UNet was built with
    ``use_flash``."""
    from dgm_img_super_resolution_tpu_torch.models.sd.attention import FLASH_MIN_TOKENS

    def count(blocks, level):
        return sum(1 for t in blocks if not t.transformer_blocks[0].only_cross
                   and t.transformer_blocks[0].attn1.use_flash and (lr >> level) ** 2 >= FLASH_MIN_TOKENS)

    n = len(unet.down_blocks)
    down = sum(count(b.attentions or [], i) for i, b in enumerate(unet.down_blocks))
    up = count(unet.mid_block.attentions, n - 1) + sum(count(b.attentions or [], n - 1 - i)
                                                      for i, b in enumerate(unet.up_blocks))
    return down, up


def phase_sd_options(rows):
    """The SD x4 serve at LR 256 (published widths, bf16, DDIM 20 eta 0,
    guidance 9) with encoder propagation (``SD_ENC_INTERVAL``) and with a
    negative prompt, beside the plain serve: flash launches against the
    block layout's count, shape, finite, range and seconds."""
    import torch

    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    pipe = StableDiffusionUpscalePipeline(seed=0)
    lr, steps, k = SD_LR, 20, SD_ENC_INTERVAL
    enc, dec = sd_flash_per_call(pipe.unet, lr)
    groups = steps // k
    runs = {"plain": ({}, steps * (enc + dec)),
            f"enc_interval{k}": ({"enc_interval": k}, (groups + steps % k) * enc + steps * dec),
            "negative_prompt": ({"negative_prompt": SD_NEGATIVE}, steps * (enc + dec))}
    print(f"SD LR {lr}: flash launches per UNet call {enc} in the down path, {dec} in the mid block and up path; "
          f"expected a serve: " + ", ".join(f"{name} {n}" for name, (_, n) in runs.items()), flush=True)
    _sd_serve(pipe, lr, 2)  # warm-up
    failures, res = [], {}
    for name, (kw, want_flash) in runs.items():
        out, dt, launches = _sd_serve(pipe, lr, steps, **kw)
        shape_ok = tuple(out.shape) == (1, 4 * lr, 4 * lr, 3) and out.is_cuda
        finite = bool(torch.isfinite(out).all())
        in_range = bool(((out >= 0) & (out <= 1)).all())
        want = {key: 0 for key in launches}
        want["flash_attention"] = want_flash
        ok = shape_ok and finite and in_range and launches == want
        if not ok:
            failures.append(f"SD LR {lr} {name}: output {tuple(out.shape)} finite {finite} in [0, 1] {in_range}, "
                            f"launches {launches}, expected {want}")
        res[name] = {"wall_s": dt, "flash_launches": launches["flash_attention"], "out_mean": float(out.mean())}
        if name != "plain":
            for row in rows:
                if row["name"] == "flash_attention":
                    row.setdefault("launches_paths", {})[f"sd_lr{lr}_{name}"] = launches["flash_attention"]
        print(f"SD x4 ddim{steps} eta 0 cfg 9 bf16 LR {lr} {name} {kw}: {dt:.3f} s (plain "
              f"{res['plain']['wall_s']:.3f} s), flash launches {launches['flash_attention']} (expected {want_flash}), "
              f"out mean {res[name]['out_mean']:.4f} {'ok' if ok else 'FAIL'}", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return res, failures


def phase_sd_card_vs_cpu():
    """The published-width UNet in float32 on the card and on the CPU at
    latent 32x32 (plain attention: level 3 is 4x4), its first level-3
    Transformer2D on 32x32 tokens (the flash kernel on the card), and the
    VAE's ``forward`` with the posterior's noise passed in (C9)."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_UNET_CONFIG, X4_VAE_CONFIG
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import init_sd_params
    from dgm_img_super_resolution_tpu_torch.models.sd.unet import UNet2DCondition
    from dgm_img_super_resolution_tpu_torch.models.sd.vae import AutoencoderKL
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = UNet2DCondition(X4_UNET_CONFIG).eval()
    init_sd_params(cpu, seed=3)
    with torch.device("cuda"):
        gpu = UNet2DCondition(X4_UNET_CONFIG).eval()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    x, ctx = torch.randn(2, 7, 32, 32, generator=g), torch.randn(2, 77, 1024, generator=g)
    t, nl = torch.tensor([951, 1]), torch.tensor([20, 350])
    res, failures = {}, []
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu(x, t, ctx, nl)
        cpu_s = time.perf_counter() - t0
        got = gpu(x.cuda(), t.cuda(), ctx.cuda(), nl.cuda()).cpu()
        err, rel = rel_err(got, want)
        # F32_TOL as for the SRDiff UNet forward: float32 sums in another
        # order (cuDNN's algorithms, TF32 off) through about 70 layers
        ok = rel <= F32_TOL and bool(torch.isfinite(got).all())
        print(f"card vs CPU, f32 SD UNet published widths, latent 32x32 B=2: max_abs_err {err:.3e} "
              f"rel {rel:.3e} {'ok' if ok else 'FAIL'} (tol {F32_TOL}; CPU {cpu_s:.1f} s)", flush=True)
        res["unet"] = {"max_abs_err": err, "rel_err": rel, "cpu_s": cpu_s}
        if not ok:
            failures.append("SD card vs CPU UNet forward")

        tcpu, tgpu = cpu.down_blocks[3].attentions[0], gpu.down_blocks[3].attentions[0]
        y = torch.randn(2, tcpu.proj_in.in_features, 32, 32, generator=g)
        want = tcpu(y, ctx)
        before = fa.flash_attention.launches
        got = tgpu(y.cuda(), ctx.cuda()).cpu()
        n = fa.flash_attention.launches - before
        err, rel = rel_err(got, want)
        ok = rel <= F32_TOL and n == 1
        print(f"card vs CPU, f32 level-3 Transformer2D (1024 ch, 8 heads) on 32x32 tokens B=2: "
              f"max_abs_err {err:.3e} rel {rel:.3e}, flash launches {n} {'ok' if ok else 'FAIL'} "
              f"(tol {F32_TOL})", flush=True)
        res["transformer2d"] = {"max_abs_err": err, "rel_err": rel, "flash_launches": n}
        if not ok:
            failures.append("SD card vs CPU Transformer2D")
    del cpu, gpu

    cpu = AutoencoderKL(X4_VAE_CONFIG).eval()
    init_sd_params(cpu, seed=5)
    with torch.device("cuda"):
        gpu = AutoencoderKL(X4_VAE_CONFIG).eval()
    gpu.load_state_dict(cpu.state_dict())
    img = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    side = 64 // 2 ** (len(X4_VAE_CONFIG["block_out_channels"]) - 1)  # the latent's: f = 4
    eps = torch.randn(2, X4_VAE_CONFIG["latent_channels"], side, side, generator=g)
    with torch.inference_mode():
        want, mean = cpu(img, noise=eps), cpu(img)
        got = gpu(img.cuda(), noise=eps.cuda()).cpu()
        err, rel = rel_err(got, want)
        moved = float((want - mean).abs().max())
        ok = rel <= F32_TOL and bool(torch.isfinite(got).all()) and moved > 0
        print(f"card vs CPU, f32 SD VAE published widths forward(x, noise) (the sampled posterior's decode) "
              f"64x64 B=2: max_abs_err {err:.3e} rel {rel:.3e} (tol {F32_TOL}); the draw moved the output from "
              f"the mean's by {moved:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        res["vae_forward_noise"] = {"max_abs_err": err, "rel_err": rel, "moved_from_mean": moved}
        if not ok:
            failures.append("SD card vs CPU VAE forward with noise")
    del cpu, gpu
    torch.cuda.empty_cache()
    return res, failures


# The checkpoint-to-scored-image path (phase_checkpoint_cli): the ddim20 eta 1
# serving point as the CLI's hparams; METRIC_TOL holds the card's psnr and
# LPIPS (relative) and ssim_eval (absolute) against the CPU's in float32 with
# TF32 off: the SSIM's u^2 - mu^2 variances cancel, so their float32 sums in
# another order differ by some 1e-6 of 255^2-scaled terms.
SERVE_HP = "sampler=ddim,sample_timesteps=20,ddim_eta=1.0"
METRIC_TOL = 1e-4
# rows 1-3 per UNet call; the CLI's paths in UNet calls: a ddim20 serve is
# 20, interp's chain from t = T-1 = 99 runs t = 98 .. 0 (99 calls), the
# operating-point check runs the T = 100 chain and ddim20 on each image
CLI_ROWS = ("block_chain3_stem", "block_chain3", "tail_fuse")
OP_POINT_IMAGES = 2


def _cli(argv) -> tuple[int, list[str], float]:
    """One run of the port's CLI: (exit code, its stdout lines, seconds)."""
    import io

    import torch

    from dgm_img_super_resolution_tpu_torch.apps.cli import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        print(f"  {ln}", flush=True)
    return rc, lines, dt


def _random_lpips_npz(path, seed=11):
    """Seeded random LPIPS weights in the JAX package's ``.npz`` layout."""
    import numpy as np

    g = np.random.default_rng(seed)
    convs = {"conv1": (11, 3, 64), "conv2": (5, 64, 192), "conv3": (3, 192, 384), "conv4": (3, 384, 256),
             "conv5": (3, 256, 256)}
    arrays = {}
    for name, (k, cin, cout) in convs.items():
        arrays[f"params/alex/{name}/kernel"] = (g.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin))
        arrays[f"params/alex/{name}/bias"] = 0.1 * g.standard_normal(cout)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        arrays[f"params/lin{i}/kernel"] = np.abs(g.standard_normal((1, 1, c, 1))) / c
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})


def phase_checkpoint_cli(rows):
    """From a checkpoint file to a scored image on the card: an upstream-
    format SRDiff checkpoint of the full-width model (seeded random
    weights) loaded by ``SRDiffPipeline(ckpt_path=...)`` serves bit for bit
    as the pipeline built from the same state dict; the CLI's ``infer``,
    ``eval``, ``test --check-op-point`` and ``interp`` on the card from that
    file, launches counted per subcommand; ``psnr``, ``ssim_eval`` and LPIPS
    on the card against the CPU, and ``Measure.measure``'s time at 512^2."""
    import json as _json
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from dgm_img_super_resolution_tpu_torch.core.config import set_hparams
    from dgm_img_super_resolution_tpu_torch.diffusion.schedule import BUFFERS
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.metrics import Measure, psnr, ssim_eval
    from dgm_img_super_resolution_tpu_torch.metrics.lpips import LPIPS
    from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
    from dgm_img_super_resolution_tpu_torch.ops.resize import imresize

    failures, res = [], {}
    counters = _counters()
    hp = set_hparams("", "", SERVE_HP)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- the checkpoint file, in the upstream format
        sd = init_srdiff_params(build_srdiff(hp), seed=7).state_dict()
        model = {f"model.{k}": v for k, v in sd.items()}
        model.update({f"model.{b}": torch.linspace(0, 1, hp["timesteps"], dtype=torch.float64) for b in BUFFERS})
        model["model.ssim_loss.window"] = torch.ones(1, 1, 11, 11)
        ckpt = tmp / "model_ckpt_steps_400000.ckpt"
        torch.save({"state_dict": {"model": model}, "global_step": 400000}, ckpt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        from_file = SRDiffPipeline(hp, ckpt_path=str(ckpt))
        torch.cuda.synchronize()
        res["ckpt_load_s"] = time.perf_counter() - t0
        in_memory = SRDiffPipeline(hp, params=sd)
        imgs = np.random.default_rng(12).integers(0, 256, (8, SERVE_LR, SERVE_LR, 3), dtype=np.uint8)
        from_file.upscale_batch_device(imgs, as_uint8=True)  # warm-up
        want = {k: v for k, v in SERVE_LAUNCHES["default"].items()}
        for n in (8, 1):
            out_f, dt, launches = _serve(from_file, imgs[:n], counters)
            out_m, _, _ = _serve(in_memory, imgs[:n], counters)
            launches = {k: v for k, v in launches.items() if v}
            same = bool(torch.equal(out_f, out_m)) and tuple(out_f.shape) == (n, 4 * SERVE_LR, 4 * SERVE_LR, 3)
            ok = same and launches == want
            print(f"SRDiff from the checkpoint file, batch {n} {SERVE_LR}->{4 * SERVE_LR} ddim20 bf16: {dt:.3f} s, "
                  f"bit-equal to the in-memory pipeline {same}, launches {launches} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"checkpoint serve batch {n}: bit-equal {same}, launches {launches}, expected {want}")
            res[f"ckpt_serve_b{n}"] = {"s": dt, "bit_equal": same, "launches": launches}
            _note_launches(rows, f"ckpt_file_batch{n}", launches)
        print(f"checkpoint load (torch.load, strict load_state_dict, to the card): {res['ckpt_load_s']:.3f} s",
              flush=True)
        sr8 = out_f
        del from_file, in_memory

        # -- the CLI on the card, from that file
        g = np.random.default_rng(13)
        yy, xx = np.mgrid[0:512, 0:512] / 512.0
        hrs = []
        for i in range(OP_POINT_IMAGES):
            smooth = np.stack([np.sin((7 + i) * yy + 3 * xx), np.cos(5 * xx * yy + i), np.sin(11 * xx - i)], -1)
            hr = np.clip((smooth * 0.5 + 0.5) * 255 + g.normal(0, 8, smooth.shape), 0, 255).round().astype(np.uint8)
            (tmp / "hr").mkdir(exist_ok=True)
            Image.fromarray(hr).save(tmp / "hr" / f"img{i}.png")
            hrs.append(hr)
        Image.fromarray(imgs[0]).save(tmp / "lr.png")
        common = ["--ckpt", str(ckpt), "-hp", SERVE_HP]
        per_serve = {k: SERVE_LAUNCHES["default"][k] for k in CLI_ROWS}
        runs = {
            "infer": (["infer", str(tmp / "lr.png"), str(tmp / "sr.png")], 1 * 20),
            "eval": (["eval", str(tmp / "hr" / "img0.png")], 1 * 20),
            "test_op_point": (["test", str(tmp / "hr"), "--gen_dir", str(tmp / "gen"), "--check-op-point",
                               "--op-point-images", str(OP_POINT_IMAGES)],
                              OP_POINT_IMAGES * 20 + OP_POINT_IMAGES * (hp["timesteps"] + 20)),
            "interp": (["interp", str(tmp / "hr" / "img0.png"), str(tmp / "hr" / "img1.png"), str(tmp / "mix.png")],
                       hp["timesteps"] - 1),
        }
        for name, (argv, calls) in runs.items():
            _reset_counts(counters)
            rc, lines, dt = _cli(argv + common)
            launches = {k: v for k, v in _read_counts(counters).items() if v}
            want = {k: calls * v // 20 for k, v in per_serve.items()}
            want.update({f"{k}_wgmma": n for k, n in want.items()})
            want["block_chain3_c64"] = want["block_chain3"]
            ok = rc == 0 and launches == want
            detail = ""
            if name in ("infer", "interp"):
                out = np.asarray(Image.open(tmp / ("sr.png" if name == "infer" else "mix.png")))
                ok = ok and out.shape == (512, 512, 3)
                detail = f"output {out.shape}"
            elif name == "eval":
                metrics = _json.loads(lines[-1])
                finite = all(np.isfinite(metrics[k]) for k in ("psnr", "ssim", "lr_psnr"))
                ok = ok and finite and np.isnan(metrics["lpips"])
                detail = f"metrics {metrics}"
                res["eval_metrics"] = metrics
            else:
                check = _json.loads((tmp / "gen" / "op_point_check.json").read_text())
                gen = sorted(p.name for p in (tmp / "gen").iterdir())
                ok = ok and gen == [f"img{i}.png" for i in range(OP_POINT_IMAGES)] + ["op_point_check.json"]
                detail = f"op-point check {check} (within_tol reported, not gated: random weights)"
                res["op_point_check"] = check
            print(f"CLI {name} on the card from the checkpoint: rc {rc}, {dt:.3f} s, launches {launches} "
                  f"(expected {want}), {detail} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"CLI {name}: rc {rc}, launches {launches}, expected {want}, {detail}")
            res[f"cli_{name}"] = {"rc": rc, "s": dt, "launches": launches}
            _note_launches(rows, f"cli_{name}", launches)

        # -- the metrics on the card against the CPU, float32 with TF32 off
        npz = tmp / "lpips.npz"
        _random_lpips_npz(npz)
        sr, hr = sr8[0].cpu().numpy(), hrs[0]
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            a_c, b_c = (torch.from_numpy(v).cuda().float() for v in (sr, hr))
            vals = {"psnr": (float(psnr(a_c, b_c)), float(psnr(torch.from_numpy(sr).float(),
                                                               torch.from_numpy(hr).float())), "rel"),
                    "ssim_eval": (ssim_eval(a_c, b_c), ssim_eval(sr, hr), "abs"),
                    "lpips": (LPIPS.maybe_create(str(npz), "cuda")(sr, hr), LPIPS.maybe_create(str(npz), "cpu")(sr, hr),
                              "rel")}
            for name, (card, cpu, kind) in vals.items():
                err = abs(card - cpu) / (abs(cpu) if kind == "rel" else 1.0)
                ok = err <= METRIC_TOL and np.isfinite(card)
                print(f"metric {name} at 512^2, card {card:.8f} vs CPU {cpu:.8f}: {kind} err {err:.3e} "
                      f"{'ok' if ok else 'FAIL'} (tol {METRIC_TOL})", flush=True)
                if not ok:
                    failures.append(f"metric {name}: card {card} vs CPU {cpu}")
                res[f"metric_{name}"] = {"card": card, "cpu": cpu, "err": err}
            lr = imgs[0]
            t0 = time.perf_counter()
            for _ in range(5):
                imresize(sr, scale=0.25)
            res["imresize_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            print(f"imresize (MATLAB bicubic, numpy float64 on the host) 512^2 -> 128^2: {res['imresize_ms']:.2f} ms",
                  flush=True)
            for label, m in (("no LPIPS weights", Measure(device="cuda")),
                             ("with LPIPS", Measure(lpips_weights=str(npz), device="cuda"))):
                ms = cuda_ms(lambda: m.measure(sr, hr, lr, 4), iters=5)
                res[f"measure_ms_{'lpips' if 'with' in label else 'plain'}"] = ms
                print(f"Measure.measure at 512^2 on the card ({label}; psnr, ssim, lr_psnr with the host's "
                      f"MATLAB resize): {ms:.2f} ms", flush=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return res, failures


def phase_sd_local_checkpoint(rows):
    """The SD x4-upscaler from a local diffusers directory: the published-
    width random state dicts of ``phase_sd_serve``'s pipeline (seed 0),
    written in float16 safetensors with the scheduler configs, loaded by
    ``load_sd_x4_pipeline`` on the card, and served at LR 256 bit for bit
    as the pipeline built in memory from the same float16-rounded dicts."""
    import tempfile

    import torch
    from safetensors.torch import save_file

    from dgm_img_super_resolution_tpu_torch.ckpt.sd_import import load_sd_x4_pipeline
    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import (
        X4_LOW_RES_SCHEDULER_CONFIG,
        X4_SCHEDULER_CONFIG,
    )
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    failures, res = [], {}
    files = {"unet": "diffusion_pytorch_model.safetensors", "vae": "diffusion_pytorch_model.safetensors",
             "text_encoder": "model.safetensors"}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = StableDiffusionUpscalePipeline(seed=0, dtype=torch.float16)
        sds = {c: {k: v.cpu().contiguous() for k, v in getattr(src, c).state_dict().items()} for c in files}
        del src
        sds["text_encoder"]["text_model.embeddings.position_ids"] = torch.arange(77)[None]  # dropped on load
        t0 = time.perf_counter()
        for comp, name in files.items():
            (tmp / comp).mkdir()
            save_file(sds[comp], str(tmp / comp / name))
        for sub, cfg in (("scheduler", X4_SCHEDULER_CONFIG), ("low_res_scheduler", X4_LOW_RES_SCHEDULER_CONFIG)):
            (tmp / sub).mkdir()
            (tmp / sub / "scheduler_config.json").write_text(json.dumps(cfg))
        res["write_s"] = time.perf_counter() - t0
        res["bytes"] = sum(p.stat().st_size for p in tmp.rglob("*.safetensors"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_sd_x4_pipeline(str(tmp))
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
    del sds["text_encoder"]["text_model.embeddings.position_ids"]
    ref = StableDiffusionUpscalePipeline({c: {k: v.float() for k, v in sd.items()} for c, sd in sds.items()})
    del sds
    lr, steps = SD_LR, 20
    gen = lambda: torch.Generator(device="cuda").manual_seed(21)  # noqa: E731
    _sd_serve(loaded, lr, 2, generator=gen())  # warm-up
    out_l, dt, launches = _sd_serve(loaded, lr, steps, generator=gen())
    out_r, dt_r, _ = _sd_serve(ref, lr, steps, generator=gen())
    launches = {k: v for k, v in launches.items() if v}
    same = bool(torch.equal(out_l, out_r)) and tuple(out_l.shape) == (1, 4 * lr, 4 * lr, 3)
    want = {"flash_attention": 6 * steps}
    ok = same and launches == want
    res.update({"serve_s": dt, "in_memory_serve_s": dt_r, "bit_equal": same, "launches": launches})
    _note_launches(rows, f"sd_local_dir_lr{lr}", launches)
    print(f"SD x4 from a local float16 diffusers directory ({res['bytes'] / 2**30:.2f} GiB of safetensors): write "
          f"{res['write_s']:.2f} s, load_sd_x4_pipeline {res['load_s']:.2f} s, serve LR {lr} -> {4 * lr} ddim{steps} "
          f"{dt:.3f} s (in-memory {dt_r:.3f} s), bit-equal {same}, launches {launches} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failures.append(f"SD local directory: bit-equal {same}, launches {launches}, expected {want}")
    del loaded, ref
    torch.cuda.empty_cache()
    return res, failures


# The training path (phase_train): SRDiff at full width (hidden 64, mults
# 1|2|3|4, RRDB 8 x 32, fix_rrdb, T = 100, l1, Adam lr 2e-4, clip 10), batch 64
# of 160x160 HR crops in bf16, through SRDiffTask, Trainer.fit, DIV2KDataset
# and DataLoader. Each training forward runs rows 1-3 once (row 1 at 160^2,
# row 2 at C = 64 on 80^2, row 3 80^2 -> 160^2) and each validation batch's
# forward too; backward recomputes their plain versions and launches none.
TRAIN_HR, TRAIN_BATCH, TRAIN_IMAGES = 160, 64, 64
TRAIN_UPDATES, TRAIN_RESUME_TO, TRAIN_VAL_EVERY, TRAIN_KEEP = 12, 16, 6, 2
TRAIN_VAL_BATCHES, TRAIN_VAL_SIZE = 2, 16  # validation batches of 16 of the PNGs, resized
TRAIN_DESCENT_STEPS, TRAIN_TIMED_STEPS = 10, 6
TRAIN_T = (7, 88)  # the card-vs-CPU batch's two timesteps: a kernel that reads the wrong row's tv fails
TRAIN_HP = dict(compute_dtype="bfloat16", batch_size=TRAIN_BATCH, patch_size=TRAIN_HR, rrdb_ckpt="",
                data_augmentation=True, num_workers=8, save_codes=[])


def train_step_launches(cfg, dtype="bfloat16") -> dict:
    """The launches of one training forward under ``cfg``: one UNet call's
    share of the serve's (float32: less the calls on the conv core)."""
    if dtype == "float32":
        return forward_launches(cfg)
    return {k: v // 20 for k, v in SERVE_LAUNCHES[cfg].items()}


def _times(want: dict, n: int) -> dict:
    return {k: v * n for k, v in want.items()}


def write_train_pngs(d, seed, n=TRAIN_IMAGES):
    """``n`` PNGs from ``seed``, each larger than the HR crop (so that
    augmentation crops): smooth colour fields with noise, 176-207 px a side."""
    import numpy as np
    from PIL import Image

    g = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in g.integers(TRAIN_HR + 16, TRAIN_HR + 48, 2))
        base = g.uniform(0, 255, (4, 4, 3))
        yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 3, w), indexing="ij")
        img = base[yy.astype(int), xx.astype(int)] + g.normal(0, 24, (h, w, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(Path(d) / f"{i:04d}.png", compress_level=1)


def _train_batch(b, hr, seed):
    """An NHWC numpy batch in [-1, 1] from ``seed``."""
    import numpy as np

    g = np.random.default_rng(seed)
    x = g.uniform(-1, 1, (b, hr, hr, 3)).astype(np.float32)
    return {"hr": x, "lr": g.uniform(-1, 1, (b, hr // 4, hr // 4, 3)).astype(np.float32),
            "lr_up": np.clip(x + 0.2 * g.standard_normal(x.shape), -1, 1).astype(np.float32)}


def _loss_and_grads(task, model, batch, t, noise, counters=None):
    """One loss and its gradients; with ``counters`` also the launches of
    the forward alone and of forward plus backward."""
    model.zero_grad(set_to_none=True)
    if counters is not None:
        _reset_counts(counters)
    loss, _ = task.loss_fn(model, batch, t=t, noise=noise)
    fwd = {k: v for k, v in _read_counts(counters).items() if v} if counters is not None else None
    loss.backward()
    both = {k: v for k, v in _read_counts(counters).items() if v} if counters is not None else None
    grads = {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, fwd, both


def _global_dist(got, want) -> tuple[float, float]:
    """max and mean |got - want| over every gradient element, each over the
    reference's max and mean |value|."""
    import torch

    a = torch.cat([got[n].float().flatten().cpu() for n in want])
    b = torch.cat([want[n].float().flatten().cpu() for n in want])
    d = (a - b).abs()
    return d.max().item() / b.abs().max().item(), d.mean().item() / b.abs().mean().item()


def _train_card_vs_cpu(res, failures):
    """Part 1: one training loss and its gradients of the full-width stack,
    B = 2 at 160^2 with two different timesteps: float32 (TF32 off) on the
    card against the CPU (loss 1e-4 relative, each gradient GRAD_TOL of its
    tensor's max |CPU gradient|); bf16 with the regions against bf16 with
    every region off (CUDNN_ENV) on the card: the loss and the eps at the
    FWD_* bounds, and the gradients as the forward is bounded against
    float32 (FWD_MAX_REL of the largest; FWD_F32_RATIO_* times the regions-
    off bf16 gradients' distance from float32). On the CPU
    (``tools/torch_port_train_cpu.py``: hidden 64, B = 2 at 64^2) the bf16
    gradients with the regions lay 1.2% (max) and 3.0% (mean) from those
    without, and 1.15% / 2.9% from float32 where the regions-off bf16 lay
    1.16% / 3.2%. The forward's launches are one training forward's, and
    backward adds none."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
    from dgm_img_super_resolution_tpu_torch.train.trainer import batch_to_device

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    counters = _counters()
    try:
        hp32 = Hparams(**dict(TRAIN_HP, compute_dtype="float32"))
        task = SRDiffTask(hp32)
        cpu = task.init_params(3)
        sd = {k: v.clone() for k, v in cpu.state_dict().items()}
        batch = _train_batch(2, TRAIN_HR, 4)
        g = torch.Generator().manual_seed(5)
        eps, eps_step = (torch.randn(2, 3, TRAIN_HR, TRAIN_HR, generator=g) for _ in range(2))
        t = torch.tensor(TRAIN_T)
        t0 = time.perf_counter()
        loss_cpu, want, _, _ = _loss_and_grads(task, cpu, batch_to_device(batch, torch.device("cpu")), t,
                                               (eps, eps_step))
        res["cpu_f32_loss_and_grads_s"] = time.perf_counter() - t0
        gpu_batch = batch_to_device(batch, torch.device("cuda"))
        cl = lambda v: v.cuda().contiguous(memory_format=torch.channels_last)  # noqa: E731
        noise = (cl(eps), cl(eps_step))

        def card(dtype, env):
            hp = Hparams(**dict(TRAIN_HP, compute_dtype=dtype))
            tk = SRDiffTask(hp)
            m = tk.diffusion
            m.load_state_dict(sd)
            m.cuda().to(memory_format=torch.channels_last)
            with switches(**env):
                out = _loss_and_grads(tk, m, gpu_batch, t.cuda(), noise, counters)
                with torch.no_grad():
                    x = m.img2res(gpu_batch["hr"], gpu_batch["lr_up"])
                    _, cond = m.rrdb_cond(gpu_batch["lr"], gpu_batch["lr_up"])
                    eps_pred = m.denoise_fn(m.q_sample(x, t.cuda(), noise[0]), t.cuda(), cond).float()
            del m
            return out, eps_pred

        (loss32, got32, fwd32, both32), _ = card("float32", {})
        worst, bad = grad_errors(got32, want)
        bad += sorted(set(want) ^ set(got32))
        rel32 = abs(loss32 - loss_cpu) / abs(loss_cpu)
        expect = train_step_launches("default", "float32")
        ok = not bad and rel32 <= 1e-4 and fwd32 == expect and both32 == fwd32
        print(f"train f32 card vs CPU, B=2 {TRAIN_HR}^2, t={list(TRAIN_T)}: loss {loss32:.6f} vs {loss_cpu:.6f} (rel "
              f"{rel32:.2e}, tol 1e-4), {len(want)} gradients max err {worst:.3e} of max |CPU grad| (tol {GRAD_TOL}), "
              f"forward launches {fwd32} (expected {expect}), after backward {both32} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"train f32 card vs CPU: loss rel {rel32}, bad grads {bad[:5]}, "
                            f"launches {fwd32} / {both32}")
        (loss16, got16, fwd16, both16), eps16 = card("bfloat16", {})
        (loss_ref, ref16, off_fwd, _), eps_ref = card("bfloat16", CUDNN_ENV)
        rel16 = abs(loss16 - loss_ref) / abs(loss_ref)
        e_max = (eps16 - eps_ref).abs().max().item() / eps_ref.abs().max().item()
        e_mean = (eps16 - eps_ref).abs().mean().item() / eps_ref.abs().mean().item()
        g_vs_off, g_vs_32 = _global_dist(got16, ref16), _global_dist(got16, got32)
        off_vs_32 = _global_dist(ref16, got32)
        expect16 = train_step_launches("default")
        ok16 = (rel16 <= FWD_MEAN_REL and e_max <= FWD_MAX_REL and e_mean <= FWD_MEAN_REL
                and g_vs_off[0] <= FWD_MAX_REL and g_vs_32[0] <= FWD_F32_RATIO_MAX * off_vs_32[0]
                and g_vs_32[1] <= FWD_F32_RATIO_MEAN * off_vs_32[1] and sorted(got16) == sorted(ref16)
                and fwd16 == expect16 and both16 == fwd16 and not off_fwd)
        print(f"train bf16 card, regions vs every region off: loss rel {rel16:.2e}, eps max rel {e_max:.3e} mean rel "
              f"{e_mean:.3e}; gradients vs regions off max {g_vs_off[0]:.3e} mean {g_vs_off[1]:.3e}; vs float32 "
              f"max {g_vs_32[0]:.3e} mean {g_vs_32[1]:.3e} where regions off lie at {off_vs_32[0]:.3e} / "
              f"{off_vs_32[1]:.3e}; forward launches {fwd16}, after backward {both16}, regions off {off_fwd} "
              f"{'ok' if ok16 else 'FAIL'}", flush=True)
        if not ok16:
            failures.append(f"train bf16 vs regions off: loss {rel16}, eps {e_max}/{e_mean}, grads {g_vs_off} "
                            f"{g_vs_32} {off_vs_32}, launches {fwd16} / {both16} / {off_fwd}")
        res["card_vs_cpu"] = {"loss_rel_f32": rel32, "max_grad_rel_err_f32": worst, "bad": bad[:10],
                              "launches_f32": fwd32, "loss_rel_bf16": rel16, "eps_rel_bf16": [e_max, e_mean],
                              "grads_bf16_vs_off": g_vs_off, "grads_bf16_vs_f32": g_vs_32,
                              "grads_off_vs_f32": off_vs_32, "launches_bf16": fwd16}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.empty_cache()


def _train_fit(tmp, res, failures, rows):
    """Part 2 and the fit's share of part 4: ``Trainer.fit`` over the PNGs
    for TRAIN_UPDATES updates with validation every TRAIN_VAL_EVERY (and the
    sanity validation at 0), keep TRAIN_KEEP; then a resume to
    TRAIN_RESUME_TO. Returns the trainer state for the next parts."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ckpt.ckpt_io import get_all_ckpts, load_checkpoint
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.data import DataLoader, DIV2KDataset
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
    from dgm_img_super_resolution_tpu_torch.train.trainer import lr_at

    work = tmp / "work"
    hp = Hparams(**dict(TRAIN_HP, work_dir=str(work), val_check_interval=TRAIN_VAL_EVERY, num_ckpt_keep=TRAIN_KEEP,
                        valid_steps=TRAIN_VAL_BATCHES, decay_steps=TRAIN_UPDATES // 2, tb_log_interval=4))
    ds = DIV2KDataset(str(tmp / "png"), hp["sr_scale"], TRAIN_HR, TRAIN_HR, data_augmentation=True, seed=1)
    val_ds = DIV2KDataset(str(tmp / "png"), hp["sr_scale"], TRAIN_HR, TRAIN_HR)
    it = iter(DataLoader(val_ds, TRAIN_VAL_SIZE, shuffle=False, num_workers=8))
    val = [next(it) for _ in range(TRAIN_VAL_BATCHES)]
    it.close()
    counters = _counters()

    def run(max_updates):
        task = SRDiffTask(hp)
        trainer = task.make_trainer()
        batches = iter(DataLoader(ds, TRAIN_BATCH, seed=hp["seed"], num_workers=hp["num_workers"], endless=True))
        torch.cuda.synchronize()
        _reset_counts(counters)
        t0 = time.perf_counter()
        try:
            state = trainer.fit(batches, 0, max_updates=max_updates, val_fn=task.make_val_fn(val))
            torch.cuda.synchronize()
        finally:
            batches.close()
        return trainer, state, time.perf_counter() - t0, {k: v for k, v in _read_counts(counters).items() if v}

    tr, s12, dt12, l12 = run(TRAIN_UPDATES)
    per = train_step_launches("default")
    want12 = _times(per, TRAIN_UPDATES + 3 * TRAIN_VAL_BATCHES)  # sanity, and validation at 6 and 12
    kept12 = [Path(p).name for p in get_all_ckpts(str(work))]
    saved, _ = load_checkpoint(str(work))
    restored = SRDiffTask(hp).make_trainer()
    rs = restored.init_state()
    restored.restore(rs, saved)
    same = (rs.step == s12.step == TRAIN_UPDATES and rs.optimizer.updates == TRAIN_UPDATES
            and all(torch.equal(v, s12.model.state_dict()[k]) for k, v in rs.model.state_dict().items())
            and all(torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
                    for a, b in zip(rs.optimizer.adam.state.values(), s12.optimizer.adam.state.values())))
    del restored, rs
    tr2, s16, dt16, l16 = run(TRAIN_RESUME_TO)
    kept = [Path(p).name for p in get_all_ckpts(str(work))]
    steps = {int(float(st["step"])) for st in s16.optimizer.adam.state.values()}
    lr = s16.optimizer.adam.param_groups[0]["lr"]
    want16 = _times(per, TRAIN_RESUME_TO - TRAIN_UPDATES)
    best = [Path(p).name for p in get_all_ckpts(str(work / "best"))]
    ok = (l12 == want12 and l16 == want16 and same and s16.step == TRAIN_RESUME_TO
          and s16.optimizer.updates == TRAIN_RESUME_TO and steps == {TRAIN_RESUME_TO}
          and lr == lr_at(hp, TRAIN_RESUME_TO - 1)
          and kept == [f"model_ckpt_steps_{TRAIN_RESUME_TO}.ckpt", f"model_ckpt_steps_{TRAIN_UPDATES}.ckpt"]
          and kept12 == [f"model_ckpt_steps_{TRAIN_UPDATES}.ckpt", f"model_ckpt_steps_{TRAIN_VAL_EVERY}.ckpt"]
          and len(best) == 1)
    wait = tr.loader_wait_s / dt12
    print(f"train fit B={TRAIN_BATCH} {TRAIN_HR}^2 bf16 on {TRAIN_IMAGES} PNGs: {TRAIN_UPDATES} updates (validation "
          f"at 0, {TRAIN_VAL_EVERY}, {TRAIN_UPDATES}) {dt12:.2f} s, waiting on the loader {100 * wait:.1f}%, "
          f"launches {l12} (expected {want12}); checkpoints {kept12}, best {best}; restored = saved {same}; resume to "
          f"{TRAIN_RESUME_TO} {dt16:.2f} s, launches {l16} (expected {want16}), step {s16.step}, Adam count "
          f"{sorted(steps)}, lr {lr:.3e}, checkpoints {kept}; saves {['%.3f' % v for v in tr.save_s + tr2.save_s]} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"train fit: launches {l12} / {l16}, restored {same}, step {s16.step}, updates "
                        f"{s16.optimizer.updates}, Adam {steps}, lr {lr}, checkpoints {kept12} / {kept}, best {best}")
    res["fit"] = {"s": dt12, "loader_wait_share": wait, "launches": l12, "resume_s": dt16, "resume_launches": l16,
                  "checkpoints": kept, "save_s": tr.save_s + tr2.save_s, "restored_equal": same}
    _note_launches(rows, "train_fit_12_updates_3_validations", l12)
    return ds


def _train_steps(state, trainer, task, ds, res, failures, rows):
    """Parts 3-5 on a fresh trainer state: the launches of one step under
    the default and under A (forward alone, then with backward), the
    descent on one fixed batch, and the timed steps fed by the loader."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.data import DataLoader
    from dgm_img_super_resolution_tpu_torch.train.trainer import batch_to_device

    counters = _counters()
    batches = iter(DataLoader(ds, TRAIN_BATCH, seed=21, num_workers=8, endless=True))
    try:
        fixed = next(batches)
        dev = batch_to_device(fixed, torch.device("cuda"))
        for cfg in ("default", "A"):
            with switches(**CONFIGS[cfg]):
                t = torch.tensor(TRAIN_T * (TRAIN_BATCH // 2)).cuda()
                _, _, fwd, both = _loss_and_grads(task, state.model, dev, t, None, counters)
                state.model.zero_grad(set_to_none=True)
                _reset_counts(counters)
                for _ in range(2):
                    trainer.train_step(state, fixed)
                two = {k: v for k, v in _read_counts(counters).items() if v}
            want = train_step_launches(cfg)
            ok = fwd == want and both == fwd and two == _times(want, 2)
            print(f"train step launches, config {cfg}: forward {fwd}, with backward {both}, two train_steps {two} "
                  f"(expected {want} a step) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"train step launches {cfg}: {fwd} / {both} / {two}, expected {want}")
            res[f"step_launches_{cfg}"] = fwd
            _note_launches(rows, f"train_step_{cfg}", fwd)

        def fixed_loss():
            with torch.no_grad():
                return float(task.loss_fn(state.model, dev, torch.Generator(device="cuda").manual_seed(0))[0])

        before = fixed_loss()
        for _ in range(TRAIN_DESCENT_STEPS):
            trainer.train_step(state, fixed, torch.Generator(device="cuda").manual_seed(0))
        after = fixed_loss()
        ok = after < before
        print(f"train descent: {TRAIN_DESCENT_STEPS} updates on one batch (same t and noise), loss {before:.5f} -> "
              f"{after:.5f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"train descent: loss {before} -> {after}")
        res["descent"] = [before, after]

        alone = iter(DataLoader(ds, TRAIN_BATCH, seed=44, num_workers=8, endless=True))
        next(alone)
        t0 = time.perf_counter()
        for _ in range(3):
            next(alone)
        res["loader_batch_s"] = (time.perf_counter() - t0) / 3  # the loader alone, nothing else running
        alone.close()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, waits = [], []
        for _ in range(TRAIN_TIMED_STEPS + 2):
            t0 = time.perf_counter()
            b = next(batches)
            t1 = time.perf_counter()
            trainer.train_step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            waits.append(t1 - t0)
        step_s = float(np.median(times[2:]))
        res["timing"] = {"step_ms": 1e3 * step_s, "crops_per_s": TRAIN_BATCH / step_s,
                         "loader_wait_share": float(sum(waits[2:]) / sum(times[2:])),
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "step_ms_all": [1e3 * v for v in times]}
    finally:
        batches.close()


def _train_device_step_ms(state, trainer, ds):
    """The median device-side step with the batch already on the card (the
    loader out of the way)."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.data import DataLoader

    it = iter(DataLoader(ds, TRAIN_BATCH, seed=33, num_workers=8))
    b = next(it)
    it.close()
    ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms[2:]))


def phase_train(rows, card):
    """SRDiff training at full width through the real entry points
    (``SRDiffTask``, ``Trainer.fit``, ``DIV2KDataset``, ``DataLoader``), batch
    64 of 160^2 HR crops in bf16: card vs CPU, fit / resume / keep-K, the
    descent, the launches of rows 1-3 under grad, and the times."""
    import tempfile

    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

    res, failures = {}, []
    t_phase = time.perf_counter()
    _train_card_vs_cpu(res, failures)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "png").mkdir()
        t0 = time.perf_counter()
        write_train_pngs(tmp / "png", seed=0)
        res["write_pngs_s"] = time.perf_counter() - t0
        ds = _train_fit(tmp, res, failures, rows)
        task = SRDiffTask(Hparams(**dict(TRAIN_HP, work_dir=str(tmp / "steps"))))
        trainer = task.make_trainer()
        state = trainer.init_state()
        _train_steps(state, trainer, task, ds, res, failures, rows)
        res["timing"]["device_step_ms"] = _train_device_step_ms(state, trainer, ds)
        tm = res["timing"]
        save = sorted(res["fit"]["save_s"])[len(res["fit"]["save_s"]) // 2]
        print(f"{card}: train step B={TRAIN_BATCH} {TRAIN_HR}^2 bf16, median of {TRAIN_TIMED_STEPS} after 2 warm-up: "
              f"{tm['step_ms']:.1f} ms fed by the loader ({tm['crops_per_s']:.1f} HR crops/s, waiting on the loader "
              f"{100 * tm['loader_wait_share']:.1f}%), {tm['device_step_ms']:.1f} ms with the batch ready "
              f"({TRAIN_BATCH / tm['device_step_ms'] * 1e3:.1f} crops/s); peak memory "
              f"{tm['peak_mem_gib']:.2f} GiB (max_memory_allocated); checkpoint save median {save:.3f} s; "
              f"fit's loader wait {100 * res['fit']['loader_wait_share']:.1f}%; the loader alone "
              f"{res['loader_batch_s']:.3f} s a batch ({TRAIN_BATCH / res['loader_batch_s']:.1f} crops/s)", flush=True)
        res["checkpoint_save_s"] = save
    del state
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"train phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


# --------------------------------------------------------------------------
# Data parallelism (phase_dp): parallel/mesh.py under the SRDiff serve and
# the trainer, one process a rank with the environment torchrun sets.
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device), spawned with torch.multiprocessing; then NCCL at world = the
# card count, and dgmsr-torch train under torchrun.
DP_GLOO_WORLD = 2
DP_BATCH, DP_ROUNDS, DP_B1_SERVES = 8, 1, 1  # timed serves cut to one each: the script's time limit
DP_TRAIN_STEPS = 3
DP_BF16_TOL = 3e-2  # max |world W - world 1 serving each rank's rows in a call of its own| in bf16, same draws
# uint8 max of world W against world 1 at batch DP_BATCH in bf16, where cuDNN
# rounds a batch of DP_BATCH / W otherwise than one of DP_BATCH: at most the
# differences between two bf16 routes of one serve in phase 3 (34-63 levels,
# NVIDIA H100 80GB HBM3, 700 W)
DP_UINT8_MAX = 64
DP_F32_TOL = 1e-3   # max |world W - world 1| of the float32 serve (TF32 off), under E2E_TOL
# world W against world 1 on the same card, bf16 training: the loss and the
# gradient norm of the global batch, and the parameters after each step in
# units of the learning rates applied so far (lr_sum, as
# tests/test_torch_port_train_step.py): DP_PARAM_ALL anywhere (a gradient
# element whose sign flips moves Adam by up to 2 lr), DP_PARAM_MEAN on
# average, DP_PARAM_STEADY where |mu| is at least DP_STEADY_MU of its
# tensor's largest.
DP_LOSS_REL, DP_GNORM_REL = 1e-4, 2e-3
# The bf16 gradients of a batch of 32 and of 64 lie percent-level apart
# (cuDNN rounds by shape, as two bf16 routes do: 1.2% of the largest,
# tools/torch_port_train_cpu.py), so where |mu| is half its tensor's
# largest an update moves by under 1% of lr; where it is small, signs flip
# (NVIDIA H100 80GB HBM3, 700 W: 0.13% of the elements moved by more than
# lr in 3 steps, the mean 2.9e-3 lr_sum, the half-max elements 1.8e-3).
DP_PARAM_ALL, DP_PARAM_MEAN, DP_PARAM_STEADY, DP_STEADY_MU = 2.0, 1e-2, 1e-2, 0.5
DP_TIMEOUT_S = 600  # the whole spawn; a collective that waits 120 s fails before


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_serve(rank, world, mesh, counters, res, dtypes, timed):
    """The full-width ddim20 serve of a batch of DP_BATCH at world W against
    the same weights and seed at world 1 (rank 0 alone, a one-rank mesh),
    in each of ``dtypes``; the launches of each rank's serve; in bf16 the
    same serve against world 1 serving each rank's rows in a call of its
    own, fed those rows of the same draws; with ``timed``, bf16 img/s and
    the batch-1 p50 at both worlds, in turns."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import Mesh, barrier

    imgs = np.random.default_rng(0).integers(0, 256, (DP_BATCH, SERVE_LR, SERVE_LR, 3), dtype=np.uint8)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for dtype in dtypes:
        if dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        hp = Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype=dtype)
        pipe = SRDiffPipeline(hp)
        one = SRDiffPipeline(hp, params=pipe.model.state_dict(), mesh=Mesh({"dp": 1}, 0))
        if dtype == "bfloat16":
            pipe.upscale_batch_device(imgs, generator=gen())  # warm-up
        out, dt, launches = _timed_serve(pipe, imgs, counters, generator=gen())
        want = SERVE_LAUNCHES["default"] if dtype == "bfloat16" else _times(forward_launches("default"), 20)
        r = {"launches": launches, "launches_ok": launches == want, "want": want, "s": dt,
             "shape": tuple(out.shape), "finite": bool(torch.isfinite(out).all())}
        if rank == 0:
            ref = one.upscale_batch_device(imgs, generator=gen())
            r["max_abs_vs_world1"] = float((out - ref).abs().max())
            if dtype == "bfloat16":
                r["uint8"] = tuple(torch.round(v * 255).to(torch.uint8).cpu() for v in (out, ref))
                # world 1 in calls of DP_BATCH / W, each fed its rows of the draws that world W made
                # from the same seed for the whole batch: the per-call batch is a rank's
                per, shape = DP_BATCH // world, (DP_BATCH, 3, 4 * SERVE_LR, 4 * SERVE_LR)

                def rows_of(lo, g):
                    return lambda t: torch.randn(shape, generator=g, device="cuda")[lo:lo + per]

                split = torch.cat([one.upscale_batch_device(imgs[lo:lo + per], noise=rows_of(lo, gen()))
                                   for lo in range(0, DP_BATCH, per)])
                r["split_max_abs"] = float((out - split).abs().max())
                del split
        if timed and dtype == "bfloat16":
            w1, w2 = [], []
            for _ in range(DP_ROUNDS):  # world 1 then world W, in turns
                barrier()
                if rank == 0:
                    w1.append(_timed_serve(one, imgs, counters, generator=gen())[1])
                barrier()
                w2.append(_timed_serve(pipe, imgs, counters, generator=gen())[1])
            b1, b2 = [], []
            if rank == 0:  # world 1's first batch-1 call captures its graph: not timed
                _timed_serve(one, imgs[:1], counters, generator=gen())
            for _ in range(DP_B1_SERVES):
                barrier()
                if rank == 0:
                    b1.append(_timed_serve(one, imgs[:1], counters, generator=gen())[1])
                barrier()
                b2.append(_timed_serve(pipe, imgs[:1], counters, generator=gen())[1])
            r.update(world1_s=w1, worldW_s=w2, b1_world1_s=b1, b1_worldW_s=b2)
        res[f"serve_{dtype}"] = r
        del pipe, one
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _dp_all_reduce(grads, mesh) -> dict:
    """The trainer's gradient all-reduce alone over ``grads``: ms of 3 after
    one warm-up, and the MiB."""
    import torch

    from dgm_img_super_resolution_tpu_torch.parallel.mesh import all_reduce_mean

    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean(grads, mesh)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"all_reduce_ms": ms[1:], "grad_mib": sum(t.numel() for t in grads) * 4 / 2**20}


def _dp_params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def _dp_train(rank, world, mesh, counters, work, res):
    """SRDiffTask at full width, bf16, global batch TRAIN_BATCH of
    TRAIN_HR^2: DP_TRAIN_STEPS steps at world W against the same steps at
    world 1 (rank 0 alone) from one state, generator and batches; the
    launches of rows 1-3 (one a forward a rank); both ranks' parameters
    equal; rank 0's checkpoint resumed on every rank; ``reduce_metrics``;
    the step's ms at both worlds and the gradient all-reduce's ms."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dgm_img_super_resolution_tpu_torch.ckpt.ckpt_io import get_all_ckpts
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import Mesh, barrier
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
    from dgm_img_super_resolution_tpu_torch.utils.misc import reduce_metrics

    hp = Hparams(**dict(TRAIN_HP, work_dir=str(work)))
    batches = [_train_batch(TRAIN_BATCH, TRAIN_HR, 60 + i) for i in range(DP_TRAIN_STEPS)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(7)  # noqa: E731

    def steps(trainer, timed=0):
        state, g, out = trainer.init_state(), gen(), []
        for b in batches:
            state, m = trainer.train_step(state, b, g)
            out.append(({k: float(v) for k, v in m.items()}, _dp_params(state.model)))
        ms = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(state, batches[0], g)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return state, out, ms

    if rank == 0:
        _, ref, ms1 = steps(SRDiffTask(hp).make_trainer(mesh=Mesh({"dp": 1}, 0)), timed=3)
    barrier()
    trainer = SRDiffTask(hp).make_trainer()
    torch.cuda.synchronize()
    _reset_counts(counters)
    state, got, _ = steps(trainer)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    want = _times(train_step_launches("default"), DP_TRAIN_STEPS)
    r = {"launches": launches, "launches_ok": launches == want, "want": want}
    flat = torch.cat([p.flatten() for p in got[-1][1].values()])
    other = flat.clone()
    dist.broadcast(other, 0)
    r["ranks_equal"] = bool(torch.equal(flat, other))
    if rank == 0:
        adam, named = state.optimizer.adam.state, dict(state.model.named_parameters())
        trained = [n for n in ref[0][1] if named[n] in adam]  # the fixed RRDB has no gradient
        errs = []
        for i, ((m2, p2), (m1, p1)) in enumerate(zip(got, ref)):
            s = sum(hp["lr"] * 0.5 ** (u // hp["decay_steps"]) for u in range(i + 1))
            d = torch.cat([(p2[n] - p1[n]).abs().flatten() for n in trained])
            fixed = max(float((p2[n] - p1[n]).abs().max()) for n in p1 if n not in trained)
            e = {"loss_rel": abs(m2["loss"] - m1["loss"]) / abs(m1["loss"]),
                 "grad_norm_rel": abs(m2["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"]),
                 "param_max_lr": float(d.max()) / s, "param_mean_lr": float(d.mean()) / s,
                 "flipped_share": float((d > hp["lr"]).float().mean()), "fixed_max": fixed,
                 "loss": m2["loss"], "loss_world1": m1["loss"]}
            if i == len(got) - 1:  # where Adam's first moment is large, the gradient's sign is settled
                for frac in (0.05, DP_STEADY_MU):
                    steady = 0.0
                    for n in trained:
                        m = adam[named[n]]["exp_avg"].abs()
                        mask = m >= frac * m.max()
                        steady = max(steady, float((p2[n] - p1[n]).abs()[mask].max()))
                    e[f"steady{frac}_lr"] = steady / s
            errs.append(e)
        r["errs"] = errs
        r["world1_step_ms"] = ms1
    # the step's ms at world W, and the all-reduce of the gradients alone
    ms = []
    g = gen()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batches[0], g)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    r["step_ms"] = ms
    r.update(_dp_all_reduce([torch.zeros_like(p) for p in state.optimizer.adam.state], mesh))
    # rank 0's one checkpoint, resumed by every rank; the others from a work dir of their own that
    # holds none (a disk local to each host), through rank 0's broadcast
    trainer.save(state, state.step)
    kept = [Path(p).name for p in get_all_ckpts(str(work))]
    fresh = SRDiffTask(hp).make_trainer()
    if rank:
        fresh.work_dir = str(work.parent / f"train_rank{rank}_local")
    ckpt, step = fresh.load_latest()
    fs = fresh.init_state()
    fresh.restore(fs, ckpt)
    same = (step == state.step == fs.step and fs.optimizer.updates == state.optimizer.updates
            and all(torch.equal(v, state.model.state_dict()[k]) for k, v in fs.model.state_dict().items())
            and all(torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
                    for a, b in zip(fs.optimizer.adam.state.values(), state.optimizer.adam.state.values())))
    r.update(checkpoints=kept, saved_step=state.step, resumed_equal=same)
    red = reduce_metrics({"rank": float(rank), "t": torch.tensor(float(rank), device="cuda")}, mesh=mesh)
    r["reduce_metrics"] = [red["rank"], float(red["t"])]
    res["train"] = r
    del state, fs, trainer, fresh
    torch.cuda.empty_cache()


def _dp_rank(rank, world, backend, port, out_dir, train, dtypes, timed):
    """One rank: torchrun's environment, ``init_distributed``, the serve in
    ``dtypes`` (``timed``: in turns with world 1) and, with ``train``, the
    trainer; its results to ``out_dir/rank<R>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from dgm_img_super_resolution_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if not init_distributed(backend=backend, timeout_s=120):
        raise RuntimeError("init_distributed did not join the group")
    try:
        mesh = make_mesh()
        res = {"rank": rank, "backend": dist.get_backend(), "mesh": mesh.shape,
               "device": f"cuda:{torch.cuda.current_device()}"}
        counters = _counters()
        t0 = time.perf_counter()
        _dp_serve(rank, world, mesh, counters, res, dtypes, timed)
        res["serve_part_s"] = time.perf_counter() - t0
        if train:
            t0 = time.perf_counter()
            _dp_train(rank, world, mesh, counters, Path(out_dir) / "train", res)
            res["train_part_s"] = time.perf_counter() - t0
        else:  # the all-reduce of the full-width UNet's gradients, alone
            from dgm_img_super_resolution_tpu_torch.core.config import Hparams
            from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff

            unet = build_srdiff(Hparams()).denoise_fn
            res["all_reduce"] = _dp_all_reduce([torch.zeros_like(p, device="cuda") for p in unet.parameters()], mesh)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dp_spawn(world, backend, tmp, *args, fn=None, name=None) -> list[dict]:
    """``world`` ranks of ``fn`` (``_dp_rank``), their results by rank. A
    rank that raises, or a spawn that outlasts DP_TIMEOUT_S, raises here."""
    import torch
    import torch.multiprocessing as mp

    out = tmp / (name or f"{backend}{world}")
    out.mkdir()
    ctx = mp.start_processes(fn or _dp_rank, args=(world, backend, _free_port(), str(out), *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + DP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{backend} world {world}: ranks still running after {DP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _dp_report(label, ranks, card, failures, rows):
    """Check and print one spawn's results."""
    world = len(ranks)
    r0 = ranks[0]
    print(f"{label}: ranks {[r['rank'] for r in ranks]} on {[r['device'] for r in ranks]}, backend "
          f"{r0['backend']}, mesh {r0['mesh']}; rank 0's serve part {r0['serve_part_s']:.1f} s, training part "
          f"{r0.get('train_part_s', 0.0):.1f} s", flush=True)
    for key in sorted(k for k in r0 if k.startswith("serve_") and isinstance(r0[k], dict)):
        dtype, s = key[len("serve_"):], r0[key]
        launch_ok = all(r[key]["launches_ok"] for r in ranks)
        ok = launch_ok and all(r[key]["finite"] for r in ranks) and s["shape"] == (DP_BATCH, 4 * SERVE_LR,
                                                                                   4 * SERVE_LR, 3)
        if dtype == "float32":
            ok = ok and s["max_abs_vs_world1"] <= DP_F32_TOL
        else:
            ok = ok and s["split_max_abs"] <= DP_BF16_TOL
        print(f"{label}: serve ddim20 {dtype} B={DP_BATCH} {SERVE_LR}->{4 * SERVE_LR} ({DP_BATCH // world} a rank) "
              f"{s['s']:.3f} s, vs world 1 (same weights and seed) max_abs_err {s['max_abs_vs_world1']:.3e}"
              + (f" (tol {DP_F32_TOL})" if dtype == "float32" else
                 f"; vs world 1 serving each rank's rows in a call of its own, the same draws: max_abs_err "
                 f"{s['split_max_abs']:.3e} (tol {DP_BF16_TOL})")
              + f"; launches a rank {[r[key]['launches'] for r in ranks]} (expected {s['want']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{label} serve {dtype}: err {s['max_abs_vs_world1']}, "
                            f"split err {s.get('split_max_abs')}, launches ok {launch_ok}")
        if dtype == "bfloat16":  # bf16 rounds elsewhere at batch DP_BATCH / world: the phase-3 bounds
            s["uint8_vs_world1"] = _uint8_check(f"{label}: bf16 world {world} vs world 1", *s.pop("uint8"),
                                                failures, max_bound=DP_UINT8_MAX)
        for r in ranks:
            _note_launches(rows, f"{label}_serve_{dtype}_rank{r['rank']}", r[key]["launches"])
    s = r0["serve_bfloat16"]
    if "world1_s" in s:
        w1, ww = median(s["world1_s"]), median(s["worldW_s"])
        print(f"{card}: {label} bf16 ddim20 B={DP_BATCH} in turns ({DP_ROUNDS} rounds): world 1 {DP_BATCH / w1:.2f} "
              f"img/s ({w1:.3f} s), world {world} {DP_BATCH / ww:.2f} img/s ({ww:.3f} s; x{w1 / ww:.2f}); batch-1 "
              f"p50 world 1 {median(s['b1_world1_s']):.3f} s, world {world} (split by rows) "
              f"{median(s['b1_worldW_s']):.3f} s", flush=True)
    if "train" not in r0:
        red = r0["all_reduce"]
        print(f"{card}: {label} the gradient all-reduce alone ({red['grad_mib']:.1f} MiB float32) "
              f"{median(red['all_reduce_ms']):.3f} ms" + (" (no collective in a world of 1)" if world == 1 else ""),
              flush=True)
        return
    t = r0["train"]
    launch_ok = all(r["train"]["launches_ok"] for r in ranks)
    worst = {k: max(e[k] for e in t["errs"] if k in e)
             for k in ("loss_rel", "grad_norm_rel", "param_max_lr", "param_mean_lr", "flipped_share",
                       "fixed_max", f"steady{DP_STEADY_MU}_lr", "steady0.05_lr")}
    ok = (worst["loss_rel"] <= DP_LOSS_REL and worst["grad_norm_rel"] <= DP_GNORM_REL
          and worst["param_max_lr"] <= DP_PARAM_ALL and worst["param_mean_lr"] <= DP_PARAM_MEAN
          and worst[f"steady{DP_STEADY_MU}_lr"] <= DP_PARAM_STEADY and worst["fixed_max"] == 0
          and launch_ok and all(r["train"]["ranks_equal"] for r in ranks))
    print(f"{label}: train bf16 B={TRAIN_BATCH} {TRAIN_HR}^2 ({TRAIN_BATCH // world} a rank), {DP_TRAIN_STEPS} steps "
          f"vs world 1 from one state: loss rel {worst['loss_rel']:.2e} (tol {DP_LOSS_REL}), grad_norm rel "
          f"{worst['grad_norm_rel']:.2e} (tol {DP_GNORM_REL}); parameters in lr_sum: max {worst['param_max_lr']:.3e} "
          f"(tol {DP_PARAM_ALL}), mean {worst['param_mean_lr']:.3e} (tol {DP_PARAM_MEAN}), where |mu| >= "
          f"{DP_STEADY_MU} of its tensor's max {worst[f'steady{DP_STEADY_MU}_lr']:.3e} (tol {DP_PARAM_STEADY}; at "
          f"0.05: {worst['steady0.05_lr']:.3e}), moved by more than lr {100 * worst['flipped_share']:.3f}% of "
          f"elements, fixed RRDB {worst['fixed_max']:.1e}; ranks equal {[r['train']['ranks_equal'] for r in ranks]}; "
          f"launches a rank {[r['train']['launches'] for r in ranks]} (expected {t['want']}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{label} train: {worst}, launches ok {launch_ok}")
    for r in ranks:
        _note_launches(rows, f"{label}_train_{DP_TRAIN_STEPS}_steps_rank{r['rank']}", r["train"]["launches"])
    want_mean = sum(range(world)) / world
    ok = (all(r["train"]["checkpoints"] == [f"model_ckpt_steps_{r['train']['saved_step']}.ckpt"] for r in ranks)
          and all(r["train"]["resumed_equal"] for r in ranks)
          and all(r["train"]["reduce_metrics"] == [want_mean, want_mean] for r in ranks))
    print(f"{label}: rank 0's checkpoint {t['checkpoints']}, resumed equal on every rank "
          f"{[r['train']['resumed_equal'] for r in ranks]}; reduce_metrics "
          f"{[r['train']['reduce_metrics'] for r in ranks]} (want {want_mean}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{label} checkpoint / reduce_metrics")
    print(f"{card}: {label} train step B={TRAIN_BATCH} bf16: world 1 {median(t['world1_step_ms']):.1f} ms, world "
          f"{world} {median(t['step_ms']):.1f} ms; the gradient all-reduce alone ({t['grad_mib']:.1f} MiB float32) "
          f"{median(t['all_reduce_ms']):.2f} ms", flush=True)


def _dp_cli(tmp, count, card, failures):
    """``dgmsr-torch train`` under ``torchrun --standalone`` at
    ``--nproc_per_node`` = the card count, on PNGs written from a seed: a
    few updates and one checkpoint."""
    png = tmp / "png"
    png.mkdir()
    write_train_pngs(png, seed=3, n=TRAIN_BATCH)
    work = tmp / "cli_train"
    updates = 4
    hp = (f"work_dir={work},batch_size={TRAIN_BATCH},patch_size={TRAIN_HR},compute_dtype=bfloat16,"
          "data_augmentation=true,num_workers=8,val_check_interval=0,tb_log_interval=2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={count}",
           "-m", "dgm_img_super_resolution_tpu_torch.apps.cli", "train", str(png), "--max_updates", str(updates),
           "-hp", hp]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_TIMEOUT_S, cwd=Path(__file__).parent)
    dt = time.perf_counter() - t0
    files = sorted(p.name for p in work.iterdir()) if work.exists() else []
    log_lines = (work / "metrics.jsonl").read_text().splitlines() if (work / "metrics.jsonl").exists() else []
    ok = (out.returncode == 0 and f"model_ckpt_steps_{updates}.ckpt" in files
          and len(log_lines) == updates // 2)
    print(f"{card}: torchrun --standalone --nproc_per_node={count} dgmsr-torch train, {updates} updates "
          f"B={TRAIN_BATCH} {TRAIN_HR}^2 bf16: rc {out.returncode}, {dt:.1f} s, files {files}, "
          f"{len(log_lines)} log lines "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(out.stdout[-3000:], out.stderr[-3000:], sep="\n", flush=True)
        failures.append(f"torchrun dgmsr-torch train: rc {out.returncode}, files {files}")
    return {"rc": out.returncode, "s": dt, "files": files, "log_lines": len(log_lines)}


def phase_dp(rows, card):
    """Data parallelism: two ranks sharing the card over gloo (serve in
    bf16 and float32, training, checkpoint, ``reduce_metrics``, times in
    turns); NCCL at world = the card count (the serve through the mesh code;
    at 2 or more cards the training too, at world min(count, 4)); and
    ``dgmsr-torch train`` under torchrun."""
    import tempfile

    import torch

    res, failures = {}, []
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        both = ("bfloat16", "float32")
        # (backend, world, train, serve dtypes, timed in turns); NCCL at world 1 serves through the mesh code
        runs = [("gloo", DP_GLOO_WORLD, True, both, True),
                ("nccl", min(count, 4), count >= 2, both if count >= 2 else both[:1], count >= 2)]
        for backend, world, *args in runs:
            label = f"dp {backend} world {world}" + (" on one card" if world > count else "")
            try:
                ranks = _dp_spawn(world, backend, tmp, *args)
            except Exception as e:  # a rank's error, printed; the phase fails
                print(f"{label}: FAIL {type(e).__name__}: {e}", flush=True)
                failures.append(f"{label}: {type(e).__name__}")
                continue
            _dp_report(label, ranks, card, failures, rows)
            res[f"{backend}{world}"] = ranks
        res["cli"] = _dp_cli(tmp, count, card, failures)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"dp phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


# --------------------------------------------------------------------------
# Spatial sharding (phase_sp): parallel/mesh.py's sp axis under the SRDiff
# serve and the trainer. Four ranks share the one card over gloo on mesh
# dp=2,sp=2, spawned as phase_dp's ranks. A batch-1 request splits its image
# rows over all four (JAX's shard_spatial), its regions under
# kernels_disabled() (JAX's _with_pallas_disabled): no kernel launches there.
SP_WORLD, SP_SPEC = 4, "dp=2,sp=2"
SP_B1_SERVES, SP_STEP_ROUNDS = 1, 1  # timed serves and steps cut to one each: the script's time limit
SP_TRAIN_SEED = 70


def _sp_zero_paths(rows, path, launches):
    """Record a path's launches, zeros included, on every row of the table."""
    for row in rows:
        row.setdefault("launches_paths", {})[path] = launches.get(row["name"], 0)


def _sp_halo(pipe, mesh, rank) -> dict:
    """A UNet step of the split batch-1 serve: its collectives (from the
    split's trace), and their replay alone, ms of 5 after one warm-up."""
    import torch

    from dgm_img_super_resolution_tpu_torch.models.layers import kernels_disabled
    from dgm_img_super_resolution_tpu_torch.ops import rowsplit
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import row_split

    unet = pipe.model.denoise_fn
    hr, c = 4 * SERVE_LR // SP_WORLD, unet.dim
    g = torch.Generator(device="cuda").manual_seed(rank)
    x = torch.randn((1, 3, hr, 4 * SERVE_LR), generator=g, device="cuda")
    cond = torch.randn((1, c, hr, 4 * SERVE_LR), generator=g, device="cuda").to(unet.dtype)
    t = torch.full((1,), 500, device="cuda", dtype=torch.long)
    trace = []
    with torch.inference_mode(), kernels_disabled():
        with row_split(mesh, trace=trace):
            unet(x, t, cond, cond_projected=True, up_folded=True)
        bufs = [torch.zeros(shape, dtype=d, device="cuda") for _, shape, d in trace]
        ms = []
        with row_split(mesh):
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in bufs:
                    rowsplit.halo(b, 1)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
    return {"count": len(trace), "kinds": sorted({k for k, _, _ in trace}), "ms": ms[1:],
            "mib": sum(SP_WORLD * 2 * s[0] * s[1] * s[3] * torch.tensor([], dtype=d).element_size()
                       for _, s, d in trace) / 2**20}


def _sp_serve(rank, mesh, counters, res):
    """The batch-1 serve split by rows, float32 and bf16, against world 1;
    a batch of 4 on dp; the batch-1 p50 and a UNet step's halo exchanges,
    timed in turns with world 1."""
    import contextlib as cl

    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.models.layers import kernels_disabled
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import Mesh, barrier

    imgs = np.random.default_rng(1).integers(0, 256, (4, SERVE_LR, SERVE_LR, 3), dtype=np.uint8)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for dtype in ("float32", "bfloat16"):
        f32 = dtype == "float32"
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (False, False) if f32 else tf32
        hp = Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype=dtype)
        pipe = SRDiffPipeline(hp, mesh=mesh)
        one = SRDiffPipeline(hp, params=pipe.model.state_dict(), mesh=Mesh({"dp": 1}, 0))
        if not f32:
            pipe.upscale_batch_device(imgs[:1], generator=gen())  # warm-up
        out, dt, launches = _timed_serve(pipe, imgs[:1], counters, generator=gen(), as_uint8=not f32)
        r = {"spatial": pipe._spatial_serving(1, SERVE_LR), "launches": launches, "s": dt,
             "shape": tuple(out.shape), "finite": bool(torch.isfinite(out.float()).all())}
        if rank == 0:
            with cl.nullcontext() if f32 else kernels_disabled():
                ref = one.upscale_batch_device(imgs[:1], generator=gen(), as_uint8=not f32)
            if f32:
                r["max_abs_vs_world1"] = float((out - ref).abs().max())
            else:
                r["uint8"] = (out.cpu(), ref.cpu())
        if not f32:
            _, _, r["b4_launches"] = _timed_serve(pipe, imgs, counters, generator=gen())
            r["halo"] = _sp_halo(pipe, mesh, rank)
            b1, bw = [], []
            if rank == 0:  # world 1's first batch-1 call captures its graph: not timed
                _timed_serve(one, imgs[:1], counters, generator=gen())
            for _ in range(SP_B1_SERVES):  # world 1 (its kernels) then world 4 (split), in turns
                barrier()
                if rank == 0:
                    b1.append(_timed_serve(one, imgs[:1], counters, generator=gen())[1])
                barrier()
                bw.append(_timed_serve(pipe, imgs[:1], counters, generator=gen())[1])
            r.update(b1_world1_s=b1, b1_worldW_s=bw)
        res[f"serve_{dtype}"] = r
        del pipe, one
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _sp_train(rank, mesh, counters, work, res):
    """One float32 spatial step at batch 64 of 160^2 against world 1 (rank
    0 alone) from one state, generator and batch; every rank's parameters
    equal; then the bf16 step's ms at both worlds, in turns."""
    import torch
    import torch.distributed as dist

    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import Mesh, barrier
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

    batch = _train_batch(TRAIN_BATCH, TRAIN_HR, SP_TRAIN_SEED)
    gen = lambda: torch.Generator(device="cuda").manual_seed(7)  # noqa: E731
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    hp = Hparams(**dict(TRAIN_HP, compute_dtype="float32", work_dir=str(work)))
    if rank == 0:
        tr1 = SRDiffTask(hp).make_trainer(mesh=Mesh({"dp": 1}, 0))
        s1, m1 = tr1.train_step(tr1.init_state(), batch, gen())
        m1, p1 = {k: float(v) for k, v in m1.items()}, _dp_params(s1.model)
        del tr1, s1
    barrier()
    trainer = SRDiffTask(hp).make_trainer(mesh=mesh)
    state = trainer.init_state()
    torch.cuda.synchronize()
    _reset_counts(counters)
    state, m2 = trainer.train_step(state, batch, gen(), spatial=True)
    torch.cuda.synchronize()
    r = {"launches": {k: v for k, v in _read_counts(counters).items() if v}}
    p2 = _dp_params(state.model)
    flat = torch.cat([p.flatten() for p in p2.values()])
    other = flat.clone()
    dist.broadcast(other, 0)
    r["ranks_equal"] = bool(torch.equal(flat, other))
    if rank == 0:
        m2 = {k: float(v) for k, v in m2.items()}
        adam, named = state.optimizer.adam.state, dict(state.model.named_parameters())
        trained = [n for n in p1 if named[n] in adam]
        s = hp["lr"]
        d = torch.cat([(p2[n] - p1[n]).abs().flatten() for n in trained])
        steady = 0.0
        for n in trained:
            mu = adam[named[n]]["exp_avg"].abs()
            steady = max(steady, float((p2[n] - p1[n]).abs()[mu >= DP_STEADY_MU * mu.max()].max()))
        r["errs"] = {"loss_rel": abs(m2["loss"] - m1["loss"]) / abs(m1["loss"]),
                     "grad_norm_rel": abs(m2["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"]),
                     "param_max_lr": float(d.max()) / s, "param_mean_lr": float(d.mean()) / s,
                     "steady_lr": steady / s,
                     "fixed_max": max(float((p2[n] - p1[n]).abs().max()) for n in p1 if n not in trained),
                     "loss": m2["loss"], "loss_world1": m1["loss"]}
    del state, trainer
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    # the bf16 step's ms: world 1 (rank 0, its kernels) and the split step, in turns after a warm-up each
    hp16 = Hparams(**dict(TRAIN_HP, work_dir=str(work)))
    st = SRDiffTask(hp16).make_trainer(mesh=mesh)
    state = st.init_state()
    one = SRDiffTask(hp16).make_trainer(mesh=Mesh({"dp": 1}, 0)) if rank == 0 else None
    s1 = one.init_state() if one is not None else None
    g = gen()
    ms1, msw = [], []
    for i in range(SP_STEP_ROUNDS + 1):
        barrier()
        if one is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.train_step(s1, batch, g)
            torch.cuda.synchronize()
            ms1.append(1e3 * (time.perf_counter() - t0))
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.train_step(state, batch, g, spatial=True)
        torch.cuda.synchronize()
        msw.append(1e3 * (time.perf_counter() - t0))
    r.update(step_ms_world1=ms1[1:], step_ms=msw[1:])
    res["train"] = r
    del state, st, one, s1
    torch.cuda.empty_cache()


def _sp_rank(rank, world, backend, port, out_dir):
    """One rank of mesh SP_SPEC: torchrun's environment,
    ``init_distributed``, the serve and the training step; its results to
    ``out_dir/rank<R>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from dgm_img_super_resolution_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if not init_distributed(backend=backend, timeout_s=120):
        raise RuntimeError("init_distributed did not join the group")
    try:
        mesh = make_mesh(SP_SPEC)
        res = {"rank": rank, "backend": dist.get_backend(), "mesh": mesh.shape,
               "coords": (mesh.dp_rank, mesh.sp_rank), "device": f"cuda:{torch.cuda.current_device()}"}
        counters = _counters()
        t0 = time.perf_counter()
        _sp_serve(rank, mesh, counters, res)
        res["serve_part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _sp_train(rank, mesh, counters, Path(out_dir) / "train", res)
        res["train_part_s"] = time.perf_counter() - t0
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_sp(rows, card):
    """Spatial sharding: four ranks sharing the card over gloo on mesh
    dp=2,sp=2 (the batch-1 serve split by rows in float32 and bf16 against
    world 1 with 0 launches, a batch of 4 on dp with its launches, one
    float32 spatial training step against world 1, times in turns)."""
    import tempfile

    import torch

    res, failures = {}, []
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    label = f"sp gloo world {SP_WORLD} {SP_SPEC} on one card"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            ranks = _dp_spawn(SP_WORLD, "gloo", Path(tmp), fn=_sp_rank, name="sp")
        except Exception as e:  # a rank's error, printed; the phase fails
            print(f"{label}: FAIL {type(e).__name__}: {e}", flush=True)
            failures.append(f"{label}: {type(e).__name__}")
            ranks = None
    if ranks is not None:
        r0 = ranks[0]
        print(f"{label}: ranks {[r['rank'] for r in ranks]} at (dp, sp) {[r['coords'] for r in ranks]}, backend "
              f"{r0['backend']}, mesh {r0['mesh']}; rank 0's serve part {r0['serve_part_s']:.1f} s, training part "
              f"{r0['train_part_s']:.1f} s", flush=True)
        shape = (1, 4 * SERVE_LR, 4 * SERVE_LR, 3)
        for dtype in ("float32", "bfloat16"):
            key, s = f"serve_{dtype}", r0[f"serve_{dtype}"]
            zero = all(not r[key]["launches"] for r in ranks)
            ok = zero and all(r[key]["spatial"] and r[key]["finite"] and r[key]["shape"] == shape for r in ranks)
            if dtype == "float32":
                ok = ok and s["max_abs_vs_world1"] <= DP_F32_TOL
            print(f"{label}: serve ddim20 {dtype} B=1 {SERVE_LR}->{4 * SERVE_LR} split by rows "
                  f"({SERVE_LR // SP_WORLD} LR rows a rank) {s['s']:.3f} s"
                  + (f", vs world 1 max_abs_err {s['max_abs_vs_world1']:.3e} (tol {DP_F32_TOL})" if dtype == "float32"
                     else "") + f"; launches a rank {[r[key]['launches'] for r in ranks]} (expected none) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"{label} serve {dtype}: zero launches {zero}, err {s.get('max_abs_vs_world1')}")
            if dtype == "bfloat16":
                s["uint8_vs_world1"] = _uint8_check(f"{label}: bf16 split vs world 1 under kernels_disabled()",
                                                    *s.pop("uint8"), failures, max_bound=DP_UINT8_MAX)
            merged = {}
            for r in ranks:
                for k, v in r[key]["launches"].items():
                    merged[k] = max(merged.get(k, 0), v)
            _sp_zero_paths(rows, f"sp_serve_b1_{dtype}", merged)
        s = r0["serve_bfloat16"]
        want = SERVE_LAUNCHES["default"]
        ok = all(r["serve_bfloat16"]["b4_launches"] == want for r in ranks)
        print(f"{label}: serve bf16 B=4 on dp (2 a rank, replicated over sp): launches a rank "
              f"{[r['serve_bfloat16']['b4_launches'] for r in ranks]} (expected {want}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"{label} serve B=4 launches")
        for r in ranks:
            _note_launches(rows, f"sp_serve_b4_rank{r['rank']}", r["serve_bfloat16"]["b4_launches"])
        h = s["halo"]
        print(f"{card}: {label} bf16 batch-1 p50 in turns ({SP_B1_SERVES} each): world 1 (kernels) "
              f"{median(s['b1_world1_s']):.3f} s, world {SP_WORLD} split {median(s['b1_worldW_s']):.3f} s; a UNet "
              f"step's collectives {h['count']} ({', '.join(h['kinds'])}; {h['mib']:.1f} MiB of buffers), replayed "
              f"alone {median(h['ms']):.2f} ms", flush=True)
        t = r0["train"]
        e = t["errs"]
        zero = all(not r["train"]["launches"] for r in ranks)
        ok = (e["loss_rel"] <= DP_LOSS_REL and e["grad_norm_rel"] <= DP_GNORM_REL
              and e["param_max_lr"] <= DP_PARAM_ALL and e["param_mean_lr"] <= DP_PARAM_MEAN
              and e["steady_lr"] <= DP_PARAM_STEADY and e["fixed_max"] == 0 and zero
              and all(r["train"]["ranks_equal"] for r in ranks))
        print(f"{label}: train float32 B={TRAIN_BATCH} {TRAIN_HR}^2 (batch over dp, {TRAIN_HR // 2} HR rows a rank "
              f"over sp), one step vs world 1 from one state: loss rel {e['loss_rel']:.2e} (tol {DP_LOSS_REL}), "
              f"grad_norm rel {e['grad_norm_rel']:.2e} (tol {DP_GNORM_REL}); parameters in lr: max "
              f"{e['param_max_lr']:.3e} (tol {DP_PARAM_ALL}), mean {e['param_mean_lr']:.3e} (tol {DP_PARAM_MEAN}), "
              f"where |mu| >= {DP_STEADY_MU} of its tensor's max {e['steady_lr']:.3e} (tol {DP_PARAM_STEADY}), "
              f"fixed RRDB {e['fixed_max']:.1e}; ranks equal {[r['train']['ranks_equal'] for r in ranks]}; "
              f"launches {[r['train']['launches'] for r in ranks]} (expected none) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"{label} train: {e}, zero launches {zero}")
        _sp_zero_paths(rows, "sp_train_step_float32", {})
        print(f"{card}: {label} train step B={TRAIN_BATCH} bf16 in turns: world 1 (kernels) "
              f"{median(t['step_ms_world1']):.1f} ms, world {SP_WORLD} split {median(t['step_ms']):.1f} ms", flush=True)
        res["ranks"] = ranks
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"sp phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


# --------------------------------------------------------------------------
# The educational models (phase_edu), the native resize (phase_native) and
# the SRDiff sampler API / SD class embedding repairs (phase_sampler_api).
# None of these paths runs a port kernel, as in the JAX package: the
# counters must read 0 across them.
EDU_TASKS = ("ae", "vae", "ddpm", "gan", "dcgan", "wgan-gp")
EDU_BATCH, EDU_DDPM_BATCH = 128, 64  # the timed steps' batch (the DDPM at 64)
EDU_CHECK_BATCH = 8  # card vs CPU: the CPU runs the same float32 step
EDU_DESCENT_STEPS, EDU_TIMED_STEPS = 10, 10
EDU_SAMPLE_N, EDU_SAMPLE_T = 16, 250  # the DDPM chain cut from the default T = 1000
EDU_HP = dict(compute_dtype="float32", lr=1e-3, clip_grad_norm=10.0, val_check_interval=0, tb_log_interval=1000)
# A BatchNorm output within this of 0 may fall on either side of the (leaky) ReLU's kink on the card and
# on the CPU (their batch variances sum in other orders), which changes that channel's gradient by one
# activation's share: its BatchNorm and conv channel are then held to Adam's two-step bound alone.
EDU_KINK = 1e-6
EDU_STEP_FRAC = 2e-2  # a conditioned parameter's card-vs-CPU difference, in Adam steps (lr)


def _edu_task(kind, device):
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.train.tasks.gan import GANTask
    from dgm_img_super_resolution_tpu_torch.train.tasks.vae import AETask, DDPMTask, VAETask

    hp = Hparams(**EDU_HP)
    if kind in ("gan", "dcgan", "wgan-gp"):
        return GANTask(hp, kind=kind, device=device)
    return {"ae": AETask, "vae": VAETask, "ddpm": DDPMTask}[kind](hp, device=device)


def _edu_images(n, size, seed, unit):
    """n synthetic MNIST digits, NHWC float32 in [0, 1] (``unit``) or [-1, 1]."""
    from dgm_img_super_resolution_tpu_torch.data.mnist import synthetic_mnist, to_model_input

    x = to_model_input(synthetic_mnist(n, seed=seed)[0], size)
    return (x + 1.0) / 2.0 if unit else x


def _edu_batch(kind, n, seed=0):
    if kind in ("gan", "dcgan", "wgan-gp"):
        return _edu_images(n, 28, seed, unit=False)
    return {"x": _edu_images(n, 32, seed, unit=kind != "ddpm")}


def _edu_loss_kw(kind, n, device, seed):
    """The draws of one loss, made on the CPU and fed to both devices."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if kind == "vae":
        return {"eps": torch.randn(n, 16, generator=g).to(device)}
    if kind == "ddpm":
        return {"t": torch.randint(0, 1000, (n,), generator=g).to(device),
                "noise": torch.randn(n, 1, 32, 32, generator=g).to(device)}
    return {}


def _gan_draws(task, n, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {("z_gen", 0): torch.randn(n, task.z_dim, generator=g)}
    for k in range(task.crit_repeats):
        out[("z", k)] = torch.randn(n, task.z_dim, generator=g)
        out[("eps", k)] = torch.rand(n, 1, 1, 1, generator=g)
    return out


def _edu_loss_card_vs_cpu(kind, dev, res, failures):
    """One float32 loss and its gradients on the card and the CPU, the same
    weights and draws."""
    import torch

    cpu_task, dev_task = _edu_task(kind, "cpu"), _edu_task(kind, dev)
    cpu_model = cpu_task.init_params(0)
    dev_model = dev_task.init_params(0).to(dev)
    dev_model.load_state_dict(cpu_model.state_dict())
    batch = _edu_batch(kind, EDU_CHECK_BATCH)
    out = {}
    for name, task, model, d in (("cpu", cpu_task, cpu_model, "cpu"), ("dev", dev_task, dev_model, dev)):
        model.zero_grad(set_to_none=True)
        b = {"x": torch.from_numpy(batch["x"]).permute(0, 3, 1, 2).to(d)}
        loss, _ = task.loss_fn(model, b, None, **_edu_loss_kw(kind, EDU_CHECK_BATCH, d, seed=1))
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (lc, gc), (ld, gd) = out["cpu"], out["dev"]
    loss_rel = abs(ld - lc) / max(abs(lc), 1e-12)
    worst, where = 0.0, None
    for n, g in gc.items():
        e = (gd[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        if e > worst:
            worst, where = e, n
    ok = loss_rel <= F32_TOL and worst <= GRAD_TOL
    print(f"card vs CPU, f32 {kind} loss and gradients B={EDU_CHECK_BATCH}: loss {ld:.6f} vs {lc:.6f} "
          f"(rel {loss_rel:.2e}, tol {F32_TOL}), worst gradient {worst:.2e} of its max |CPU grad| at {where} "
          f"(tol {GRAD_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
    res["card_vs_cpu"] = {"loss": ld, "loss_cpu": lc, "loss_rel": loss_rel, "grad_worst": worst, "grad_worst_at": where}
    if not ok:
        failures.append(f"edu {kind} card vs CPU")


def _kink_channels(state):
    """Forward hooks on every BatchNorm: the (model, module, channel)s with
    an output within ``EDU_KINK`` of 0. Returns (found, remove)."""
    from dgm_img_super_resolution_tpu_torch.models.layers import BatchNorm

    found, handles = set(), []
    for part, mod in (("gen", state.gen), ("disc", state.disc)):
        for name, m in mod.named_modules():
            if isinstance(m, BatchNorm):
                def hook(m, i, o, part=part, name=name):
                    near = (o.detach().abs() < EDU_KINK).transpose(0, 1).reshape(o.shape[1], -1).any(dim=1)
                    found.update((part, name, int(c)) for c in near.nonzero().flatten().tolist())
                handles.append(m.register_forward_hook(hook))
    return found, lambda: [h.remove() for h in handles]


def _kink_free(part, pname, shape, kinks):
    """False on the elements a kink channel's gradient reaches: its
    BatchNorm's weight and bias, its conv's (``conv<i>`` / ``deconv<i>``
    before ``bn<i>``) output channel."""
    import torch

    free = torch.ones(shape, dtype=torch.bool)
    prefix, _, leaf = pname.rpartition(".")
    parent, _, mod = prefix.rpartition(".")
    for kpart, kname, c in kinks:
        kparent, _, kmod = kname.rpartition(".")
        idx = kmod.removeprefix("bn")
        if kpart != part or kparent != parent:
            continue
        if mod == kmod or (mod in (f"conv{idx}", f"deconv{idx}") and leaf == "bias") or mod == f"conv{idx}":
            free[c] = False
        elif mod == f"deconv{idx}":
            free[:, c] = False
    return free


def _gan_state_into(dst, src):
    """Copy a GANState's models and optimizers into ``dst`` (the optimizers'
    state deep-copied: on one device ``load_state_dict`` would share it)."""
    import copy

    from dgm_img_super_resolution_tpu_torch.train.trainer import adam_state_dict, load_adam_state

    dst.gen.load_state_dict(src.gen.state_dict())
    dst.disc.load_state_dict(src.disc.state_dict())
    load_adam_state(dst.gen_opt, copy.deepcopy(adam_state_dict(src.gen_opt)))
    load_adam_state(dst.disc_opt, copy.deepcopy(adam_state_dict(src.disc_opt)))


def _gan_round_card_vs_cpu(kind, dev, res, failures):
    """One whole round (K critic updates, then the generator's) on the card
    and the CPU, update by update from the CPU's state, the same draws:
    each update's loss (rel F32_TOL), its model's BatchNorm statistics (rel
    F32_TOL), Adam's first moments (GRAD_TOL of the model's largest), the
    parameters (EDU_STEP_FRAC of a step where a gradient error of
    GRAD_TOL moves Adam's step by less, two steps elsewhere; a conv bias
    before a train-mode BatchNorm has a gradient of exactly 0, so Adam
    moves it by rounding noise on each side)."""
    import torch

    from dgm_img_super_resolution_tpu_torch.train.tasks.gan import _draw_fn

    cpu_task, dev_task = _edu_task(kind, "cpu"), _edu_task(kind, dev)
    cs, ds = cpu_task.init_state(0), dev_task.init_state(0)
    n = EDU_CHECK_BATCH
    real = _edu_batch(kind, n)
    draws = _gan_draws(cpu_task, n, seed=2)

    updates = [("disc", k) for k in range(cpu_task.crit_repeats)] + [("gen", 0)]
    worst = {"loss": 0.0, "stats": 0.0, "moment": 0.0, "param_steps": 0.0, "param_steps_unconditioned": 0.0}
    bad = []
    for which, k in updates:
        _gan_state_into(ds, cs)
        before = {i: st["exp_avg"].clone() for i, st in getattr(cs, which + "_opt").state_dict()["state"].items()}
        outs = {}
        for name, task, st, d in (("cpu", cpu_task, cs, "cpu"), ("dev", dev_task, ds, dev)):
            draw = _draw_fn(draws, None, torch.device(d))
            kinks, unhook = _kink_channels(st)
            if which == "disc":
                loss, _ = task._disc_update(st, task._real(real), k, draw)
            else:
                loss = task._gen_update(st, n, draw)
            unhook()
            outs[name] = (loss.item(), kinks)
        (lc, kc), (ld, kd) = outs["cpu"], outs["dev"]
        kinks = kc | kd
        worst["loss"] = max(worst["loss"], abs(ld - lc) / max(abs(lc), 1e-12))
        for part in ("gen", "disc"):
            cm, dm = getattr(cs, part), getattr(ds, part)
            csd, dsd = cm.state_dict(), dm.state_dict()
            for key in [k_ for k_ in csd if "running_" in k_]:
                e = (dsd[key].cpu() - csd[key]).abs().max().item() / max(csd[key].abs().max().item(), 1.0)
                worst["stats"] = max(worst["stats"], e)
            if part != which:
                continue
            names = [n_ for n_, _ in cm.named_parameters()]
            copt = getattr(cs, part + "_opt").state_dict()["state"]
            dopt = getattr(ds, part + "_opt").state_dict()["state"]
            mu_max = max(copt[i]["exp_avg"].abs().max().item() for i in range(len(names)))
            b1 = cpu_task.b1
            for i, pn in enumerate(names):
                mu_c, mu_d = copt[i]["exp_avg"], dopt[i]["exp_avg"].cpu()
                g = (mu_c - (b1 * before[i] if i in before else 0.0)) / (1.0 - b1)  # this update's gradient
                free = _kink_free(part, pn, g.shape, kinks)
                e = ((mu_d - mu_c).abs() * free).max().item() / mu_max
                worst["moment"] = max(worst["moment"], e)
                delta = GRAD_TOL * (1.0 - b1) * mu_max
                cond = ((g.abs() + 1e-8) ** 2 >= 1e-8 * delta / EDU_STEP_FRAC) & free
                diff = (dsd[pn].cpu() - csd[pn]).abs() / cpu_task.lr
                if cond.any():
                    worst["param_steps"] = max(worst["param_steps"], diff[cond].max().item())
                worst["param_steps_unconditioned"] = max(worst["param_steps_unconditioned"], diff.max().item())
        if worst["loss"] > F32_TOL or worst["stats"] > F32_TOL or worst["moment"] > GRAD_TOL:
            bad.append(f"{which}{k}")
    ok = (not bad and worst["param_steps"] <= EDU_STEP_FRAC + 1e-3 and worst["param_steps_unconditioned"] <= 2.0)
    print(f"card vs CPU, f32 {kind} round of {len(updates)} updates B={n}, update by update: worst loss rel "
          f"{worst['loss']:.2e}, BatchNorm statistics {worst['stats']:.2e} (tol {F32_TOL}), Adam first moment "
          f"{worst['moment']:.2e} of the largest (tol {GRAD_TOL}), parameters {worst['param_steps']:.2e} Adam steps "
          f"where conditioned (tol {EDU_STEP_FRAC}), {worst['param_steps_unconditioned']:.2f} anywhere (tol 2) "
          f"{'ok' if ok else 'FAIL ' + ','.join(bad)}", flush=True)
    res["card_vs_cpu"] = worst
    if not ok:
        failures.append(f"edu {kind} card vs CPU round")


def _edu_descent_and_time(kind, dev, res, failures):
    """Ten updates on one batch lower the loss (a GAN's: the discriminator's
    loss of the round, on fixed draws); then the step's (round's) time with
    the batch on the card, at EDU_BATCH (the DDPM at EDU_DDPM_BATCH)."""
    import numpy as np
    import torch

    task = _edu_task(kind, dev)
    n = EDU_DDPM_BATCH if kind == "ddpm" else EDU_BATCH
    gan = kind in ("gan", "dcgan", "wgan-gp")
    if gan:
        state = task.init_state(0)
        real = task._real(_edu_batch(kind, n, seed=3))
        draws = {k: v.to(dev) for k, v in _gan_draws(task, n, seed=4).items()}

        def step():
            return task.train_step(state, real, noise=draws)[1]["disc_loss"]
    else:
        trainer = task.make_trainer(dev)
        state = trainer.init_state(0)
        b = {"x": torch.from_numpy(_edu_batch(kind, n, seed=3)["x"]).to(dev)}  # NHWC, on the card: the batch ready
        kw = _edu_loss_kw(kind, n, dev, seed=5)  # the same draws every step: one objective

        def step():
            return trainer.train_step(state, b, None, **kw)[1]["loss"]
    losses = [float(step()) for _ in range(EDU_DESCENT_STEPS + 1)]
    ok = losses[-1] < losses[0] and all(np.isfinite(losses))
    ms = []
    for _ in range(EDU_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    step_ms = float(np.median(ms))
    what = "round (K critic updates + 1 generator update)" if gan else "training step"
    print(f"{kind}: {EDU_DESCENT_STEPS} updates on one batch {'(the discriminator loss) ' if gan else ''}"
          f"{losses[0]:.4f} -> {losses[-1]:.4f} {'ok' if ok else 'FAIL'}; {what} B={n} median of "
          f"{EDU_TIMED_STEPS}: {step_ms:.2f} ms ({n / step_ms * 1e3:.1f} images/s)", flush=True)
    res.update(descent=losses, step_ms=step_ms, images_per_s=n / step_ms * 1e3, batch=n)
    if not ok:
        failures.append(f"edu {kind} descent")
    return task, state


def phase_edu(rows, card, dev="cuda"):
    """The six educational tasks at the JAX defaults' widths: card vs CPU,
    the descent, the step times; GANTask.fit with validation and its model
    IO; the VAE and DDPM samplers timed; every kernel counter 0 across it."""
    import itertools
    import tempfile

    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _counters()
    _reset_counts(counters)
    t_phase = time.perf_counter()
    res, failures, kept = {}, [], {}
    for kind in EDU_TASKS:
        r = res[kind] = {}
        if kind in ("gan", "dcgan", "wgan-gp"):
            _gan_round_card_vs_cpu(kind, dev, r, failures)
        else:
            _edu_loss_card_vs_cpu(kind, dev, r, failures)
        kept[kind] = _edu_descent_and_time(kind, dev, r, failures)

    task = _edu_task("wgan-gp", dev)
    data = itertools.repeat(_edu_batch("wgan-gp", 64, seed=6))
    t0 = time.perf_counter()
    state, results = task.fit(data, epochs=1, steps_per_epoch=4, seed=0, val_iter=data, val_steps=2)
    fit_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        task.save_model_info(state, tmp)
        loaded = task.load_model_info(tmp)
    same = all(torch.equal(a, b) for m, l in ((state.gen, loaded.gen), (state.disc, loaded.disc))
               for a, b in zip(m.state_dict().values(), l.state_dict().values()))
    same = same and loaded.step == state.step and all(
        torch.equal(a[k], b[k]) for o, lo in ((state.gen_opt, loaded.gen_opt), (state.disc_opt, loaded.disc_opt))
        for a, b in zip(o.state_dict()["state"].values(), lo.state_dict()["state"].values()) for k in a)
    finite = all(v == v and abs(v) < float("inf") for vs in results.values() for v in vs)
    ok = same and finite and all(len(v) == 1 for v in results.values())
    print(f"wgan-gp fit: 1 epoch of 4 rounds B=64 + 2 validation batches in {fit_s:.2f} s, losses "
          f"{ {k: round(v[0], 4) for k, v in results.items()} }; save_model_info / load_model_info give back "
          f"the same state: {'ok' if ok else 'FAIL'}", flush=True)
    res["fit"] = {"seconds": fit_s, "results": results, "round_trip_equal": same}
    if not ok:
        failures.append("edu GAN fit / model IO")

    (vae_task, vae_state), (ddpm_task, ddpm_state) = kept["vae"], kept["ddpm"]
    vae_model, ddpm_model = vae_state.model, ddpm_state.model
    g = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = vae_task.sample(vae_model, n=EDU_SAMPLE_N, generator=g)
    torch.cuda.synchronize()
    vae_ms = 1e3 * (time.perf_counter() - t0)
    steps = EDU_SAMPLE_T
    if steps != ddpm_task.ddpm.num_timesteps:
        from dgm_img_super_resolution_tpu_torch.core.config import Hparams
        from dgm_img_super_resolution_tpu_torch.train.tasks.vae import DDPMTask

        short = DDPMTask(Hparams(**dict(EDU_HP, ddpm_timesteps=steps)), device=dev)
        short.model.load_state_dict(ddpm_model.state_dict())
        ddpm_task, ddpm_model = short, short.model.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graphs.eager():  # the eager chain, as timed before; phase_graphs captures and times its replay
        s = ddpm_task.sample(ddpm_model, n=EDU_SAMPLE_N, generator=g)
    torch.cuda.synchronize()
    ddpm_s = time.perf_counter() - t0
    ok = (tuple(v.shape) == (EDU_SAMPLE_N, 1, 32, 32) and tuple(s.shape) == (EDU_SAMPLE_N, 1, 32, 32)
          and bool(torch.isfinite(v).all() and torch.isfinite(s).all()) and 0 <= float(v.min())
          and float(v.max()) <= 1)
    print(f"{card}: VAE sample of {EDU_SAMPLE_N} in {vae_ms:.2f} ms; DDPM sample of {EDU_SAMPLE_N} at 32x32 over "
          f"T = {steps} (cut from 1000; phase_graphs replays it) in {ddpm_s:.2f} s "
          f"({steps / ddpm_s:.1f} UNet calls/s) {'ok' if ok else 'FAIL'}", flush=True)
    res["samplers"] = {"vae_ms": vae_ms, "ddpm_s": ddpm_s, "ddpm_T": steps, "n": EDU_SAMPLE_N}
    if not ok:
        failures.append("edu samplers")

    launches = {k: v for k, v in _read_counts(counters).items() if v}
    print(f"edu phase kernel launches: {launches or 'none'} {'ok' if not launches else 'FAIL'}", flush=True)
    if launches:
        failures.append(f"edu phase launched port kernels {launches}")
    for row in rows:
        if "shape" not in row:
            row.setdefault("launches_paths", {})["edu_phase"] = launches.get(row["name"], 0)
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"edu phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


# The example scripts (phase_examples) at JAX's default widths and batch, EXAMPLE_STEPS steps each (cut
# from the scripts' default 500): (script, arguments, grid, its side). The first run draws the scripts'
# default synthetic set; the others read the same 8192 images from an MNIST IDX directory.
EXAMPLE_STEPS = 100
EXAMPLES = (("train_vae", ["--model", "vae"], "vae_samples.png", 128),
            ("train_vae", ["--model", "ae"], "ae_recon.png", 128),
            ("train_gan", ["--kind", "gan"], f"gan_samples_{EXAMPLE_STEPS}.png", 112),
            ("train_gan", ["--kind", "dcgan"], f"dcgan_samples_{EXAMPLE_STEPS}.png", 112),
            ("train_gan", ["--kind", "wgan-gp"], f"wgan-gp_samples_{EXAMPLE_STEPS}.png", 112),
            ("train_ddpm", [], "ddpm_samples.png", 128))


def _write_idx(d, images, labels):
    """MNIST's IDX files of ``images`` (N, 28, 28) uint8 under ``d``."""
    import struct

    import numpy as np

    (d / "train-images-idx3-ubyte").write_bytes(struct.pack(">4I", 0x0803, *images.shape) + images.tobytes())
    (d / "train-labels-idx1-ubyte").write_bytes(struct.pack(">2I", 0x0801, len(labels))
                                                + labels.astype(np.uint8).tobytes())


def phase_examples(rows, card):
    """Each example script's ``main`` on the card (``--device`` left at its
    default): its grid at JAX's name and size, its logged losses finite, no
    port kernel launched; the wall s and the steps/s it reports (the
    trainer's ``sps`` over its first log interval, capture included; the
    GANs' ``StepTimer`` over the last 50 rounds)."""
    import importlib
    import math
    import tempfile

    import torch
    from PIL import Image

    from dgm_img_super_resolution_tpu_torch.data.mnist import synthetic_mnist

    t_phase = time.perf_counter()
    counters = _counters()
    res, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "mnist").mkdir()
        _write_idx(tmp / "mnist", *synthetic_mnist(8192, seed=0))  # get_mnist's default set (n_synth, --seed 0)
        for i, (name, argv, png, side) in enumerate(EXAMPLES):
            label = " ".join([name] + argv)
            out_dir = tmp / f"run{i}"
            argv = argv + ["--steps", str(EXAMPLE_STEPS), "--out_dir", str(out_dir)]
            if i:
                argv += ["--data_dir", str(tmp / "mnist")]
            main = importlib.import_module(f"examples_torch.{name}").main
            torch.cuda.synchronize()
            _reset_counts(counters)
            t0 = time.perf_counter()
            out = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _read_counts(counters).items() if v}
            grid = out_dir / png
            size = Image.open(grid).size if grid.is_file() else None
            scalars = {k: v for k, v in out["scalars"].items() if k not in ("step", "sps")}
            finite = bool(scalars) and all(math.isfinite(v) for v in scalars.values())
            rate = out["it_per_s"] if name == "train_gan" else out["scalars"].get("sps", 0.0)
            ok = size == (side, side) and finite and not launches
            print(f"{card}: example {label} --steps {EXAMPLE_STEPS} (batch 128): wall {wall:.2f} s, {rate:.1f} "
                  f"steps/s, losses {scalars}; {png} {size}, launches {launches or 'none'} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            res[label] = {"wall_s": wall, "steps_per_s": rate, "scalars": scalars, "png_size": size,
                          "launches": launches}
            if not ok:
                failures.append(f"example {label}: grid {size}, losses {scalars}, launches {launches}")
            del out
            torch.cuda.empty_cache()
    for row in rows:
        if "shape" not in row:
            row.setdefault("launches_paths", {})["examples"] = sum(r["launches"].get(row["name"], 0)
                                                                   for r in res.values())
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"examples phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


# The benchmark scripts (phase_bench): each JAX script's JSON line and the
# port's counterpart, which prints its keys plus ``device``; every knob of
# theirs, unset for the phase so that they run at their defaults.
BENCH_SCRIPTS = {"bench": ("bench.py", "bench_torch.py"),
                 "sd": ("tools/sd_bench.py", "tools/torch_port_sd_bench.py"),
                 "train": ("tools/train_bench.py", "tools/torch_port_train_bench.py")}
BENCH_KNOBS = ("BENCH_SAMPLER", "BENCH_STEPS", "BENCH_ETA", "BENCH_ENC", "BENCH_BATCH", "BENCH_ITERS",
               "BENCH_LAT_ITERS", "BENCH_FULL_CHAIN", "BENCH_FULL_ITERS", "BENCH_PATCH", "SD_BATCH", "SD_ENC",
               "SD_FLASH", "SD_STEPS", "SD_ITERS", "SD_OUT", "SD_LR", "TRAIN_BENCH_MESH", "TRAIN_BENCH_OUT")
# bench_torch.py's serves at its defaults: at the operating point, batch 8
# (a warm-up, 16 for throughput, 5 for latency) and batch 1 (a warm-up, 5);
# the T = 100 ancestral chain at batch 8 (a warm-up, 3). The training tool:
# a first step and 20.
BENCH_OP_SERVES, BENCH_CHAIN_SERVES, TRAIN_BENCH_STEPS = 1 + 16 + 5 + 1 + 5, 1 + 3, 21
# The runs of phase_bench: (label, script, knobs). The SD tool at its
# defaults (LR 128), and at LR 256 with the UNet built without flash (C12),
# where the default UNet launches the kernel 6 times a step.
BENCH_RUNS = (("bench", "bench", {}), ("sd", "sd", {}),
              ("sd_noflash_lr256", "sd", {"SD_FLASH": "0", "SD_LR": "256", "SD_ITERS": "1"}),
              ("train", "train", {}))


def json_keys_of(path, marker: str = "metric") -> list[str]:
    """The keys of a script's JSON record: the one dict literal of the file
    with a ``marker`` key (a benchmark script's line: ``"metric"``), read
    with ``ast`` (nothing imported)."""
    import ast

    found = [[k.value for k in node.keys if isinstance(k, ast.Constant)]
             for node in ast.walk(ast.parse(Path(path).read_text())) if isinstance(node, ast.Dict)]
    found = [keys for keys in found if marker in keys]
    if len(found) != 1:
        raise ValueError(f"{path}: {len(found)} dict literals with a {marker!r} key")
    return found[0]


def bench_launches(line: dict) -> dict:
    """The launches of ``bench_torch.py``'s run at its default knobs, from
    its JSON line: each serve's UNet calls (the operating point's steps, with
    encoder propagation as ``encprop_launches``; the chain's 100) times one
    UNet call's share of ``SERVE_LAUNCHES["default"]``."""
    steps = line["steps"] if line["sampler"] == "ddim" else 100
    want = _times(encprop_launches("default", line["enc_interval"], steps), BENCH_OP_SERVES)
    if line["full_chain_value"]:
        want = {k: v + n for (k, v), n in zip(want.items(), _times(encprop_launches("default", 1, 100),
                                                                     BENCH_CHAIN_SERVES).values())}
    return want


def sd_bench_launches(env: dict) -> dict:
    """The SD tool's flash launches under the knobs of ``env``: its calls
    (a first one and ``SD_ITERS``) of 20 steps, one UNet call a step (the
    guidance batch is one call), each launching as ``sd_flash_per_call``
    of the UNet built with ``SD_FLASH``."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_UNET_CONFIG
    from dgm_img_super_resolution_tpu_torch.models.sd.unet import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(X4_UNET_CONFIG, use_flash=env.get("SD_FLASH", "1") not in ("0", "false", ""))
    n = sum(sd_flash_per_call(unet, int(env.get("SD_LR", "128")))) * 20 * (1 + int(env.get("SD_ITERS", "3")))
    return {"flash_attention": n} if n else {}


def _run_script(label, fn, counters, failures) -> dict:
    """``fn()`` with the launch counters set to 0 just before it; its
    printed lines echoed; (its JSON line, wall s, non-zero launches)."""
    import io

    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        print(f"  {ln}", flush=True)
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        failures.append(f"{label}: no JSON line")
        line = {}
    return {"line": line, "wall_s": wall, "launches": launches}


def phase_bench(rows, card):
    """The port's three benchmark scripts on the card (``BENCH_RUNS``) at
    the JAX scripts' full widths: ``dgmsr-torch bench`` in process (which
    runs ``bench_torch.py``), ``tools/torch_port_sd_bench.py`` and
    ``tools/torch_port_train_bench.py`` through their ``main``. Each JSON
    line must hold its JAX script's keys (``json_keys_of``) and ``device``,
    the card line; the launches of each run, counted from 0 just before it,
    must equal its serves' (``bench_launches``), the SD tool's flash
    launches (``sd_bench_launches``: none at LR 128, none without flash)
    and the training tool's steps' (``train_step_launches``)."""
    import math
    import runpy

    import torch

    from dgm_img_super_resolution_tpu_torch.apps.cli import main as cli_main

    t_phase = time.perf_counter()
    counters = _counters()
    res, failures = {}, []
    mains = {"bench": lambda: cli_main(["bench"]),
             "sd": lambda: runpy.run_path(BENCH_SCRIPTS["sd"][1])["main"]([]),
             "train": lambda: runpy.run_path(BENCH_SCRIPTS["train"][1])["main"]([])}
    saved = {k: os.environ.pop(k) for k in BENCH_KNOBS if k in os.environ}
    try:
        with switches():
            for label, script, env in BENCH_RUNS:
                jax_path, port_path = BENCH_SCRIPTS[script]
                os.environ.update(env)
                try:
                    r = _run_script(port_path, mains[script], counters, failures)
                finally:
                    for k in env:
                        os.environ.pop(k)
                line = r["line"]
                if not line:
                    continue
                if script == "bench":
                    want = bench_launches(line)
                elif script == "sd":
                    want = sd_bench_launches(env)
                else:
                    want = _times(train_step_launches("default"), TRAIN_BENCH_STEPS)
                keys = json_keys_of(jax_path) + ["device"]
                nums = [v for v in line.values() if isinstance(v, (int, float)) and not isinstance(v, bool)]
                ok_line = list(line) == keys and line["device"] == card and all(math.isfinite(v) for v in nums)
                ok = ok_line and r["launches"] == want
                print(f"{card}: {port_path} {' '.join(f'{k}={v}' for k, v in env.items()) or 'at its defaults'}: "
                      f"wall {r['wall_s']:.1f} s; "
                      + ", ".join(f"{k} {line[k]}" for k in keys if k in line and k not in ("device", "baseline"))
                      + f"; launches {r['launches'] or 'none'} {'ok' if ok else f'FAIL, expected {want or None}'}"
                      + ("" if ok_line else f"; keys {list(line)} != {keys} or device != the card line"), flush=True)
                if not ok:
                    failures.append(f"{label}: keys {list(line)}, launches {r['launches']}, expected {want}")
                res[label] = dict(r, env=env)
                _note_launches(rows, f"bench_{label}", r["launches"])
                torch.cuda.empty_cache()
    finally:
        os.environ.update(saved)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"bench phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


# The DDIM operating-point study (tools/torch_port_ddim_operating_point.py) at a reduced depth: 200
# updates at batch 4 of 160^2 crops of its two synthetic images (its host iterator takes ~40 ms a
# crop: batch 16 took 158.6 s of the phase's 184.1), the evaluation at 256^2 HR (LR 64),
# four of its modes, and the kernels against their plain versions at ddim20 eta 1, held there to the
# 0.1 dB that the study chooses by.
OP_STUDY = ("tools/ddim_operating_point.py", "tools/torch_port_ddim_operating_point.py")
OP_TRAIN_STEPS, OP_BATCH, OP_HR_SIZE = 200, 4, 256
OP_MODES = ("ddpm100", "ddpm100_seed2", "ddim20_eta1", "ddim20_eta1_ep2")
OP_CHECK = "ddim20_eta1"
OP_GAP_DB = 0.1


def op_mode_launches(mode: tuple) -> dict:
    """One serve's launches at a study mode ``(sampler, steps, eta, key,
    seed, enc_interval)``: its UNet calls (the chain's 100) with encoder
    propagation as ``encprop_launches``."""
    sampler, steps, _, _, _, k = mode
    return encprop_launches("default", k, steps if sampler == "ddim" else 100)


def _nonfinite_metrics(tree) -> list[str]:
    """The paths of every PSNR or SSIM in a record that is not finite."""
    import math

    bad = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif k.startswith(("psnr", "ssim")) and not (isinstance(v, (int, float)) and math.isfinite(v)):
                bad.append("/".join(path + [k]))

    walk(tree, [])
    return bad


def phase_operating_point(rows, card):
    """The port's DDIM operating-point study through its ``main`` at a
    reduced depth (``OP_*``): training through ``SRDiffTask`` and
    ``Trainer.fit`` over ``DIV2KDataset``, every serve through
    ``SRDiffPipeline`` at batch 1, the metrics through ``Measure``. The
    record must hold the JAX tool's keys (``backend`` as ``device``) and
    ``images``, ``kernels_vs_plain``, ``launches``, every PSNR and SSIM
    finite; rows 1-3 must have launched exactly once a training update (so
    none in backward), 100 times a ``ddpm100`` serve, 20 a ddim20 serve and
    at ``enc_interval`` 2 row 1 10 times and rows 2-3 20, none under
    ``kernels_disabled()`` and no other kernel at all (the counters set to 0
    before the study and read after, against the sum of the record's); and
    the kernels' PSNR-vs-HR at ``OP_CHECK`` must be within ``OP_GAP_DB`` of
    the plain versions'."""
    import importlib.util
    import io
    import tempfile

    import torch

    t_phase = time.perf_counter()
    jax_path, port_path = OP_STUDY
    spec = importlib.util.spec_from_file_location("torch_port_ddim_operating_point", port_path)
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    counters = _counters()
    failures = []
    tmp = Path(tempfile.mkdtemp(prefix="op_point_"))
    argv = ["--train-steps", str(OP_TRAIN_STEPS), "--batch", str(OP_BATCH), "--hr-size", str(OP_HR_SIZE),
            "--modes", ",".join(OP_MODES), "--kernels-vs-plain", OP_CHECK, "--work-dir", str(tmp / "wd"),
            "--out", str(tmp / "record.json")]
    buf = io.StringIO()
    try:
        with switches():
            torch.cuda.synchronize()
            _reset_counts(counters)
            with contextlib.redirect_stdout(buf):
                rec = study.main(argv)
            torch.cuda.synchronize()
            total = {k: v for k, v in _read_counts(counters).items() if v}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for ln in buf.getvalue().splitlines():
        if ln.startswith("| "):
            print(f"  {ln}", flush=True)

    keys = [("device" if k == "backend" else k) for k in json_keys_of(jax_path, "operating_point")]
    want_keys = keys + ["images", "kernels_vs_plain", "launches"]
    if list(rec) != want_keys or rec["device"] != card:
        failures.append(f"operating point: record keys {list(rec)} != {want_keys} or device {rec['device']!r}")
    bad = _nonfinite_metrics({"results": rec["results"], "kernels_vs_plain": rec["kernels_vs_plain"]})
    if bad:
        failures.append(f"operating point: not finite {bad}")

    kvp = rec["kernels_vs_plain"][OP_CHECK]
    names = [n for n in kvp if n != "mean_gap_db"]
    n_img = len(names)
    modes = {m[3]: m for m in study.mode_list(7, ",".join(OP_MODES))}
    per_update = train_step_launches("default")
    want = {"train": {"updates": OP_TRAIN_STEPS, "launches": _times(per_update, OP_TRAIN_STEPS)},
            "modes": {key: _times(op_mode_launches(m), n_img) for key, m in modes.items()},
            "kernels_vs_plain": {OP_CHECK: {"kernels": _times(op_mode_launches(modes[OP_CHECK]), n_img),
                                            "plain": {}}}}
    got = rec["launches"]
    summed: dict = {}
    for part in [got["train"]["launches"], *got["modes"].values(), *[r for v in got["kernels_vs_plain"].values()
                                                                     for r in v.values()]]:
        for k, v in part.items():
            summed[k] = summed.get(k, 0) + v
    for label, g, w in (("training", got["train"], want["train"]),
                        *((f"{k} serves", got["modes"].get(k), w) for k, w in want["modes"].items()),
                        ("kernels vs plain", got["kernels_vs_plain"], want["kernels_vs_plain"]),
                        ("the counters across the study", total, summed)):
        _launch_check(f"operating point: {label}", g, w, failures)

    gap = kvp["mean_gap_db"]
    ok_gap = abs(gap) <= OP_GAP_DB
    mean = lambda key: sum(rec["results"][key][n]["psnr_vs_hr"] for n in names) / len(names)  # noqa: E731
    print(f"{card}: operating-point study, {OP_TRAIN_STEPS} updates at batch {OP_BATCH}, {OP_HR_SIZE}^2 regions "
          f"of {rec['images']}: mean PSNR-vs-HR " + ", ".join(f"{k} {mean(k):.4f}" for k in OP_MODES)
          + f" dB; seed floor {rec['seed_noise_floor_db']} dB; chosen {rec['operating_point']}; {OP_CHECK} kernels "
          f"vs plain: PSNR-vs-HR gap {gap:+.4f} dB (bound {OP_GAP_DB}) {'ok' if ok_gap else 'FAIL'}, kernels' image "
          f"vs plain " + ", ".join(f"{n} {kvp[n]['psnr_kernels_vs_plain']:.2f}" for n in names) + " dB", flush=True)
    if not ok_gap:
        failures.append(f"operating point: {OP_CHECK} kernels vs plain PSNR-vs-HR gap {gap} dB > {OP_GAP_DB}")
    _note_launches(rows, "operating_point", total)
    res = {"record": rec, "launches": total, "phase_s": time.perf_counter() - t_phase}
    print(f"operating point phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


NATIVE_SHAPES = (((512, 512, 3), 0.25), ((37, 53, 3), 1.7), ((128, 96, 3), 4.0), ((300, 200), 0.37))
NATIVE_MEASURE_ROUNDS = 5


def phase_native(card, dev="cuda"):
    """The port's native library builds on the card's host, ``imresize``
    takes it by default and equals the matrix path (uint8 exactly, float64
    to 1e-12); ``Measure.measure`` at 512^2 timed with the matrix path and
    with the library, in turns."""
    import numpy as np

    from dgm_img_super_resolution_tpu_torch import native
    from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure
    from dgm_img_super_resolution_tpu_torch.ops.resize import imresize

    res, failures = {}, []
    t0 = time.perf_counter()
    built = native.available()
    res["build_s"] = time.perf_counter() - t0
    print(f"native imageops: {'built' if built else 'FAILED to build'} in {res['build_s']:.2f} s", flush=True)
    if not built:
        return res, ["native library did not build"]
    rng = np.random.default_rng(0)
    worst_f, u8_diff, default_native = 0.0, 0, True
    for shape, scale in NATIVE_SHAPES:
        u8 = rng.integers(0, 256, shape, dtype=np.uint8)
        f = rng.uniform(0, 1, shape)
        out_hw = (int(np.ceil(scale * shape[0])), int(np.ceil(scale * shape[1])))
        default_native &= bool(np.array_equal(imresize(u8, scale=scale), native.matlab_resize(u8, out_hw)))
        u8_diff += int((imresize(u8, scale=scale, use_native=True)
                        != imresize(u8, scale=scale, use_native=False)).sum())
        worst_f = max(worst_f, float(np.abs(imresize(f, scale=scale, use_native=True)
                                            - imresize(f, scale=scale, use_native=False)).max()))
    ok = default_native and u8_diff == 0 and worst_f <= 1e-12
    print(f"native imresize vs the matrix path at {len(NATIVE_SHAPES)} shapes: uint8 pixels differing {u8_diff}, "
          f"float64 max |diff| {worst_f:.2e} (tol 1e-12), default routes to native {default_native} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    res.update(u8_pixels_differing=u8_diff, f64_max_abs=worst_f, default_native=default_native)
    if not ok:
        failures.append("native imresize vs the matrix path")

    sr = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    hr = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    lr = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    by = {False: Measure(device=dev, use_native=False), None: Measure(device=dev)}
    times = {False: [], None: []}
    outs = {}
    for m in by.values():
        m.measure(sr, hr, lr, 4)  # warm-up
    for _ in range(NATIVE_MEASURE_ROUNDS):
        for key in (False, None, None, False):
            t0 = time.perf_counter()
            outs[key] = by[key].measure(sr, hr, lr, 4)
            times[key].append(1e3 * (time.perf_counter() - t0))
    mat, nat = float(np.median(times[False])), float(np.median(times[None]))
    same = outs[False] == outs[None] or all(
        (a == b) or (a != a and b != b) for a, b in zip(outs[False].values(), outs[None].values()))
    print(f"{card}: Measure.measure at 512x512 (x4, lr_psnr through imresize), median of "
          f"{2 * NATIVE_MEASURE_ROUNDS} in turns: {mat:.2f} ms with the matrix path, {nat:.2f} ms with native; "
          f"the same scores {'ok' if same else 'FAIL'}", flush=True)
    res["measure_ms"] = {"matrix": mat, "native": nat}
    if not same:
        failures.append("Measure native vs matrix")
    return res, failures


# C10: ddim_sample(shape=...) at the full width in float32, two draws for a
# batch-1 condition, 32 -> 128, 4 DDIM steps at eta 1: a UNet call runs rows
# 1-3 once each (block_chain.cu and tail_fuse.cu in float32)
DDIM_SHAPE_STEPS = 4
DDIM_SHAPE_LAUNCHES = {"block_chain3_stem": DDIM_SHAPE_STEPS, "block_chain3": DDIM_SHAPE_STEPS,
                       "block_chain3_c64": DDIM_SHAPE_STEPS, "tail_fuse": DDIM_SHAPE_STEPS}


def phase_sampler_api(rows, dev="cuda"):
    """The repaired SRDiff sampler API and SD class embedding on the card
    against the CPU, float32 with TF32 off: ``sample(save_intermediate=True)``
    and ``p_sample`` on a small model (hidden 16, mults 1|2, T = 8, HR 64,
    B = 2; no kernel route at hidden 16); ``ddim_sample(shape=...)`` at the
    full width with the launches of rows 1-3 (C10); then the published-width
    SD UNet with ``num_class_embeds=None`` and class labels at latent
    32x32."""
    import torch

    from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_UNET_CONFIG
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import init_sd_params
    from dgm_img_super_resolution_tpu_torch.models.sd.unet import UNet2DCondition

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, failures = {}, []
    hp = Hparams(hidden_size=16, unet_dim_mults="1|2", rrdb_num_block=2, rrdb_num_feat=16, timesteps=8,
                 compute_dtype="float32")
    cpu = init_srdiff_params(build_srdiff(hp), seed=8).eval()
    gpu = build_srdiff(hp).eval().to(dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(9)
    lr, up = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1, torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    noise = (torch.randn(2, 3, 64, 64, generator=g), {t: torch.randn(2, 3, 64, 64, generator=g) for t in range(8)})
    with torch.inference_mode():
        want = cpu.sample(lr, up, noise=noise, save_intermediate=True)
        got = gpu.sample(lr.to(dev), up.to(dev), noise=noise, save_intermediate=True)
        plain, _ = gpu.sample(lr.to(dev), up.to(dev), noise=noise)
        err = max(rel_err(a.cpu(), b)[0] for a, b in ((got[0], want[0]), (got[2][0], want[2][0]),
                                                        (got[2][1], want[2][1])))
        # sample()'s image against this one on the card: the same code path (bit for bit on the CPU,
        # tests/test_torch_port_sampler_api.py), but cuDNN's transposed convs (backward-data algorithms)
        # may add in another order from run to run, so the bound is the card-vs-CPU one
        plain_err = rel_err(plain.cpu(), got[0].cpu())[0]
        ok = err <= E2E_TOL and plain_err <= E2E_TOL and tuple(got[2][0].shape) == (8, 2, 3, 64, 64)
        print(f"card vs CPU, f32 sample(save_intermediate=True) T=8 B=2 64x64: max_abs_err {err:.3e} over the image "
              f"and the 8 steps' images and x0s; sample()'s image against it {plain_err:.3e} (tol {E2E_TOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        res["save_intermediate"] = {"max_abs_err": err, "sample_vs_intermediate_max_abs_err": plain_err}
        if not ok:
            failures.append("sample(save_intermediate) card vs CPU")
        _, cond = cpu.rrdb_cond(lr, up)
        x, t, step = noise[0], torch.tensor([7, 2]), noise[1][3]
        want = cpu.p_sample(x, t, cond, up, step)
        _, gcond = gpu.rrdb_cond(lr.to(dev), up.to(dev))
        got = gpu.p_sample(x.to(dev), t.to(dev), gcond, up.to(dev), step.to(dev))
        err, rel = rel_err(tuple(v.cpu() for v in got), want)
        # eps within F32_TOL (one UNet forward), which the x0 step scales by sqrt((1 - a_t) / a_t) at t = 7
        a_t = float(cpu.schedule.alphas_cumprod[7])
        tol = F32_TOL * (1.0 + ((1.0 - a_t) / a_t) ** 0.5)
        ok = rel <= tol
        print(f"card vs CPU, f32 p_sample (per-row t 7, 2; raw condition) B=2 64x64: max_abs_err {err:.3e} "
              f"rel {rel:.3e} (tol {tol:.2e}: {F32_TOL} on eps x the x0 step's sqrt((1 - a_t) / a_t) at t = 7) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        res["p_sample"] = {"max_abs_err": err, "rel_err": rel, "tol": tol}
        if not ok:
            failures.append("p_sample card vs CPU")
    del cpu, gpu

    hp = Hparams(compute_dtype="float32")
    cpu = init_srdiff_params(build_srdiff(hp), seed=12).eval()
    gpu = build_srdiff(hp).eval().to(dev)
    gpu.load_state_dict(cpu.state_dict())
    lr, up = torch.rand(1, 3, 32, 32, generator=g) * 2 - 1, torch.rand(1, 3, 128, 128, generator=g) * 2 - 1
    shape = (2, 3, 128, 128)
    ts, _ = cpu.ddim_timesteps(DDIM_SHAPE_STEPS)
    noise = (torch.randn(shape, generator=g), {t: torch.randn(shape, generator=g) for t in ts})
    counters = _counters()
    with torch.inference_mode():
        want, _ = cpu.ddim_sample(lr, up, num_steps=DDIM_SHAPE_STEPS, eta=1.0, noise=noise, shape=shape)
        _reset_counts(counters)
        got, _ = gpu.ddim_sample(lr.to(dev), up.to(dev), num_steps=DDIM_SHAPE_STEPS, eta=1.0, noise=noise,
                                 shape=shape)
        launches = {k: v for k, v in _read_counts(counters).items() if v}
    err = rel_err(got.cpu(), want)[0]
    two = float((got[0] - got[1]).abs().max())
    ok = err <= E2E_TOL and tuple(got.shape) == shape and two > 0 and launches == DDIM_SHAPE_LAUNCHES
    print(f"card vs CPU, f32 ddim_sample(shape={shape}) for a batch-1 condition, full width, ddim"
          f"{DDIM_SHAPE_STEPS} eta 1 32->128: max_abs_err {err:.3e} (tol {E2E_TOL}), the two draws differ by "
          f"{two:.3e}; launches {launches} (expected {DDIM_SHAPE_LAUNCHES}) {'ok' if ok else 'FAIL'}", flush=True)
    res["ddim_sample_shape"] = {"max_abs_err": err, "launches": launches}
    _note_launches(rows, "ddim_sample_shape", launches)
    if not ok:
        failures.append("ddim_sample(shape=) card vs CPU")
    del cpu, gpu

    cfg = dict(X4_UNET_CONFIG, num_class_embeds=None)
    cpu = UNet2DCondition(cfg).eval()
    init_sd_params(cpu, seed=10)
    with torch.device(dev):
        gpu = UNet2DCondition(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(11)
    x, ctx = torch.randn(2, 7, 32, 32, generator=g), torch.randn(2, 77, 1024, generator=g)
    t, labels = torch.tensor([951, 1]), torch.tensor([20, 350])
    with torch.inference_mode():
        want = cpu(x, t, ctx, labels)
        got = gpu(x.to(dev), t.to(dev), ctx.to(dev), labels.to(dev)).cpu()
        err, rel = rel_err(got, want)
        ok = rel <= F32_TOL and bool(torch.isfinite(got).all())
        print(f"card vs CPU, f32 SD UNet published widths with num_class_embeds=None and class labels (the "
              f"timestep-style class embedding), latent 32x32 B=2: max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {F32_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
        res["sd_class_embedding"] = {"max_abs_err": err, "rel_err": rel}
        if not ok:
            failures.append("SD timestep class embedding card vs CPU")
    del cpu, gpu
    torch.cuda.empty_cache()
    return res, failures


# phase_graphs: each captured path replayed against its eager run (graphs.eager()) at the same generator
# state, and both timed in turns. The bar is bit-equality; where two eager runs already differ (a
# non-deterministic kernel), the phase names it and holds the replay at GRAPH_NONDET_REL (the bf16 kernel
# bound). The WGAN-GP round is compared under cuDNN's deterministic algorithms: with its default ones
# (weight gradients summed by atomics) two eager rounds differ, and Adam moves each zero-gradient conv bias
# by that noise.
# The timed rounds are cut to what keeps a time in turns (the checks are unchanged) so that the whole
# script stays inside its limit with phase_operating_point's host-bound training.
GRAPH_ROUNDS = {"srdiff_b8": 2, "srdiff_b1": 2, "srdiff_t100_b1": 1, "sd_lr128": 1, "sd_lr256": 1, "train": 1,
                "wgan_gp": 2, "progress": 1, "sd_callback": 0, "interp": 1, "validation": 1, "lpips": 2}
GRAPH_TRAIN_STEPS, GRAPH_TRAIN_ACC = 3, 2
GRAPH_DDPM_REPLAYS = 1  # the DDPM chain's replays timed beyond the compared one
GRAPH_DDPM_T = 100  # the DDPM chain's length here (phase_edu's EDU_SAMPLE_T, cut further for time)
GRAPH_CLI_TURNS = (True, False)  # the CLI's infer --progress, eager (True) then through the graphs
GRAPH_NONDET_REL = 3e-2


def _graph_turns(run, rounds):
    """``run()`` timed in turns, eager (``graphs.eager()``) and replayed:
    e r r e e r ...; (eager s, replayed s) per call."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs

    out = {True: [], False: []}
    for i in range(rounds):
        for eager in ((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with graphs.eager() if eager else contextlib.nullcontext():
                run()
            torch.cuda.synchronize()
            out[eager].append(time.perf_counter() - t0)
    return out[True], out[False]


def _graph_report(label, entries, first_s, eager_s, replay_s, launches, want, same, nondet, failures) -> dict:
    """Print and check one path: equality (or the named non-determinism),
    the launches of one replay, the times, the path's captures and pools."""
    capture_s = sum(e.capture_s for e in entries)
    pool = sum(e.pool_bytes for e in entries)
    n_graphs = sum(len(getattr(e, "pieces", [e])) for e in entries)  # a segmented program: a graph a piece
    equal_ok = same is True or (nondet is not None and same <= GRAPH_NONDET_REL)
    ok = equal_ok and launches == want
    spread = lambda xs: f"{median(xs):.4f} s ({min(xs):.4f}-{max(xs):.4f})"  # noqa: E731
    eq = "bit-equal" if same is True else f"max rel {same:.3e} (bound {GRAPH_NONDET_REL}; not deterministic: {nondet})"
    print(f"graphs {label}: replay vs eager {eq}{'' if equal_ok else ' FAIL'}; eager {spread(eager_s)}, replayed "
          f"{spread(replay_s)} a call (x{median(eager_s) / median(replay_s):.2f}); capturing call {first_s:.3f} s with "
          f"capture {capture_s:.3f} s of {n_graphs} graph(s), pool {pool / 2**20:.1f} MiB; launches a replay "
          f"{launches} {'ok' if launches == want else f'FAIL (expected {want})'}", flush=True)
    if not ok:
        failures.append(f"graphs {label}: replay vs eager {same}, launches {launches} (expected {want})")
    return {"equal": same is True, "max_rel": None if same is True else same, "nondeterministic": nondet,
            "eager_s": eager_s, "replay_s": replay_s, "first_call_s": first_s, "capture_s": capture_s,
            "graphs": n_graphs, "pool_bytes": pool, "launches_per_replay": launches}


def _tree_rel(a: list, b: list) -> float:
    """max over tensors of max |a - b| / max |b|."""
    return max(float((x.float() - y.float()).abs().max()) / max(float(y.float().abs().max()), 1e-30)
               for x, y in zip(a, b))


def _compare(want, again, got, what) -> tuple:
    """(True or the max rel of replay vs eager, None or what makes two eager
    runs differ)."""
    import torch

    nondet = None if all(torch.equal(a, b) for a, b in zip(want, again)) else \
        f"{what} (two eager runs differ by max rel {_tree_rel(again, want):.3e})"
    return (True if all(torch.equal(a, b) for a, b in zip(got, want)) else _tree_rel(got, want)), nondet


def _graph_serve(label, pipe, imgs, steps_scale, rounds, counters, failures, eager_ref=None) -> dict:
    """An SRDiff serve of ``imgs`` (uint8): first call (eager, then the
    capture), replay vs eager at one generator state, one replay's
    launches, the times in turns, a replay's and an eager call's kernels
    traced (``eager_ref`` as in :func:`replay_trace_check`)."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs

    def serve(seed=0):
        return pipe.upscale_batch_device(imgs, generator=torch.Generator(device="cuda").manual_seed(seed),
                                         as_uint8=True)

    before = set(pipe._graphs.entries)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    got = serve(7)
    with graphs.eager():
        want, again = serve(7), serve(7)
    same, nondet = _compare([want], [again], [got], "the eager serve")
    _reset_counts(counters)
    serve()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    want_l = {k: v * steps_scale for k, v in SERVE_LAUNCHES["default"].items()}
    eager_s, replay_s = _graph_turns(serve, rounds)
    entries = [e for k, e in pipe._graphs.entries.items() if k not in before]
    out = _graph_report(label, entries, first, eager_s, replay_s, launches, want_l, same, nondet, failures)
    out["traced"] = replay_trace_check(f"graphs {label}", serve, counters, failures, eager_ref)
    return out


def _rewind_train(state, start):
    """A training state back to its start in place (the tensors its graphs
    read stay): the parameters and the EMA, Adam's moments and counts at 0,
    the gradient buffers, the host's counts."""
    import torch

    opt = state.optimizer
    with torch.no_grad():
        for p, v in zip(state.model.parameters(), start):
            p.copy_(v)
        for e, v in zip(state.ema.values(), start):
            e.copy_(v)
        for st in opt.adam.state.values():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                st[key].zero_()
        for b in opt.bufs:
            if b is not None:
                b.zero_()
    opt.updates = opt.mini_step = state.step = 0


def _rewind_gan(state, start):
    """A GAN state back to ``start``'s models in place, Adam's moments and
    counts at 0."""
    state.gen.load_state_dict(start.gen.state_dict())
    state.disc.load_state_dict(start.disc.state_dict())
    for opt in (state.gen_opt, state.disc_opt):
        for st in opt.state.values():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                st[key].zero_()
    state.step = 0


def _graph_train(counters, failures) -> dict:
    """Three SRDiff training steps eager twice and replayed: a third state
    takes the steps once (the first calls and the captures), goes back to
    its start in place and takes them again by replay."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

    hp = Hparams(**dict(TRAIN_HP, accumulate_grad_batches=GRAPH_TRAIN_ACC, ema_decay=0.999))
    batches = [_train_batch(TRAIN_BATCH, TRAIN_HR, seed=90 + i) for i in range(GRAPH_TRAIN_STEPS)]

    def train(trainer, state, eager):
        _reset_counts(counters)
        t0 = time.perf_counter()
        with graphs.eager() if eager else contextlib.nullcontext():
            for i, b in enumerate(batches):
                trainer.train_step(state, b, torch.Generator(device="cuda").manual_seed(i))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, {k: v for k, v in _read_counts(counters).items() if v}

    def trained(state):
        return [p.detach().clone() for p in state.model.parameters()] + [v.clone() for v in state.ema.values()]

    runs = []
    for _ in range(2):
        trainer = SRDiffTask(hp).make_trainer()
        state = trainer.init_state()
        eager_l = train(trainer, state, True)[1]
        runs.append(trained(state))
    del trainer, state
    trainer = SRDiffTask(hp).make_trainer()
    state = trainer.init_state()
    start = [p.detach().clone() for p in state.model.parameters()]
    first = train(trainer, state, False)[0]
    _rewind_train(state, start)
    graph_l = train(trainer, state, False)[1]
    same, nondet = _compare(runs[0], runs[1], trained(state), "the eager step")
    if graph_l != eager_l:
        failures.append(f"graphs train: launches over {GRAPH_TRAIN_STEPS} steps {graph_l}, eager {eager_l}")
    del runs, start
    _reset_counts(counters)
    trainer.train_step(state, batches[0])  # generator None: its own capture, outside the timed turns
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    eager_s, replay_s = _graph_turns(lambda: trainer.train_step(state, batches[0]), 2 * GRAPH_ROUNDS["train"])
    out = _graph_report(f"SRDiff training step B={TRAIN_BATCH} {TRAIN_HR}^2 bf16, accumulate {GRAPH_TRAIN_ACC}, "
                        f"{GRAPH_TRAIN_STEPS} steps", list(state.optimizer.graphs.entries.values()), first, eager_s,
                        replay_s, launches, train_step_launches("default"), same, nondet, failures)
    out["launches_3_steps"] = graph_l
    out["traced"] = replay_trace_check("graphs SRDiff training step", lambda: trainer.train_step(state, batches[0]),
                                       counters, failures)
    return out


def _graph_wgan(counters, failures) -> dict:
    """One WGAN-GP round (float32) eager twice and replayed as the training
    steps, compared under cuDNN's deterministic algorithms, timed under its
    defaults."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs

    task = _edu_task("wgan-gp", "cuda")
    real = task._real(_edu_batch("wgan-gp", EDU_BATCH, seed=3))

    def round_(st, eager):
        t0 = time.perf_counter()
        with graphs.eager() if eager else contextlib.nullcontext():
            task.train_step(st, real, torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def flat(st):
        return [v.clone() for v in list(st.gen.state_dict().values()) + list(st.disc.state_dict().values())]

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            st = task.init_state(0)
            round_(st, True)
            runs.append(flat(st))
        gstate = task.init_state(0)
        first = round_(gstate, False)
        _rewind_gan(gstate, task.init_state(0))
        round_(gstate, False)
        same, nondet = _compare(runs[0], runs[1], flat(gstate), "the eager round")
        entries = list(gstate.graphs.entries.values())
    finally:
        torch.backends.cudnn.deterministic = prev
    task.train_step(gstate, real)  # the default algorithms' capture, outside the timed turns
    eager_s, replay_s = _graph_turns(lambda: task.train_step(gstate, real), GRAPH_ROUNDS["wgan_gp"])
    out = _graph_report(f"WGAN-GP round B={EDU_BATCH} f32 ({task.crit_repeats} critic updates + 1; compared under "
                        "cudnn.deterministic, timed without)", entries, first, eager_s, replay_s, {}, {}, same,
                        nondet, failures)
    out["traced"] = replay_trace_check("graphs WGAN-GP round", lambda: task.train_step(gstate, real), counters,
                                       failures)
    return out


def _graph_path(label, call, caches, rounds, counters, failures, want, traced=True, on_repeat=False, replays=0,
                trace=None) -> dict:
    """A captured path. ``call(seed)`` -> (the outputs, a list of tensors;
    the host callbacks' sequence); ``caches`` the graph caches it captures
    into. Its first call captures (``on_repeat``: its first call runs
    eagerly and must capture nothing, its second captures); the call after
    the capture must capture nothing, replay bit-equal to ``graphs.eager()``
    from one generator state (where they differ, a second eager call names
    the non-determinism) with the eager callbacks' sequence, and launch
    ``want``; eager and replayed s a call in turns (``rounds`` 0: the
    eager calls made and the compared replay with ``replays`` more); one
    replay's and one eager call's port kernels traced (``trace(seed)``, a
    shorter call of the same path, instead of ``call`` where an eager trace
    of ``call`` is too long to trust: see :func:`replay_trace_check`; not
    ``traced``: the launch counters alone)."""
    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs

    def entries():
        return [e for c in caches for e in c.entries.values()]

    def timed(seed, eager=False, fn=call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graphs.eager() if eager else contextlib.nullcontext():
            out, seq = fn(seed)
        torch.cuda.synchronize()
        return out, seq, time.perf_counter() - t0

    t_path = time.perf_counter()
    before, eager_t = {id(e) for e in entries()}, []
    if on_repeat:
        eager_t.append(timed(0)[2])
        if len(entries()) != len(before):
            failures.append(f"graphs {label}: the first call captured a graph")
    first = timed(0)[2]
    captured = [e for e in entries() if id(e) not in before]
    after_first = [id(e) for e in entries()]
    _reset_counts(counters)
    got, seq_g, replay_t = timed(7)
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    fresh = [id(e) for e in entries()] != after_first
    want_out, seq_e, t = timed(7, eager=True)
    eager_t.append(t)
    same, nondet = True, None
    if not all(torch.equal(a, b) for a, b in zip(got, want_out, strict=True)):
        same, nondet = _compare(want_out, timed(7, eager=True)[0], got, "the eager call")
    replay_t = [replay_t] + [timed(0)[2] for _ in range(replays)]
    eager_s, replay_s = _graph_turns(lambda: call(0), rounds) if rounds else (eager_t, replay_t)
    out = _graph_report(label, captured, first, eager_s, replay_s, launches, want, same, nondet, failures)
    print(f"graphs {label}: {f'the first call ran eagerly in {eager_t[0]:.3f} s, ' if on_repeat else ''}the call "
          f"after the capture captured {'a graph: FAIL' if fresh else 'nothing, ok'}; callbacks {len(seq_g)}, "
          f"{'as the eager call' if seq_g == seq_e else 'NOT as the eager call: FAIL'}", flush=True)
    if fresh or seq_g != seq_e:
        failures.append(f"graphs {label}: the second call captured {fresh}, callbacks {seq_g} against {seq_e}")
    out.update(second_call_captured=fresh, callbacks=len(seq_g), callbacks_as_eager=seq_g == seq_e,
               on_repeat=on_repeat)
    t_trace = time.perf_counter()
    if traced:
        if trace is not None:  # its own key: captured before the trace
            for _ in range(2 if on_repeat else 1):
                trace(0)
        run = trace or call
        out["traced"] = replay_trace_check(f"graphs {label}{' (traced shorter)' if trace else ''}",
                                           lambda: run(0), counters, failures)
    out["path_s"], out["trace_s"] = time.perf_counter() - t_path, time.perf_counter() - t_trace
    print(f"graphs {label}: {out['path_s']:.1f} s, the traces {out['trace_s']:.1f} s of it", flush=True)
    return out


def _graph_progress(pipe, imgs, every, counters, failures) -> dict:
    """The progress path at batch 1, its own eager call traced."""
    import torch

    def call(seed):
        seq = []
        out = pipe.upscale_batch_device(imgs, generator=torch.Generator(device="cuda").manual_seed(seed),
                                        as_uint8=True, progress_cb=lambda d, t: seq.append((d, t)),
                                        callback_steps=every)
        return [out], seq

    return _graph_path(f"SRDiff progress ddim20 eta 1 bf16 uint8 B=1 128->512, callback_steps {every}", call,
                       [pipe._graphs], GRAPH_ROUNDS["progress"], counters, failures, SERVE_LAUNCHES["default"])


def _graph_whole(counters, failures, card) -> dict:
    """The paths JAX jits whole beside the serves: interpolation at 512^2,
    SRDiff validation, a WGAN-GP ``val_step``, the DDPM sampler, LPIPS; and
    the CLI's ``infer --progress`` wall, eager and through the graphs.
    Interpolation, the DDPM sampler and LPIPS capture at a key's second
    call. Interpolation's and validation's eager traces are of the same
    path at 20 steps (one eager trace of some 180k launches lost 2 of the
    port's 1000 kernel records), the DDPM sampler's at T = 10."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from dgm_img_super_resolution_tpu_torch.core import graphs
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.metrics.lpips import LPIPS
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
    from dgm_img_super_resolution_tpu_torch.train.tasks.vae import DDPMTask

    res = {}
    per_step = {k: v // 20 for k, v in SERVE_LAUNCHES["default"].items()}
    pipe = SRDiffPipeline(Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype="bfloat16"))
    g = np.random.default_rng(21)
    a, b = (g.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(2))
    steps = pipe.hp["timesteps"] - 1

    def interp(seed, t=None):  # seeds 0 and 7: two mixing weights, one graph
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.from_numpy(pipe.interpolate(a, b, lam=0.25 + 0.5 * (seed % 2), t=t, generator=gen))], []

    res["interp"] = _graph_path(f"SRDiff interpolate 512^2 bf16 (t = {steps}: {steps} steps)", interp,
                                [pipe._graphs], GRAPH_ROUNDS["interp"], counters, failures,
                                _times(per_step, steps), on_repeat=True, trace=lambda seed: interp(seed, t=20))
    del pipe
    torch.cuda.empty_cache()

    val_batches = [_train_batch(TRAIN_VAL_SIZE, TRAIN_HR, seed=70 + i) for i in range(TRAIN_VAL_BATCHES)]

    def validation(timesteps=None):
        """A validate(seed) at the training hparams (``timesteps``: the
        model's T instead), its cache, its T."""
        task = SRDiffTask(Hparams(**dict(TRAIN_HP, **({} if timesteps is None else {"timesteps": timesteps}))))
        state = task.make_trainer().init_state()
        val = task.make_val_fn(val_batches, sample_metrics=True)

        def validate(seed):
            m = val(state)
            return [torch.tensor([m[k] for k in sorted(m)], dtype=torch.float64)], sorted(m)

        return validate, val.graphs, task.diffusion.num_timesteps

    validate, val_graphs, t_val = validation()
    res["validation"] = _graph_path(
        f"SRDiff validation B={TRAIN_VAL_SIZE} {TRAIN_HR}^2 bf16 ({TRAIN_VAL_BATCHES} loss batches, the T = "
        f"{t_val} sample, PSNR / SSIM)", validate, [val_graphs], GRAPH_ROUNDS["validation"], counters, failures,
        _times(per_step, TRAIN_VAL_BATCHES + t_val), trace=validation(timesteps=20)[0])
    del validate, val_graphs
    torch.cuda.empty_cache()

    gan = _edu_task("wgan-gp", "cuda")
    gstate = gan.init_state(0)
    real = gan._real(_edu_batch("wgan-gp", EDU_BATCH, seed=4))

    def val_step(seed):
        m = gan.val_step(gstate, real, torch.Generator(device="cuda").manual_seed(seed))
        return [m["disc_loss"], m["gen_loss"]], []

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the round's comparison
    try:
        res["wgan_gp_val"] = _graph_path(f"WGAN-GP val_step B={EDU_BATCH} f32 (cudnn.deterministic)", val_step,
                                         [gstate.graphs], GRAPH_ROUNDS["wgan_gp"], counters, failures, {})
    finally:
        torch.backends.cudnn.deterministic = prev
    del gan, gstate

    def ddpm_sampler(timesteps):
        """A sample(seed) of the DDPM at ``timesteps``, its model."""
        task = DDPMTask(Hparams(**dict(EDU_HP, ddpm_timesteps=timesteps)), device="cuda")
        model = task.init_params(0).to("cuda")

        def sample(seed):
            return [task.sample(model, n=EDU_SAMPLE_N, generator=torch.Generator(device="cuda").manual_seed(seed))], []

        return sample, model

    # at GRAPH_DDPM_T (cut from 1000: the T = 1000 chain's eager call, capture and replay took 72 s of this
    # phase), compared under cuDNN's deterministic algorithms (with its defaults two eager chains differ by
    # ~2e-6); its traces at T = 10 (the profiler took 81 s over one T = 1000 replay). The educational models
    # launch no port kernel: the traces and the captured counts must show none.
    sample, model = ddpm_sampler(GRAPH_DDPM_T)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res["ddpm_sample"] = _graph_path(f"DDPM sampler T = {GRAPH_DDPM_T} B={EDU_SAMPLE_N} 32^2 f32 "
                                         "(cudnn.deterministic)", sample, [model._graphs], 0, counters, failures, {},
                                         on_repeat=True, replays=GRAPH_DDPM_REPLAYS, trace=ddpm_sampler(10)[0])
    finally:
        torch.backends.cudnn.deterministic = prev
    del sample, model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _random_lpips_npz(tmp / "lpips.npz")
        scorer = LPIPS.maybe_create(str(tmp / "lpips.npz"), "cuda")

        def lpips(seed):
            r = np.random.default_rng(seed)
            x, y = (r.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(2))
            return [torch.tensor(scorer(x, y), dtype=torch.float64)], []

        res["lpips"] = _graph_path("LPIPS 512^2 f32", lpips, [scorer._graphs], GRAPH_ROUNDS["lpips"], counters,
                                   failures, {}, on_repeat=True)
        Image.fromarray(np.random.default_rng(22).integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(tmp / "lr.png")
        walls = {True: [], False: []}
        for eager in GRAPH_CLI_TURNS:
            with graphs.eager() if eager else contextlib.nullcontext():
                rc, _, dt = _cli(["infer", str(tmp / "lr.png"), str(tmp / "sr.png"), "--progress", "-hp", SERVE_HP])
            walls[eager].append(dt)
            if rc != 0:
                failures.append(f"CLI infer --progress (eager {eager}): rc {rc}")
    res["cli_infer_progress"] = {"eager_s": walls[True], "graphs_s": walls[False]}
    print(f"{card}: CLI infer --progress 128 -> 512 ddim20 bf16 (a pipeline built a call): eager "
          f"{median(walls[True]):.3f} s, through the graphs (eager first call, then the captures) "
          f"{median(walls[False]):.3f} s, in turns", flush=True)
    return res


def phase_graphs(card):
    """The captured paths (``core/graphs.py``): the default uint8 SRDiff
    serve at batch 8 and 1 (128 -> 512, bf16, ddim20 eta 1), the T = 100
    ancestral serve at batch 1, the SD serve at LR 128 and 256, three
    SRDiff training steps (batch 64 of 160^2, bf16, accumulate 2) and one
    WGAN-GP round, each replayed against ``graphs.eager()`` at the same
    generator state and timed in turns; the launches of one replay against
    the serve's counts."""
    import numpy as np
    import torch

    from dgm_img_super_resolution_tpu_torch.core import graphs
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline

    t_phase = time.perf_counter()
    counters = _counters()
    failures, res = [], {"card": card}
    imgs = np.random.default_rng(0).integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    pipe = SRDiffPipeline(Hparams(sampler="ddim", sample_timesteps=20, ddim_eta=1.0, compute_dtype="bfloat16"))
    res["srdiff_b8"] = _graph_serve("SRDiff ddim20 eta 1 bf16 uint8 B=8 128->512", pipe, imgs, 1,
                                    GRAPH_ROUNDS["srdiff_b8"], counters, failures)
    res["srdiff_b1"] = _graph_serve("SRDiff ddim20 eta 1 bf16 uint8 B=1 128->512", pipe, imgs[:1], 1,
                                    GRAPH_ROUNDS["srdiff_b1"], counters, failures)
    for every in (10, 3):
        res[f"progress_b1_every{every}"] = _graph_progress(pipe, imgs[:1], every, counters, failures)
    anc = SRDiffPipeline(Hparams(sampler="ddpm", compute_dtype="bfloat16"), params=pipe.model.state_dict())
    del pipe
    # the ancestral chain's eager trace: the ddim20 serve's at batch 1, 100 UNet steps instead of 20
    b1 = res["srdiff_b1"]["traced"]
    t100_ref = {key: {k: 5 * v for k, v in b1[key].items()} for key in ("kernels_eager", "counts_eager")}
    res["srdiff_t100_b1"] = _graph_serve("SRDiff T=100 ancestral bf16 uint8 B=1 128->512", anc, imgs[:1], 5,
                                         GRAPH_ROUNDS["srdiff_t100_b1"], counters, failures, t100_ref)
    del anc
    torch.cuda.empty_cache()

    sd = StableDiffusionUpscalePipeline()
    for lr in (128, 256):
        def serve(seed=0, lr=lr):
            return _sd_serve(sd, lr, GN_STEPS, generator=torch.Generator(device="cuda").manual_seed(seed))

        _, first, _ = serve()
        got = serve(7)[0]
        with graphs.eager():
            want, again = serve(7)[0], serve(7)[0]
        same, nondet = _compare([want], [again], [got], "the eager serve")
        launches = {k: v for k, v in serve()[2].items() if v}
        eager_s, replay_s = _graph_turns(serve, GRAPH_ROUNDS[f"sd_lr{lr}"])
        res[f"sd_lr{lr}"] = _graph_report(f"SD x4 ddim20 guidance 9 bf16 LR {lr} -> {4 * lr}",
                                          list(sd._graphs.entries.values()), first, eager_s, replay_s, launches,
                                          {"flash_attention": 120} if lr == 256 else {}, same, nondet, failures)
        res[f"sd_lr{lr}"]["traced"] = replay_trace_check(f"graphs SD LR {lr}", serve, counters, failures)

        def serve_cb(seed, lr=lr):
            seq = []
            out = _sd_serve(sd, lr, GN_STEPS, generator=torch.Generator(device="cuda").manual_seed(seed),
                            callback=lambda i, t, x: seq.append((i, t, tuple(x.shape))), callback_steps=1)[0]
            return [out], seq

        res[f"sd_lr{lr}_callback"] = _graph_path(
            f"SD x4 ddim20 guidance 9 bf16 LR {lr} -> {4 * lr}, a callback every step", serve_cb, [sd._graphs],
            GRAPH_ROUNDS["sd_callback"], counters, failures, {"flash_attention": 120} if lr == 256 else {})
        sd._graphs.clear()  # this size's pool back before the next
        torch.cuda.empty_cache()
    del sd
    torch.cuda.empty_cache()
    res["train"] = _graph_train(counters, failures)
    torch.cuda.empty_cache()
    res["wgan_gp"] = _graph_wgan(counters, failures)
    torch.cuda.empty_cache()
    res.update(_graph_whole(counters, failures, card))
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"graphs phase {res['phase_s']:.1f} s", flush=True)
    return res, failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="directory for the full results")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import dgm_img_super_resolution_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 1
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    phase_build(args.out)
    rows, failures = phase_kernels()
    pipe, f3 = phase_pipeline(rows)
    paths, f3c = phase_serving_paths(rows)
    fwd16, f3b = phase_bf16_forward()
    e2e, f4 = phase_card_vs_cpu()
    bwd, f4b = phase_backward()
    flash_row, f5 = phase_flash()
    gn_row, f6 = phase_group_norm()
    rows += [flash_row, gn_row]
    sd, f7 = phase_sd_serve([flash_row, gn_row])
    sd_opts, f7b = phase_sd_options(rows)
    ckpt_cli, f9 = phase_checkpoint_cli(rows)
    sd_local, f10 = phase_sd_local_checkpoint(rows)
    sd_e2e, f8 = phase_sd_card_vs_cpu()
    train, f11 = phase_train(rows, card)
    dp, f15 = phase_dp(rows, card)
    sp, f16 = phase_sp(rows, card)
    sampler_api, f12 = phase_sampler_api(rows)
    edu, f13 = phase_edu(rows, card)
    examples, f18 = phase_examples(rows, card)
    bench_res, f19 = phase_bench(rows, card)
    op_point, f20 = phase_operating_point(rows, card)
    native, f14 = phase_native(card)
    graphs_res, f17 = phase_graphs(card)
    failures += (f3 + f3c + f3b + f4 + f4b + f5 + f6 + f7 + f7b + f9 + f10 + f8 + f11 + f15 + f16 + f12 + f13 + f14
                 + f17 + f18 + f19 + f20)
    missing = [row["name"] for row in rows if row["launches"] is None]
    if missing:
        failures.append(f"no launch count for {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "pipeline": pipe, "serving_paths": paths, "bf16_forward": fwd16,
             "card_vs_cpu": e2e, "backward": bwd, "sd": sd, "sd_options": sd_opts, "checkpoint_cli": ckpt_cli,
             "sd_local_checkpoint": sd_local, "sd_card_vs_cpu": sd_e2e, "train": train, "dp": dp, "sp": sp,
             "sampler_api": sampler_api, "edu": edu, "examples": examples, "bench": bench_res,
             "operating_point": op_point, "native": native,
             "graphs": graphs_res, "failures": failures},
            indent=1))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
