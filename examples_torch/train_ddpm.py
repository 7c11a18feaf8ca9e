"""Train the from-scratch DDPM at 32×32 on the port and sample a grid.

Realises the reference's missing ``basic_diffusion.ipynb`` (architecture per
``basic_diffusion_model.png``): noise-prediction UNet with GroupNorm +
attention, linear schedule, ancestral sampling (one captured graph on the
card from a shape's second call; this script samples once, eagerly). The
JAX package's ``examples/train_ddpm.py`` on the card.

    python examples_torch/train_ddpm.py --steps 2000 [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the port and examples_torch from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from dgm_img_super_resolution_tpu_torch.core.config import Hparams  # noqa: E402
from dgm_img_super_resolution_tpu_torch.train.tasks.vae import DDPMTask  # noqa: E402
from examples_torch.common import base_parser, batches, device, get_mnist, nhwc, save_grid  # noqa: E402


def main(argv=None) -> dict:
    """Train, then write ``ddpm_samples.png`` (4 x 4) into ``--out_dir``.
    Returns the training state, the last logged scalars (every 100 steps)
    and the grid's path."""
    parser = base_parser("basic_diffusion DDPM training")
    parser.add_argument("--timesteps", type=int, default=1000)
    parser.add_argument("--dim", type=int, default=64)
    args = parser.parse_args(argv)
    dev = device(args)

    x = get_mnist(args, size=32)
    hp = Hparams(
        lr=2e-4, val_check_interval=0, tb_log_interval=100, seed=args.seed,
        ddpm_timesteps=args.timesteps, ddpm_dim=args.dim,
    )
    task = DDPMTask(hp, img_hw=32, device=dev)
    trainer = task.make_trainer()
    trainer.work_dir = args.out_dir
    data = ({"x": b} for b in batches(x, args.batch_size, args.seed))
    state = trainer.fit(data, generator=args.seed, max_updates=args.steps, resume=False)

    samples = task.sample(state.model, 16, generator=torch.Generator(device=dev).manual_seed(1))
    path = f"{args.out_dir}/ddpm_samples.png"
    save_grid(nhwc(samples), path, cols=4)
    return {"state": state, "scalars": trainer._metrics_log[-1] if trainer._metrics_log else {}, "png": path}


if __name__ == "__main__":
    main()
