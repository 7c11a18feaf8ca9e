"""Train the adversarial models on the port: simple MLP GAN, DCGAN, or WGAN-GP.

The reference training loops (``notebooks/simple_gan.ipynb`` cell 22,
``dcgan.ipynb`` cell 17, ``wgan-gp.ipynb`` cells 34-39): same losses, same
5:1 critic schedule and λ=10 gradient penalty for WGAN-GP, one captured
CUDA graph per adversarial round on the card (``GANTask.jitted_step``). The
JAX package's ``examples/train_gan.py`` on the card.

    python examples_torch/train_gan.py --kind dcgan --steps 1000 [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the port and examples_torch from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from dgm_img_super_resolution_tpu_torch.core.config import Hparams  # noqa: E402
from dgm_img_super_resolution_tpu_torch.train.tasks.gan import GANTask  # noqa: E402
from dgm_img_super_resolution_tpu_torch.utils.profiling import StepTimer  # noqa: E402
from examples_torch.common import base_parser, batches, device, get_mnist, nhwc, save_grid  # noqa: E402


def main(argv=None) -> dict:
    """Train, writing ``{kind}_samples_{N}.png`` (4 x 4) into ``--out_dir``
    every 100 rounds. Returns the state, the last printed losses and rate,
    and the grids' paths."""
    parser = base_parser("GAN / DCGAN / WGAN-GP training")
    parser.add_argument("--kind", choices=["gan", "dcgan", "wgan-gp"], default="dcgan")
    args = parser.parse_args(argv)
    dev = device(args)

    size = 28  # all reference notebooks train on native-resolution MNIST
    x = get_mnist(args, size=size)
    hp = Hparams(seed=args.seed)
    task = GANTask(hp, kind=args.kind, img_shape=(size, size, 1), device=dev)
    state = task.init_state(args.seed)
    step_fn = task.jitted_step()

    # As in JAX's script, only the float() every 100 rounds reads a result
    # back: it/s counts the rounds handed to the card, each of which first
    # copies its batch to the card behind the rounds before it.
    timer = StepTimer()
    data = batches(x, args.batch_size, args.seed)
    scal, rate, paths = {}, 0.0, []
    for i in range(args.steps):
        g = torch.Generator(device=dev).manual_seed(args.seed * 100003 + i)  # JAX's PRNGKey(seed * 100003 + i)
        state, metrics = step_fn(state, next(data), g)
        timer.tick()
        if (i + 1) % 100 == 0:
            scal = {k: round(float(v), 4) for k, v in metrics.items()}
            rate = timer.steps_per_sec
            print(f"| step {i + 1} {scal} ({rate:.1f} it/s)")
            fake = task.generate(state, 16, generator=torch.Generator(device=dev).manual_seed(7))
            paths.append(f"{args.out_dir}/{args.kind}_samples_{i + 1}.png")
            save_grid(nhwc(fake), paths[-1], cols=4)
    return {"state": state, "scalars": scal, "it_per_s": rate, "png": paths}


if __name__ == "__main__":
    main()
