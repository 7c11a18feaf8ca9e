"""Train the simple autoencoder or the VAE (MNIST, ELBO/recon loss) on the port.

The AE mirrors ``notebooks/simple_autoencoder.ipynb`` (plus the training loop
the notebook omits); the VAE fills the reference's empty ``vae.ipynb`` stub.
The JAX package's ``examples/train_vae.py`` on the card.

    python examples_torch/train_vae.py --model vae --steps 1000 [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the port and examples_torch from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from dgm_img_super_resolution_tpu_torch.core.config import Hparams  # noqa: E402
from dgm_img_super_resolution_tpu_torch.train.tasks.vae import AETask, VAETask  # noqa: E402
from examples_torch.common import base_parser, batches, device, get_mnist, nhwc, save_grid  # noqa: E402


def main(argv=None) -> dict:
    """Train, then write ``vae_samples.png`` or ``ae_recon.png`` (4 x 4)
    into ``--out_dir``. Returns the training state, the last logged
    scalars (every 100 steps) and the grid's path."""
    parser = base_parser("AE / VAE training")
    parser.add_argument("--model", choices=["ae", "vae"], default="vae")
    parser.add_argument("--latent_dim", type=int, default=16)
    args = parser.parse_args(argv)
    dev = device(args)

    x = (get_mnist(args, size=32) + 1.0) / 2.0  # sigmoid decoders want [0,1]
    hp = Hparams(lr=1e-3, val_check_interval=0, tb_log_interval=100, seed=args.seed)
    task = (
        AETask(hp, latent_dim=2, device=dev)
        if args.model == "ae"
        else VAETask(hp, latent_dim=args.latent_dim, device=dev)
    )
    trainer = task.make_trainer()
    trainer.work_dir = args.out_dir
    data = ({"x": b} for b in batches(x, args.batch_size, args.seed))
    state = trainer.fit(data, generator=args.seed, max_updates=args.steps, resume=False)

    if args.model == "vae":
        samples = task.sample(state.model, 16, generator=torch.Generator(device=dev).manual_seed(1))
        path = f"{args.out_dir}/vae_samples.png"
        save_grid(nhwc(samples), path, cols=4)
    else:
        with torch.no_grad():
            recon = state.model(torch.from_numpy(x[:16]).to(dev).permute(0, 3, 1, 2))
        path = f"{args.out_dir}/ae_recon.png"
        save_grid(nhwc(recon), path, cols=4)
    return {"state": state, "scalars": trainer._metrics_log[-1] if trainer._metrics_log else {}, "png": path}


if __name__ == "__main__":
    main()
