"""Runnable training scripts of the educational models on the port
(``dgm_img_super_resolution_tpu_torch``): the AE / VAE, the GANs and the
DDPM, each with ``main(argv=None)``. Run them as files from a checkout,
``python examples_torch/train_gan.py --kind wgan-gp --steps 2000``."""
