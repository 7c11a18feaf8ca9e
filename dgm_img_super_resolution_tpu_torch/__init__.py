"""dgm_img_super_resolution_tpu_torch — the PyTorch/CUDA port of
``dgm_img_super_resolution_tpu``, serving SRDiff x4 super-resolution on an
NVIDIA H100.

The JAX package beside it is the reference: every module here keeps the
counterpart's name and is tested against it with the same weights and inputs.
The port imports ``torch`` and ``numpy`` (and ``yaml`` for the config), never
JAX and nothing of the JAX package.

Entry point: :class:`dgm_img_super_resolution_tpu_torch.inference.SRDiffPipeline`.
It runs on ``cuda`` unless the caller passes ``device="cpu"``. The three
Pallas regions of the UNet step (``block_chain3_stem``, ``block_chain3``,
``tail_fuse``) are hand-written CUDA kernels under ``ops/kernels/csrc``, built
with ``nvcc`` at first use; on CPU tensors they run their plain PyTorch
versions.
"""

__version__ = "0.1.0"

from dgm_img_super_resolution_tpu_torch.core.config import Hparams, set_hparams  # noqa: F401
