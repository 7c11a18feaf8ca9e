from dgm_img_super_resolution_tpu_torch.metrics.psnr_ssim import (  # noqa: F401
    SSIM,
    psnr,
    ssim,
    ssim_eval,
)
from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure  # noqa: F401
