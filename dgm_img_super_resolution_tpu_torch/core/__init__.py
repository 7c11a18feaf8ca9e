from dgm_img_super_resolution_tpu_torch.core.config import (  # noqa: F401
    DEFAULTS,
    Hparams,
    load_config,
    override_config,
    set_hparams,
)
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device  # noqa: F401
