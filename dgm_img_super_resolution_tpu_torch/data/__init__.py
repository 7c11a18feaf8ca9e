from dgm_img_super_resolution_tpu_torch.data.div2k import DIV2KDataset  # noqa: F401
from dgm_img_super_resolution_tpu_torch.data.loader import DataLoader  # noqa: F401
from dgm_img_super_resolution_tpu_torch.data.mnist import load_mnist, synthetic_mnist  # noqa: F401
