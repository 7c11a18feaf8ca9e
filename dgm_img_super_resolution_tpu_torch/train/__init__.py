from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer, TrainState  # noqa: F401
