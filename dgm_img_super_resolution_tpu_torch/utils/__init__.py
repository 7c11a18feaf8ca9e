from dgm_img_super_resolution_tpu_torch.utils.misc import (  # noqa: F401
    cycle,
    make_run_dir,
    num_to_groups,
    plot_img,
    reduce_metrics,
    set_seed,
    tensors_to_np,
    tensors_to_scalars,
    to_device,
    to_host,
)
from dgm_img_super_resolution_tpu_torch.utils.profiling import StepTimer, profile_to, trace_annotation  # noqa: F401
