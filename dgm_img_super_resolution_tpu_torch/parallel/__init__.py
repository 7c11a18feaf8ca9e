from dgm_img_super_resolution_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Rows,
    Shard,
    all_reduce_mean,
    batch_rows,
    gather_rows,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
