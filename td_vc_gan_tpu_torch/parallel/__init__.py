"""Data-parallel training and sharded conversion on ``torch.distributed``.

Counterpart of ``td_vc_gan_tpu/parallel``: one process per GPU, parameters
replicated, each rank with its slice of the global batch, gradients averaged
across ranks before every optimizer update (see ``mesh.py``).
"""

from td_vc_gan_tpu_torch.parallel.mesh import (  # noqa: F401
    barrier,
    check_replicas,
    gather_rows,
    initialize_multihost,
    local_batch,
    local_devices,
    mean_,
    mean_metrics,
    rank_world,
)
