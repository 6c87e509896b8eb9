from xalm_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from xalm_tpu_torch.parallel.shardings import (  # noqa: F401
    cache_pspecs,
    param_pspecs,
    shard_cache,
    shard_params,
)
