from quadrupedwholebodycontroller_tpu_torch.parallel.mesh import (  # noqa: F401
    distributed_init,
    make_mesh,
    shard_batch,
)
from quadrupedwholebodycontroller_tpu_torch.parallel.sweep import (  # noqa: F401
    sharded_sweep_step,
    sweep_metrics,
)
from quadrupedwholebodycontroller_tpu_torch.parallel.flagship import (  # noqa: F401
    sharded_wbc_step,
)
