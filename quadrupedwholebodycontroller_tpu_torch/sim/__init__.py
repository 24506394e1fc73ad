from quadrupedwholebodycontroller_tpu_torch.sim.world import (  # noqa: F401
    SimParams,
    SimState,
    init_sim_state,
    observe,
    sim_control_period,
)
# the single robot's loops; `sim.rollout` stays the module (its `rollout`
# and `batched_rollout` are reached through it)
from quadrupedwholebodycontroller_tpu_torch.sim.rollout import (  # noqa: F401
    closed_loop_rollout,
    init_rollout_carry,
    trot_rollout,
)
