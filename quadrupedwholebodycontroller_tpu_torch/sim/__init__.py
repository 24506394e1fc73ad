from quadrupedwholebodycontroller_tpu_torch.sim.world import (  # noqa: F401
    SimParams,
    SimState,
    init_sim_state,
    observe,
    sim_control_period,
)
