from quadrupedwholebodycontroller_tpu_torch.planner.gait import (  # noqa: F401
    PlannerState,
    init_planner_state,
    planner_step,
)
