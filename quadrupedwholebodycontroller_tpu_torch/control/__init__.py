from quadrupedwholebodycontroller_tpu_torch.control.wbc import (  # noqa: F401
    Reference,
    RobotObservation,
    WBCCarry,
    WBCOutput,
    init_carry,
    wbc_step,
    wbc_step_batched,
)
