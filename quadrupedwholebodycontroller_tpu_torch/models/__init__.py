from quadrupedwholebodycontroller_tpu_torch.models.anymal import anymal_d_model  # noqa: F401
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel  # noqa: F401
