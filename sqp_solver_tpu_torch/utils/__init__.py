from sqp_solver_tpu_torch.utils.device import default_device, resolve_device
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["pin_precision", "default_device", "resolve_device"]
