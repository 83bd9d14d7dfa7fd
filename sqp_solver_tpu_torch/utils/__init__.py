from sqp_solver_tpu_torch.utils.debug import is_psd, print_qp
from sqp_solver_tpu_torch.utils.device import default_device, resolve_device
from sqp_solver_tpu_torch.utils.precision import hdot, hmat, pin_precision

__all__ = ["hdot", "hmat", "is_psd", "print_qp", "pin_precision", "default_device",
           "resolve_device"]
