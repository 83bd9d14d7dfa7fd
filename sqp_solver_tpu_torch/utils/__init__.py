from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["pin_precision"]
