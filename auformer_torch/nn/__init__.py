from .registry import build_model, compute_dtype, loss_suite

__all__ = ["build_model", "compute_dtype", "loss_suite"]
