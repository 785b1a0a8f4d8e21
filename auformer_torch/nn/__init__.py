from .registry import build_model, compute_dtype, example_batch, loss_suite

__all__ = ["build_model", "compute_dtype", "example_batch", "loss_suite"]
