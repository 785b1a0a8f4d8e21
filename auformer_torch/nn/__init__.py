from .registry import build_model, compute_dtype

__all__ = ["build_model", "compute_dtype"]
