from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused, rmsnorm_plain

__all__ = ["rmsnorm_fused", "rmsnorm_plain"]
