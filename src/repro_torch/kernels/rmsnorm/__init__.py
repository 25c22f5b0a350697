from repro_torch.kernels.rmsnorm.ops import (RMSNormFunction, rmsnorm_bwd,
                                             rmsnorm_bwd_plain, rmsnorm_fused,
                                             rmsnorm_plain)

__all__ = ["RMSNormFunction", "rmsnorm_bwd", "rmsnorm_bwd_plain",
           "rmsnorm_fused", "rmsnorm_plain"]
