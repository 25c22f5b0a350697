from repro_torch.kernels.ssd_scan.ops import (ssd_inner, ssd_inner_bwd,
                                              ssd_inner_bwd_plain,
                                              ssd_inner_plain, ssd_scan_op)

__all__ = ["ssd_inner", "ssd_inner_bwd", "ssd_inner_bwd_plain",
           "ssd_inner_plain", "ssd_scan_op"]
