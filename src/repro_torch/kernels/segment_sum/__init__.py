from repro_torch.kernels.segment_sum.ops import (segment_sum,
                                                 segment_sum_scatter,
                                                 segment_sum_scatter_plain,
                                                 segment_sum_sorted,
                                                 segment_sum_sorted_plain)

__all__ = ["segment_sum", "segment_sum_scatter", "segment_sum_scatter_plain",
           "segment_sum_sorted", "segment_sum_sorted_plain"]
