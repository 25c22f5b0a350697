"""Segment sum: CUDA wrappers and their plain PyTorch versions.

Counterpart of ``repro/kernels/segment_sum``.  Two entry forms, both
accumulating float32 values into ``out`` (float32 ``[n_segments]``):

* :func:`segment_sum_sorted` — values already ordered by segment, with
  int32 ``seg_off`` ``[n_segments + 1]`` offsets (``seg_off[0] == 0``,
  ``seg_off[-1] == len(values)``): the plan-pinned pair list;
* :func:`segment_sum_scatter` — unsorted int32 ids; ids outside
  ``[0, n_segments)`` contribute nothing.

A wrapper runs the plain version only for tensors on the CPU (which only
the tests pass).  For CUDA tensors it launches the kernel of
``csrc/segment_sum.cu`` on the current stream or raises; any other
device raises, and so does a CUDA call that would need a gradient (the
kernels have no backward, and the simulator never asks for one:
:mod:`repro_torch.kernels._route`).  Each
wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import launches_kernel
from repro_torch.kernels.segment_sum.build import load_library


# ----------------------------------------------------------- plain versions
def segment_sum_sorted_plain(values: torch.Tensor, seg_off: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """``out[s] += values[seg_off[s]:seg_off[s+1]].sum()``."""
    n = out.shape[0]
    ids = torch.repeat_interleave(
        torch.arange(n, device=out.device), (seg_off[1:] - seg_off[:-1]).long(),
        output_size=values.shape[0])
    return out.index_add_(0, ids, values)


def segment_sum_scatter_plain(values: torch.Tensor, ids: torch.Tensor,
                              out: torch.Tensor) -> torch.Tensor:
    """``out[ids[i]] += values[i]`` for the in-range ids."""
    keep = (ids >= 0) & (ids < out.shape[0])
    return out.index_add_(0, ids[keep], values[keep])


# ----------------------------------------------------------------- wrappers
def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous 1-D {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, values on {device}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def segment_sum_sorted(values: torch.Tensor, seg_off: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    """Sorted form; returns ``out``."""
    _check("values", values, torch.float32, values.device)
    _check("seg_off", seg_off, torch.int32, values.device)
    _check("out", out, torch.float32, values.device)
    if seg_off.shape[0] != out.shape[0] + 1:
        raise ValueError("seg_off must have n_segments + 1 entries")
    if not launches_kernel("segment_sum_sorted", values, out):
        return segment_sum_sorted_plain(values, seg_off, out)
    if values.shape[0] >= 2**31:
        raise ValueError("segment_sum_sorted takes fewer than 2**31 values")
    if values.shape[0] == 0 or out.shape[0] == 0:
        return out
    err = load_library().segment_sum_sorted(
        values.data_ptr(), seg_off.data_ptr(), out.shape[0], out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream)
    _raise_on(err, "segment_sum_sorted")
    segment_sum_sorted.launches += 1
    return out


def segment_sum_scatter(values: torch.Tensor, ids: torch.Tensor,
                        out: torch.Tensor) -> torch.Tensor:
    """Scatter form; returns ``out``."""
    _check("values", values, torch.float32, values.device)
    _check("ids", ids, torch.int32, values.device)
    _check("out", out, torch.float32, values.device)
    if ids.shape[0] != values.shape[0]:
        raise ValueError("ids and values differ in length")
    if not launches_kernel("segment_sum_scatter", values, out):
        return segment_sum_scatter_plain(values, ids, out)
    if values.shape[0] == 0 or out.shape[0] == 0:
        return out
    err = load_library().segment_sum_scatter(
        values.data_ptr(), ids.data_ptr(), values.shape[0], out.shape[0],
        out.data_ptr(), torch.cuda.current_stream(values.device).cuda_stream)
    _raise_on(err, "segment_sum_scatter")
    segment_sum_scatter.launches += 1
    return out


segment_sum_sorted.launches = 0
segment_sum_scatter.launches = 0


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``[num_segments]`` float32 sums of ``values`` by ``ids`` (scatter
    form into fresh zeros) — the reference ``segment_sum_ref`` contract."""
    out = torch.zeros(num_segments, dtype=torch.float32, device=values.device)
    return segment_sum_scatter(values, ids, out)
