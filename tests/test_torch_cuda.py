"""The port's CUDA kernels and its phase on the card.

Every test here needs an NVIDIA CUDA device and skips without one; on
the card run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  This file imports neither jax nor the
reference package, so it runs where only the port is installed.

Kernel vs plain version: float32 sums of positive values in another
order (and, for the scatter form, in atomic order) agree to a few 1e-7
relative per term, so both are held at ``rtol = 1e-5``.  A phase on the
card vs the same seeded phase on the CPU is held at the jax engine's
``JAX_RTOL = 2e-2``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly import (DragonflySimulator, RoutingPolicy,
                                   SimParams, small_topology)
from repro_torch.kernels.segment_sum import (segment_sum_scatter,
                                             segment_sum_scatter_plain,
                                             segment_sum_sorted,
                                             segment_sum_sorted_plain)

pytestmark = pytest.mark.cuda

TOL = 1e-5
JAX_RTOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(n, segs, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segs, size=n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    off = np.zeros(segs + 1, dtype=np.int32)
    np.cumsum(np.bincount(ids, minlength=segs), out=off[1:])
    return ids, vals, vals[order], off


@pytest.mark.parametrize("n,segs", [(3_500_000, 56_448), (1000, 300),
                                    (64, 1000), (5, 3)])
def test_kernels_match_plain_versions(cuda, n, segs):
    ids, vals, v_sorted, off = (torch.from_numpy(a).to(cuda)
                                for a in _inputs(n, segs, seed=3))

    def zeros():
        return torch.zeros(segs, device=cuda)

    before = segment_sum_sorted.launches, segment_sum_scatter.launches
    k_sorted = segment_sum_sorted(v_sorted, off, zeros())
    k_scatter = segment_sum_scatter(vals, ids, zeros())
    assert (segment_sum_sorted.launches, segment_sum_scatter.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        k_sorted, segment_sum_sorted_plain(v_sorted, off, zeros()),
        rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        k_scatter, segment_sum_scatter_plain(vals, ids, zeros()),
        rtol=TOL, atol=TOL)


def test_scatter_skips_out_of_range_ids(cuda):
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], device=cuda)
    ids = torch.tensor([2, 2, 5, -1, 8, 100], dtype=torch.int32,
                       device=cuda)
    out = segment_sum_scatter(vals, ids, torch.zeros(8, device=cuda))
    assert out.tolist() == [0, 0, 3.0, 0, 0, 4.0, 0, 0]


def test_sorted_form_is_deterministic(cuda):
    _, _, v_sorted, off = (torch.from_numpy(a).to(cuda)
                           for a in _inputs(200_000, 5000, seed=4))
    runs = [segment_sum_sorted(v_sorted, off, torch.zeros(5000, device=cuda))
            for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("use_plan", [False, True])
def test_phase_on_the_card_matches_the_cpu(cuda, use_plan):
    topo = small_topology("aries")
    rng = np.random.default_rng(7)
    src = rng.integers(0, topo.n_nodes, size=400)
    dst = (src + rng.integers(1, topo.n_nodes, size=400)) % topo.n_nodes
    size = rng.pareto(1.2, size=400) * 65536 + 1024
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_2)
    sims = [DragonflySimulator(topo, SimParams(seed=5), device=d)
            for d in (cuda, "cpu")]
    for _ in range(3):
        a, b = (s.run_phase(src, dst, size, pol,
                            plan=s.plan_for(src, dst, size) if use_plan
                            else None) for s in sims)
        np.testing.assert_allclose(a.t_us, b.t_us, rtol=JAX_RTOL)
        np.testing.assert_allclose(a.latency_us, b.latency_us, rtol=JAX_RTOL)
        assert np.array_equal(a.flits, b.flits)
        assert sims[0].rng.bit_generator.state == \
            sims[1].rng.bit_generator.state
