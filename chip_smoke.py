#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Drives the port's main path — one Dragonfly simulator phase — on the
card at full width: the default Aries machine (``TopologyParams(
n_groups=12)``: 4,608 nodes, 56,448 directed links), a 120,000-flow
Pareto-sized phase (the size ``benchmarks/perf_sim.py`` uses, and
``SimParams.max_flows``), a 64-rank inter-group allocation,
``ADAPTIVE_0`` and 4 feedback iterations.  Phases:

1. the card's name, power limit and compute capability (must be 9.0);
2. build of the segment-sum kernels from ``csrc/segment_sum.cu``;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with its time, the plain version's, one PyTorch
   library call's (``torch.bincount``, a yardstick the port never calls)
   and its memory bound;
4. the main path: a planned phase, 1 warm-up and 5 timed, then one
   planless, one notifying and one faulted phase, each checked for the
   kernel launches it must make;
5. the same seeded phase on the CPU, whose ``t_us`` must agree with the
   card's at rtol 2e-2.

Prints the kernel summary as one JSON line, then the ``ok`` line last.
Any failed check exits non-zero; so does a machine without CUDA, and a
directory without the rest of the repository.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.strategies import RoutingMode  # noqa: E402
from repro_torch.dragonfly import (DragonflySimulator, DragonflyTopology,  # noqa: E402
                                   RoutingPolicy, SimParams, TopologyParams,
                                   make_allocation)
from repro_torch.dragonfly import torch_backend  # noqa: E402
from repro_torch.faults import FaultSchedule, link_down  # noqa: E402
from repro_torch.kernels.segment_sum import build as kernel_build  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    segment_sum_scatter, segment_sum_scatter_plain, segment_sum_sorted,
    segment_sum_sorted_plain)
from repro_torch.runtime import on_hopper  # noqa: E402

N_GROUPS = 12
N_FLOWS = 120_000
FEEDBACK_ITERS = 4
TIMED_PHASES = 5
#: kernel vs plain version: float32 sums of positive values in another
#: order (and, for the scatter form, in atomic order) — a relative error
#: of a few 1e-7 per term over segments of tens to hundreds of terms
KERNEL_RTOL = 1e-5
#: card vs CPU run of the same phase (the jax engine's JAX_RTOL)
CPU_RTOL = 2e-2
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
TPU_KERNEL = "src/repro/kernels/segment_sum/segment_sum.py:48"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_inputs(topo, n_flows: int, seed: int = 42):
    """The Pareto-sized random many-to-many phase of perf_sim.py."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.params.n_nodes, size=n_flows)
    dst = (src + rng.integers(1, topo.params.n_nodes, size=n_flows)) \
        % topo.params.n_nodes
    size = rng.pareto(1.2, size=n_flows) * 65536 + 1024
    return src, dst, size


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per eager call of ``fn`` over ``iters`` calls,
    between CUDA events: device time, or the host's enqueue time when
    the host is slower."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds per launch: ``iters`` calls captured in
    one CUDA graph and replayed, so the host's per-call Python cost is
    out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn):
    """Call ``fn`` once under ``torch.profiler`` and print its device
    time by kernel (kernels, copies and fills on the card); returns
    ``fn``'s result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_s = sum(us for _, us in by_name.values()) * 1e-6
    if not by_name:
        print("  device time: not measured (the trace holds no device "
              "events)")
        return res
    print(f"  profiled phase: wall {wall_s:.6f} s, device busy "
          f"{busy_s:.6f} s, device idle share {1 - busy_s / wall_s:.4f}, "
          f"{sum(n for n, _ in by_name.values())} device events")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us:10.1f} us  x{n:<4d} {name[:90]}")
    return res


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def hold(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel result vs plain result on the same inputs."""
    torch.cuda.synchronize()
    err = max_err(got, want)
    tol = KERNEL_RTOL * float(want.abs().max())
    ok = bool(torch.allclose(got, want, rtol=KERNEL_RTOL, atol=tol))
    print(f"  {name}: max_abs_err {err:.3e} (rtol {KERNEL_RTOL}, "
          f"atol {tol:.3e}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------------ phase 3
def kernel_checks(x: dict, n_links: int) -> list:
    """Both kernel forms against their plain versions at the shapes of
    one planned phase ``x`` (prepared pipeline inputs)."""
    dev = x["size_all"].device
    n_all, ncand = x["safe"].shape[0], x["safe"].shape[1]
    w = torch.full((n_all, ncand), 1.0 / ncand, device=dev)
    vals = ((x["size_all"][:, None] * w).reshape(-1)[x["pair_fc"]]
            .contiguous())
    p_sorted, seg_off = x["p_sorted"], x["seg_off"]
    head, tail = vals[:p_sorted], vals[p_sorted:]
    tail_ids = x["pair_links"][p_sorted:]
    head_ids = x["pair_links"][:p_sorted].long()
    nic_ids = x["nic_ids"]
    nic_vals = torch.minimum(x["size_all"], x["cap_window"][nic_ids])

    def zeros():
        return torch.zeros(n_links, device=dev)

    print(f"phase 3: kernels vs plain on the card (P = {p_sorted} sorted "
          f"pairs, {tail.shape[0]} tail pairs, {n_all} NIC ids, "
          f"{n_links} segments)")
    # sorted form: the plan-pinned head; real offsets have empty segments
    n_empty = int((seg_off[1:] == seg_off[:-1]).sum())
    check(n_empty > 0, "the main path's offsets have no empty segment")
    err_sorted = hold("sorted head",
                      segment_sum_sorted(head, seg_off, zeros()),
                      segment_sum_sorted_plain(head, seg_off, zeros()))
    # a handful of segments, most of them empty
    few_off = torch.tensor([0, 0, 3, 3, 3, 7, 7], dtype=torch.int32,
                           device=dev)
    few = head[:7].contiguous()
    err_sorted = max(err_sorted, hold(
        "sorted, empty segments",
        segment_sum_sorted(few, few_off, torch.zeros(6, device=dev)),
        segment_sum_sorted_plain(few, few_off, torch.zeros(6, device=dev))))
    # scatter form: the NIC ids, the padded tail, out-of-range ids
    err_scatter = hold("scatter NIC ids",
                       segment_sum_scatter(nic_vals, nic_ids, zeros()),
                       segment_sum_scatter_plain(nic_vals, nic_ids, zeros()))
    err_scatter = max(err_scatter, hold(
        "scatter background tail (bucket-padded)",
        segment_sum_scatter(tail, tail_ids, zeros()),
        segment_sum_scatter_plain(tail, tail_ids, zeros())))
    rng = np.random.default_rng(0)
    bad_ids = torch.from_numpy(rng.choice(
        np.array([-5, -1, n_links, n_links + 7, 3, 17], dtype=np.int32),
        size=nic_ids.shape[0])).to(dev)
    err_scatter = max(err_scatter, hold(
        "scatter, out-of-range ids",
        segment_sum_scatter(nic_vals, bad_ids, zeros()),
        segment_sum_scatter_plain(nic_vals, bad_ids, zeros())))
    # one buffer for head and tail = the plain sum over every pair
    both = segment_sum_scatter(tail, tail_ids,
                               segment_sum_sorted(head, seg_off, zeros()))
    err_sorted = max(err_sorted, hold(
        "sorted head + scatter tail into one buffer", both,
        segment_sum_scatter_plain(vals, x["pair_links"], zeros())))

    # times: kernel, plain version, library yardstick, memory bound
    out = zeros()
    nonempty = int((seg_off[1:] > seg_off[:-1]).sum())
    touched = int(torch.unique(nic_ids).numel())
    nic_ids_long = nic_ids.long()
    rows = []
    for name, kernel, plain, library, n_pairs, nbytes in (
            ("segment_sum_sorted",
             lambda: segment_sum_sorted(head, seg_off, out),
             lambda: segment_sum_sorted_plain(head, seg_off, out),
             lambda: torch.bincount(head_ids, head, minlength=n_links),
             p_sorted,
             4 * p_sorted + 4 * (n_links + 1) + 8 * nonempty),
            ("segment_sum_scatter",
             lambda: segment_sum_scatter(nic_vals, nic_ids, out),
             lambda: segment_sum_scatter_plain(nic_vals, nic_ids, out),
             lambda: torch.bincount(nic_ids_long, nic_vals,
                                    minlength=n_links),
             n_all, 8 * n_all + 8 * touched)):
        ms = graph_ms(kernel, 200)
        eager_ms = cuda_ms(kernel, 200)
        plain_ms = cuda_ms(plain, 20)
        library_ms = cuda_ms(library, 200)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_pairs / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  {name}: {ms * 1e3:.2f} us/launch (graph replay; "
              f"eager call {eager_ms * 1e3:.2f} us), plain "
              f"{plain_ms * 1e3:.2f} us, torch.bincount "
              f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s) over "
              f"{n_pairs} pairs")
        rows.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": TPU_KERNEL, "launches": 0,
                     "max_abs_err": err_sorted if "sorted" in name
                     else err_scatter,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "library_ms": library_ms, "eager_ms": eager_ms})
    return rows


# ------------------------------------------------------------ phase 4
def launches() -> tuple:
    return segment_sum_sorted.launches, segment_sum_scatter.launches


def run_counted(what: str, want: tuple, fn):
    """Run one phase; check the kernel launches it made."""
    before = launches()
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    got = tuple(a - b for a, b in zip(launches(), before))
    print(f"  {what}: {dt:.4f} s, launches sorted/scatter {got[0]}/"
          f"{got[1]} (want {want[0]}/{want[1]})")
    check(got == want, f"{what}: launches {got}, want {want}")
    check(bool(np.isfinite(res.t_us).all()) and res.t_us.shape[0] > 0,
          f"{what}: non-finite or empty t_us")
    return res, dt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    cuda = torch.device("cuda")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print("phase 1:", card, "| capability", cap, "| torch", torch.__version__,
          "cuda", torch.version.cuda)
    check(on_hopper(), f"compute capability {cap}, want (9, 0)")

    info = kernel_build.build()
    kernel_build.load_library()
    print(f"phase 2: built {info.path.name} in {info.seconds:.2f} s")
    if info.log.strip():
        print(info.log.strip())

    topo = DragonflyTopology(TopologyParams(n_groups=N_GROUPS))
    n_links = int(topo.n_links)
    check(n_links == 56_448 and topo.n_nodes == 4_608,
          f"unexpected machine: {n_links} links, {topo.n_nodes} nodes")
    src, dst, size = phase_inputs(topo, N_FLOWS)
    alloc = make_allocation(topo, 64, spread="inter_groups", seed=3)
    pol = RoutingPolicy(RoutingMode.ADAPTIVE_0)
    params = SimParams(seed=0, route_feedback_iters=FEEDBACK_ITERS,
                       profile_stages=True)

    # phase 3 on a probe simulator, so the main path's draws stay its own
    probe = DragonflySimulator(topo, params, device=cuda)
    pplan = probe.plan_for(src, dst, size)
    x = torch_backend._prepare_inputs(
        probe, probe._phase_begin(src, dst, size, pol, alloc, plan=pplan))
    kernels = kernel_checks(x, n_links)
    del probe, pplan, x

    # phase 4: the main path; launch counts from here on are its own
    loads = FEEDBACK_ITERS + 1
    planned = (loads, 1 + loads)      # sorted head + scattered tail each
    planless = (0, 1 + loads)
    segment_sum_sorted.launches = 0
    segment_sum_scatter.launches = 0
    print(f"phase 4: main path, {N_FLOWS} flows on {topo.n_nodes} nodes / "
          f"{n_links} links")
    sim = DragonflySimulator(topo, params, device=cuda)
    t0 = time.perf_counter()
    plan = sim.plan_for(src, dst, size)
    print(f"  plan_for: {time.perf_counter() - t0:.4f} s, "
          f"P = {plan.pair_links.shape[0]} app pairs")

    def planned_phase(s, p):
        return lambda: s.run_phase(src, dst, size, pol, alloc, plan=p)

    run_counted("warm-up phase", planned, planned_phase(sim, plan))
    sim.stage_time_s.clear()
    times = [run_counted(f"timed phase {i}", planned,
                         planned_phase(sim, plan))[1]
             for i in range(TIMED_PHASES)]
    phase_s = float(np.mean(times))
    stages = {k: v / TIMED_PHASES for k, v in sim.stage_time_s.items()}
    print(f"  phase_s {phase_s:.6f} (min {min(times):.6f}, max "
          f"{max(times):.6f}), flows_per_s {N_FLOWS / phase_s:.1f}, "
          f"launches per phase {sum(planned)}")
    print("  stages_s " + json.dumps({k: round(v, 6)
                                      for k, v in stages.items()}))
    run_counted("profiled phase", planned,
                lambda: device_profile(planned_phase(sim, plan)))
    run_counted("planless phase", planless,
                lambda: sim.run_phase(src, dst, size, pol, alloc))

    nsim = DragonflySimulator(
        topo, SimParams(seed=1, route_feedback_iters=FEEDBACK_ITERS,
                        notify_threshold_s=1e-5), device=cuda)
    for i in range(2):      # a raised flag shows after one phase's delay
        run_counted(f"notify warm-up phase {i}", planned,
                    planned_phase(nsim, nsim.plan_for(src, dst, size)))
    check(bool(nsim.notified_links.any()), "no congestion flag is visible")
    res, _ = run_counted("notifying phase", planned,
                         planned_phase(nsim, nsim.plan_for(src, dst, size)))
    check(res.notified is not None and bool((res.notified > 0).any()),
          "no flow crossed a flagged link")

    fsim = DragonflySimulator(
        topo, SimParams(seed=2, route_feedback_iters=FEEDBACK_ITERS),
        faults=FaultSchedule.of(link_down(n_random=2, seed=1)), device=cuda)
    res, _ = run_counted("faulted phase (2 global links down)", planned,
                         planned_phase(fsim, fsim.plan_for(src, dst, size)))
    check(res.stranded is not None, "the faulted phase carried no mask")

    counts = {"segment_sum_sorted": segment_sum_sorted.launches,
              "segment_sum_scatter": segment_sum_scatter.launches}
    for row in kernels:
        row["launches"] = counts[row["name"]]
        check(row["launches"] > 0, f"{row['name']} never ran on the path")

    # phase 5: the same seeded phase on the CPU
    print("phase 5: card vs CPU, one planned phase of seed 7")
    out = []
    for dev in (cuda, torch.device("cpu")):
        s = DragonflySimulator(topo, SimParams(
            seed=7, route_feedback_iters=FEEDBACK_ITERS), device=dev)
        out.append(s.run_phase(src, dst, size, pol, alloc,
                               plan=s.plan_for(src, dst, size)))
    a, b = out
    check(np.array_equal(a.flits, b.flits), "flits differ card vs CPU")
    rel = np.abs(a.t_us - b.t_us) / np.abs(b.t_us)
    print(f"  t_us max rel diff {rel.max():.3e} (rtol {CPU_RTOL}), "
          f"phase_time_us card {a.phase_time_us:.3f} cpu "
          f"{b.phase_time_us:.3f}")
    check(bool(np.allclose(a.t_us, b.t_us, rtol=CPU_RTOL, atol=0.0)),
          "card and CPU t_us disagree")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
