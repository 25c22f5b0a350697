#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Drives the port's three main paths on the card at full width:

* the simulator path, one Dragonfly phase: the default Aries machine
  (``TopologyParams(n_groups=12)``: 4,608 nodes, 56,448 directed
  links), a 120,000-flow Pareto-sized phase (the size
  ``benchmarks/perf_sim.py`` uses, and ``SimParams.max_flows``), a
  64-rank inter-group allocation, ``ADAPTIVE_0`` and 4 feedback
  iterations;
* the serving path: mamba2-130m at its published width (24 layers,
  d_model 768, vocab 50,280; random weights from a seed) behind the
  port's ``ServeEngine``, 8 requests of 512-token prompts and 32 new
  tokens each, greedy;
* the dense serving path: qwen2-1.5b at its published width (28 layers,
  d_model 1536, 12 heads over 2 KV heads of 128, d_ff 8960, vocab
  151,936; random weights from a seed), the same requests.

Phases:

1. the card's name, power limit and compute capability (must be 9.0);
2. build of every kernel library (one ``nvcc`` per source, all started
   together), and a probe of the flash and SSD libraries' SASS for
   ``HGMMA`` (the tensor-core ``wgmma`` of their bf16 kernels);
3. the segment-sum kernels against their plain PyTorch versions on the
   card, at the simulator path's shapes, with their times, the plain
   versions', one PyTorch library call's (``torch.bincount``, a
   yardstick the port never calls) and their memory bound;
4. the simulator path: a planned phase, 1 warm-up and 5 timed, then one
   planless, one notifying and one faulted phase, each checked for the
   kernel launches it must make;
5. the same seeded phase on the CPU, whose ``t_us`` must agree with the
   card's at rtol 2e-2;
6. the SSD (B3) and RMSNorm (B4) kernels against their plain versions
   on inputs taken from a warm-up serve, at the serving path's shapes:
   B3's bf16 tensor-core route on the serve's own bf16 inputs (B and C
   per group) and its float32 SIMT route on the same inputs cast to
   float32, with both routes' times and bounds, the plain version's,
   ``F.rms_norm``'s for B4 and its bound;
7. the serving path: one timed ``ServeEngine.run``, every prefill and
   decode step checked for its kernel launches (every B3 launch on the
   tensor-core route), then one run with the prefill and one decode step
   under ``torch.profiler``;
8. the same seeded model on the CPU: 2 prompts of 256 tokens, last-token
   prefill logits against the card's in float32 and bfloat16 at 24
   layers, and in bfloat16 at 2 layers;
9. the flash-attention kernel (B2) against its plain version on inputs
   taken from a warm-up serve of qwen2-1.5b, in bfloat16 and float32 at
   the prefill's shape and at ragged lengths, and in bfloat16 at
   stablelm-1.6b's head dim of 64, with its time, the plain version's,
   ``F.scaled_dot_product_attention``'s (a yardstick the port never
   calls) and its bound; B4 at that serve's shapes;
10. the dense serving path as phase 7: qwen2-1.5b, every prefill and
    decode step checked for its kernel launches, then profiled;
11. as phase 8 for qwen2-1.5b at 28 layers and at 2.

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
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2  # noqa: E402
from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN2  # noqa: E402
from repro_torch.configs.stablelm_1_6b import CONFIG as STABLELM  # noqa: E402
from repro_torch.kernels import libraries  # noqa: E402
from repro_torch.kernels._build import build_all, find_nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.build import LIB as FLASH_LIB  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_plain  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    segment_sum_scatter, segment_sum_scatter_plain, segment_sum_sorted,
    segment_sum_sorted_plain)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_inner, ssd_inner_plain  # noqa: E402
from repro_torch.kernels.ssd_scan.build import LIB as SSD_LIB  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import mamba2 as model_mamba2  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.runtime import on_hopper  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402

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
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s, dense
#: bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
KERNEL_SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
TPU_KERNEL = "src/repro/kernels/segment_sum/segment_sum.py:48"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/ssd_scan.py:54"
RMS_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
RMS_TPU = "src/repro/kernels/rmsnorm/rmsnorm.py:29"
FLASH_SOURCE = \
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:84"
#: serving path: requests x prompt tokens, new tokens, weight seed
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS, SEED = 8, 512, 32, 0
#: card vs CPU prefill: prompts x tokens
CPU_BATCH, CPU_PROMPT = 2, 256
#: SSD kernel vs plain version in float32: float32 sums of at most 128
#: products, relative to the largest output (the tests' SSD_RTOL); in
#: bf16 per output within ssd_ops.bf16_limits (the witness
#: tests/test_torch_ssd_scan.py::test_bf16_route_witness)
SSD_RTOL = 1e-5
#: targets for B3's bf16 route at the prefill's shape: at most this many
#: us per launch, and this many times faster than the float32 route in the
#: same run; reported, not enforced (a miss goes into PERF.md)
SSD_BF16_US, SSD_F32_FACTOR = 110.0, 4.0
#: RMSNorm kernel vs plain version in bf16: one bf16 ulp of the value
BF16_RTOL = 2.0 ** -7
#: flash kernel vs plain version in float32: the same float32 math in
#: other orders (the kernel scales q before the dot, the plain version
#: the scores after it), at the JAX kernel tests' 3e-5
FLASH_TOL = 3e-5
#: in bf16 the kernel rounds each kv tile's unnormalised P to bf16 and
#: the plain version the normalised probabilities, each p_j to within
#: 2**-8 p_j: outputs to one bf16 ulp of the value (BF16_RTOL) plus, per
#: output, FLASH_BF16_ATOL_PER_PV * sum_j p_j |v_j|, the worst case of
#: the two placements (flash_bf16_atol; the witness
#: tests/test_torch_flash_attention.py::test_kernel_order_witness)
FLASH_BF16_ATOL_PER_PV = 2.0 ** -7
#: the target for B2's bf16 time, as a multiple of SDPA's: reported, not
#: enforced (a miss goes into PERF.md with its numbers)
FLASH_SDPA_FACTOR = 2.0
#: card vs CPU logits of the full-width model in float32: the same math
#: in other summation orders over 24 or 28 layers
LOGITS_F32_TOL = 1e-3
#: card vs CPU logits in bf16 at full width and 2 layers: the tests' bf16
#: tolerance (tests/test_torch_mamba2.py), at the depth they hold it
LOGITS_BF16_TOL = 4e-2
#: card vs CPU logits of mamba2-130m in bf16 at 24 layers, as a share of
#: the CPU's bf16 vs float32 difference: there the two bf16 runs share
#: most of their rounding (readings: 0.40-0.50 card vs CPU, PERF.md
#: section 6).  Not held for qwen2-1.5b at 28 layers, where any two bf16
#: runs that sum in other orders share little of it (readings: 0.93 and
#: 0.86 card vs CPU; tests/test_torch_transformer.py::
#: test_bf16_rounding_spread_grows_with_depth)
BF16_SPREAD_SHARE = {MAMBA2.name: 0.75}
#: the card's bf16 logits at full depth vs the CPU's float32 ones, as a
#: multiple of the CPU's bf16 vs float32 difference: a bf16 run that sums
#: in another order is as close to float32 as the first (the witness
#: above: 0.97-0.99 in mean, at most 1.0 in max)
BF16_ACCURACY_RATIO = 1.25


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


#: device_profile's numbers by label
PROFILES: dict = {}


def device_profile(fn, label: str = "phase"):
    """Call ``fn`` once under ``torch.profiler`` and print its device
    time by kernel (kernels, copies and fills on the card); returns
    ``fn``'s result and keeps wall, busy and idle share in
    ``PROFILES[label]``."""
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
    PROFILES[label] = {"wall_s": wall_s, "busy_s": busy_s,
                       "idle_share": 1 - busy_s / wall_s}
    print(f"  profiled {label}: wall {wall_s:.6f} s, device busy "
          f"{busy_s:.6f} s, device idle share {1 - busy_s / wall_s:.4f}, "
          f"{sum(n for n, _ in by_name.values())} device events")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us:10.1f} us  x{n:<4d} {name[:90]}")
    return res


def hgmma_count(lib) -> int:
    """HGMMA (``wgmma``) instructions in a built library's SASS, read
    with the toolkit's ``cuobjdump``."""
    out = subprocess.run(
        [str(Path(find_nvcc()).parent / "cuobjdump"), "--dump-sass",
         str(lib.path)], capture_output=True, text=True, check=True,
        timeout=300)
    return sum("HGMMA" in line for line in out.stdout.splitlines())


def flash_bf16_atol(q, k, v, causal: bool) -> torch.Tensor:
    """Per output, ``FLASH_BF16_ATOL_PER_PV * sum_j p_j |v_j|`` with the
    plain version's float32 probabilities."""
    return FLASH_BF16_ATOL_PER_PV * flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal)


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



# ----------------------------------------------------------- phases 6-11
#: the kernels of each serving path: the mixer's (B3 or B2), then B4;
#: a prefill launches the first once per layer, a decode step never, and
#: B4 twice per layer and once for the final norm in both
SERVE_KERNELS = {MAMBA2.name: (ssd_inner, rmsnorm_fused),
                 QWEN2.name: (flash_attention, rmsnorm_fused)}


def launch_counts(kernels) -> tuple:
    return tuple(k.launches for k in kernels)


def prompts(vocab: int, batch: int, length: int, seed: int) -> list:
    """Random prompts, as ``repro_torch.launch.serve`` draws them."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, vocab, length)) for _ in range(batch)]


class Checked:
    """Wraps an engine's prefill or decode step: each call synchronises,
    is timed on the host clock, and must launch exactly ``want`` of each
    of ``kernels``; ``profile_at`` names calls to run under
    :func:`device_profile` instead."""

    def __init__(self, fn, what: str, kernels, want: tuple, profile_at=()):
        self.fn, self.what, self.kernels, self.want = fn, what, kernels, want
        self.profile_at = set(profile_at)
        self.times: list = []

    def __call__(self, *args):
        before = launch_counts(self.kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(self.times) in self.profile_at:
            out = device_profile(lambda: self.fn(*args), self.what)
        else:
            out = self.fn(*args)
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        got = tuple(a - b for a, b in zip(launch_counts(self.kernels),
                                        before))
        names = "/".join(k.__name__ for k in self.kernels)
        check(got == self.want, f"{self.what} call {len(self.times)}: "
              f"launches {names} {got}, want {self.want}")
        return out


def serve_engine(cfg, model, cuda, profile=False):
    """A ServeEngine of ``cfg`` whose prefill and decode steps are
    Checked for the launches of ``SERVE_KERNELS[cfg.name]``."""
    n_layers, kernels = cfg.n_layers, SERVE_KERNELS[cfg.name]
    eng = ServeEngine(cfg, model,
                      ServeConfig(batch=SERVE_BATCH,
                                  max_len=PROMPT_LEN + NEW_TOKENS + 8),
                      device=cuda)
    eng._prefill = Checked(eng._prefill, f"{cfg.name} prefill", kernels,
                           (n_layers, 2 * n_layers + 1),
                           profile_at=(0,) if profile else ())
    eng._step = Checked(eng._step, f"{cfg.name} decode step", kernels,
                        (0, 2 * n_layers + 1),
                        profile_at=(1,) if profile else ())
    return eng


def serve_requests(cfg) -> list:
    return [Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts(cfg.vocab, SERVE_BATCH, PROMPT_LEN, SEED)]


def capture_inputs(cfg, model, cuda) -> dict:
    """One warm-up serve; keeps the first inputs of each shape that the
    B2, B3 and B4 wrappers were given (B3's rebuilt from the scan's
    arguments by ``chunk_inputs``, as ``ssd_scan_op`` builds them: x, B,
    C, dacum and dt on the bf16 route)."""
    seen: dict = {}
    real_scan, real_norm, real_flash = model_mamba2.ssd_scan_op, \
        model_common.rmsnorm_fused, model_attention.flash_attention

    def scan(x, dt, a_log, b_mat, c_mat, chunk, **kw):
        key = ("ssd",) + tuple(x.shape)
        if key not in seen:
            seen[key] = [t.clone() for t in ssd_ops.chunk_inputs(
                x, dt, a_log, b_mat, c_mat, chunk)]
        return real_scan(x, dt, a_log, b_mat, c_mat, chunk, **kw)

    def norm(x, gamma, eps):
        seen.setdefault(("rms",) + tuple(x.shape),
                        [x.clone(), gamma.clone(), eps])
        return real_norm(x, gamma, eps)

    def flash(q, k, v, *, causal=True):
        seen.setdefault(("flash",) + tuple(q.shape) + tuple(k.shape),
                        [q.clone(), k.clone(), v.clone(), causal])
        return real_flash(q, k, v, causal=causal)

    model_mamba2.ssd_scan_op, model_common.rmsnorm_fused, \
        model_attention.flash_attention = scan, norm, flash
    try:
        serve_engine(cfg, model, cuda).run(serve_requests(cfg), seed=SEED)
    finally:
        model_mamba2.ssd_scan_op, model_common.rmsnorm_fused, \
            model_attention.flash_attention = real_scan, real_norm, real_flash
    return seen


def serve_kernel_checks(seen: dict) -> list:
    """B3 and B4 against their plain versions on the serving path's own
    inputs; times and bounds.  Returns the JSON rows (B3, then B4 at the
    prefill's ``[B*S, d_model]``)."""
    import torch.nn.functional as F

    print("phase 6: SSD and RMSNorm kernels vs plain on the card, inputs "
          "from a warm-up serve")
    rows = []
    ssd_keys = [k for k in seen if k[0] == "ssd"]
    check(len(ssd_keys) == 1, f"the serve gave B3 shapes {ssd_keys}")
    bf = seen[ssd_keys[0]]
    x, bm, cm, da, dt = bf
    bsz, nc, heads, q, p = x.shape
    groups, n = bm.shape[2], bm.shape[-1]
    check(x.dtype == bm.dtype == cm.dtype == torch.bfloat16 and
          dt is not None and groups == 1, f"B3 saw x {x.dtype}, b "
          f"{tuple(bm.shape)} {bm.dtype}: want bf16, dt, one group")
    f32 = [t.float() for t in (x, bm, cm)] + [da, dt]
    row = {"name": "ssd_inner", "route": "cuda", "source": SSD_SOURCE,
           "replaces": SSD_TPU, "launches": 0,
           "shape": list(x.shape) + [n, groups]}
    cells = bsz * nc * heads
    # the function's own work: C.B^T once per group over the causal half
    # (j <= i), scores . xdt over it and the state; the elementwise decay
    # terms (under 1 %) are left out
    flops = cells * (q * (q + 1) * p + 2 * q * n * p) + \
        bsz * nc * groups * q * (q + 1) * n
    for prefix, args in (("", bf), ("f32_", f32)):
        label = "bf16 (wgmma)" if prefix == "" else "float32 (SIMT)"
        y, st = ssd_inner(*args)
        torch.cuda.synchronize()
        want_y, want_st = ssd_inner_plain(*args)
        if prefix == "":
            limits = ssd_ops.bf16_limits(*args)
            what = "per output bf16_limits"
        else:
            limits = [SSD_RTOL * (w.abs() + float(w.abs().max()))
                      for w in (want_y, want_st)]
            what = f"rtol {SSD_RTOL}, atol {SSD_RTOL} max|want|"
        err = share = 0.0
        for name, got, want, lim in (("y", y, want_y, limits[0]),
                                     ("states", st, want_st, limits[1])):
            gap = (got - want).abs()
            ok = bool((gap <= lim).all())
            sh = float((gap / lim.clamp_min(1e-30)).max())
            print(f"  ssd_inner {label} {name} {tuple(got.shape)}: "
                  f"max_abs_err {float(gap.max()):.3e} ({what}; largest gap "
                  f"{sh:.3f} of its limit) {'ok' if ok else 'MISMATCH'}")
            check(ok, f"ssd_inner {label} {name} disagrees with its plain "
                  f"version")
            err, share = max(err, float(gap.max())), max(share, sh)
        nbytes = sum(t.numel() * t.element_size() for t in args) + \
            4 * (y.numel() + st.numel())
        ms = graph_ms(lambda: ssd_inner(*args), 20)
        plain_ms = cuda_ms(lambda: ssd_inner_plain(*args), 10)
        plain_graph_ms = graph_ms(lambda: ssd_inner_plain(*args), 10)
        peak = BF16_FLOP_PER_S if prefix == "" else F32_FLOP_PER_S
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        print(f"  ssd_inner {label} {tuple(x.shape)} N={n} G={groups}: "
              f"{ms * 1e3:.2f} us/launch (graph replay), plain "
              f"{plain_ms * 1e3:.2f} us (graph replay "
              f"{plain_graph_ms * 1e3:.2f} us), bound "
              f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({flops} flop at "
              f"{peak:.3g} flop/s: {ops_ms * 1e3:.2f} us; {nbytes} bytes: "
              f"{bytes_ms * 1e3:.2f} us), {flops / (ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s")
        row.update({f"{prefix}max_abs_err": err, f"{prefix}limit_share": share,
                    f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms,
                    f"{prefix}bound_ms": max(bytes_ms, ops_ms),
                    f"{prefix}bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", f"{prefix}library_ms": None,
                    f"{prefix}plain_graph_ms": plain_graph_ms})
    factor = row["f32_ms"] / row["ms"]
    row["f32_factor"] = factor
    print(f"  B3 bf16 {row['ms'] * 1e3:.2f} us: "
          f"{'within' if row['ms'] * 1e3 <= SSD_BF16_US else 'MISSES'} "
          f"{SSD_BF16_US} us; float32 / bf16 = {factor:.2f}: "
          f"{'within' if factor >= SSD_F32_FACTOR else 'MISSES'} "
          f"{SSD_F32_FACTOR}x")
    rows.append(row)

    rms_keys = sorted(k for k in seen if k[0] == "rms")
    rms_rows = []
    for key in rms_keys:
        x, gamma, eps = seen[key]
        x2 = x.reshape(-1, x.shape[-1])
        got = rmsnorm_fused(x2, gamma, eps)
        torch.cuda.synchronize()
        want = rmsnorm_plain(x2, gamma, eps)
        e = max_err(got.float(), want.float())
        n_diff = int((got != want).sum())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                                 atol=0.0))
        d = x2.shape[-1]
        nbytes = 2 * x2.numel() * x2.element_size() + \
            d * gamma.element_size()
        flops = 4 * x2.numel()
        ms = graph_ms(lambda: rmsnorm_fused(x2, gamma, eps), 200)
        plain_ms = cuda_ms(lambda: rmsnorm_plain(x2, gamma, eps), 50)
        library_ms = cuda_ms(lambda: F.rms_norm(x2, (d,), gamma, eps), 200)
        plain_graph_ms = graph_ms(lambda: rmsnorm_plain(x2, gamma, eps), 50)
        library_graph_ms = graph_ms(
            lambda: F.rms_norm(x2, (d,), gamma, eps), 200)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOP_PER_S * 1e3
        print(f"  rmsnorm {tuple(x2.shape)} {str(x2.dtype)[6:]}: "
              f"max_abs_err {e:.3e} (rtol {BF16_RTOL:.4g}; {n_diff} of "
              f"{got.numel()} differ) "
              f"{'ok' if ok else 'MISMATCH'}; {ms * 1e3:.2f} us/launch "
              f"(graph replay), plain {plain_ms * 1e3:.2f} us (graph "
              f"replay {plain_graph_ms * 1e3:.2f} us), F.rms_norm "
              f"{library_ms * 1e3:.2f} us (graph replay "
              f"{library_graph_ms * 1e3:.2f} us), bound "
              f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({nbytes} bytes)")
        check(ok, f"rmsnorm {tuple(x2.shape)} disagrees with its plain "
              f"version")
        rms_rows.append({"name": "rmsnorm_fused", "route": "cuda",
                         "source": RMS_SOURCE, "replaces": RMS_TPU,
                         "launches": 0, "max_abs_err": e, "ms": ms,
                         "plain_ms": plain_ms,
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations", "library_ms": library_ms,
                         "shape": list(x2.shape),
                         "plain_graph_ms": plain_graph_ms,
                         "library_graph_ms": library_graph_ms})
    check(len(rms_rows) == 4, f"the serve gave B4 shapes {rms_keys}")
    row = next(r for r in rms_rows if r["shape"] == [
        SERVE_BATCH * PROMPT_LEN, MAMBA2.d_model])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rms_rows)
    rows.append(row)
    return rows


def flash_checks(seen: dict) -> dict:
    """Phase 9: B2 against its plain version on the dense serving path's
    own inputs (the first layer's q, k and v of the prefill), in bf16 and
    float32, also at ragged lengths, and on seeded inputs at
    stablelm-1.6b's head dim of 64; time, plain and library times and
    bound at the prefill's shape; B4 at that path's shapes.  Returns the
    JSON row (the bf16 prefill; float32 figures under ``f32_*``)."""
    import torch.nn.functional as F

    print("phase 9: flash attention (B2) vs plain on the card, inputs from "
          "a warm-up serve")
    keys = [k for k in seen if k[0] == "flash"]
    check(len(keys) == 1, f"the serve gave B2 shapes {keys}")
    q, k, v, causal = seen[keys[0]]
    bsz, heads, seq, hd = q.shape
    kv_heads = k.shape[1]
    check(causal and q.dtype == torch.bfloat16 and
          (bsz, heads, seq, hd) == (SERVE_BATCH, QWEN2.n_heads, PROMPT_LEN,
                                    QWEN2.hd) and kv_heads == QWEN2.n_kv_heads,
          f"B2 saw q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")

    def cut(t, b, s):
        return t[:b, :, :s].contiguous()

    f32 = [t.float() for t in (q, k, v)]
    gen = torch.Generator(device=q.device).manual_seed(SEED)
    hd64 = [torch.randn((2, n, PROMPT_LEN, STABLELM.hd), generator=gen,
                        device=q.device).to(torch.bfloat16)
            for n in (STABLELM.n_heads, STABLELM.n_kv_heads,
                      STABLELM.n_kv_heads)]
    cases = [("bf16", (q, k, v), True), ("float32", f32, True),
             ("bf16, S = 200", [cut(t, 2, 200) for t in (q, k, v)], True),
             ("float32, S = 200", [cut(t, 2, 200) for t in f32], True),
             ("bf16, Sq = 7, Skv = 333, non-causal",
              (cut(q, 1, 7), cut(k, 1, 333), cut(v, 1, 333)), False),
             (f"bf16, {STABLELM.name} head dim (randn)", hd64, True)]
    err = 0.0
    for label, (a, b, c), is_causal in cases:
        got = flash_attention(a, b, c, causal=is_causal)
        torch.cuda.synchronize()
        want = flash_attention_plain(a, b, c, causal=is_causal)
        e = max_err(got.float(), want.float())
        if a.dtype == torch.float32:
            rtol, atol, what = FLASH_TOL, FLASH_TOL, f"atol {FLASH_TOL:.4g}"
        else:
            rtol, atol = BF16_RTOL, flash_bf16_atol(a, b, c, is_causal)
            what = f"atol 2**-7 sum p|v|, {float(atol.min()):.3e} to " \
                f"{float(atol.max()):.3e}"
        gap = (got.float() - want.float()).abs()
        limit = atol + rtol * want.float().abs()
        ok = bool((gap <= limit).all())
        share = float((gap / limit.clamp_min(1e-30)).max())
        print(f"  flash_attention {label} q {tuple(a.shape)} k "
              f"{tuple(b.shape)}: max_abs_err {e:.3e} (rtol {rtol:.4g}, "
              f"{what}; largest gap {share:.3f} of its limit; "
              f"{int((got != want).sum())} of {got.numel()} differ) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"flash_attention {label} disagrees with its plain version")
        err = max(err, e)

    # the function's own work: q.k and p.v over the causal pairs
    flops = 4 * hd * bsz * heads * seq * (seq + 1) // 2
    row = {"name": "flash_attention", "route": "cuda",
           "source": FLASH_SOURCE, "replaces": FLASH_TPU, "launches": 0,
           "max_abs_err": err, "shape": [bsz, heads, kv_heads, seq, hd]}
    for prefix, (a, b, c) in (("", (q, k, v)), ("f32_", f32)):
        nbytes = (2 * a.numel() + b.numel() + c.numel()) * a.element_size()
        ms = graph_ms(lambda: flash_attention(a, b, c), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(a, b, c), 10)
        def sdpa():
            return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                                  enable_gqa=True)

        library_ms = cuda_ms(sdpa, 20)
        library_graph_ms = graph_ms(sdpa, 20)
        # bf16 runs on the tensor cores, float32 on the FMA pipe
        peak = BF16_FLOP_PER_S if a.dtype == torch.bfloat16 \
            else F32_FLOP_PER_S
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        print(f"  flash_attention {str(a.dtype)[6:]} {tuple(a.shape)} / "
              f"{tuple(b.shape)}: {ms * 1e3:.2f} us/launch (graph replay), "
              f"plain {plain_ms * 1e3:.2f} us, SDPA {library_ms * 1e3:.2f} "
              f"us (graph replay {library_graph_ms * 1e3:.2f} us), bound "
              f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({flops} "
              f"flop at {peak:.3g} flop/s: {ops_ms * 1e3:.2f} us; {nbytes} "
              f"bytes: {bytes_ms * 1e3:.2f} us), "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        if a.dtype == torch.bfloat16:
            factor = ms / library_graph_ms
            print(f"  bf16 B2 / SDPA (graph replay) = {factor:.3f}: "
                  f"{'within' if factor <= FLASH_SDPA_FACTOR else 'MISSES'}"
                  f" {FLASH_SDPA_FACTOR}x")
            row["sdpa_factor"] = factor
        row.update({f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms,
                    f"{prefix}bound_ms": max(bytes_ms, ops_ms),
                    f"{prefix}bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", f"{prefix}library_ms": library_ms,
                    f"{prefix}library_graph_ms": library_graph_ms})

    for key in sorted(k for k in seen if k[0] == "rms"):
        x, gamma, eps = seen[key]
        x2 = x.reshape(-1, x.shape[-1])
        got = rmsnorm_fused(x2, gamma, eps)
        torch.cuda.synchronize()
        want = rmsnorm_plain(x2, gamma, eps)
        ok = bool(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                                 atol=0.0))
        print(f"  rmsnorm {tuple(x2.shape)} {str(x2.dtype)[6:]}: max_abs_err "
              f"{max_err(got.float(), want.float()):.3e} (rtol "
              f"{BF16_RTOL:.4g}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"rmsnorm {tuple(x2.shape)} disagrees with its plain "
              f"version")
    return row


def serve_path(cfg, model, cuda, phase: int) -> dict:
    """Phases 7 and 10: a serving path, counted and timed, then
    profiled."""
    n_layers = cfg.n_layers
    mixer, norm = SERVE_KERNELS[cfg.name]
    print(f"phase {phase}: serve {cfg.name} ({n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}), {SERVE_BATCH} requests "
          f"x {PROMPT_LEN} prompt tokens, {NEW_TOKENS} new tokens, greedy")
    eng = serve_engine(cfg, model, cuda)
    reqs = serve_requests(cfg)
    mixer.launches = norm.launches = ssd_inner.bf16_launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs, seed=SEED)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {mixer.__name__: mixer.launches, norm.__name__: norm.launches}
    steps = eng._step.times
    check(len(eng._prefill.times) == 1 and len(steps) == NEW_TOKENS,
          f"{len(eng._prefill.times)} prefills, {len(steps)} decode steps")
    want = {mixer.__name__: n_layers,
            norm.__name__: (2 * n_layers + 1) * (1 + NEW_TOKENS)}
    check(counts == want, f"serve launches {counts}, want {want}")
    if mixer is ssd_inner:
        check(ssd_inner.bf16_launches == n_layers, f"{ssd_inner.bf16_launches}"
              f" of {n_layers} B3 launches on the tensor-core route")
    toks = [t for r in out for t in r.out_tokens]
    check(len(toks) == SERVE_BATCH * NEW_TOKENS and
          all(0 <= t < cfg.vocab for t in toks),
          "served tokens out of range or missing")
    prefill_s = eng._prefill.times[0]
    step_s = float(np.mean(steps))
    stats = {"prefill_s": prefill_s, "decode_step_s": step_s,
             "decode_step_min_s": float(np.min(steps)),
             "decode_step_max_s": float(np.max(steps)),
             "decode_tok_per_s": SERVE_BATCH / step_s,
             "prefill_tok_per_s": SERVE_BATCH * PROMPT_LEN / prefill_s,
             "run_s": run_s, "launches": counts,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"  prefill_s {prefill_s:.6f} ({stats['prefill_tok_per_s']:.1f} "
          f"prompt tok/s), decode_step_s {step_s:.6f} (min "
          f"{stats['decode_step_min_s']:.6f}, max "
          f"{stats['decode_step_max_s']:.6f}), decode_tok_per_s "
          f"{stats['decode_tok_per_s']:.1f}, run {run_s:.4f} s, launches "
          f"{counts} (per prefill {n_layers}/{2 * n_layers + 1}, per decode "
          f"step 0/{2 * n_layers + 1}), peak "
          f"memory {stats['peak_mem_gb']:.2f} GB")
    print(f"  req0 tokens: {out[0].out_tokens[:12]}")
    prof = serve_engine(cfg, model, cuda, profile=True)
    prof.run(serve_requests(cfg), seed=SEED)
    for label in ("prefill", "decode step"):
        stats[f"{label.split()[0]}_idle_share"] = \
            PROFILES.get(f"{cfg.name} {label}", {}).get("idle_share")
    return stats


def cpu_compare(cfg, cuda) -> None:
    """Phases 8 and 11: the same seeded model on the CPU, last-token
    prefill logits against the card's, at full depth and at 2 layers.

    float32 is held at ``LOGITS_F32_TOL``.  bf16 is held at the tests'
    ``LOGITS_BF16_TOL`` at full width and 2 layers, the depth at which the
    tests hold it.  At full depth the bf16 model's own rounding error
    against float32 can be of the order of the logits themselves (so it
    is for mamba2-130m at 24 layers, in the reference as in the port:
    tests/test_torch_mamba2.py::
    test_bf16_spread_grows_with_depth_like_reference), and two bf16 runs
    that sum in other orders can differ by nearly as much as either
    differs from float32 (so they do for qwen2-1.5b at 28 layers:
    tests/test_torch_transformer.py::
    test_bf16_rounding_spread_grows_with_depth).  So there the card's
    bf16 logits must be no farther from the CPU's float32 ones than
    ``BF16_ACCURACY_RATIO`` times the CPU's bf16 ones are, in the largest
    and in the mean absolute difference, and pick the CPU bf16 run's
    argmax; for the models in ``BF16_SPREAD_SHARE`` they must also lie
    within that share of the CPU's bf16 vs float32 spread from the CPU's
    bf16 logits."""
    toks = torch.from_numpy(np.array(
        prompts(cfg.vocab, CPU_BATCH, CPU_PROMPT, 1)))

    def last_logits(cfg, dev):
        model = model_registry.init_params(cfg, SEED, dev)
        state = model_registry.make_decode_state(cfg, CPU_BATCH, CPU_PROMPT,
                                                 device=dev)
        lg, _ = model_registry.prefill(model, {"tokens": toks.to(dev)}, cfg,
                                       state)
        return lg[:, -1, :cfg.vocab].float().cpu()

    def mean_err(a, b):
        return float((a - b).abs().mean())

    logits = {}
    for n_layers in (cfg.n_layers, 2):
        for dtype in (torch.float32, torch.bfloat16):
            for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
                if n_layers == 2 and (where, dtype) == ("card", torch.float32):
                    continue
                t0 = time.perf_counter()
                logits[n_layers, where, dtype] = last_logits(
                    cfg.scaled(n_layers=n_layers, dtype=dtype), dev)
                print(f"  {where} {str(dtype)[6:]} prefill, {n_layers} "
                      f"layers: {time.perf_counter() - t0:.2f} s (with init)")
    full = cfg.n_layers
    card, host = logits[full, "card", torch.float32], \
        logits[full, "cpu", torch.float32]
    check(bool(torch.isfinite(card).all()), "non-finite logits on the card")
    err = max_err(card, host)
    ok = bool(torch.allclose(card, host, rtol=LOGITS_F32_TOL,
                             atol=LOGITS_F32_TOL))
    print(f"  float32, {full} layers: logits max_abs_err {err:.3e} (max "
          f"|logit| {float(host.abs().max()):.3f}; rtol = atol = "
          f"{LOGITS_F32_TOL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, "card and CPU logits disagree in float32")

    bf_card, bf_host = logits[full, "card", torch.bfloat16], \
        logits[full, "cpu", torch.bfloat16]
    err, spread = max_err(bf_card, bf_host), max_err(bf_host, host)
    err_mean, spread_mean = mean_err(bf_card, bf_host), mean_err(bf_host, host)
    acc, acc_mean = max_err(bf_card, host), mean_err(bf_card, host)
    same = bool((bf_card.argmax(-1) == bf_host.argmax(-1)).all())
    share = BF16_SPREAD_SHARE.get(cfg.name)
    ok = (acc <= BF16_ACCURACY_RATIO * spread
          and acc_mean <= BF16_ACCURACY_RATIO * spread_mean and same
          and bool(torch.isfinite(bf_card).all()))
    if share is not None:
        ok = ok and err <= share * spread and err_mean <= share * spread_mean
    print(f"  bfloat16, {full} layers: card vs CPU max_abs_err {err:.3e} "
          f"(mean {err_mean:.3e}); CPU bf16 vs float32 {spread:.3e} (mean "
          f"{spread_mean:.3e}): shares {err / spread:.3f} and "
          f"{err_mean / spread_mean:.3f} (limit {share}); card bf16 vs "
          f"float32 {acc:.3e} (mean {acc_mean:.3e}): ratios "
          f"{acc / spread:.3f} and {acc_mean / spread_mean:.3f} (limit "
          f"{BF16_ACCURACY_RATIO}); argmax "
          f"{'same' if same else 'DIFFERS'} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"card and CPU logits disagree in bf16 at {full} layers")

    bf_card, bf_host = logits[2, "card", torch.bfloat16], \
        logits[2, "cpu", torch.bfloat16]
    err = max_err(bf_card, bf_host)
    ok = bool(torch.allclose(bf_card, bf_host, rtol=LOGITS_BF16_TOL,
                             atol=LOGITS_BF16_TOL))
    print(f"  bfloat16, 2 layers: card vs CPU max_abs_err {err:.3e} (mean "
          f"{mean_err(bf_card, bf_host):.3e}; rtol = atol = "
          f"{LOGITS_BF16_TOL}); CPU bf16 vs float32 "
          f"{max_err(bf_host, logits[2, 'cpu', torch.float32]):.3e} "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, "card and CPU logits disagree in bf16 at 2 layers")


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

    t0 = time.perf_counter()
    libs = libraries()
    infos = build_all(libs)
    for lib in libs:
        lib.load()
    print(f"phase 2: built {len(infos)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for info in infos:
        print(f"  {info.path.name}: {info.seconds:.2f} s")
        entry = ""
        for line in info.log.splitlines():
            if "Compiling entry function" in line:   # mangled: cut the
                entry = line.split("'")[1]           # file's namespace
                entry = entry[entry.find("_cu_") + 4:][:48] \
                    if "_cu_" in entry else entry[:48]
            elif "registers" in line or "spill" in line:
                print("   ", entry, line.strip())
    for lib in (FLASH_LIB, SSD_LIB):
        n_hgmma = hgmma_count(lib)
        print(f"  {lib.path.name}: {n_hgmma} HGMMA instructions in its "
              f"SASS ({'present' if n_hgmma else 'ABSENT'})")
        check(n_hgmma > 0, f"{lib.path.name}'s SASS holds no HGMMA")

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

    # phases 6-8: the serving path
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = model_registry.init_params(MAMBA2, SEED, cuda)
    print(f"serving model: {sum(p.numel() for p in model.parameters())} "
          f"parameters, built in {time.perf_counter() - t0:.2f} s")
    kernels += serve_kernel_checks(capture_inputs(MAMBA2, model, cuda))
    serve_stats = {MAMBA2.name: serve_path(MAMBA2, model, cuda, 7)}
    del model
    torch.cuda.empty_cache()
    print(f"phase 8: card vs CPU, {MAMBA2.name} prefill of {CPU_BATCH} x "
          f"{CPU_PROMPT} tokens")
    cpu_compare(MAMBA2, cuda)

    # phases 9-11: the dense serving path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_registry.init_params(QWEN2, SEED, cuda)
    print(f"dense serving model: {sum(p.numel() for p in model.parameters())}"
          f" parameters, built in {time.perf_counter() - t0:.2f} s")
    kernels.append(flash_checks(capture_inputs(QWEN2, model, cuda)))
    serve_stats[QWEN2.name] = serve_path(QWEN2, model, cuda, 10)
    del model
    torch.cuda.empty_cache()
    print(f"phase 11: card vs CPU, {QWEN2.name} prefill of {CPU_BATCH} x "
          f"{CPU_PROMPT} tokens")
    cpu_compare(QWEN2, cuda)

    # each kernel's launches on the serving paths that run it
    for row in kernels:
        if row["name"].startswith("segment_sum"):
            continue
        by_path = {name: st["launches"][row["name"]]
                   for name, st in serve_stats.items()
                   if row["name"] in st["launches"]}
        check(all(n > 0 for n in by_path.values()) and by_path,
              f"{row['name']} never ran on a serving path: {by_path}")
        row["launches"], row["launches_by_path"] = sum(by_path.values()), \
            by_path
    for name, st in serve_stats.items():
        print(f"  serve {name} " + json.dumps(
            {k: v for k, v in st.items() if k != "launches"}))

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
