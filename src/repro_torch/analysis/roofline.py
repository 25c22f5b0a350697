"""Three-term roofline of a traced step, on the card's datasheet figures.

Counterpart of ``repro/analysis/roofline.py``::

    compute    = FLOPs per rank                / peak_FLOP/s
    memory     = bytes per rank                / HBM bandwidth
    collective = wire bytes per link class     / link bandwidth

fed by :mod:`repro_torch.analysis.trace_costs` (the reference's by the
compiled HLO).  The reference's ``V5E`` is a TPU spec and is not carried
over; the port's spec is the card it runs on, ``H100``, from NVIDIA's
H100 SXM5 80GB datasheet: datasheet values, not measurements.  Every
function takes its ``hw`` (default ``H100``); the reference's
``RooflineReport.roofline_fraction`` reads ``V5E``'s peak whatever spec
made the report, the port's reads the report's own (``peak_flops``).

The dominant term is the bottleneck a perf loop works on;
MODEL_FLOPS / traced FLOPs is the useful-compute ratio.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per chip per link class (intra-pod)
    dcn_bw: float              # bytes/s per chip (pod boundary)


H100 = HwSpec(
    name="h100-sxm5-80gb",
    # datasheet: "BF16 Tensor Core 1,979 teraFLOPS" with sparsity; dense
    # is half of it
    peak_flops=989e12,
    # datasheet: "GPU memory bandwidth 3.35TB/s"
    hbm_bw=3.35e12,
    # datasheet: "Interconnect NVLink: 900GB/s" (both directions); one
    # direction is half of it
    ici_bw=450e9,
    # ConnectX-7 datasheet: one NDR InfiniBand port per GPU, 400Gb/s
    dcn_bw=50e9,
)


def classify_collective(group0_devices, mesh_shape) -> str:
    """'cross_pod' if the replica group spans pod boundaries, else 'intra'.

    Device ids are row-major over mesh_shape; for ("pod","data","model")
    the pod coordinate is id // (data*model)."""
    if len(mesh_shape) < 3 or not group0_devices:
        return "intra"
    per_pod = int(np.prod(mesh_shape[1:]))
    pods = {d // per_pod for d in group0_devices}
    return "cross_pod" if len(pods) > 1 else "intra"


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: tuple
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    collective_intra_bytes: float
    collective_cross_bytes: float
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    model_flops_total: float
    n_collectives: int
    extras: dict = field(default_factory=dict)
    #: the peak FLOP/s of the spec that made the report
    peak_flops: float = H100.peak_flops

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline step time = max of the three (perfectly overlapped)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total_hlo = self.hlo_flops_per_chip * self.chips
        return self.model_flops_total / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        (useful FLOPs / chips / peak) / bound_s."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops_total / self.chips / self.peak_flops
        return useful_s / self.bound_s

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} "
                f"{'x'.join(map(str, self.mesh)):>9s} "
                f"{self.compute_s*1e3:9.3f} {self.memory_s*1e3:9.3f} "
                f"{self.collective_s*1e3:9.3f} {self.dominant:10s} "
                f"{self.useful_flops_ratio:7.3f} "
                f"{self.roofline_fraction:7.3f}")


def roofline_terms(costs, *, arch: str, shape: str, mesh_shape: tuple,
                   model_flops: float, hw: HwSpec = H100) -> RooflineReport:
    """The report of ``costs`` (a :class:`~repro_torch.analysis.
    trace_costs.TraceCosts`, or anything with its ``flops``,
    ``bytes_accessed`` and ``collectives``) on ``mesh_shape``."""
    chips = int(np.prod(mesh_shape))
    intra = 0.0
    cross = 0.0
    for c in costs.collectives:
        wb = c.wire_bytes() * c.multiplier
        if classify_collective(c.group0_devices, mesh_shape) == "cross_pod":
            cross += wb
        else:
            intra += wb
    collective_s = intra / hw.ici_bw + cross / hw.dcn_bw
    return RooflineReport(
        arch=arch, shape=shape, mesh=tuple(mesh_shape), chips=chips,
        compute_s=costs.flops / hw.peak_flops,
        memory_s=costs.bytes_accessed / hw.hbm_bw,
        collective_s=collective_s,
        collective_intra_bytes=intra,
        collective_cross_bytes=cross,
        hlo_flops_per_chip=costs.flops,
        hlo_bytes_per_chip=costs.bytes_accessed,
        model_flops_total=model_flops,
        n_collectives=len(costs.collectives),
        peak_flops=hw.peak_flops,
    )


def flash_ideal_bytes_per_chip(cfg, shape, chips: int,
                               passes: float = 4.0) -> float:
    """HBM traffic of the flash kernel replacing the plain attention:
    q, k, v reads + o write per layer, ~4 passes in all (forward,
    recompute, backward dq/dkv), every intermediate on chip (the
    reference's count, whatever the shape's kind)."""
    from repro_torch.models.common import Family

    if cfg.family == Family.SSM or not cfg.n_heads:
        return 0.0
    tokens = shape.global_batch * shape.seq_len
    L = cfg.n_layers + (cfg.n_encoder_layers or 0)
    per_tok = (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * cfg.hd * 2
    return tokens * per_tok * L * passes / chips


def flash_adjusted(rep: RooflineReport, costs, cfg, shape,
                   hw: HwSpec = H100):
    """(adjusted memory term, adjusted roofline fraction): subtract the
    measured "attn_core" scope traffic, add the kernel's ideal traffic."""
    removed = costs.scope_bytes.get("attn_core", 0.0)
    ideal = flash_ideal_bytes_per_chip(cfg, shape, rep.chips)
    adj_bytes = max(rep.hlo_bytes_per_chip - removed + ideal, 0.0)
    adj_memory_s = adj_bytes / hw.hbm_bw
    bound = max(rep.compute_s, adj_memory_s, rep.collective_s)
    useful_s = rep.model_flops_total / rep.chips / hw.peak_flops
    return adj_memory_s, (useful_s / bound if bound > 0 else 0.0)


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for dense training (N = params, D = tokens);
    6*N_active*D for MoE; 2*N_active per generated token for decode."""
    n_total, n_active = param_counts_analytic(cfg)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: 1 token per seq


def param_counts_analytic(cfg) -> tuple:
    """(total, active) parameter counts from the config dims."""
    from repro_torch.models.common import Family

    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        return d * (cfg.n_heads * hd) * 2 + d * (cfg.n_kv_heads * hd) * 2

    def mlp_params(f):
        return d * f * (3 if cfg.glu else 2)

    if cfg.family == Family.SSM:
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_head_dim
        per = d * (2 * d_in + 2 * cfg.ssm_state + H) + d_in * d
        total = emb + L * per
        return total, total
    if cfg.family == Family.HYBRID:
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_head_dim
        per = d * (2 * d_in + 2 * cfg.ssm_state + H) + d_in * d
        shared = attn_params() + mlp_params(cfg.d_ff)
        total = emb + L * per + shared
        return total, total
    if cfg.family == Family.MOE:
        fe = cfg.d_ff_expert or cfg.d_ff
        per_expert = d * fe * (3 if cfg.glu else 2)
        shared = mlp_params(fe * cfg.n_shared_experts) \
            if cfg.n_shared_experts else 0
        per = attn_params() + cfg.n_experts * per_expert + shared \
            + d * cfg.n_experts
        per_active = attn_params() + cfg.top_k * per_expert + shared \
            + d * cfg.n_experts
        return emb + L * per, emb + L * per_active
    if cfg.family == Family.ENCDEC:
        enc = cfg.n_encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        dec = L * (2 * attn_params() + mlp_params(cfg.d_ff))
        total = emb + enc + dec
        return total, total
    # dense / vlm
    per = attn_params() + mlp_params(cfg.d_ff)
    total = emb + L * per
    return total, total
