"""The traced step's costs and the roofline (counterpart of
``repro.analysis``).

``trace_costs`` runs a step on DTensors in a fake world and counts what
one rank runs: FLOPs, bytes, collectives with their groups, named
scopes and live memory (the counterpart of ``hlo_parse``, which parses
the reference's compiled HLO).  ``roofline`` turns those counts into
the three-term model on the datasheet ``H100`` (no ``V5E``), and holds
the analytic parameter and model-FLOP counts.  The collective byte
counts also feed the NIC counters of Algorithm 1
(:mod:`repro_torch.collectives.trace_counters`).
"""

from repro_torch.analysis.roofline import (H100, HwSpec, RooflineReport,
                                           classify_collective,
                                           flash_adjusted,
                                           flash_ideal_bytes_per_chip,
                                           model_flops_estimate,
                                           param_counts_analytic,
                                           roofline_terms)
from repro_torch.analysis.trace_costs import (CollectiveOp, CostTracer,
                                              TraceCosts)

__all__ = ["H100", "HwSpec", "classify_collective", "RooflineReport",
           "roofline_terms", "flash_adjusted", "flash_ideal_bytes_per_chip",
           "model_flops_estimate", "param_counts_analytic", "CollectiveOp",
           "CostTracer", "TraceCosts"]
