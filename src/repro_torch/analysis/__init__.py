"""Hardware figures for the cost models (counterpart of
``repro.analysis``).

Only ``roofline.HwSpec``, ``classify_collective`` and the port's one
spec, ``H100``, are here: the collective cost model
(:mod:`repro_torch.collectives.selector`) needs them.  The rest of
``roofline.py`` (the three-term report) and ``hlo_parse.py`` wait for
ROADMAP A.5.
"""

from repro_torch.analysis.roofline import H100, HwSpec, classify_collective

__all__ = ["H100", "HwSpec", "classify_collective"]
