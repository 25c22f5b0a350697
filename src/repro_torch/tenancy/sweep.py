"""(job-mix × victim-policy × placement) grid driver.

`sweep()` fills the interference matrix the benchmark / paper discussion
needs: for every mix, every candidate routing arm is installed on the
VICTIM (the aggressors keep their specced arms — they are other people's
jobs), optionally across victim placement tiers, and the victim's
slowdown vs its run-alone baseline is recorded.  The qualitative Kang
result this reproduces: adaptive-heavy aggressors inflate minimal-routed
victims, and the app-aware arm keeps the victim closer to run-alone than
fully-adaptive routing does.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from repro_torch.dragonfly.simulator import SimParams
from repro_torch.dragonfly.topology import Topology
from repro_torch.runtime import resolve_device
from repro_torch.tenancy.engine import (InterferenceEngine, arm_label,
                                  run_mixes_lockstep)
from repro_torch.tenancy.spec import TenancyMix


def _auto_lockstep(device) -> bool:
    """The port's lockstep rule: on where the engines' simulators run on
    the CUDA card (a column's round is then one batched pipeline
    dispatch), off on the CPU, where batching saves no launches."""
    return resolve_device(device).type == "cuda"


def sweep(topo: Topology | str | None, mixes: Sequence[TenancyMix],
          arms: Mapping, *, params: SimParams | None = None,
          rounds: int = 4, seed: int = 0,
          placements: Sequence = (None,),
          shared_engine: bool = False, device=None,
          lockstep: bool | None = None) -> list:
    """Run the grid; one flat record dict per cell.

    arms: {label: RoutingMode member | policy name} — the victim's
    candidate routing arms.  placements: victim spread overrides (None ==
    keep the mix's specced placement).  Every cell re-seeds its own
    InterferenceEngine so cells are independent and order-insensitive.

    device: where every cell's simulator runs (the CUDA card unless
    device="cpu").  lockstep: drive each (mix, placement) column's arm
    cells round-for-round through one batched phase dispatch
    (`run_mixes_lockstep`) instead of cell-after-cell.  Default None
    turns it on when the device resolves to CUDA, where the column
    becomes a single batched pipeline dispatch per round, and off on
    the CPU; records are identical either way because every cell keeps
    its own simulator and RNG stream.
    """
    if lockstep is None:
        lockstep = _auto_lockstep(device)
    records = []
    for mix in mixes:
        for place in placements:
            m = mix if place is None else mix.with_victim_spread(place)
            labels = list(arms.items())
            cells = [m.with_victim_arm(arm) for _, arm in labels]
            engines = [InterferenceEngine(topo, params, seed=seed,
                                          shared_engine=shared_engine,
                                          device=device)
                       for _ in cells]
            if lockstep and len(cells) > 1:
                col = run_mixes_lockstep(engines, cells, rounds=rounds)
            else:
                col = [eng.run_mix(cell, rounds=rounds)
                       for eng, cell in zip(engines, cells)]
            for (label, arm), eng, cell, res in zip(labels, engines,
                                                    cells, col):
                vic = res.victim_report
                records.append({
                    "mix": mix.name,
                    "topology": eng._topo_for(cell).spec_str(),
                    "policy": label,
                    "arm": arm_label(arm),
                    "placement": place or mix.victim_workload.spread,
                    "victim": vic.name,
                    "victim_slowdown": vic.slowdown,
                    "victim_time_us": vic.time_us,
                    "victim_alone_us": vic.alone_time_us,
                    "victim_nonmin_fraction": vic.nonmin_fraction,
                    "aggressor_slowdowns": {
                        t.name: t.slowdown for i, t in
                        enumerate(res.tenants) if i != res.victim},
                })
    return records
