"""Carry simulator state from the reference simulator into the port.

The simulator runs no model, so its "weights" are the state one phase
hands to the next: the persistent link queues, the stale-estimate
memory, the notification flags and epochs, the phase and clock
counters, the background hot groups, the NIC counters and the NumPy
generator's state.  :func:`simulator_state` reads that state as plain
values from either package's simulator (by attribute, so this module
imports nothing of ``repro``); :func:`state_from_reference` loads it
into a port simulator, after which both compute the same next phase.
Fault schedules are configuration, not state: install the same one on
both sides.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from repro_torch.core.counters import NICCounters

#: per-link arrays carried across, [n_links] each
STATE_ARRAYS = ("link_queue_s", "est_memory_s", "link_notify_age")
#: scalar counters carried across
STATE_SCALARS = ("phase_index", "clock_s", "total_flits_all_jobs",
                 "_phase_count", "_notify_epoch", "_notify_fault_epoch")


def simulator_state(sim) -> dict:
    """Plain-value snapshot of a simulator's carried state."""
    d = {k: np.array(getattr(sim, k)) for k in STATE_ARRAYS}
    d.update({k: getattr(sim, k) for k in STATE_SCALARS})
    d["_hot_groups"] = np.array(sim._hot_groups)
    d["counters"] = {aid: dataclasses.asdict(c)
                     for aid, c in sim.counters.items()}
    d["rng_state"] = copy.deepcopy(sim.rng.bit_generator.state)
    return d


def state_from_reference(sim, state: dict):
    """Load ``state`` (as :func:`simulator_state` returns it) into the
    port simulator ``sim``; returns ``sim``.

    The plan cache is cleared: its plans were drawn from the generator
    stream this call replaces."""
    n_links = int(sim.topo.n_links)
    for k in STATE_ARRAYS:
        a = np.asarray(state[k])
        if a.shape != (n_links,):
            raise ValueError(f"{k}: shape {a.shape}, topology has "
                             f"{n_links} links")
        setattr(sim, k, a.astype(getattr(sim, k).dtype, copy=True))
    for k in STATE_SCALARS:
        setattr(sim, k, type(getattr(sim, k))(state[k]))
    sim._hot_groups = np.array(state["_hot_groups"])
    sim.counters = {aid: NICCounters(**fields)
                    for aid, fields in state["counters"].items()}
    sim.rng.bit_generator.state = copy.deepcopy(state["rng_state"])
    sim._plan_cache.clear()
    return sim
