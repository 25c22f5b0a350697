"""The phase pipeline on a torch device: score -> spray -> feedback -> observables.

Counterpart of ``repro/dragonfly/jax_backend.py`` (``_phase_pipeline``,
``_device_plan``, ``_pad_pairs``, ``_prepare_inputs``,
``fixed_point_jax``).  It computes in float32, as the jax engine does,
and keeps its kernel contract: ``(w, rho, load_q, lat_us, s_flit)`` as
float64 NumPy.

* **RNG parity.** Every random number of a phase is drawn on the host
  from the simulator's NumPy generator before the pipeline runs; torch
  never draws.  So the port consumes the seed stream draw for draw like
  the reference and matches it within float32 tolerance.

* **Link loads** go through the hand-written segment sum
  (``repro_torch.kernels.segment_sum``): the plan-pinned app pairs,
  sorted by link id once per plan, through the sorted form (one warp per
  link, deterministic); the NIC loads and the unsorted background tail
  through the scatter form.  Both accumulate into one buffer.  This
  replaces the jax engine's blocked cumsum-diff, an XLA-on-CPU
  workaround that also loses float32 precision on short segments.

* **Plan-pinned tensors** live on ``PhasePlan.device_tensors``, the
  port's own slot.  A planned phase moves only the small per-link state,
  the per-row constants, the Gumbel block and the background rows to the
  device.  The background rows are written in place into full-size
  buffers kept on the plan; their pair tail is padded to a bucket with
  out-of-range link ids (exact no-ops under the segment sum) so the
  buffers keep their shape from phase to phase.

One planned phase with background traffic launches the segment-sum
kernels 11 times: 1 scatter for the NIC loads, then a sorted head and a
scattered tail for each of the ``route_feedback_iters`` feedback loads
and for the backlog ``load_q``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.segment_sum import (segment_sum,
                                             segment_sum_scatter,
                                             segment_sum_sorted)

#: background pair-tail padding bucket of planned phases
_PAIR_BUCKET = 256

_INF = math.inf


def _padded_len(n: int, bucket: int) -> int:
    return -(-max(int(n), 1) // bucket) * bucket


# --------------------------------------------------------------- pipeline
def phase_pipeline(*, safe, validf, hops, is_nonmin, cand_mask, est_queue_s,
                   link_queue_s, hl_rows, bias_rows, posinf, neginf, t_rows,
                   noise_scale, gnoise, size_all, cap_window, nic_ids,
                   pair_links, pair_fc, seg_off, window_s, feedback_rho0,
                   rho_threshold, queue_delay_ns, qwait_fraction, stall_gain,
                   nic_latency_ns, hop_latency_ns, n_links: int,
                   p_sorted: int):
    """One phase on ``size_all.device``; returns float32 tensors
    ``(w, rho, load_q, lat_us, s_flit)``.

    The first ``p_sorted`` pair entries are sorted by link id with
    ``seg_off`` their ``[n_links + 1]`` offsets; the rest (the background
    tail, or every pair of a planless phase) are unsorted.  ``cand_mask``
    may be None (healthy machine).  Pair ids at or past ``n_links`` are
    padding and add nothing.
    """
    def zeros():
        return torch.zeros(n_links, dtype=torch.float32,
                           device=size_all.device)

    def pair_sum(vals):
        out = zeros()
        if p_sorted:
            segment_sum_sorted(vals[:p_sorted], seg_off, out)
        if vals.shape[0] > p_sorted:
            segment_sum_scatter(vals[p_sorted:], pair_links[p_sorted:], out)
        return out

    # loop-invariant score base: estimate gather + hop latency + bias
    base = (est_queue_s[safe] * validf).sum(dim=-1) \
        + hl_rows[:, None] * hops
    score0 = base + torch.where(is_nonmin[None, :], bias_rows[:, None], 0.0)
    score0 = torch.where(posinf[:, None] & is_nonmin[None, :], _INF, score0)
    score0 = torch.where(neginf[:, None] & ~is_nonmin[None, :], _INF, score0)
    if cand_mask is not None:
        # fault path: candidates crossing dead links spray exactly zero
        score0 = torch.where(cand_mask, score0, _INF)

    # a flow cannot inject more than its NIC moves in the window
    size_inst = torch.minimum(size_all, cap_window[nic_ids])
    nic_load = segment_sum(size_inst, nic_ids, n_links)

    def spray(score, g):
        s = score + g * noise_scale
        s = torch.where(torch.isfinite(s), s, _INF)
        smin = s.amin(dim=1, keepdim=True)
        smin = torch.where(torch.isfinite(smin), smin, 0.0)
        z = torch.exp(-(s - smin) / t_rows[:, None])
        tot = z.sum(dim=1, keepdim=True)
        tot = torch.where(tot <= 0, 1.0, tot)
        return z / tot

    def loads(w):
        return pair_sum((size_inst[:, None] * w).reshape(-1)[pair_fc]) \
            + nic_load

    w = spray(score0, gnoise[0])
    load_i = loads(w)
    for g in gnoise[1:]:
        extra = torch.clamp(load_i / cap_window - feedback_rho0, min=0.0) \
            * window_s
        score = score0 + (extra[safe] * validf).sum(dim=-1)
        w = 0.5 * (w + spray(score, g))
        load_i = loads(w)

    load_q = pair_sum((size_all[:, None] * w).reshape(-1)[pair_fc])
    rho = load_i / cap_window

    # --- observables: per-flow (L_us, s) ------------------------------
    rho_path = rho[safe] * validf                   # [n, ncand, hops]
    excess = torch.clamp(rho_path - rho_threshold, min=0.0)
    qdelay_ns = queue_delay_ns * excess.sum(dim=-1)
    qwait_ns = (link_queue_s[safe] * validf).sum(dim=-1) \
        * qwait_fraction * 1e9
    lat_ns_cand = 2.0 * nic_latency_ns + hops * hop_latency_ns \
        + qdelay_ns + qwait_ns
    lat_us = (lat_ns_cand * w).sum(dim=-1) / 1e3
    rho_bneck = torch.maximum(rho_path.amax(dim=-1), rho[nic_ids][:, None])
    s_cand = stall_gain * torch.clamp(rho_bneck - rho_threshold, min=0.0)
    s_flit = (s_cand * w).sum(dim=-1)
    return w, rho, load_q, lat_us, s_flit


# ------------------------------------------------------- input preparation
def _tensor(a, dtype: np.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _device_plan(plan, n_links: int, device) -> dict:
    """Pin a PhasePlan's phase-invariant tensors on ``device`` (once).

    Stored on the plan, so their lifetime is the plan's; ``plan_for``'s
    cache key (topology spec, fault and notify epochs, pattern) keys the
    device side too.  The pair list is pinned sorted by link id (a host
    argsort paid once per plan) with its segment offsets; the plan's own
    host arrays keep their original order."""
    dev = plan.device_tensors
    if dev is None:
        pl = np.asarray(plan.pair_links)
        order = np.argsort(pl, kind="stable")
        off = np.zeros(n_links + 1, dtype=np.int64)
        np.cumsum(np.bincount(pl, minlength=n_links), out=off[1:])
        dev = {
            "safe": _tensor(plan.safe, np.int64, device),
            "validf": _tensor(plan.valid, np.float32, device),
            "hops": _tensor(plan.hops, np.float32, device),
            "nic_ids": _tensor(plan.nic_ids, np.int32, device),
            "pair_links": _tensor(pl[order], np.int32, device),
            "pair_fc": _tensor(np.asarray(plan.pair_fc)[order], np.int64,
                               device),
            "seg_off": _tensor(off, np.int32, device),
            "p_sorted": int(pl.shape[0]),
            "bufs": None,
        }
        plan.device_tensors = dev
    return dev


def _pad_pairs(links: np.ndarray, fc: np.ndarray, pad_to: int,
               n_links: int):
    """Bucket padding of a background pair tail.

    Padding entries carry link id ``n_links`` — out of range, so the
    segment sum drops them — and flat index 0, a valid gather."""
    n = links.shape[0]
    pl = np.full(pad_to, n_links, dtype=np.int32)
    pl[:n] = links
    pf = np.zeros(pad_to, dtype=np.int64)
    pf[:n] = fc
    return pl, pf


_ROW_TYPES = (np.int64, np.float32, np.float32, np.int32)


def _plan_rows_and_pairs(sim, ctx: dict, dev: dict) -> tuple:
    """(safe, validf, hops, nic_ids, pair_links, pair_fc) of a planned
    phase: the pinned head, plus this phase's background rows written in
    place into full-size buffers on the plan."""
    heads = (dev["safe"], dev["validf"], dev["hops"], dev["nic_ids"],
             dev["pair_links"], dev["pair_fc"])
    n_app = ctx["n_app"]
    if ctx["safe"].shape[0] == n_app:           # no background rows
        return heads
    p_app = dev["p_sorted"]
    n_bg_pairs = ctx["pair_links"].shape[0] - p_app
    bl, bf = _pad_pairs(ctx["pair_links"][p_app:], ctx["pair_fc"][p_app:],
                        _padded_len(n_bg_pairs, _PAIR_BUCKET),
                        int(sim.topo.n_links))
    rows = (ctx["safe"][n_app:], ctx["valid"][n_app:], ctx["hops"][n_app:],
            ctx["nic_ids"][n_app:])
    tails = tuple(np.ascontiguousarray(a, dtype=t)
                  for a, t in zip(rows, _ROW_TYPES)) + (bl, bf)
    bufs = dev["bufs"]
    if bufs is not None and all(
            b.shape[0] == h.shape[0] + t.shape[0]
            for b, h, t in zip(bufs, heads, tails)):
        for b, h, t in zip(bufs, heads, tails):
            b[h.shape[0]:].copy_(torch.from_numpy(t))
    else:
        bufs = dev["bufs"] = tuple(
            torch.cat([h, torch.from_numpy(t).to(h.device)])
            for h, t in zip(heads, tails))
    return bufs


def _prepare_inputs(sim, ctx: dict) -> dict:
    """ctx (from ``_phase_begin``) -> keyword inputs of
    :func:`phase_pipeline` on ``sim.device``."""
    p, tp, device = sim.params, sim.topo, sim.device
    n_links = int(tp.n_links)
    plan = ctx["plan"]
    if plan is not None:
        dev = _device_plan(plan, n_links, device)
        (safe, validf, hops, nic_ids,
         pair_links, pair_fc) = _plan_rows_and_pairs(sim, ctx, dev)
        seg_off, p_sorted = dev["seg_off"], dev["p_sorted"]
    else:
        safe = _tensor(ctx["safe"], np.int64, device)
        validf = _tensor(ctx["valid"], np.float32, device)
        hops = _tensor(ctx["hops"], np.float32, device)
        nic_ids = _tensor(ctx["nic_ids"], np.int32, device)
        pair_links = _tensor(ctx["pair_links"], np.int32, device)
        pair_fc = _tensor(ctx["pair_fc"], np.int64, device)
        seg_off, p_sorted = None, 0             # planless: scatter all

    def f32(a):
        return _tensor(a, np.float32, device)

    def flag(a):
        return _tensor(a, np.bool_, device)

    cm = ctx["cand_mask"]
    return dict(
        safe=safe, validf=validf, hops=hops, is_nonmin=flag(ctx["is_nonmin"]),
        cand_mask=None if cm is None else flag(cm),
        est_queue_s=f32(ctx["est_queue_s"]), link_queue_s=f32(sim.link_queue_s),
        hl_rows=f32(ctx["hl_rows"]), bias_rows=f32(ctx["bias_rows"]),
        posinf=flag(ctx["posinf"]), neginf=flag(ctx["neginf"]),
        t_rows=f32(ctx["t_rows"]), noise_scale=f32(ctx["noise_scale"]),
        gnoise=f32(ctx["gnoise"]), size_all=f32(ctx["size_all"]),
        cap_window=f32(ctx["cap_window"]), nic_ids=nic_ids,
        pair_links=pair_links, pair_fc=pair_fc, seg_off=seg_off,
        window_s=float(ctx["window_s"]), feedback_rho0=p.feedback_rho0,
        rho_threshold=p.rho_threshold, queue_delay_ns=p.queue_delay_ns,
        qwait_fraction=p.qwait_fraction, stall_gain=p.stall_gain,
        nic_latency_ns=float(tp.nic_latency_ns),
        hop_latency_ns=float(tp.hop_latency_ns),
        n_links=n_links, p_sorted=p_sorted)


# ------------------------------------------------------------- entry point
def fixed_point_torch(sim, ctx: dict):
    """One phase on ``sim.device``; float64 NumPy outputs (the kernel
    contract ``(w, rho, load_q, lat_us, s_flit)``)."""
    out = phase_pipeline(**_prepare_inputs(sim, ctx))
    return tuple(o.cpu().numpy().astype(np.float64) for o in out)
