"""The phase pipeline on a torch device: score -> spray -> feedback -> observables.

Counterpart of ``repro/dragonfly/jax_backend.py`` (``_phase_pipeline``,
``_device_plan``, ``_pad_pairs``, ``_prepare_inputs``,
``batch_signature``, ``fixed_point_jax`` and ``fixed_point_jax_batch``).
It computes in float32, as the jax engine does, and keeps its kernel
contract: ``(w, rho, load_q, lat_us, s_flit)`` as float64 NumPy per
phase.

* **One batch-native pipeline.**  :func:`phase_pipeline` evaluates B
  phases (one per simulator) at once over a leading batch axis; a single
  phase is a batch of one.  The per-link state of phase ``b`` lives at
  ``[b * n_links, (b + 1) * n_links)`` of flat ``[B * n_links]`` tensors,
  and :func:`prepare_batch` offsets every link id (candidate gathers,
  NIC ids, pair lists) by ``b * n_links`` and every flat flow-candidate
  index by ``b * n_all * ncand``.  Every per-phase value (the window,
  the SimParams constants, the row arrays) is its own entry of the
  batch, never the first entry's.

* **RNG parity.** Every random number of a phase is drawn on the host
  from the simulator's NumPy generator before the pipeline runs; torch
  never draws.  So the port consumes the seed stream draw for draw like
  the reference and matches it within float32 tolerance, and batching
  changes the dispatch, never the draws.

* **Link loads** go through the hand-written segment sum
  (``repro_torch.kernels.segment_sum``) over ``B * n_links`` segments:
  the plan-pinned app pairs, sorted by link id once per plan, through
  the sorted form (one warp per link, deterministic) — the B phases'
  sorted heads concatenated in batch order, so the list stays sorted;
  the NIC loads and the unsorted background tails (every pair of a
  planless phase) through the scatter form.  Both accumulate into one
  buffer.  Padding ids lie at ``B * n_links`` or above and add nothing.
  This replaces the jax engine's blocked cumsum-diff, an XLA-on-CPU
  workaround that also loses float32 precision on short segments.

* **Plan-pinned tensors** live on ``PhasePlan.device_tensors``, the
  port's own slot.  A planned phase moves only the small per-link state,
  the per-row constants, the Gumbel block and the background rows to the
  device.  The background rows are written in place into full-size
  buffers kept on the plan; their pair tail is padded to a bucket with
  out-of-range link ids (exact no-ops under the segment sum) so the
  buffers keep their shape from phase to phase.  Planless pair lists are
  padded to a coarser bucket, so that phases of one sweep column share a
  :func:`batch_signature`.

A dispatch launches the segment-sum kernels as often as one phase of
its group does, whatever B: a planned phase with background traffic 11
times — 1 scatter for the NIC loads, then a sorted head and a scattered
tail for each of the ``route_feedback_iters`` feedback loads and for
the backlog ``load_q`` — and a planless phase 6 times (scatter only).
``PIPELINE_CALLS`` counts dispatches, single and batched.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.segment_sum import (segment_sum,
                                             segment_sum_scatter,
                                             segment_sum_sorted)

#: dispatch counters: "single" (one phase) and "batched" (a group of
#: two or more phases in one dispatch); tests and perf_sim read deltas
PIPELINE_CALLS = {"single": 0, "batched": 0}

#: background pair-tail padding bucket of planned phases
_PAIR_BUCKET = 256
#: pair-list padding bucket of planless phases (every pair redrawn)
_PAIR_BUCKET_FULL = 4096

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
    """B phases on ``size_all.device``; returns float32 tensors
    ``(w [B, n, ncand], rho [B, n_links], load_q [B, n_links],
    lat_us [B, n], s_flit [B, n])``.

    Row tensors carry a leading batch axis (``safe`` ``[B, n, ncand,
    hops]``, ``gnoise`` ``[B, iters, n, ncand]``, ...); the per-link
    state (``est_queue_s``, ``link_queue_s``, ``cap_window``) is flat
    ``[B * n_links]``, and ``safe`` and ``nic_ids`` index it (batch
    offsets included).  The per-phase constants are ``[B]`` tensors.
    The first ``p_sorted`` pair entries are sorted by link id with
    ``seg_off`` their ``[B * n_links + 1]`` offsets; the rest (the
    background tails, or every pair of a planless phase) are unsorted.
    ``pair_fc`` indexes the flat ``[B * n * ncand]`` spray weights.
    ``cand_mask`` may be None (healthy machines).  Pair ids at or past
    ``B * n_links`` are padding and add nothing.
    """
    B = size_all.shape[0]
    n_seg = B * n_links

    def per_row(v):                  # [B] -> [B, 1, 1]
        return v[:, None, None]

    def pair_sum(vals):
        out = torch.zeros(n_seg, dtype=torch.float32, device=vals.device)
        if p_sorted:
            segment_sum_sorted(vals[:p_sorted], seg_off, out)
        if vals.shape[0] > p_sorted:
            segment_sum_scatter(vals[p_sorted:], pair_links[p_sorted:], out)
        return out

    nonmin = is_nonmin[:, None, :]                  # [B, 1, ncand]
    # loop-invariant score base: estimate gather + hop latency + bias
    base = (est_queue_s[safe] * validf).sum(dim=-1) \
        + hl_rows[..., None] * hops
    score0 = base + torch.where(nonmin, bias_rows[..., None], 0.0)
    score0 = torch.where(posinf[..., None] & nonmin, _INF, score0)
    score0 = torch.where(neginf[..., None] & ~nonmin, _INF, score0)
    if cand_mask is not None:
        # fault path: candidates crossing dead links spray exactly zero
        score0 = torch.where(cand_mask, score0, _INF)

    # a flow cannot inject more than its NIC moves in the window
    size_inst = torch.minimum(size_all, cap_window[nic_ids])
    nic_load = segment_sum(size_inst.reshape(-1), nic_ids.reshape(-1),
                           n_seg)

    def spray(score, g):
        s = score + g * noise_scale
        s = torch.where(torch.isfinite(s), s, _INF)
        smin = s.amin(dim=-1, keepdim=True)
        smin = torch.where(torch.isfinite(smin), smin, 0.0)
        z = torch.exp(-(s - smin) / t_rows[..., None])
        tot = z.sum(dim=-1, keepdim=True)
        tot = torch.where(tot <= 0, 1.0, tot)
        return z / tot

    def loads(w):
        return pair_sum((size_inst[..., None] * w).reshape(-1)[pair_fc]) \
            + nic_load

    def feedback(load_i):             # per-link score penalty
        rho_i = load_i.view(B, n_links) / cap_window.view(B, n_links)
        return (torch.clamp(rho_i - feedback_rho0[:, None], min=0.0)
                * window_s[:, None]).view(-1)

    w = spray(score0, gnoise[:, 0])
    load_i = loads(w)
    for i in range(1, gnoise.shape[1]):
        extra = feedback(load_i)
        score = score0 + (extra[safe] * validf).sum(dim=-1)
        w = 0.5 * (w + spray(score, gnoise[:, i]))
        load_i = loads(w)

    load_q = pair_sum((size_all[..., None] * w).reshape(-1)[pair_fc])
    rho = load_i / cap_window

    # --- observables: per-flow (L_us, s) ------------------------------
    rho_path = rho[safe] * validf                   # [B, n, ncand, hops]
    thr = per_row(rho_threshold)
    excess = torch.clamp(rho_path - thr[..., None], min=0.0)
    qdelay_ns = per_row(queue_delay_ns) * excess.sum(dim=-1)
    qwait_ns = (link_queue_s[safe] * validf).sum(dim=-1) \
        * per_row(qwait_fraction) * 1e9
    lat_ns_cand = 2.0 * per_row(nic_latency_ns) \
        + hops * per_row(hop_latency_ns) + qdelay_ns + qwait_ns
    lat_us = (lat_ns_cand * w).sum(dim=-1) / 1e3
    rho_bneck = torch.maximum(rho_path.amax(dim=-1), rho[nic_ids][..., None])
    s_cand = per_row(stall_gain) * torch.clamp(rho_bneck - thr, min=0.0)
    s_flit = (s_cand * w).sum(dim=-1)
    return (w, rho.view(B, n_links), load_q.view(B, n_links), lat_us,
            s_flit)


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
    """ctx (from ``_phase_begin``) -> one phase's inputs on
    ``sim.device``, the per-phase constants as Python floats;
    :func:`prepare_batch` stacks them into :func:`phase_pipeline`'s
    keyword inputs."""
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
        pl, pf = _pad_pairs(ctx["pair_links"], ctx["pair_fc"],
                            _padded_len(ctx["pair_links"].shape[0],
                                        _PAIR_BUCKET_FULL), n_links)
        pair_links = _tensor(pl, np.int32, device)
        pair_fc = _tensor(pf, np.int64, device)
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


#: per-row inputs, stacked over the batch axis
_ROW_KEYS = ("safe", "validf", "hops", "is_nonmin", "cand_mask", "hl_rows",
             "bias_rows", "posinf", "neginf", "t_rows", "noise_scale",
             "gnoise", "size_all", "nic_ids")
#: per-link inputs, laid end to end
_LINK_KEYS = ("est_queue_s", "link_queue_s", "cap_window")
#: per-phase constants, one [B] tensor each
_CONST_KEYS = ("window_s", "feedback_rho0", "rho_threshold",
               "queue_delay_ns", "qwait_fraction", "stall_gain",
               "nic_latency_ns", "hop_latency_ns")


def _with_consts(out: dict, xs: list) -> dict:
    """Add the per-phase constants as [B] float32 views of one tensor
    (one host-to-device copy per dispatch)."""
    consts = torch.tensor([[x[k] for k in _CONST_KEYS] for x in xs],
                          dtype=torch.float32).to(out["cap_window"].device)
    out.update({k: consts[:, j] for j, k in enumerate(_CONST_KEYS)})
    return out


def prepare_batch(batch) -> dict:
    """[(sim, ctx)] -> :func:`phase_pipeline`'s keyword inputs for the B
    phases, stacked on the simulators' device.  The phases must share a
    :func:`batch_signature`.

    Each phase is prepared by :func:`_prepare_inputs` and copied into
    the batch at once, offsets added (link ids by ``b * n_links``, flat
    flow-candidate indices by ``b * n * ncand``, tail padding moved to
    ``B * n_links``): two phases replaying one plan share its in-place
    background buffers, which the next phase's preparation rewrites.
    A batch of one takes the phase's tensors as they are."""
    B = len(batch)
    if B == 1:
        x = _prepare_inputs(*batch[0])
        out = {k: None if x[k] is None else x[k].unsqueeze(0)
               for k in _ROW_KEYS}
        out.update({k: x[k] for k in _LINK_KEYS + (
            "pair_links", "pair_fc", "seg_off", "p_sorted", "n_links")})
        return _with_consts(out, [x])
    out, xs = {}, []
    head_ids, head_fc, tail_ids, tail_fc, offs = [], [], [], [], []
    p_head = 0
    for b, (sim, ctx) in enumerate(batch):
        x = _prepare_inputs(sim, ctx)
        n_links, ps = x["n_links"], x["p_sorted"]
        link0 = b * n_links
        fc0 = b * x["safe"].shape[0] * x["safe"].shape[1]
        for k in _ROW_KEYS:
            if x[k] is None:
                out[k] = None
                continue
            if b == 0:
                out[k] = x[k].new_empty((B,) + tuple(x[k].shape))
            if k in ("safe", "nic_ids"):
                torch.add(x[k], link0, out=out[k][b])
            else:
                out[k][b].copy_(x[k])
        pl, fc = x["pair_links"], x["pair_fc"]
        head_ids.append(pl[:ps] + link0)
        head_fc.append(fc[:ps] + fc0)
        tail_ids.append(torch.where(pl[ps:] >= n_links, B * n_links,
                                    pl[ps:] + link0).to(torch.int32))
        tail_fc.append(fc[ps:] + fc0)
        if ps:
            offs.append(x["seg_off"][:-1] + p_head)
        p_head += ps
        xs.append({k: x[k] for k in _LINK_KEYS + _CONST_KEYS})
    out.update({k: torch.cat([x[k] for x in xs]) for k in _LINK_KEYS})
    # the sorted heads first, in batch order (so still sorted by link id
    # over B * n_links segments), then the tails
    out["pair_links"] = torch.cat(head_ids + tail_ids)
    out["pair_fc"] = torch.cat(head_fc + tail_fc)
    out["p_sorted"] = p_head
    out["seg_off"] = torch.cat(offs + [offs[0].new_tensor([p_head])]) \
        if p_head else None
    out["n_links"] = n_links
    return _with_consts(out, xs)


def batch_signature(sim, ctx: dict) -> tuple:
    """Hashable key: phases with equal keys share one batched dispatch
    (:func:`fixed_point_torch_batch`).  It holds what the batch stacks or
    must agree on: the link count, the feedback iterations, the row
    shape, the padded pair-tail length, the plan's pair count, whether
    there is a plan and a candidate mask, and the device."""
    plan = ctx["plan"]
    n_pairs = ctx["pair_links"].shape[0]
    if plan is None:
        tail = _padded_len(n_pairs, _PAIR_BUCKET_FULL)
        p_app = 0
    else:
        p_app = int(plan.pair_links.shape[0])
        tail = 0 if ctx["safe"].shape[0] == ctx["n_app"] \
            else _padded_len(n_pairs - p_app, _PAIR_BUCKET)
    return (int(sim.topo.n_links), int(ctx["gnoise"].shape[0]),
            tuple(ctx["safe"].shape), tail, p_app, plan is not None,
            ctx["cand_mask"] is not None, str(sim.device))


# ------------------------------------------------------------ entry points
def fixed_point_torch_batch(batch) -> list:
    """Phases through ONE dispatch of the pipeline; float64 NumPy
    outputs (the kernel contract ``(w, rho, load_q, lat_us, s_flit)``),
    one tuple per entry, batch order, with one host copy per output.

    ``batch``: [(sim, ctx)] whose :func:`batch_signature`s agree (the
    caller groups).  Cells keep their own simulators and generators:
    batching changes the dispatch, not the draws."""
    out = phase_pipeline(**prepare_batch(batch))
    PIPELINE_CALLS["batched" if len(batch) > 1 else "single"] += 1
    outs = [o.cpu().numpy().astype(np.float64) for o in out]
    return [tuple(o[b] for o in outs) for b in range(len(batch))]


def fixed_point_torch(sim, ctx: dict):
    """One phase on ``sim.device``: a batch of one."""
    return fixed_point_torch_batch([(sim, ctx)])[0]
