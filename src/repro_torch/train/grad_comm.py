"""Gradient communication: bucketing, compression, error feedback.

Counterpart of ``repro/train/grad_comm.py``:

  * bucketize: group the gradient leaves into buckets of ~bucket_bytes,
    greedy, in the reference's leaf order (so locality follows layer
    order);
  * compress_decompress: bf16 wire format with fp32 error-feedback
    residuals (the quantization error is carried to the next step);
  * the schedule of each bucket (DIRECT vs HIERARCHICAL) goes through
    the paper's Algorithm 1 (``collectives/selector.py``) on the
    bucket's byte size.

A leaf is the reference's: its parameters keep per-layer tensors
stacked ``[L, ...]`` under one name, the port keeps one tensor a layer
(``blocks.{i}.attn.wq``).  :func:`reference_leaves` groups the port's
parameters (or gradients, keyed alike) back into the reference's leaves,
in its order (``jax.tree_util.tree_leaves``: dict keys sorted at every
level), so the buckets and their sizes are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.collectives.modes import CollectiveMode
from repro_torch.collectives.selector import AppAwareSelector


@dataclass(frozen=True)
class GradCommConfig:
    bucket_bytes: int = 32 * 1024 * 1024
    compress: bool = True          # bf16 on the wire
    error_feedback: bool = True


def reference_leaves(named: dict) -> list:
    """-> ``[(leaf name, [tensors]), ...]``: the tensors of ``named``
    (keyed by the model's parameter names) grouped into the reference's
    leaves, the per-layer index dropped from each name
    (``blocks.3.attn.wq`` -> ``blocks.attn.wq``), each leaf's tensors in
    layer order, the leaves in the reference's order."""
    groups: dict = {}
    for name, t in named.items():
        key = tuple(part for part in name.split(".") if not part.isdigit())
        groups.setdefault(key, []).append(t)
    return [(".".join(key), groups[key]) for key in sorted(groups)]


def _numel(leaf: list) -> int:
    return sum(t.numel() for t in leaf)


def bucketize(grads: dict, bucket_bytes: int) -> list:
    """-> list of tuples of leaf indices (into :func:`reference_leaves`)
    grouping the leaves into buckets of ~bucket_bytes of float32."""
    buckets, cur, cur_bytes = [], [], 0
    for i, (_, leaf) in enumerate(reference_leaves(grads)):
        nb = _numel(leaf) * 4
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(tuple(cur))
    return buckets


def bucket_bytes_on_wire(grads: dict, cfg: GradCommConfig) -> list:
    """The byte size of each bucket as sent: 2 bytes an entry compressed
    (bf16), 4 otherwise."""
    leaves = reference_leaves(grads)
    return [sum(_numel(leaves[i][1]) for i in b)
            * (2 if cfg.compress else 4)
            for b in bucketize(grads, cfg.bucket_bytes)]


def compress_decompress(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback bf16 compression of one tensor.

    wire = bf16(g + residual); new_residual = (g + residual) - wire.
    Returns (wire_value_as_f32, new_residual)."""
    acc = g.float() + residual
    back = acc.to(torch.bfloat16).float()
    return back, acc - back


def select_bucket_modes(selector: AppAwareSelector, grads: dict,
                        cfg: GradCommConfig) -> list:
    """Algorithm 1 per bucket: returns [(bucket, CollectiveMode), ...].

    Called once per step on the host.  ONE vectorized engine call
    decides every bucket of the step, then the cost model self-feeds the
    batch."""
    buckets = bucketize(grads, cfg.bucket_bytes)
    sizes = bucket_bytes_on_wire(grads, cfg)
    modes = selector.decide_batch(sizes, site="grad_comm")
    selector.update_predicted(sizes)
    return list(zip(buckets, modes))


def reduce_bucketed(grads: dict, mesh, selector: AppAwareSelector,
                    cfg: GradCommConfig, residuals: dict | None = None):
    """Explicit bucketed, compressed, app-aware scheduled gradient
    reduce over ``mesh`` (``repro_torch.collectives.allreduce``): one
    schedule for the step, HIERARCHICAL where Algorithm 1 chose it for
    any bucket.  Returns (reduced_grads, new_residuals, modes)."""
    from repro_torch.collectives.allreduce import grad_allreduce

    if residuals is None and cfg.error_feedback and cfg.compress:
        residuals = {k: torch.zeros_like(g, dtype=torch.float32)
                     for k, g in grads.items()}
    if cfg.compress:
        pairs = {k: compress_decompress(g, residuals[k])
                 for k, g in grads.items()}
        wire = {k: p[0] for k, p in pairs.items()}
        new_res = {k: p[1] for k, p in pairs.items()}
    else:
        wire, new_res = grads, residuals

    modes = select_bucket_modes(selector, wire, cfg)
    # one reduce per mode class (buckets of the same mode share a schedule)
    chosen = {m for _, m in modes} or {CollectiveMode.DIRECT}
    mode = (CollectiveMode.HIERARCHICAL
            if CollectiveMode.HIERARCHICAL in chosen
            else CollectiveMode.DIRECT)
    reduced = grad_allreduce(wire, mesh, mode=mode)
    return reduced, new_res, modes
