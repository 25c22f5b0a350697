"""Anchored comparison of two runs of an MoE model, with the tie rule.

Top-k routing is discontinuous: where a token's k-th and (k+1)-th
router logits lie closer than the rounding of the router's input, two
runs that round it differently (the card and the CPU, or the port and
the reference, in bf16) choose different experts, and the token's
output moves by far more than any tolerance of the logits.  So two runs
are compared anchored, as the protocol's runs are
(:mod:`repro_torch.benchmarks.parity`):

* :func:`recording` keeps each router call of the anchor run (its input
  ``x`` in float32, the router, the probabilities), in call order;
* :func:`anchored` runs the other model with the anchor's expert
  choices: call i takes the anchor's call i's indices, with gates from
  its own probabilities, and records the choices it would have made;
* :func:`flips` lists each (call, token) whose own choices differ from
  the anchor's, and holds it to the tie rule: at the first top-k slot
  where they differ, the anchor's expert ``a`` against the expert ``c``
  the other run put there, the anchor's logit margin ``z_a - z_c`` must
  be at most ``TIE_ROUNDINGS * U_BF16 * sum_d |x_d| |R_da - R_dc|``:
  what one bf16 rounding of each element of ``x`` in each run can
  change that difference by.

The hooks replace :func:`repro_torch.models.moe.router_probs` and
:func:`~repro_torch.models.moe.topk` while they are open, so they see
the ``moe_einsum`` path (prefill and decode), not ``moe_ep``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import moe

#: bf16's unit roundoff
U_BF16 = 2.0 ** -8
#: roundings of x the tie rule admits: one in each run
TIE_ROUNDINGS = 2


@dataclass
class RouterTrace:
    """Router calls of one run, in order: (x ``[T, D]`` float32, router
    ``[D, E]``, probs ``[T, E]``, top-k indices ``[T, k]``), all on the
    CPU."""
    calls: list = field(default_factory=list)

    def add(self, x, router, probs, idx=None) -> None:
        def cpu(t):
            return torch.from_numpy(np.array(t, np.float32)) \
                if not isinstance(t, torch.Tensor) else t.detach().cpu()
        self.calls.append([cpu(x).float(), cpu(router).float(),
                           cpu(probs).float(),
                           None if idx is None else cpu(idx).long()])


@contextlib.contextmanager
def recording(trace: RouterTrace):
    """Record every router call (and its top-k) of the run inside."""
    real_probs, real_topk = moe.router_probs, moe.topk

    def probs_hook(w, x, cfg):
        p = real_probs(w, x, cfg)
        trace.add(x, w["router"], p)
        return p

    def topk_hook(p, k):
        v, i = real_topk(p, k)
        trace.calls[-1][3] = i.reshape(-1, k).detach().cpu()
        return v, i

    moe.router_probs, moe.topk = probs_hook, topk_hook
    try:
        yield trace
    finally:
        moe.router_probs, moe.topk = real_probs, real_topk


@contextlib.contextmanager
def anchored(anchor: RouterTrace, trace: RouterTrace):
    """Run with ``anchor``'s expert choices, call for call; ``trace``
    records this run's own inputs and the choices it would have made."""
    real_probs, real_topk = moe.router_probs, moe.topk

    def probs_hook(w, x, cfg):
        p = real_probs(w, x, cfg)
        trace.add(x, w["router"], p)
        return p

    def topk_hook(p, k):
        n = len(trace.calls) - 1
        _, own = real_topk(p, k)
        trace.calls[-1][3] = own.reshape(-1, k).detach().cpu()
        want = anchor.calls[n][3]
        if want is None or want.shape != (own.numel() // k, k):
            raise ValueError(f"router call {n}: the anchor chose "
                             f"{None if want is None else tuple(want.shape)}"
                             f", this run needs {(own.numel() // k, k)}")
        idx = want.to(p.device).reshape(own.shape)
        return torch.gather(p, -1, idx), idx

    moe.router_probs, moe.topk = probs_hook, topk_hook
    try:
        yield trace
    finally:
        moe.router_probs, moe.topk = real_probs, real_topk


def flips(run: RouterTrace, anchor: RouterTrace, n_layers: int,
          recomputed: bool = False) -> dict:
    """Each (call, token) whose choices in ``run`` differ from
    ``anchor``'s, held to the tie rule.  Returns ``per_layer`` (flips by
    layer, call i being layer ``i % n_layers``; with ``recomputed``, the
    calls after the forward's ``n_layers`` are the backward's
    recomputations, the last layer's first), ``n`` (all of them),
    ``share`` (the largest margin's share of its bound; at most 1 passes)
    and ``calls`` compared."""
    if len(run.calls) != len(anchor.calls):
        raise ValueError(f"{len(run.calls)} router calls against the "
                         f"anchor's {len(anchor.calls)}")
    per_layer = [0] * n_layers
    share = 0.0
    for n, (own, ref) in enumerate(zip(run.calls, anchor.calls)):
        x, router = ref[0].double(), ref[1].double()
        diff = (own[3] != ref[3]).any(dim=1).nonzero().flatten()
        layer = n % n_layers
        if recomputed and n >= n_layers:
            layer = n_layers - 1 - layer
        per_layer[layer] += int(diff.numel())
        for t in diff.tolist():
            j = int((own[3][t] != ref[3][t]).nonzero()[0])
            a, c = int(ref[3][t, j]), int(own[3][t, j])
            r = router[:, a] - router[:, c]
            margin = float(x[t] @ r)
            bound = TIE_ROUNDINGS * U_BF16 * float(x[t].abs() @ r.abs())
            share = max(share, margin / bound)
    return {"per_layer": per_layer, "n": sum(per_layer), "share": share,
            "calls": len(run.calls)}
