"""The comparisons that decide ``correct``, each number beside its limit.

Training (the first ``checked_steps`` steps, which set-up drives through
the window's own call and feed, against the plain reference's steps from
the same weights and batches):

* ``loss_gap``: the largest gap between the program's loss and the
  reference's over those steps;
* ``grad_gap``: over the leaves, the largest gap between the norms of
  the first step's clipped gradient (the program's worked out from its
  optimizer state after one step, ``m / (1 - b1)``), as a share of the
  reference's norm of that leaf or of the median leaf's, whichever is
  larger;
* ``change_gap``: the same, of the norms of each leaf's change over the
  checked steps;
* ``change_median``: the median leaf's gap of those changes, which is
  steady from seed to seed where the worst leaf is one small leaf's
  noise (an MoE router's gradient follows the discrete expert choices).

A cell's limits file names the numbers it compares.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone; both gaps leave them out.

Serving: over the sampled requests' served tokens, the gap by which a
served token's logit lies below the reference's best at its position:
``mean_logit_gap`` the mean, which the fp8 control fails (its widest
gap is set, as the bf16 program's is, by the rarest expert choice that
flips); ``logit_gap`` the widest, which a single token altered where it
is produced fails; ``flip_share`` the share of served tokens that are
not the reference's best (for the log).
"""

from __future__ import annotations

import math
import statistics

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of the leaf comparisons
NOUGHT = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's gap of norms, over the leaves in ``keep``."""
    med = statistics.median(ref[n] for n in keep)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in keep}


def worst(gaps: dict) -> tuple:
    """(leaf, gap) of the largest gap."""
    return max(gaps.items(), key=lambda kv: kv[1])


def kept(ref: dict) -> list:
    """The leaves compared: those whose reference gradient is not nought
    to rounding."""
    med = statistics.median(ref["grad_norms"].values())
    return [n for n, v in ref["grad_norms"].items() if v >= NOUGHT * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (a list), ``grad_norms`` and
    ``change_norms`` (name -> norm)."""
    keep = kept(ref)
    loss = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    return {"loss_gap": loss,
            "grad_gap": worst(leaf_gaps(prog["grad_norms"],
                                        ref["grad_norms"], keep))[1],
            "change_gap": worst(change)[1],
            "change_median": statistics.median(change.values())}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """For the log: the leaf of each leaf gap, the gaps' quartiles and
    90th percentile, and the leaves left out."""
    keep = kept(ref)
    out = {"left_out": sorted(set(ref["grad_norms"]) - set(keep))}
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key + "_norms"], ref[key + "_norms"], keep)
        q = statistics.quantiles(gaps.values(), n=10)
        out[key] = {"worst": worst(gaps), "median": q[4], "p90": q[8]}
    return out


def logit_gaps(ref_logits, served, vocab: int):
    """Per served token, the reference's best logit at its position less
    the logit of the served token (``ref_logits`` ``[..., Vp]`` float32,
    ``served`` ``[...]`` ints); the pad of the vocabulary is left out."""
    import torch

    lg = ref_logits[..., :vocab].float()
    best = lg.max(dim=-1).values
    got = torch.gather(lg, -1, served.long()[..., None])[..., 0]
    return best - got


def serve_numbers(gaps) -> dict:
    """The served tokens' logit gaps (a float32 tensor) -> the widest
    gap, the mean gap, and the share of served tokens that are not the
    reference's best."""
    return {"logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "flip_share": float((gaps > 0).float().mean())}


def checks(numbers: dict, limits: dict) -> dict:
    """name -> {"value", "limit"}, for each number the cell's limits
    name."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def passed(checked: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())
