"""UGAL-style adaptive routing with minimal bias — paper §2.2.

Per packet, Aries picks 2 minimal and 2 non-minimal candidate paths at
random and routes on the one whose *estimated* congestion is lowest, where
the estimate mixes local queue occupancy with far-end credit information
that arrives late (=> phantom congestion, Won et al. [46]).  The bias is
added to the non-minimal estimates; higher bias => more minimal routing.

All scores are in SECONDS of predicted delay:
    score(path) = sum(est_queue_s[link]) + hops * hop_latency + bias_s
where bias_s = mode.minimal_bias * bias_unit_s is charged to non-minimal
candidates only.

The simulator distributes each flow's bytes across candidates with a
softmin over scores (temperature = per-packet noise scale): this is the
fluid limit of per-packet argmin-with-noise selection — P(packet takes
candidate c) = softmax(-score/T)_c for Gumbel(T) packet noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.strategies import RoutingMode
from repro_torch.dragonfly.topology import PAD


@dataclass(frozen=True)
class RoutingPolicy:
    mode: RoutingMode
    #: seconds of predicted delay per unit of minimal bias (paper: the exact
    #: Aries bias values are not public; this is the calibration constant).
    #: Sized so HIGH BIAS (8 units = 160us) overrides transient self-
    #: congestion and phantom ghosts, but yields to real ms-scale backlogs.
    bias_unit_s: float = 20e-6
    #: softmin temperature == per-packet congestion-estimate noise scale.
    spray_temperature_s: float = 10e-6
    #: per-hop latency charged in the score (router pipeline).
    hop_latency_s: float = 100e-9

    @property
    def bias_s(self) -> float:
        return mode_bias_s(self.mode, self.bias_unit_s)


def mode_bias_s(mode: RoutingMode, bias_unit_s: float) -> float:
    """Seconds of minimal bias for one mode.  Deterministic modes return
    raw ±inf (never scaled — inf * unit would be inf anyway, but the raw
    value is the sentinel score_candidates branches on)."""
    b = mode.minimal_bias
    if mode is RoutingMode.ADAPTIVE_1:
        # Increasingly-minimal: bias ramps 0 -> terminal along the path;
        # in the fluid model we charge the path-average (half terminal).
        return b * 0.5 * bias_unit_s
    if np.isinf(b):
        return b
    return b * bias_unit_s


# --- int mode codes + bias lookup (the fast path's per-flow bias) ---------
#: fixed enumeration order backing the int mode-code representation
MODE_ORDER: tuple = tuple(RoutingMode)
MODE_CODE: dict = {m: i for i, m in enumerate(MODE_ORDER)}


def mode_codes(modes: np.ndarray) -> np.ndarray:
    """Object array of RoutingModes -> int64 code array (one Python pass
    per *phase* instead of one set-membership pass per feedback
    iteration)."""
    n = len(modes)
    return np.fromiter((MODE_CODE[m] for m in modes), dtype=np.int64,
                       count=n)


def bias_table_s(bias_unit_s: float) -> np.ndarray:
    """[n_modes] seconds-of-bias lookup table aligned with MODE_ORDER
    (deterministic modes keep their raw ±inf sentinel)."""
    return np.array([mode_bias_s(m, bias_unit_s) for m in MODE_ORDER])


def row_bias_terms(n: int, policy: RoutingPolicy,
                   modes: np.ndarray | None = None):
    """Loop-invariant per-flow bias decomposition.

    Returns (bias_rows [n] float64, posinf [n] bool, neginf [n] bool):
    the finite seconds-of-bias charged to non-minimal candidates, and
    the deterministic-mode masks (±inf sentinels).  Computed once per
    phase and reused by every feedback iteration.
    """
    if modes is None:
        b = policy.bias_s
        bias_rows = np.full(n, 0.0 if np.isinf(b) else b)
        posinf = np.full(n, np.isposinf(b))
        neginf = np.full(n, np.isneginf(b))
        return bias_rows, posinf, neginf
    raw = bias_table_s(policy.bias_unit_s)[mode_codes(modes)]
    finite = np.isfinite(raw)
    return (np.where(finite, raw, 0.0), np.isposinf(raw),
            np.isneginf(raw))


def apply_bias(score: np.ndarray, is_nonmin: np.ndarray,
               bias_rows: np.ndarray, posinf: np.ndarray,
               neginf: np.ndarray) -> np.ndarray:
    """Charge the per-flow minimal bias to a [n, ncand] score array."""
    score = score + np.where(is_nonmin[None, :], bias_rows[:, None], 0.0)
    if posinf.any():                     # deterministic minimal rows
        score = np.where(posinf[:, None] & is_nonmin[None, :],
                         np.inf, score)
    if neginf.any():                     # deterministic non-minimal rows
        score = np.where(neginf[:, None] & ~is_nonmin[None, :],
                         np.inf, score)
    return score


def apply_notifications(est_queue_s: np.ndarray, notified: np.ndarray,
                        penalty_s: float) -> np.ndarray:
    """Demote links under a visible congestion notification.

    The notification channel (SimParams.notify_*, docs/policy_api.md;
    Rocher-Gonzalez et al. 2502.00616) marks links whose queue estimate
    crossed the notify threshold on a past phase.  Routing reacts by
    charging ``penalty_s`` seconds of predicted delay to every flagged
    link, which flows into the hoisted score base exactly like queue
    backlog — minimal candidates crossing a flagged link lose to clean
    non-minimal ones once the penalty exceeds the mode's bias.

    Returns a NEW array; the caller skips this call entirely when no
    flag is visible, so the disabled channel stays bit-identical to the
    notification-free scorer.
    """
    return est_queue_s + penalty_s * notified


def score_candidates(link_ids: np.ndarray, est_queue_s: np.ndarray,
                     is_nonmin: np.ndarray, policy: RoutingPolicy,
                     modes: np.ndarray | None = None) -> np.ndarray:
    """Predicted-delay score per candidate (seconds; lower is better).

    link_ids:    [n, ncand, max_hops] PAD-padded link ids
    est_queue_s: [n_links] estimated (stale/noisy) seconds-to-drain
    modes:       optional [n] object array of per-flow RoutingModes; when
                 given, each flow is biased by its own mode (the
                 PolicyEngine path: one batched call per phase, mixed
                 modes welcome).  Without it, policy.mode biases all rows.

    The simulator's fast path does not call this per feedback iteration
    any more — it hoists the (queue gather + hop latency + bias) base via
    row_bias_terms/apply_bias and only re-adds the iteration's `extra`
    term; this function remains the one-shot scoring entry point.
    """
    valid = link_ids != PAD
    safe = np.where(valid, link_ids, 0)
    q = est_queue_s[safe] * valid        # [n, ncand, hops]
    hops = valid.sum(axis=-1)            # [n, ncand]
    score = q.sum(axis=-1) + policy.hop_latency_s * hops
    if modes is None:
        bias = policy.bias_s
        if np.isposinf(bias):                # deterministic minimal
            score = np.where(is_nonmin[None, :], np.inf, score)
        elif np.isneginf(bias):              # deterministic non-minimal
            score = np.where(is_nonmin[None, :], score, np.inf)
        else:
            score = score + np.where(is_nonmin[None, :], bias, 0.0)
        return score
    return apply_bias(score, is_nonmin,
                      *row_bias_terms(score.shape[0], policy, modes))


def spray_weights(scores: np.ndarray, policy: RoutingPolicy,
                  rng: np.random.Generator | None = None,
                  packets: np.ndarray | None = None) -> np.ndarray:
    """Byte distribution over candidates: softmin(scores / T).

    When candidate scores are close (ADAPTIVE, bias 0) bytes spread across
    paths (packet spraying); when the bias separates them (HIGH BIAS) bytes
    concentrate on minimal paths.  Deterministic modes collapse to one
    class.

    The optional Gumbel jitter is the *sampling error* of per-packet
    selection: each packet draws its own noisy estimate, so a message of
    `packets` packets realizes the softmin distribution with ~1/sqrt(p)
    relative error — a single-packet message takes exactly one path, a
    64k-packet message matches the distribution almost exactly.

    When `rng is None` the scores go straight into the softmin — no
    copy, no noise machinery (this runs 4x per phase on the bg arm)."""
    t = max(policy.spray_temperature_s, 1e-12)
    noise = scale = None
    if rng is not None:
        noise = rng.gumbel(0.0, 1.0, size=scores.shape)
        scale = t * 0.9
        if packets is not None:
            scale = scale / np.sqrt(np.maximum(packets, 1.0))[:, None]
    return softmin_weights(scores, t, noise=noise, noise_scale=scale)


def softmin_weights(scores: np.ndarray, temperature,
                    noise: np.ndarray | None = None,
                    noise_scale=None) -> np.ndarray:
    """softmin(scores / T) with optional pre-drawn additive noise.

    `temperature` is a scalar or a per-row [n] / [n, 1] array (the fused
    fast path sprays app + background flows, whose policies may carry
    different temperatures, in ONE call).  Inf/NaN scrubbing is a single
    pass on the score side: a +inf score exponentiates to an exact 0.0
    weight, so the exp output needs no second scrub.
    """
    t = np.asarray(temperature)
    if t.ndim == 1:
        t = t[:, None]
    s = scores
    if noise is not None:
        s = s + noise * noise_scale
    s = np.where(np.isfinite(s), s, np.inf)
    smin = s.min(axis=1, keepdims=True)
    # rows with no usable candidate (all inf): shift by 0 instead of inf
    # so exp(-inf) cleanly zeroes them without inf-inf NaN warnings
    smin = np.where(np.isfinite(smin), smin, 0.0)
    z = np.exp(-(s - smin) / t)
    tot = z.sum(axis=1, keepdims=True)
    tot = np.where(tot <= 0, 1.0, tot)
    return z / tot
