"""Loss and train step.

Counterpart of ``repro/train/train_step.py``.  The reference takes
``jax.value_and_grad`` of a plain model; the port's dense, SSM, hybrid
and VLM models run B2, B3 and B4 on the card, whose autograd Functions
run their backward kernels, so ``torch.autograd.grad`` through
:func:`repro_torch.models.registry.train_forward` gives the gradient of
every float32 master.  The step
then updates the model in place (:func:`~repro_torch.train.optimizer.
adamw_update`) and drops its cached serving copies.  ``make_train_step``
(``jax.jit`` with explicit shardings, for the dry-run) has no
counterpart: the port runs eagerly on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import registry as model_registry
from repro_torch.models.common import (Family, ModelConfig, constrain,
                                       dp_spec, is_sharded)
from repro_torch.sharding.local import (rows_per_rank, vocab_gather,
                                        vocab_logsumexp)
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatch: int = 0        # 0 = no microbatching; else per-step split
    z_loss: float = 1e-4       # logit-norm regularizer (numerics at scale)


def auto_microbatch(cfg: ModelConfig, global_batch: int, seq_len: int,
                    dp_size: int, *, budget_bytes: float = 3e9) -> int:
    """Pick a microbatch size so the remat stash (~per-layer saved
    activations x depth: under ``cfg.remat`` each layer's input, which
    :func:`repro_torch.models.common.checkpoint_wrap` keeps, and one
    layer's recomputed activations) fits the budget.  Returns 0 (no
    microbatching) when the full batch already fits.  The microbatch
    stays a multiple of dp_size so each shard keeps >=1 row.  (The
    reference's estimate, as it is: its family factors stand for the
    saved activations of a layer, not for its input alone.)"""
    depth = cfg.n_layers + (cfg.n_encoder_layers or 0)
    if cfg.family == Family.HYBRID:
        depth += max(cfg.n_layers // cfg.shared_attn_period, 0)
    bytes_per_row = seq_len * cfg.d_model * 2 * max(depth, 1) * 1.3
    # family factors: SSD's quadratic-within-chunk buffers ([Q,Q,H] per
    # chunk) and MoE dispatch/capacity tensors dominate the plain-residual
    # estimate
    if cfg.family in (Family.SSM, Family.HYBRID) and cfg.ssm_chunk:
        d_inner = cfg.ssm_expand * cfg.d_model
        heads = max(d_inner // cfg.ssm_head_dim, 1)
        bytes_per_row *= 1.0 + (2.0 * cfg.ssm_chunk * heads * 4.0
                                / (cfg.d_model * 2.0))
    if cfg.family == Family.MOE:
        bytes_per_row *= 3.0
    rows_budget = max(int(budget_bytes / bytes_per_row), 1) * dp_size
    if rows_budget >= global_batch:
        return 0
    mb = dp_size
    while mb * 2 <= rows_budget and global_batch % (mb * 2) == 0:
        mb *= 2
    return mb


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 0.0) -> torch.Tensor:
    """logits ``[B,S,V]`` (any float dtype; V the padded vocab), labels
    ``[B,S]`` int -> scalar float32: cross-entropy from a float32
    logsumexp and a gather, plus ``z_loss`` times the mean squared
    logsumexp.  Logits that are DTensors (the dry run's) are kept sharded
    over the vocab, their gradient too, and take the vocab-parallel
    logsumexp and gather."""
    lg = constrain(logits.float(), dp_spec(logits), None, "model")
    lse = (vocab_logsumexp(lg) if is_sharded(lg)               # [B,S]
           else torch.logsumexp(lg, dim=-1))
    gold = (vocab_gather(lg, labels) if is_sharded(lg)
            else torch.gather(lg, -1, labels.long()[..., None])[..., 0])
    ce = (lse - gold).mean()
    if z_loss:
        ce = ce + z_loss * lse.square().mean()
    return ce


def _step_loss(model, batch: dict, cfg: ModelConfig, tcfg: TrainConfig):
    logits, aux = model_registry.train_forward(model, batch, cfg)
    ce = loss_fn(logits, batch["labels"], z_loss=tcfg.z_loss)
    total = ce + cfg.router_aux_coef * aux
    return total, {"ce": ce, "aux": aux}


def value_and_grad(model, batch: dict, cfg: ModelConfig,
                   tcfg: TrainConfig):
    """-> (loss, metrics, grads): the step's loss and its metrics
    (detached) and the gradient of every parameter, a dict keyed by the
    model's parameter names.  Makes every parameter require a gradient
    (they are made frozen for serving)."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, metrics = _step_loss(model, batch, cfg, tcfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(named, grads)))


def _apply(model, opt_state: AdamWState, grads: dict, tcfg: TrainConfig):
    _, opt_state, opt_metrics = adamw_update(
        tcfg.optimizer, dict(model.named_parameters()), grads, opt_state)
    model._cw = None          # the serving copies hold the old weights
    return opt_state, opt_metrics


def train_step(model, opt_state: AdamWState, batch: dict, *,
               cfg: ModelConfig, tcfg: TrainConfig):
    """One optimizer step on ``batch`` (``tokens`` and ``labels`` on the
    model's device) -> (model, opt_state, metrics); the model and the
    optimizer state are updated in place."""
    if tcfg.microbatch and tcfg.microbatch < batch["tokens"].shape[0]:
        return _train_step_micro(model, opt_state, batch, cfg=cfg,
                                 tcfg=tcfg)
    loss, metrics, grads = value_and_grad(model, batch, cfg, tcfg)
    opt_state, opt_metrics = _apply(model, opt_state, grads, tcfg)
    return model, opt_state, dict(metrics, loss=loss, **opt_metrics)


def _train_step_micro(model, opt_state, batch: dict, *, cfg, tcfg):
    """Gradient accumulation over microbatches: float32 gradients summed
    over the splits, then divided by their number.  A batch of DTensors
    (the dry run's) is split within each rank's rows, so that every
    microbatch stays sharded as the batch is (the reference reshapes and
    re-shards; either split sums to the same gradient)."""
    n = batch["tokens"].shape[0] // tcfg.microbatch
    mb = tcfg.microbatch
    acc, loss_sum, metrics = None, torch.zeros(()), None
    for i in range(n):
        part = {k: (rows_per_rank(v, i, n) if is_sharded(v)
                    else v[i * mb:(i + 1) * mb]) for k, v in batch.items()}
        loss, metrics, grads = value_and_grad(model, part, cfg, tcfg)
        if acc is None:
            acc = {k: g.float() for k, g in grads.items()}
        else:
            for k, g in grads.items():
                acc[k] += g.float()
        loss_sum = loss_sum.to(loss.device) + loss
        del grads
    acc = {k: g / n for k, g in acc.items()}
    opt_state, opt_metrics = _apply(model, opt_state, acc, tcfg)
    return model, opt_state, dict(metrics, loss=loss_sum / n, **opt_metrics)
