"""AdamW (decoupled weight decay) and its schedule over the model's
float32 parameters.

Counterpart of ``repro/train/optimizer.py``.  The reference maps pure
functions over pytrees; here parameters, gradients and the moments are
dicts of tensors keyed by the model's parameter names
(``dict(model.named_parameters())``), the moments ``m`` and ``v`` float32
like the masters.  :func:`clip_by_global_norm` and :func:`adamw_update`
work in place under ``torch.no_grad``: the clip scales the given
gradients, and the update writes the parameters and the moments where
they are (at qwen2-1.5b every float32 copy is 6.17 GB).  The arithmetic
is the reference's, elementwise in float32, on ``torch._foreach`` lists
(a few launches for a chunk of tensors); the reference leaves it to XLA,
so there is no kernel.  The update's two float32 temporaries are made a
chunk of at most :data:`UPDATE_CHUNK` entries at a time (or one tensor,
where it is larger), so that beside the masters, their gradients and
the moments the update needs 8 bytes an entry of one chunk, not of every
parameter; each entry's arithmetic is the same whatever the chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


#: entries of the parameters updated together (1 GiB of float32 per
#: temporary)
UPDATE_CHUNK = 1 << 28


def _chunks(params: dict) -> list:
    """The parameter names in chunks of at most UPDATE_CHUNK entries (a
    larger tensor alone), in order."""
    chunks, cur, n = [], [], 0
    for name, p in params.items():
        if cur and n + p.numel() > UPDATE_CHUNK:
            chunks.append(cur)
            cur, n = [], 0
        cur.append(name)
        n += p.numel()
    return chunks + [cur] if cur else chunks


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


def adamw_init(params: dict) -> AdamWState:
    """Zero float32 moments beside each parameter, on its device."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    return AdamWState(step=0, m=zeros,
                      v={n: z.clone() for n, z in zeros.items()})


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` as a float32 scalar on the host:
    linear warm-up, then a cosine down to ``min_lr_ratio``, in the
    reference's float32 arithmetic."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32, summed per
    tensor as the reference sums them.  (Not ``torch._foreach_norm``:
    on the CPU its float32 accumulation left 8e-2 of the float64 norm of
    a 233 M-entry tensor, where ``square().sum()`` left 8e-8.)"""
    return torch.stack([t.float().square().sum()
                        for t in tensors]).sum().sqrt()


def _clip(grads: dict, norm: torch.Tensor, max_norm: float) -> None:
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(list(grads.values()), scale)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales ``grads`` in place by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)`` (the norm before the clip, a device scalar)."""
    norm = global_norm(grads.values())
    _clip(grads, norm, max_norm)
    return grads, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: AdamWState):
    """-> (params, new_state, metrics).  Clips ``grads`` and updates
    ``params`` and the moments in place; ``metrics`` holds ``lr`` (host)
    and ``grad_norm`` (device, before the clip).  On DTensors (the dry
    run's) each gradient is first brought to its parameter's placements
    (the data-parallel reduction) and the norm taken over the whole
    tensors; the update then runs on each rank's shards, as a sharded
    optimizer steps."""
    if any(isinstance(p, DTensor) for p in params.values()):
        grads = {n: g.redistribute(params[n].device_mesh,
                                   params[n].placements)
                 for n, g in grads.items()}
        norm = global_norm(grads.values())
        norm = norm.redistribute(norm.device_mesh,
                                 [Replicate()] * norm.device_mesh.ndim)

        def local(d):
            return {n: t.to_local() for n, t in d.items()}

        _, new, metrics = _update(
            cfg, local(params), local(grads),
            AdamWState(state.step, local(state.m), local(state.v)),
            norm.to_local())
        return params, AdamWState(new.step, state.m, state.v), \
            dict(metrics, grad_norm=norm)
    return _update(cfg, params, grads, state)


def _update(cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState,
            norm: torch.Tensor | None = None):
    """:func:`adamw_update` on plain tensors; ``norm``: the gradients'
    global norm where the caller took it."""
    if norm is None:
        _, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = norm
        _clip(grads, norm, cfg.grad_clip_norm)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    bc1 = float(1.0 - _f32(cfg.b1) ** step)
    bc2 = float(1.0 - _f32(cfg.b2) ** step)
    for names in _chunks(params):
        p = [params[n] for n in names]
        g = [grads[n].float() for n in names]
        m = [state.m[n] for n in names]
        v = [state.v[n] for n in names]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        del g
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m, bc1)
        torch._foreach_div_(delta, denom)
        del denom
        torch._foreach_add_(delta, p, alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, float(lr))
        torch._foreach_sub_(p, delta)
        del delta
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
