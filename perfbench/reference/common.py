"""The plain references' shared arithmetic, in float32 with TF32 off.

``prec`` selects the numerics of every matrix product (:func:`mm`):
``"f32"`` is the reference; ``"bf16"`` and ``"fp8"`` round both
operands of each product to that format first (fp8: e4m3 with one
scale a tensor) and, in a backward, each operand's gradient (fp8: e5m2),
which is the control's arithmetic: the reference computed one precision
below the bfloat16 that the configurations state.  Elementwise work,
norms, softmax, the router and the loss stay float32 in every
precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_f32() -> None:
    """No TF32 in float32 products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    if fmt == torch.bfloat16:
        return x.to(torch.bfloat16).to(x.dtype)
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / _FP8_MAX[fmt], 1.0)
    return ((x / scale).to(fmt).to(x.dtype)) * scale


class _Rounded(torch.autograd.Function):
    """Rounds to ``fwd`` going forward and the gradient to ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


_FORMATS = {"bf16": (torch.bfloat16, torch.bfloat16),
            "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    fwd, bwd = _FORMATS[prec]
    return _Rounded.apply(x, fwd, bwd)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in float32 on operands at ``prec``."""
    return torch.matmul(operand(a, prec), operand(b, prec))


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x ``[B,S,H,hd]`` at positions
    ``0 .. S-1``."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, prec: str, rows: int = 0) -> torch.Tensor:
    """Causal grouped-query attention, positions from 0.  q ``[B,S,H,hd]``,
    k, v ``[B,S,Hkv,hd]``; q head ``g Hkv + j`` reads kv head ``j``.
    ``rows``: the batch rows a block computes at a time (0: all)."""
    bsz, s, heads, hd = q.shape
    kvh = k.shape[2]
    g = heads // kvh
    step = rows or bsz
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    outs = []
    for r in range(0, bsz, step):
        qb = q[r:r + step].reshape(-1, s, g, kvh, hd).permute(0, 3, 2, 1, 4)
        kb = k[r:r + step].permute(0, 2, 1, 3)               # [b,Hkv,S,hd]
        vb = v[r:r + step].permute(0, 2, 1, 3)
        sc = mm(qb, kb[:, :, None].transpose(-1, -2), prec) / math.sqrt(hd)
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)                        # [b,Hkv,G,S,S]
        o = mm(p, vb[:, :, None], prec)                      # [b,Hkv,G,S,hd]
        outs.append(o.permute(0, 3, 2, 1, 4).reshape(-1, s, heads, hd))
    return torch.cat(outs)


def loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """Cross-entropy over the padded vocabulary plus ``z_loss`` times the
    mean squared logsumexp."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    return ce + z_loss * lse.square().mean() if z_loss else ce


def cosine_lr(opt: dict, step: int) -> float:
    """Linear warm-up, then a cosine to ``min_lr_ratio``, in float32."""
    f = torch.tensor
    s = f(float(step))
    warm = torch.clamp(s / max(opt["warmup_steps"], 1), max=1.0)
    t = torch.clamp((s - opt["warmup_steps"])
                    / max(opt["total_steps"] - opt["warmup_steps"], 1),
                    0.0, 1.0)
    frac = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (
        1.0 + torch.cos(f(math.pi) * t))
    return float(opt["lr"] * warm * frac)


def train_readings(loss_fn, params: dict, batches: list, opt: dict) -> dict:
    """Runs AdamW (clipped by the global norm, decoupled decay) over
    ``batches`` from ``params`` (float32 leaves, updated in place) ->
    ``{"losses": [...], "grad_norms": {name: norm}}``: each step's loss
    and each leaf's norm of the first step's clipped gradient."""
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        total = loss_fn(params, tokens, labels)
        grads = torch.autograd.grad(total, [params[n] for n in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            scale = torch.clamp(opt["grad_clip_norm"]
                                / torch.clamp(norm, min=1e-9), max=1.0)
            grads = list(grads)
            torch._foreach_mul_(grads, scale)
            if first is None:
                first = {n: float(torch.linalg.vector_norm(
                    g, dtype=torch.float64)) for n, g in zip(names, grads)}
            lr = cosine_lr(opt, step)
            bc1 = 1.0 - opt["b1"] ** step
            bc2 = 1.0 - opt["b2"] ** step
            for n, g in zip(names, grads):
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                delta = (m[n] / bc1) / ((v[n] / bc2).sqrt() + opt["eps"])
                delta.add_(params[n], alpha=opt["weight_decay"])
                params[n].sub_(delta * lr)
            del grads
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": first}


# ---------------------------------------------------------------- the MoE
#: tokens per dispatch group, and the capacity factor (copies of the
#: port's rule, which the reference has to work out again)
MOE_GROUP = 512
CAPACITY_FACTOR = 1.25


def moe_groups(n_tok: int) -> int:
    g = max(1, n_tok // MOE_GROUP)
    while n_tok % g:
        g -= 1
    return g


def moe_layer(x: torch.Tensor, w: dict, m: dict, prec: str):
    """One MoE layer over the tokens ``x`` ``[T,D]`` of one call, grouped
    and capacity-bounded as a call of the port's dispatch groups them:
    top-k of the float32 router (ties to the lower index), the gates
    renormalised over the k, each expert taking a group's tokens in
    choice order then token order up to its capacity; a dropped pair adds
    nothing.  -> (y ``[T,D]``, the load-balancing loss)."""
    n_tok, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    g = moe_groups(n_tok)
    sg = n_tok // g
    cap = max(k, int(math.ceil(sg * k * CAPACITY_FACTOR / e)))
    probs = torch.softmax(x @ w["router"], dim=-1).reshape(g, sg, e)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    gate = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(g, e, dtype=torch.int64, device=x.device)
    keep = []
    for j in range(k):
        oh = F.one_hot(topi[..., j], e)
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        keep.append(((pos < cap) & (oh > 0)).any(-1))
        counts = counts + oh.sum(dim=1)
    keep = torch.stack(keep, -1).reshape(n_tok, k)
    expert = topi.reshape(n_tok, k)
    gate = gate.reshape(n_tok, k)
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, j = torch.nonzero((expert == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = x[tok]
        h = mm(rows, w["w_in"][ex], prec)
        gt = mm(rows, w["w_gate"][ex], prec)
        out = mm(act(gt, m["act"]) * h, w["w_out"][ex], prec)
        y = y.index_add(0, tok, out * gate[tok, j][:, None])
    me = probs.mean(dim=(0, 1))
    top1 = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
    return y, e * torch.sum(me * top1)


def mlp(x, w: dict, m: dict, prec: str) -> torch.Tensor:
    h = mm(x, w["w_in"], prec)
    if m["glu"]:
        h = act(mm(x, w["w_gate"], prec), m["act"]) * h
    else:
        h = act(h, m["act"])
    return mm(h, w["w_out"], prec)


def attention_block(x, w: dict, m: dict, prec: str, rows: int = 0):
    """``x + attn(rmsnorm(x, ln1))``: projections, RoPE, causal GQA."""
    bsz, s, d = x.shape
    hd = m["head_dim"] or d // m["n_heads"]
    h = rmsnorm(x, w["ln1"], m["norm_eps"])
    q = mm(h, w["attn.wq"], prec).reshape(bsz, s, m["n_heads"], hd)
    k = mm(h, w["attn.wk"], prec).reshape(bsz, s, m["n_kv_heads"], hd)
    v = mm(h, w["attn.wv"], prec).reshape(bsz, s, m["n_kv_heads"], hd)
    if m["qkv_bias"]:
        q = q + w["attn.bq"].reshape(m["n_heads"], hd)
        k = k + w["attn.bk"].reshape(m["n_kv_heads"], hd)
        v = v + w["attn.bv"].reshape(m["n_kv_heads"], hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    o = attention(q, k, v, prec, rows).reshape(bsz, s, -1)
    return x + mm(o, w["attn.wo"], prec)


def sub(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` (``blocks.3.``), the prefix cut."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward where a gradient is
    taken, so that a block's activations are not all kept."""
    if torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
