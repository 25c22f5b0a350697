"""Plain reference of the hybrid family (zamba2-7b as the port builds
it): ``n_layers // period`` super-blocks, each the shared attention
block (skipped in the first) and ``period`` Mamba2 layers, then ``n_layers
% period`` trailing Mamba2 layers, the final norm and an untied head.
A Mamba2 layer is ``x + mamba(rmsnorm(x, ln))``: the five input
projections, a depthwise causal conv (silu) over x, B and C, ``dt =
softplus(dt_raw + dt_bias)``, the SSD scan with ``A = -exp(a_log)`` in
chunks of ``ssm_chunk`` (within a chunk by the stable segment sums of
the Mamba2 paper's minimal implementation, across chunks by the chunk
states), the ``x * d_skip`` skip, ``rmsnorm(y * silu(z), norm_g)`` and
the output projection.  The shared block is the dense family's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common as C

_MAMBA = ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x_w", "conv_b_w",
          "conv_c_w", "conv_x_b", "conv_bb", "conv_cb", "a_log", "d_skip",
          "dt_bias", "norm_g", "out_proj")


def _vocab_padded(m: dict) -> int:
    mult = max(m["pad_vocab_multiple"], 1)
    return -(-m["vocab"] // mult) * mult


def layout(m: dict) -> tuple:
    period = m["shared_attn_period"]
    return m["n_layers"] // period, period, m["n_layers"] % period


def _dims(m: dict) -> tuple:
    d_in = m["ssm_expand"] * m["d_model"]
    return d_in, d_in // m["ssm_head_dim"], m["ssm_state"]


def _mamba_shapes(m: dict) -> dict:
    d, k = m["d_model"], m["ssm_conv"]
    d_in, heads, n = _dims(m)
    return {"w_z": (d, d_in), "w_x": (d, d_in), "w_b": (d, n),
            "w_c": (d, n), "w_dt": (d, heads), "conv_x_w": (k, d_in),
            "conv_b_w": (k, n), "conv_c_w": (k, n), "conv_x_b": (d_in,),
            "conv_bb": (n,), "conv_cb": (n,), "a_log": (heads,),
            "d_skip": (heads,), "dt_bias": (heads,), "norm_g": (d_in,),
            "out_proj": (d_in, d)}


def param_shapes(m: dict) -> dict:
    """name -> shape, as the port's module names its parameters."""
    d, vp = m["d_model"], _vocab_padded(m)
    hd = m["head_dim"] or d // m["n_heads"]
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    n_super, period, rem = layout(m)
    mamba = _mamba_shapes(m)
    out = {"embed": (vp, d)}

    def layer(prefix):
        out[prefix + "ln"] = (d,)
        out.update({prefix + "mamba." + k: s for k, s in mamba.items()})

    for a in range(n_super):
        for j in range(period):
            layer(f"main.{a}.{j}.")
    out.update({"shared.ln1": (d,), "shared.attn.wq": (d, hq),
                "shared.attn.wk": (d, hkv), "shared.attn.wv": (d, hkv),
                "shared.attn.wo": (hq, d), "shared.ln2": (d,),
                "shared.mlp.w_in": (d, m["d_ff"]),
                "shared.mlp.w_out": (m["d_ff"], d)})
    if m["glu"]:
        out["shared.mlp.w_gate"] = (d, m["d_ff"])
    for r in range(rem):
        layer(f"trailing.{r}.")
    out["ln_f"] = (d,)
    out["lm_head"] = (d, vp)
    return out


def causal_conv(x, w, b):
    """Depthwise causal conv along the positions of x ``[B,S,C]`` with
    taps w ``[K,C]`` (zeros before position 0), then silu."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return F.silu(acc + b)


def segsum(x):
    """x ``[..., T]`` -> ``[..., T, T]``: ``sum_{k=j+1..i} x_k`` for j <= i,
    -inf above the diagonal, each sum taken directly."""
    t = x.shape[-1]
    xe = x[..., :, None].expand(*x.shape, t)
    strict = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    s = torch.cumsum(xe.masked_fill(~strict, 0.0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a_log, b, c, chunk: int, prec: str):
    """y ``[B,S,H,P]`` of the SSD scan: x ``[B,S,H,P]``, dt ``[B,S,H]``,
    b and c ``[B,S,N]`` (one group), from a zero state."""
    bsz, s, heads, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q
    da = (dt * -torch.exp(a_log)).reshape(bsz, nc, q, heads) \
        .permute(0, 1, 3, 2)                                 # [B,Nc,H,Q]
    xdt = (x * dt[..., None]).reshape(bsz, nc, q, heads, p) \
        .permute(0, 1, 3, 2, 4)                              # [B,Nc,H,Q,P]
    bq = b.reshape(bsz, nc, q, n)
    cq = c.reshape(bsz, nc, q, n)
    cum = torch.cumsum(da, dim=-1)
    cb = C.mm(cq, bq.transpose(-1, -2), prec)                # [B,Nc,Q,Q]
    y_diag = C.mm(cb[:, :, None] * torch.exp(segsum(da)), xdt, prec)
    w_end = torch.exp(cum[..., -1:] - cum)[..., None] * xdt
    states = C.mm(bq[:, :, None].transpose(-1, -2), w_end, prec)  # [.,N,P]
    last = F.pad(cum[..., -1].transpose(1, 2), (1, 0))       # [B,H,Nc+1]
    decay = torch.exp(segsum(last))                          # [B,H,Nc+1,..]
    st = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    entering = torch.einsum("bhzc,bchnp->bzhnp", decay, st)[:, :-1]
    y_off = C.mm(cq[:, :, None], entering, prec) \
        * torch.exp(cum)[..., None]                          # [B,Nc,H,Q,P]
    return (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, s, heads, p)


def mamba(x, w: dict, m: dict, prec: str):
    bsz, s, _ = x.shape
    d_in, heads, n = _dims(m)
    z = C.mm(x, w["w_z"], prec)
    xs = causal_conv(C.mm(x, w["w_x"], prec), w["conv_x_w"], w["conv_x_b"])
    bm = causal_conv(C.mm(x, w["w_b"], prec), w["conv_b_w"], w["conv_bb"])
    cm = causal_conv(C.mm(x, w["w_c"], prec), w["conv_c_w"], w["conv_cb"])
    dt = F.softplus(C.mm(x, w["w_dt"], prec) + w["dt_bias"])
    xh = xs.reshape(bsz, s, heads, m["ssm_head_dim"])
    y = ssd(xh, dt, w["a_log"], bm, cm, m["ssm_chunk"], prec)
    y = (y + xh * w["d_skip"][:, None]).reshape(bsz, s, d_in)
    y = C.rmsnorm(y * F.silu(z), w["norm_g"], m["norm_eps"])
    return C.mm(y, w["out_proj"], prec)


def _layer(x, w: dict, m: dict, prec: str):
    return x + mamba(C.rmsnorm(x, w["ln"], m["norm_eps"]),
                     C.sub(w, "mamba."), m, prec)


def _shared(x, w: dict, m: dict, prec: str, rows: int):
    x = C.attention_block(x, w, m, prec, rows)
    return x + C.mlp(C.rmsnorm(x, w["ln2"], m["norm_eps"]),
                     C.sub(w, "mlp."), m, prec)


def hidden(params: dict, tokens, m: dict, prec: str, segments=None,
           rows: int = 0):
    """The final hidden states ``[B,S,D]`` (before the final norm).
    ``segments`` is accepted for the families' common signature: nothing
    here groups positions across a call."""
    n_super, period, rem = layout(m)
    x = params["embed"][tokens.long()]
    shared = C.sub(params, "shared.")
    for a in range(n_super):
        if a:
            x = C.checkpointed(lambda x_: _shared(x_, shared, m, prec,
                                                  rows), x)
        for j in range(period):
            w = C.sub(params, f"main.{a}.{j}.")
            x = C.checkpointed(lambda x_, w_=w: _layer(x_, w_, m, prec), x)
    for r in range(rem):
        w = C.sub(params, f"trailing.{r}.")
        x = C.checkpointed(lambda x_, w_=w: _layer(x_, w_, m, prec), x)
    return x, x.new_zeros(())


def head(params: dict, x, m: dict, prec: str):
    return C.mm(C.rmsnorm(x, params["ln_f"], m["norm_eps"]),
                params["lm_head"], prec)


def forward(params: dict, tokens, m: dict, prec: str, segments=None):
    x, aux = hidden(params, tokens, m, prec, segments)
    return head(params, x, m, prec), aux


def train_loss(params: dict, tokens, labels, m: dict, prec: str,
               z_loss: float):
    logits, _ = forward(params, tokens, m, prec)
    return C.loss(logits, labels, z_loss)


@torch.no_grad()
def logits_at(params: dict, tokens, m: dict, prec: str, positions,
              segments=None, rows: int = 2):
    x, _ = hidden(params, tokens, m, prec, segments, rows)
    return head(params, x[:, list(positions)], m, prec)
