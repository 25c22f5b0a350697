"""Plain reference of the MoE family (granite-moe-3b-a800m): a decoder
of ``n_layers`` blocks, ``x + attn(rmsnorm(x, ln1))`` then ``x +
moe(rmsnorm(x, ln2))``, the final norm and the head (the embedding's
transpose when tied), logits over the padded vocabulary.  The MoE layer
is :func:`perfbench.reference.common.moe_layer`: each call of the
port's dispatch (a prefill, a decode step, a train step's forward) is a
``segment`` of positions whose tokens are grouped together, batch row
by batch row, as the port flattens them.
"""

from __future__ import annotations

import torch

from perfbench.reference import common as C


def _vocab_padded(m: dict) -> int:
    mult = max(m["pad_vocab_multiple"], 1)
    return -(-m["vocab"] // mult) * mult


def param_shapes(m: dict) -> dict:
    """name -> shape, as the port's module names its parameters."""
    d, hd = m["d_model"], m["head_dim"] or m["d_model"] // m["n_heads"]
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    e, f = m["n_experts"], m["d_ff_expert"] or m["d_ff"]
    vp = _vocab_padded(m)
    out = {"embed": (vp, d)}
    for i in range(m["n_layers"]):
        b = f"blocks.{i}."
        out[b + "ln1"] = (d,)
        out.update({b + "attn.wq": (d, hq), b + "attn.wk": (d, hkv),
                    b + "attn.wv": (d, hkv), b + "attn.wo": (hq, d)})
        if m["qkv_bias"]:
            out.update({b + "attn.bq": (hq,), b + "attn.bk": (hkv,),
                        b + "attn.bv": (hkv,)})
        out[b + "ln2"] = (d,)
        if m["family"] == "moe":
            out.update({b + "moe.router": (d, e), b + "moe.w_in": (e, d, f),
                        b + "moe.w_gate": (e, d, f),
                        b + "moe.w_out": (e, f, d)})
            if m["n_shared_experts"]:
                fs = f * m["n_shared_experts"]
                out.update({b + "moe.shared.w_in": (d, fs),
                            b + "moe.shared.w_out": (fs, d)})
                if m["glu"]:
                    out[b + "moe.shared.w_gate"] = (d, fs)
        else:
            out.update({b + "mlp.w_in": (d, m["d_ff"]),
                        b + "mlp.w_out": (m["d_ff"], d)})
            if m["glu"]:
                out[b + "mlp.w_gate"] = (d, m["d_ff"])
    out["ln_f"] = (d,)
    if not m["tie_embeddings"]:
        out["lm_head"] = (d, vp)
    return out


def _ffn(h, w: dict, m: dict, prec: str, segments: list):
    """The block's feed-forward half over ``h`` ``[B,S,D]``."""
    if m["family"] != "moe":
        return C.mlp(h, C.sub(w, "mlp."), m, prec), h.new_zeros(())
    moe = C.sub(w, "moe.")
    bsz, _, d = h.shape
    parts, aux = [], h.new_zeros(())
    for a, b in segments:
        x = h[:, a:b].reshape(-1, d)
        y, la = C.moe_layer(x, moe, m, prec)
        if m["n_shared_experts"]:
            y = y + C.mlp(x, C.sub(moe, "shared."), m, prec)
        parts.append(y.reshape(bsz, b - a, d))
        aux = aux + la
    return torch.cat(parts, dim=1), aux


def _block(x, w: dict, m: dict, prec: str, segments: list, rows: int):
    x = C.attention_block(x, w, m, prec, rows)
    y, aux = _ffn(C.rmsnorm(x, w["ln2"], m["norm_eps"]), w, m, prec,
                  segments)
    return x + y, aux


def hidden(params: dict, tokens, m: dict, prec: str, segments=None,
           rows: int = 0):
    """The final hidden states ``[B,S,D]`` (before the final norm) and
    the summed load-balancing loss.  ``segments``: the calls' position
    ranges (default one call over every position)."""
    segments = segments or [(0, tokens.shape[1])]
    x = params["embed"][tokens.long()]
    aux = x.new_zeros(())
    for i in range(m["n_layers"]):
        w = C.sub(params, f"blocks.{i}.")
        x, a = C.checkpointed(
            lambda x_, w_=w: _block(x_, w_, m, prec, segments, rows), x)
        aux = aux + a
    return x, aux


def head(params: dict, x, m: dict, prec: str):
    w = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    return C.mm(C.rmsnorm(x, params["ln_f"], m["norm_eps"]), w, prec)


def forward(params: dict, tokens, m: dict, prec: str, segments=None):
    """(logits ``[B,S,Vp]``, load-balancing loss)."""
    x, aux = hidden(params, tokens, m, prec, segments)
    return head(params, x, m, prec), aux


def train_loss(params: dict, tokens, labels, m: dict, prec: str,
               z_loss: float):
    """The port's training loss: cross-entropy with the z-loss, plus
    ``router_aux_coef`` times the layers' load-balancing loss."""
    logits, aux = forward(params, tokens, m, prec)
    return C.loss(logits, labels, z_loss) + m["router_aux_coef"] * aux


@torch.no_grad()
def logits_at(params: dict, tokens, m: dict, prec: str, positions,
              segments=None, rows: int = 2):
    """The logits ``[B,len(positions),Vp]`` at ``positions``."""
    x, _ = hidden(params, tokens, m, prec, segments, rows)
    return head(params, x[:, list(positions)], m, prec)
