"""The yardstick's work counts: model FLOPs of a step or a served batch,
and the needed operations and bytes of each launch of the kernels B2
(flash attention), B3 (the SSD within-chunk block) and B4 (RMSNorm).

Model FLOPs count the work the model needs (a copy of the port's
``analysis/roofline.py`` ``param_counts_analytic`` and
``model_flops_estimate``, corrected): the products of the active
parameters only (an MoE layer's router and its ``top_k`` experts), each
matrix product once, attention and the SSD over the causal half, no
recomputation, no embedding lookup, the head over the positions whose
logits are needed; a train step is three times its forward.  A served
batch is its prefill, the head at the last position, and the decode
steps whose tokens are kept (``max_new_tokens - 1``).

A kernel launch's bound is the larger of its operations over
:data:`PEAK_FLOPS` and its bytes over :data:`PEAK_BYTES`, each input
read once and each output written once, from the shapes that the
configuration and the traffic fix.  The work counted is what a step
needs, whatever the program launches: a recomputed forward is not
counted again, so recomputation reads as a lower share.
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 80GB data sheet: dense bf16 tensor-core FLOP/s
#: (1,979 with sparsity) and HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}

#: the kernels' names in a device trace, by family
KERNELS = {
    "b2": r"\bflash_(wgmma|kernel|bwd_[a-z_]+)\b",
    "b3": r"\bssd_(wgmma|inner_kernel|bwd_[a-z_]+)\b",
    "b4": r"\brmsnorm_(regs|wide|generic|bwd_[a-z_]+)\b",
}


# ------------------------------------------------------------ model FLOPs
def _hd(m: dict) -> int:
    return m["head_dim"] or m["d_model"] // max(m["n_heads"], 1)


def attn_params(m: dict) -> int:
    d, hd = m["d_model"], _hd(m)
    return d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])


def mlp_params(m: dict, f: int) -> int:
    return m["d_model"] * f * (3 if m["glu"] else 2)


def ssm_dims(m: dict) -> tuple:
    """(d_inner, heads, groups, state)."""
    d_in = m["ssm_expand"] * m["d_model"]
    return d_in, d_in // m["ssm_head_dim"], 1, m["ssm_state"]


def ssm_params(m: dict) -> int:
    d = m["d_model"]
    d_in, heads, groups, n = ssm_dims(m)
    return d * (2 * d_in + 2 * groups * n + heads) + d_in * d


def hybrid_layout(m: dict) -> tuple:
    """(n_super, period, trailing, shared-block applications)."""
    period = m["shared_attn_period"]
    n_super = m["n_layers"] // period
    return n_super, period, m["n_layers"] % period, max(n_super - 1, 0)


def attention_layers(m: dict) -> int:
    if m["family"] in ("dense", "moe"):
        return m["n_layers"]
    if m["family"] == "hybrid":
        return hybrid_layout(m)[3]
    return 0


def ssm_layers(m: dict) -> int:
    return m["n_layers"] if m["family"] in ("ssm", "hybrid") else 0


def token_params(m: dict) -> int:
    """Parameters a token's products use in the layers (no head, no
    embedding)."""
    fam, L = m["family"], m["n_layers"]
    if fam == "dense":
        return L * (attn_params(m) + mlp_params(m, m["d_ff"]))
    if fam == "moe":
        fe = m["d_ff_expert"] or m["d_ff"]
        per = (attn_params(m) + m["top_k"] * mlp_params(m, fe)
               + m["d_model"] * m["n_experts"])
        if m["n_shared_experts"]:
            per += mlp_params(m, fe * m["n_shared_experts"])
        return L * per
    if fam == "ssm":
        return L * ssm_params(m)
    if fam == "hybrid":
        apps = hybrid_layout(m)[3]
        return L * ssm_params(m) + apps * (attn_params(m)
                                           + mlp_params(m, m["d_ff"]))
    raise ValueError(f"no FLOP count for the {fam} family")


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_flops(m: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, every layer."""
    return 4.0 * m["n_heads"] * _hd(m) * pairs * attention_layers(m)


def chunk_len(seq: int, chunk: int) -> int:
    q = min(chunk, seq)
    while seq % q:
        q -= 1
    return q


def ssd_flops(m: dict, seq: int) -> float:
    """One sequence's chunked SSD, every SSM layer: C.B^T per group and
    M.X per head over the causal half of each chunk, the chunk states and
    the entering states' readout."""
    if not ssm_layers(m):
        return 0.0
    _, heads, groups, n = ssm_dims(m)
    p = m["ssm_head_dim"]
    q = chunk_len(seq, m["ssm_chunk"])
    nc = seq // q
    per_chunk = (2.0 * causal_pairs(q) * (groups * n + heads * p)
                 + 2.0 * 2.0 * q * n * p * heads)
    return per_chunk * nc * ssm_layers(m)


def forward_flops(m: dict, batch: int, seq: int, head_rows: int) -> float:
    """A forward over ``batch`` sequences of ``seq`` positions from 0,
    the head over ``head_rows`` positions of each."""
    per_seq = (2.0 * token_params(m) * seq
               + attention_flops(m, causal_pairs(seq)) + ssd_flops(m, seq)
               + 2.0 * m["d_model"] * m["vocab"] * head_rows)
    return batch * per_seq


def decode_flops(m: dict, batch: int, pos: int) -> float:
    """One decode step at position ``pos`` (``pos + 1`` keys)."""
    _, heads, _, n = ssm_dims(m)
    ssm = 4.0 * heads * n * m["ssm_head_dim"] * ssm_layers(m)
    return batch * (2.0 * token_params(m) + attention_flops(m, pos + 1)
                    + ssm + 2.0 * m["d_model"] * m["vocab"])


def train_step_flops(m: dict, traffic: dict) -> float:
    b, s = traffic["batch"], traffic["seq_len"]
    return 3.0 * forward_flops(m, b, s, head_rows=s)


def serve_batch_flops(m: dict, traffic: dict) -> float:
    b, s = traffic["batch"], traffic["seq_len"]
    kept = traffic["max_new_tokens"] - 1
    return forward_flops(m, b, s, head_rows=1) + sum(
        decode_flops(m, b, s + t) for t in range(kept))


def unit_flops(m: dict, traffic: dict) -> float:
    """Model FLOPs of one unit of the mix: a step, or a served batch."""
    if traffic["kind"] == "train":
        return train_step_flops(m, traffic)
    return serve_batch_flops(m, traffic)


# ----------------------------------------------------------- kernel bounds
def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def b2_launch(m: dict, batch: int, seq: int, *, backward: bool) -> float:
    """Causal attention over ``seq`` positions: q, o ``[B,H,S,hd]``, k, v
    ``[B,Hkv,S,hd]`` in the compute dtype, the row logsumexp float32
    (written by a training forward, read by the backward); the backward
    reads q, k, v, o, dO and writes dq, dk, dv, and its operations are
    2.5 times the forward's (S = QK^T again, dP, dV, dQ, dK)."""
    e = _SIZE[m["dtype"]]
    hd, h, hkv = _hd(m), m["n_heads"], m["n_kv_heads"]
    q = batch * h * seq * hd * e
    kv = batch * hkv * seq * hd * e
    lse = batch * h * seq * 4
    fwd_ops = 4.0 * h * hd * causal_pairs(seq) * batch
    if backward:
        return bound_s(2.5 * fwd_ops, 3 * q + 2 * kv + lse + q + 2 * kv)
    return bound_s(fwd_ops, 2 * q + 2 * kv + lse)


def b2_serve_launch(m: dict, batch: int, seq: int) -> float:
    """A prefill's causal attention: no logsumexp written."""
    e = _SIZE[m["dtype"]]
    hd, h, hkv = _hd(m), m["n_heads"], m["n_kv_heads"]
    q = batch * h * seq * hd * e
    kv = batch * hkv * seq * hd * e
    return bound_s(4.0 * h * hd * causal_pairs(seq) * batch, 2 * q + 2 * kv)


def b3_launch(m: dict, batch: int, seq: int, *, backward: bool) -> float:
    """The within-chunk block of one SSM layer: x ``[B,Nc,H,Q,P]`` and
    B, C ``[B,Nc,G,Q,N]`` in the compute dtype, the cumulative decay and
    dt ``[B,Nc,H,Q]`` float32, y ``[B,Nc,H,Q,P]`` and the chunk states
    ``[B,Nc,H,N,P]`` float32; the backward reads those inputs and the
    gradients of y and the states, and writes the inputs' gradients."""
    e = _SIZE[m["dtype"]]
    _, heads, groups, n = ssm_dims(m)
    p = m["ssm_head_dim"]
    q = chunk_len(seq, m["ssm_chunk"])
    nc = seq // q
    x = batch * nc * heads * q * p
    bc = 2 * batch * nc * groups * q * n
    dec = 2 * batch * nc * heads * q
    y = x
    st = batch * nc * heads * n * p
    ops = batch * nc * (2.0 * causal_pairs(q) * (groups * n + heads * p)
                        + 2.0 * q * n * p * heads)
    inputs = e * (x + bc) + 4 * dec
    if backward:
        return bound_s(2.0 * ops, inputs + 4 * (y + st) + inputs)
    return bound_s(ops, inputs + 4 * (y + st))


def b4_launch(m: dict, rows: int, width: int, *, backward: bool) -> float:
    """RMSNorm over ``[rows, width]`` in the compute dtype: x and gamma
    read, y written; the backward reads x, gamma and dy and writes dx and
    dgamma."""
    e = _SIZE[m["dtype"]]
    x, g = rows * width * e, width * e
    if backward:
        return bound_s(0.0, 3 * x + 2 * g)
    return bound_s(0.0, 2 * x + g)


def _norms(m: dict, rows: int, head_rows: int) -> list:
    """(rows, width, count) of a forward's RMSNorms."""
    d, fam = m["d_model"], m["family"]
    out = [(head_rows, d, 1)]
    if fam in ("dense", "moe"):
        out.append((rows, d, 2 * m["n_layers"]))
    elif fam in ("ssm", "hybrid"):
        d_in = ssm_dims(m)[0]
        out += [(rows, d, m["n_layers"]), (rows, d_in, m["n_layers"])]
        if fam == "hybrid":
            out.append((rows, d, 2 * hybrid_layout(m)[3]))
    return out


def kernel_bound_s(m: dict, traffic: dict, family: str) -> float:
    """The least time a unit of the mix (a step, a served batch) needs
    in ``family``'s launches."""
    b, s = traffic["batch"], traffic["seq_len"]
    train = traffic["kind"] == "train"
    if family == "b2":
        n = attention_layers(m)
        if train:
            return n * (b2_launch(m, b, s, backward=False)
                        + b2_launch(m, b, s, backward=True))
        return n * b2_serve_launch(m, b, s)
    if family == "b3":
        n = ssm_layers(m)
        if train:
            return n * (b3_launch(m, b, s, backward=False)
                        + b3_launch(m, b, s, backward=True))
        return n * b3_launch(m, b, s, backward=False)
    if family == "b4":
        if train:
            return sum(c * (b4_launch(m, r, w, backward=False)
                            + b4_launch(m, r, w, backward=True))
                       for r, w, c in _norms(m, b * s, b * s))
        total = sum(c * b4_launch(m, r, w, backward=False)
                    for r, w, c in _norms(m, b * s, b))
        steps = traffic["max_new_tokens"] - 1
        return total + steps * sum(c * b4_launch(m, r, w, backward=False)
                                   for r, w, c in _norms(m, b, b))
    raise ValueError(f"unknown kernel family {family!r}")
