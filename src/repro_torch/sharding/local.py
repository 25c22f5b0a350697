"""Per-rank regions of the models on DTensors (the dry run's).

The reference leaves every layout change to GSPMD.  The port runs its
models eagerly on DTensors, and a few regions are local by nature but
have no DTensor sharding strategy, or one that cannot follow a layout
the rules produce: the attention core (the flash kernel B2 is a per-rank
kernel), the Mamba2 depthwise conv (per channel) and the SSD scan
(B3; per head).  :func:`per_rank` runs such a
region on each rank's local shards (``local_map``) after bringing its
inputs to the placements the region needs, with every move a DTensor
redistribution, so the tracer counts it.  :func:`write_positions`
writes positions into a sequence-sharded cache in place, on the ranks
that hold them.

Nothing here runs on the card's paths, whose tensors are plain.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def batch_dims(t: DTensor) -> list:
    """The mesh dims that shard ``t``'s first dim."""
    return [n for n, p in zip(t.device_mesh.mesh_dim_names, t.placements)
            if isinstance(p, Shard) and p.dim == 0]


def layout(t: DTensor, batch: list, model) -> tuple:
    """Placements for a tensor on ``t``'s mesh: dim 0 over the mesh dims
    ``batch``, ``model`` (a placement) on the "model" dim, replicated
    elsewhere."""
    out = []
    for name in t.device_mesh.mesh_dim_names:
        if name in batch:
            out.append(Shard(0))
        elif name == "model" and model is not None:
            out.append(model)
        else:
            out.append(Replicate())
    return tuple(out)


def model_size(t: DTensor) -> int:
    names = t.device_mesh.mesh_dim_names
    if "model" not in names:
        return 1
    return t.device_mesh.size(names.index("model"))


def as_dtensor(x, like: DTensor, placements: tuple):
    """A plain tensor ``x`` (the same on every rank) as a DTensor on
    ``like``'s mesh, then moved to ``placements``."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements)
    mesh = like.device_mesh
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


def per_rank(fn, args: tuple, in_placements: tuple, out_placements,
             **kwargs):
    """``fn(*local args, **kwargs)`` on each rank's shards, the DTensor
    ``args`` first redistributed to ``in_placements`` (None for an
    argument that is not a tensor); the result is a DTensor with
    ``out_placements`` (a tuple of placements), or, for a list of them,
    a tuple of DTensors."""
    args = tuple(a if p is None else a.redistribute(a.device_mesh, p)
                 for a, p in zip(args, in_placements))
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    outs = (tuple(list(p) for p in out_placements)
            if isinstance(out_placements, list) else list(out_placements))
    return local_map(functools.partial(fn, **kwargs), out_placements=outs,
                     in_placements=in_placements, device_mesh=mesh)(*args)


def attention_layout(q: DTensor, k: DTensor, gather_kv: bool = False):
    """The model-dim placements ``(q's, k's and v's)`` under which the
    attention core of q ``[B,Sq,H,hd]`` over k, v ``[B,Skv,Hkv,hd]`` is
    local to each rank, or None where it is not: heads over "model"
    where q and kv heads pair one to one and divide; else q over its
    positions, k and v replicated; else both replicated.  None where k's
    positions are sharded (a decode step over a sequence-sharded cache,
    left to DTensor's propagation), unless ``gather_kv``: then they are
    gathered."""
    if not gather_kv and any(isinstance(p, Shard) and p.dim == 1
                             for p in k.placements):
        return None
    m = model_size(q)
    heads, kv_heads, sq = q.shape[2], k.shape[2], q.shape[1]
    if m == 1:
        return Replicate(), Replicate()
    if heads == kv_heads and heads % m == 0:
        return Shard(2), Shard(2)
    if sq % m == 0 and sq >= m:
        return Shard(1), Replicate()
    return Replicate(), Replicate()


def attention_per_rank(fn, q, k, v, *extra, gather_kv: bool = False,
                       **kwargs):
    """``fn(q, k, v, *extra, **kwargs)``, an attention core, per rank
    under :func:`attention_layout` (its batch over q's data dims;
    ``extra``: per-row tensors ``[B]``, e.g. valid lengths, sharded
    likewise), or None where the core is not local.  A q over its
    positions keeps the kernel's own causal mask per rank: the tracer
    reads costs, which the mask does not change, not values."""
    plan = attention_layout(q, k, gather_kv)
    if plan is None:
        return None
    batch = batch_dims(q)
    pq, pkv = layout(q, batch, plan[0]), layout(q, batch, plan[1])
    prow = layout(q, batch, None)
    extra = tuple(as_dtensor(e, q, prow) for e in extra)
    out = per_rank(fn, (q, k, v) + extra,
                   (pq, pkv, pkv) + (prow,) * len(extra), pq, **kwargs)
    if plan[0] != Shard(1):
        return out
    # positions back together before the output projection, whose
    # product would merge the batch and position shards: the heads over
    # "model" where they divide, else every head on every rank
    heads = Shard(2) if q.shape[2] % model_size(q) == 0 else None
    return out.redistribute(out.device_mesh, layout(q, batch, heads))


def local_shape_offset(shape, mesh, placements) -> tuple:
    """This rank's shard of a tensor of ``shape``: ``(local shape, global
    offset)``, chunks as ``torch.chunk`` cuts them, from the rank's mesh
    coordinate (no tensor is read, so it holds under a fake mode)."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for size, index, p in zip(tuple(mesh.shape), coord, placements):
        if isinstance(p, Shard):
            step = -(-shape[p.dim] // size)
            lo = min(index * step, shape[p.dim])
            offset[p.dim] += lo
            shape[p.dim] = min(step, shape[p.dim] - lo)
    return tuple(shape), tuple(offset)


def write_positions(cache: DTensor, new, start: int) -> None:
    """``cache[:, start:start + S] = new`` in place, where ``cache``
    ``[B,Smax,...]`` may be sharded over its positions: each rank writes
    the positions it holds (in the fake world, rank 0's program)."""
    mesh = cache.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in cache.placements)
    src = as_dtensor(new, cache, want).to_local()
    shape, offset = local_shape_offset(cache.shape, mesh, cache.placements)
    seq = new.shape[1]
    lo = max(start, offset[1])
    hi = min(start + seq, offset[1] + shape[1])
    if lo < hi:
        cache.to_local()[:, lo - offset[1]:hi - offset[1]] = \
            src[:, lo - start:hi - start].to(cache.dtype)


def channels_per_rank(fn, x: DTensor, *args, **kwargs):
    """``fn(x, *args)``, channel-wise over x's last dim, per rank: x
    ``[B,S,C]`` as it is laid out (its batch and "model" placements of
    the channels kept), ``args`` (``[..., C]`` weights or ``[B,K,C]``
    states) laid out to match; returns ``fn``'s tuple of results, each
    ``[B?, ..., C]`` as x."""
    batch = batch_dims(x)
    chan = any(n == "model" and p == Shard(x.ndim - 1) for n, p in
               zip(x.device_mesh.mesh_dim_names, x.placements))
    px = layout(x, batch, Shard(x.ndim - 1) if chan else None)

    def lay(a):
        if a.ndim == x.ndim:            # a per-row state
            return layout(x, batch, Shard(a.ndim - 1) if chan else None)
        return layout(x, [], Shard(a.ndim - 1) if chan else None)

    args = tuple(as_dtensor(a, x, lay(a)) for a in args)
    return per_rank(fn, (x,) + args, (px,) + tuple(lay(a) for a in args),
                    [px, px], **kwargs)


def heads_view(x, heads: int, head_dim: int):
    """``x`` ``[..., H P]`` viewed as ``[..., H, P]``; a DTensor whose last
    dim is sharded over "model" where the heads do not divide is first
    gathered (the split would cut a head)."""
    shape = (*x.shape[:-1], heads, head_dim)
    if isinstance(x, DTensor) and heads % model_size(x):
        x = x.redistribute(x.device_mesh,
                           layout(x, batch_dims(x), None))
    return x.reshape(shape)


def ssd_per_rank(fn, x, dt, a_log, b_mat, c_mat, init_state, **kwargs):
    """The SSD scan ``fn(x, dt, a_log, b, c, init_state=...)`` per rank: x
    ``[B,S,H,P]`` over its heads where they divide "model", else whole
    on every "model" rank (the scan repeated there); dt, a_log and the
    state ``[B,H,N,P]`` to match; B and C ``[B,S,G,N]`` replicated over
    "model".  Returns ``(y, final state)``."""
    batch = batch_dims(x)
    on_h = Shard(2) if x.shape[2] % model_size(x) == 0 else None
    px = pdt = layout(x, batch, on_h)
    pa = layout(x, [], Shard(0) if on_h else None)
    pbc = layout(x, batch, None)
    pst = layout(x, batch, Shard(1) if on_h else None)
    args = (x, dt, as_dtensor(a_log, x, pa), b_mat, c_mat)
    placements = (px, pdt, pa, pbc, pbc)
    if init_state is None:
        return per_rank(lambda *a, **kw: fn(*a, **kw), args, placements,
                        [px, pst], **kwargs)
    return per_rank(lambda *a, **kw: fn(*a[:5], init_state=a[5], **kw),
                    args + (init_state,), placements + (pst,), [px, pst],
                    **kwargs)


def _model_placement(t: DTensor):
    """``t``'s placement on the "model" dim (None without one)."""
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == "model":
            return p
    return None


def _on_model(t: DTensor, like: DTensor) -> tuple:
    """``t``'s placements with every dim but "model" replicated (an FSDP
    shard of a weight is gathered where it is used)."""
    p = _model_placement(t)
    return layout(like, [], p if isinstance(p, Shard) else None)


def moe_per_rank(fn, w: dict, x: DTensor, cfg):
    """The MoE layer ``fn(w, x, cfg, experts=...)`` per rank: x ``[B,S,D]``
    over its data dims and whole on "model"; the router whole; the expert
    weights on "model" as the rules placed them, their experts (``fn``
    gets the slice of experts a rank holds, and dispatches to those) or
    their ff columns, gathered on every other dim; likewise the shared
    experts' ff columns.  Each rank's output is its experts' or columns'
    share of y (summed over "model"); the aux loss, over its tokens
    (averaged over the data dims).  Returns ``(y, aux)``."""
    from torch.distributed.tensor import Partial
    from torch.utils._pytree import (tree_flatten_with_path,
                                     tree_unflatten)

    batch = batch_dims(x)
    px = layout(x, batch, None)
    flat, spec = tree_flatten_with_path(w)
    leaves, pls = [], []
    experts = slice(None)
    split = False
    for path, t in flat:
        top = getattr(path[0], "key", None)
        pl = layout(x, [], None) if top == "router" else _on_model(t, x)
        if any(isinstance(p, Shard) for p in pl):
            split = True
            if top in ("w_in_gate", "w_out") and t.ndim == 3 and \
                    _model_placement(t) == Shard(0):
                n = t.shape[0] // model_size(x)
                index = x.device_mesh.get_local_rank("model")
                experts = slice(index * n, (index + 1) * n)
        leaves.append(t)
        pls.append(pl)

    def local(x_, *ws):
        return fn(tree_unflatten(list(ws), spec), x_, cfg, experts=experts)

    model = Partial() if split else None
    py = layout(x, batch, model)
    paux = tuple(Partial("avg") if n in batch else Replicate()
                 for n in x.device_mesh.mesh_dim_names)
    return per_rank(local, (x,) + tuple(leaves), (px,) + tuple(pls),
                    [py, paux])


def ssd_step_per_rank(fn, state, x_t, dt_t, a_log, b_t, c_t):
    """One SSD decode step ``fn(state, x_t, dt_t, a_log, b_t, c_t)`` per
    rank, laid out as :func:`ssd_per_rank` lays the scan out: state
    ``[B,H,N,P]``, x_t ``[B,H,P]``, dt_t ``[B,H]``, a_log and b_t, c_t
    ``[B,H,N]`` over the heads where they divide "model", else whole
    there.  Returns ``(y_t, new state)``."""
    batch = batch_dims(x_t)
    on_h = Shard(1) if x_t.shape[1] % model_size(x_t) == 0 else None
    px = pst = pdt = layout(x_t, batch, on_h)
    pa = layout(x_t, [], Shard(0) if on_h else None)
    a_log = as_dtensor(a_log, x_t, pa)
    return per_rank(fn, (state, x_t, dt_t, a_log, b_t, c_t),
                    (pst, px, pdt, pa, pdt, pdt), [px, pst])


def rows_per_rank(v: DTensor, i: int, n: int) -> DTensor:
    """Microbatch ``i`` of ``n`` of a batch ``v`` sharded over its rows:
    the ``i``-th of ``n`` equal parts of each rank's own rows, laid out
    as ``v`` (nothing is sent)."""
    loc = v.to_local()
    m = loc.shape[0] // n
    shape = (v.shape[0] // n, *v.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(loc[i * m:(i + 1) * m], v.device_mesh,
                              v.placements, run_check=False, shape=shape,
                              stride=stride)


def pin(x: DTensor) -> DTensor:
    """``x`` as it is, its gradient brought back to ``x``'s placements:
    put after a view that merges dims, whose backward would otherwise
    get a gradient sharded where the split back cannot follow."""
    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def vocab_logsumexp(lg: DTensor) -> DTensor:
    """``logsumexp(lg, -1)`` of logits ``[B,S,V]`` sharded over the vocab,
    as a vocab-parallel loss takes it: each rank's max over its columns,
    reduced over "model" (a per-row all-reduce), then each rank's sum of
    exponentials, likewise, the logits and their gradient staying on
    each rank's columns."""
    from torch.distributed.tensor import Partial

    batch = batch_dims(lg)
    on_v = any(n == "model" and p == Shard(lg.ndim - 1) for n, p in
               zip(lg.device_mesh.mesh_dim_names, lg.placements))
    plg = layout(lg, batch, Shard(lg.ndim - 1) if on_v else None)
    prow = layout(lg, batch, None)

    def part(op):
        return layout(lg, batch, Partial(op) if on_v else None)

    m = per_rank(lambda x: x.amax(dim=-1, keepdim=True), (lg.detach(),),
                 (plg,), part("max"))
    m = m.redistribute(lg.device_mesh, prow)
    s = per_rank(lambda x, m_: torch.exp(x - m_).sum(dim=-1, keepdim=True),
                 (lg, m), (plg, prow), part("sum"))
    return (m + torch.log(s.redistribute(lg.device_mesh, prow)))[..., 0]


def vocab_gather(lg: DTensor, labels) -> DTensor:
    """``lg[..., labels]`` of logits ``[B,S,V]`` sharded over the vocab,
    per rank: each rank gathers the labels in its columns (zero
    elsewhere), and the ranks' shares are summed over "model"; the
    gather's backward stays on each rank's columns."""
    from torch.distributed.tensor import Partial

    batch = batch_dims(lg)
    on_v = any(n == "model" and p == Shard(lg.ndim - 1) for n, p in
               zip(lg.device_mesh.mesh_dim_names, lg.placements))
    n = lg.shape[-1] // model_size(lg) if on_v else lg.shape[-1]
    lo = lg.device_mesh.get_local_rank("model") * n if on_v else 0

    def local(lg_, labels_):
        idx = labels_.long() - lo
        inside = (idx >= 0) & (idx < n)
        got = torch.gather(lg_, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    plg = layout(lg, batch, Shard(lg.ndim - 1) if on_v else None)
    pl = layout(lg, batch, None)
    out = layout(lg, batch, Partial() if on_v else None)
    return per_rank(local, (lg, as_dtensor(labels, lg, pl)), (plg, pl), out)
