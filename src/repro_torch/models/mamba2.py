"""Mamba2 block — State Space Duality (SSD), arXiv:2405.21060.

Counterpart of ``repro/models/mamba2.py``: the chunked SSD scan for a
full sequence (its within-chunk block is the CUDA kernel B3 of
:mod:`repro_torch.kernels.ssd_scan`), the O(1) one-token update for
decode, and the block around them with split projections and a
per-part depthwise causal conv.  The dtype casts sit where the
reference puts them: activations in ``cfg.dtype``, softplus(dt) and the
SSD in float32, the ``y + xh * d_skip`` add in ``cfg.dtype``.

Parameters are float32 masters (``cfg.param_dtype``) under the
reference's names.  The reference casts a weight to ``cfg.dtype`` at
each use; :meth:`Mamba2Block.weights` casts each once and keeps the
copies until the module moves or is reloaded, which gives the same
numbers; training passes copies cast anew with gradients
(:meth:`Mamba2Block._cast`), so the gradient reaches the masters
through B3's and B4's backward kernels.  The five input projections
share one product against their concatenated weights (five products
on the dry run's DTensors, each sharded on its own).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan_op
from repro_torch.models.common import (CastCache, ModelConfig, constrain,
                                       dense_init, dp_spec, is_sharded,
                                       normal, rmsnorm, split_product)
from repro_torch.sharding.local import (channels_per_rank, heads_view, pin,
                                        ssd_per_rank, ssd_step_per_rank)


# ----------------------------------------------------------------- SSD core
def ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan; the within-chunk block runs on kernel B3.

    x ``[B,S,H,P]``, dt ``[B,S,H]`` (post-softplus), a_log ``[H]``,
    b/c ``[B,S,G,N]`` per group (G dividing H; the reference takes them
    broadcast to the heads, ``[B,S,H,N]``, which is G = H),
    init_state ``[B,H,N,P]`` or None.  Returns ``(y [B,S,H,P],
    final_state [B,H,N,P])``.  bf16 x, B and C take B3's tensor-core
    route (:mod:`repro_torch.kernels.ssd_scan`).
    """
    if is_sharded(x):
        return ssd_per_rank(ssd_scan_op, x, dt, a_log, b_mat, c_mat,
                            init_state, chunk=chunk)
    return ssd_scan_op(x, dt, a_log, b_mat, c_mat, chunk,
                       init_state=init_state)


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t):
    """One-token SSD update.  state ``[B,H,N,P]``; x_t ``[B,H,P]``;
    dt_t ``[B,H]``; b_t/c_t ``[B,H,N]``.  Returns ``(y_t [B,H,P],
    new_state)``."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    da = torch.exp(dt_t.to(f32) * a)                          # [B,H]
    upd = b_t.to(f32)[..., :, None] * \
        (x_t * dt_t[..., None]).to(f32)[..., None, :]         # [B,H,N,P]
    new_state = da[..., None, None] * state + upd
    y = torch.einsum("bhn,bhnp->bhp", c_t.to(f32), new_state)
    return y.to(x_t.dtype), new_state


# ------------------------------------------------------------- Mamba2 block
class Mamba2State(NamedTuple):
    ssm: torch.Tensor     # [B,H,N,P] fp32
    conv_x: torch.Tensor  # [B, conv-1, d_inner]
    conv_b: torch.Tensor  # [B, conv-1, G*N]
    conv_c: torch.Tensor  # [B, conv-1, G*N]


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    heads = d_inner // cfg.ssm_head_dim
    groups = 1
    return d, d_inner, heads, groups, cfg.ssm_state


def _causal_conv(x, prev, w, b, dtype):
    """Depthwise causal conv along seq.  x ``[B,S,C]``; prev
    ``[B,K-1,C]``; w ``[K,C]`` float32; returns ``(y [B,S,C], new_prev
    [B,K-1,C])``.  The taps are summed in float32 and rounded once.  On
    DTensors it runs per rank over each rank's channels."""
    if is_sharded(x):
        return channels_per_rank(_causal_conv, x, prev, w, b, dtype=dtype)
    k, s = w.shape[0], x.shape[1]
    xpad = torch.cat([prev.to(dtype), x], dim=1)
    new_prev = xpad[:, s:, :]
    acc = xpad[:, 0:s].float() * w[0]
    for i in range(1, k):
        acc.addcmul_(xpad[:, i:i + s].float(), w[i])
    return F.silu(acc.to(dtype) + b.to(dtype)), new_prev


def _conv_step(win, w, b, dtype):
    """win ``[B,K,C]`` (already includes the new sample at the end);
    w ``[K,C]`` float32."""
    y = torch.einsum("bkc,kc->bc", win.float(), w)
    return F.silu(y.to(dtype) + b.to(dtype))


#: weights the reference casts to ``cfg.dtype`` at use; the conv taps
#: are kept as float32 copies of those values, for the float32 tap sum;
#: ``a_log`` and ``dt_bias`` the reference reads in float32
_IN_PROJ = ("w_z", "w_x", "w_b", "w_c", "w_dt")
_CAST = ("conv_x_b", "conv_bb", "conv_cb", "d_skip", "norm_g", "out_proj")
_TAPS = ("conv_x_w", "conv_b_w", "conv_c_w")
_F32 = ("a_log", "dt_bias")


class Mamba2Block(CastCache):
    """One Mamba2 mixer; ``forward`` is the reference's
    ``mamba2_forward``, :meth:`decode` its ``mamba2_decode``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, d_inner, heads, groups, n = _dims(cfg)
        self.dims = (d, d_inner, heads, groups, n)
        k, pd = cfg.ssm_conv, cfg.param_dtype
        shapes = {
            "w_z": (d, d_inner), "w_x": (d, d_inner),
            "w_b": (d, groups * n), "w_c": (d, groups * n),
            "w_dt": (d, heads),
            "conv_x_w": (k, d_inner), "conv_b_w": (k, groups * n),
            "conv_c_w": (k, groups * n),
            "conv_x_b": (d_inner,), "conv_bb": (groups * n,),
            "conv_cb": (groups * n,),
            "a_log": (heads,), "d_skip": (heads,), "dt_bias": (heads,),
            "norm_g": (d_inner,), "out_proj": (d_inner, d),
        }
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape, dtype=pd,
                                               device=device),
                                   requires_grad=False))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Mamba2Block":
        """Random weights from ``gen``, as the reference's
        ``init_mamba2`` lays them out (other draws: ``jax.random`` and
        ``torch.Generator`` differ).  Each tensor is drawn on the host and
        copied to the block's device as it is drawn."""
        d, d_inner, heads, groups, n = self.dims
        k, pd = self.cfg.ssm_conv, self.cfg.param_dtype
        for name in _IN_PROJ:
            w = getattr(self, name)
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], pd))
        self.out_proj.copy_(dense_init(gen, d_inner, d, pd))
        for name in _TAPS:
            w = getattr(self, name)
            w.copy_(normal(gen, w.shape, 1.0 / math.sqrt(k), pd))
        for name in ("conv_x_b", "conv_bb", "conv_cb"):
            getattr(self, name).zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, heads)))
        self.d_skip.fill_(1.0)
        self.dt_bias.fill_(math.log(math.e - 1.0))
        self.norm_g.fill_(1.0)
        self._cw = None
        return self

    def _cast(self) -> dict:
        dt_ = self.cfg.dtype
        w = {name: getattr(self, name).to(dt_) for name in _CAST}
        w.update({name: getattr(self, name).to(dt_).float()
                  for name in _TAPS})
        w.update({name: getattr(self, name).float() for name in _F32})
        ws = [getattr(self, n) for n in _IN_PROJ]
        w["w_in"] = (tuple(t.to(dt_) for t in ws) if is_sharded(ws[0])
                     else torch.cat(ws, dim=1).to(dt_))
        return w

    def _project(self, x, w_in):
        """The five input projections of ``x``."""
        d, d_inner, heads, groups, n = self.dims
        return split_product(x, w_in, [d_inner, d_inner, groups * n,
                                       groups * n, heads])

    def forward(self, x: torch.Tensor,
                init_state: Mamba2State | None = None, *,
                w: dict | None = None):
        """Full-sequence forward.  x ``[B,S,D]``; ``w``: the compute dict
        (default the serving cache, :meth:`weights`; training passes
        :meth:`_cast` copies made with gradients).  Returns ``(y, final
        Mamba2State)``, under the caller's grad mode."""
        d, d_inner, heads, groups, n = self.dims
        cfg = self.cfg
        w = self.weights() if w is None else w
        x = constrain(x, dp_spec(x), None, None)
        bsz, seq, _ = x.shape
        dt_, k = cfg.dtype, cfg.ssm_conv
        z, xs, bm, cm, dt_raw = self._project(x, w["w_in"])

        if init_state is None:
            def zpad(ch):
                return torch.zeros(bsz, k - 1, ch, dtype=dt_, device=x.device)
            prev_x, prev_b, prev_c = zpad(d_inner), zpad(groups * n), \
                zpad(groups * n)
        else:
            prev_x, prev_b, prev_c = (init_state.conv_x, init_state.conv_b,
                                      init_state.conv_c)
        xs, new_px = _causal_conv(xs, prev_x, w["conv_x_w"], w["conv_x_b"],
                                  dt_)
        bm, new_pb = _causal_conv(bm, prev_b, w["conv_b_w"], w["conv_bb"],
                                  dt_)
        cm, new_pc = _causal_conv(cm, prev_c, w["conv_c_w"], w["conv_cb"],
                                  dt_)

        xh = heads_view(xs, heads, cfg.ssm_head_dim)
        dt = F.softplus(dt_raw.float() + w["dt_bias"])

        # B and C per group: the scan reads group h // (H/G) for head h
        y, ssm_final = ssd_chunked(
            xh, dt, w["a_log"], bm.reshape(bsz, seq, groups, n),
            cm.reshape(bsz, seq, groups, n), cfg.ssm_chunk,
            init_state.ssm if init_state is not None else None)
        y = y + xh * w["d_skip"][None, None, :, None]
        y = y.reshape(bsz, seq, d_inner)
        if is_sharded(y):
            y = pin(y)
        y = rmsnorm(y * F.silu(z), w["norm_g"], cfg.norm_eps)
        out = y @ w["out_proj"]
        out = constrain(out, dp_spec(out), None, None)
        return out, Mamba2State(ssm=ssm_final, conv_x=new_px, conv_b=new_pb,
                                conv_c=new_pc)

    def decode(self, x_t: torch.Tensor, state: Mamba2State):
        """One-token decode.  x_t ``[B,1,D]``."""
        d, d_inner, heads, groups, n = self.dims
        cfg, w = self.cfg, self.weights()
        x_t = constrain(x_t, dp_spec(x_t), None, None)
        bsz = x_t.shape[0]
        dt_ = cfg.dtype
        z, xs, bm, cm, dt_raw = self._project(x_t, w["w_in"])
        xs, bm, cm, dt_raw = xs[:, 0], bm[:, 0], cm[:, 0], dt_raw[:, 0]

        def upd(prev, new):
            win = torch.cat([prev.to(dt_), new[:, None, :]], dim=1)
            return win, win[:, 1:, :]

        win_x, new_px = upd(state.conv_x, xs)
        win_b, new_pb = upd(state.conv_b, bm)
        win_c, new_pc = upd(state.conv_c, cm)
        xs = _conv_step(win_x, w["conv_x_w"], w["conv_x_b"], dt_)
        bm = _conv_step(win_b, w["conv_b_w"], w["conv_bb"], dt_)
        cm = _conv_step(win_c, w["conv_c_w"], w["conv_cb"], dt_)

        xh = heads_view(xs, heads, cfg.ssm_head_dim)
        rep = heads // groups
        b_h = bm.reshape(bsz, groups, n).repeat_interleave(rep, dim=1)
        c_h = cm.reshape(bsz, groups, n).repeat_interleave(rep, dim=1)
        dt = F.softplus(dt_raw.float() + w["dt_bias"])
        if is_sharded(xh):
            y, ssm_new = ssd_step_per_rank(ssd_decode_step, state.ssm, xh,
                                           dt, w["a_log"], b_h, c_h)
        else:
            y, ssm_new = ssd_decode_step(state.ssm, xh, dt, w["a_log"], b_h,
                                         c_h)
        y = y + xh * w["d_skip"][None, :, None]
        y = y.reshape(bsz, 1, d_inner)
        y = rmsnorm(y * F.silu(z), w["norm_g"], cfg.norm_eps)
        out = y @ w["out_proj"]
        out = constrain(out, dp_spec(out), None, None)
        return out, Mamba2State(ssm=ssm_new, conv_x=new_px, conv_b=new_pb,
                                conv_c=new_pc)


def init_mamba2_state(cfg: ModelConfig, batch: int,
                      device=None) -> Mamba2State:
    d, d_inner, heads, groups, n = _dims(cfg)
    k = cfg.ssm_conv
    return Mamba2State(
        ssm=torch.zeros(batch, heads, n, cfg.ssm_head_dim,
                        dtype=torch.float32, device=device),
        conv_x=torch.zeros(batch, k - 1, d_inner, dtype=cfg.dtype,
                           device=device),
        conv_b=torch.zeros(batch, k - 1, groups * n, dtype=cfg.dtype,
                           device=device),
        conv_c=torch.zeros(batch, k - 1, groups * n, dtype=cfg.dtype,
                           device=device),
    )
