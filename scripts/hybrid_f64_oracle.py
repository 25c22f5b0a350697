"""A float64 oracle for the hybrid family's float32 gap (ROADMAP C11).

The reference hybrid (``repro.models.hybrid``) evaluated in float64 with
jax x64 on the CPU is the oracle: its own code, with every float32 cast
it makes (the norms, softplus(dt), the SSD scan, RoPE, the attention
scores) lifted to float64, on the float32 weights cast exactly to
float64.  It runs in a subprocess of its own (``--oracle``), so that x64
never reaches the process that evaluates the float32 models.  The two
float32 models, the reference and the port (``repro_torch``, on the
CPU, whose kernels run their plain versions), are then held to it layer
by layer: the hidden state after every Mamba2 layer and after every
shared-block application, and the logits.

Two gaps per layer and package, each the largest absolute difference
from the oracle over the whole ``[B, S, D]`` hidden state:

* ``carried``: each float32 model runs from the tokens, so a layer's
  gap holds what every layer before it left;
* ``local``: each float32 layer gets the oracle's input to that layer,
  rounded to float32, so the gap is the layer's own.

The shape is ``test_torch_hybrid.py``'s: 14 layers (2 super-blocks of 6
Mamba2 layers, one shared-block application, 2 trailing layers), head
dim 128, d_ff 4 d_model, vocab 2048, 2 x 256 tokens.

    PYTHONPATH=src python scripts/hybrid_f64_oracle.py [--d-model 256 1024]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import types

import numpy as np

N_LAYERS = 14
SEQ = 256
VOCAB = 2048
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def config_kw(d_model: int) -> dict:
    return dict(n_layers=N_LAYERS, d_model=d_model, n_heads=d_model // 128,
                n_kv_heads=d_model // 128, d_ff=4 * d_model, vocab=VOCAB,
                remat=False)


def tokens() -> np.ndarray:
    return np.random.default_rng(1).integers(1, VOCAB, (2, SEQ)) \
        .astype(np.int32)


def layer_names(n_super: int, period: int, rem: int) -> list:
    """The recorded points in forward order."""
    names = []
    for a in range(n_super):
        if a:
            names.append(f"shared.{a}")
        names += [f"main.{a}.{j}" for j in range(period)]
    return names + [f"trailing.{r}" for r in range(rem)] + ["logits"]


# ------------------------------------------------------------- reference
def _ref_modules():
    from repro.models import attention, common, hybrid, mamba2, mlp
    return (attention, common, hybrid, mamba2, mlp)


def _lift_to_float64() -> None:
    """Point the reference modules' ``jnp`` at a namespace whose float32
    is float64, so each float32 cast the reference makes becomes a
    float64 one.  Only in the oracle's own process (x64 on)."""
    import jax.numpy as jnp

    class F64(types.SimpleNamespace):
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    for mod in _ref_modules():
        mod.jnp = F64()


def ref_layers(params, toks, cfg, feed=None) -> dict:
    """The reference's hidden state after each recorded point.  ``feed``
    (a dict of the oracle's states): each layer starts from the oracle's
    state before it, cast to ``cfg.dtype`` (the ``local`` gaps)."""
    import jax
    import jax.numpy as jnp
    _, common, hybrid, mamba2, _ = _ref_modules()
    n_super, period, rem, _ = hybrid.hybrid_layout(cfg)
    names = layer_names(n_super, period, rem)
    x = params["embed"].astype(cfg.dtype)[jnp.asarray(toks)]
    bsz, seq, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(seq)[None, :], (bsz, seq))
    out, prev = {}, None

    def start(x):
        if feed is None or prev is None:
            return x
        return jnp.asarray(feed[prev], cfg.dtype)

    def mamba(x, lp):
        hn = common.rmsnorm(x, lp["ln"].astype(cfg.dtype), cfg.norm_eps)
        y, _ = mamba2.mamba2_forward(lp["mamba"], hn, cfg)
        return x + y

    layers = []
    for a in range(n_super):
        if a:
            layers.append(("shared", None))
        layers += [("mamba", jax.tree_util.tree_map(
            lambda t, a=a, j=j: t[a, j], params["main"]))
            for j in range(period)]
    layers += [("mamba", jax.tree_util.tree_map(
        lambda t, r=r: t[r], params["trailing"])) for r in range(rem)]
    for name, (kind, lp) in zip(names, layers):
        x = start(x)
        if kind == "shared":
            x, _ = hybrid._shared_block(params["shared"], x, cfg, positions)
        else:
            x = mamba(x, lp)
        out[name] = np.asarray(x, np.float64)
        prev = name
    x = start(x)
    x = common.rmsnorm(x, params["ln_f"].astype(cfg.dtype), cfg.norm_eps)
    out["logits"] = np.asarray(
        jnp.einsum("bsd,dv->bsv", x, params["lm_head"].astype(cfg.dtype)),
        np.float64)
    return out


def ref_params(d_model: int, dtype):
    """The reference's float32 weights from seed 0, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs.zamba2_7b import CONFIG
    from repro.models import registry
    cfg = CONFIG.scaled(dtype=jnp.float32, **config_kw(d_model))
    params = registry.init_params(cfg, 0)
    return jax.tree_util.tree_map(np.asarray, params), \
        CONFIG.scaled(dtype=dtype, **config_kw(d_model))


def oracle_main(path: str, d_model: int) -> None:
    """The float64 states, written to ``path``; the float32 weights are
    read from it first (drawn without x64: under x64 ``jax.random`` draws
    other values).  This process runs with x64 on."""
    import jax
    import jax.numpy as jnp
    from repro.configs.zamba2_7b import CONFIG
    from repro.models import registry
    if not jax.config.jax_enable_x64:
        raise SystemExit("the oracle needs JAX_ENABLE_X64=1")
    cfg = CONFIG.scaled(dtype=jnp.float64, param_dtype=jnp.float64,
                        **config_kw(d_model))
    shapes = jax.eval_shape(lambda: registry.init_params(cfg, 0))
    with np.load(path) as f:
        leaves = [jnp.asarray(f[f"w{i}"], jnp.float64)
                  for i in range(len(f.files))]
    if [a.shape for a in leaves] != [a.shape for a in
                                     jax.tree_util.tree_leaves(shapes)]:
        raise SystemExit("the weights do not match the config")
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), leaves)
    _lift_to_float64()
    np.savez(path, **ref_layers(params, tokens(), cfg))


def start_oracle(params, d_model: int, tmp: str):
    """Starts the oracle's subprocess (x64 on) for the reference's float32
    weights ``params`` at ``d_model``; :func:`oracle_result` waits for it
    and reads its float64 states."""
    import jax
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    path = os.path.join(tmp, f"oracle_{d_model}.npz")
    np.savez(path, **{f"w{i}": a for i, a in
                      enumerate(jax.tree_util.tree_leaves(params))})
    return path, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--oracle", path,
         "--d-model", str(d_model)], env=env)


def oracle_result(started) -> dict:
    path, proc = started
    if proc.wait() != 0:
        raise RuntimeError(f"the float64 oracle failed ({proc.returncode})")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------------ port
def port_layers(model, toks, cfg, feed=None) -> dict:
    """The port's hidden state after each recorded point, as
    :func:`ref_layers`."""
    import torch
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.hybrid import _groups, hybrid_layout
    from repro_torch.models.transformer import _positions, block_forward
    names = layer_names(*hybrid_layout(cfg)[:3])
    w = model.weights()
    tt = torch.from_numpy(toks)
    x = w["embed"][tt.long()]
    positions = _positions(tt)
    out, prev, it = {}, None, iter(names)

    def start(x):
        if feed is None or prev is None:
            return x
        return torch.from_numpy(feed[prev]).to(cfg.dtype)

    with torch.no_grad():
        for a, layers in _groups(model, w["ln"]):
            if a:
                name = next(it)
                x, _ = block_forward(w["shared"], start(x), cfg, positions)
                out[name], prev = x.double().numpy(), name
            for layer, ln, _ in layers:
                name = next(it)
                x = start(x)
                y, _ = layer.mamba(rmsnorm(x, ln, cfg.norm_eps))
                x = x + y
                out[name], prev = x.double().numpy(), name
        x = rmsnorm(start(x), w["ln_f"], cfg.norm_eps) @ w["head"]
        out["logits"] = x.double().numpy()
    return out


def gaps(d_models, local: bool = True) -> dict:
    """``{d_model: {(package, kind): {point: gap}}}`` for package in ref,
    port and kind in carried and, with ``local``, local; plus ``("scale",
    "")``: the oracle's largest |value| per point.  The oracles of all
    widths run at once, beside the float32 models."""
    import jax.numpy as jnp
    import torch
    from repro_torch.configs.zamba2_7b import CONFIG as PORT_CONFIG
    from repro_torch.models.convert import hybrid_from_reference
    toks, out = tokens(), {}
    weights = {d: ref_params(d, jnp.float32) for d in d_models}
    with tempfile.TemporaryDirectory() as tmp:
        started = {d: start_oracle(weights[d][0], d, tmp) for d in d_models}
        for d in d_models:
            params, jc = weights[d]
            tc = PORT_CONFIG.scaled(dtype=torch.float32, **config_kw(d))
            model = hybrid_from_reference(params, tc, device="cpu")
            got = {("ref", "carried"): ref_layers(params, toks, jc),
                   ("port", "carried"): port_layers(model, toks, tc)}
            want = oracle_result(started[d])
            if local:
                got[("ref", "local")] = ref_layers(params, toks, jc, want)
                got[("port", "local")] = port_layers(model, toks, tc, want)
            out[d] = {key: {k: float(np.abs(v[k] - want[k]).max())
                            for k in want} for key, v in got.items()}
            out[d][("scale", "")] = {k: float(np.abs(v).max())
                                     for k, v in want.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--d-model", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--oracle", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.oracle:
        oracle_main(args.oracle, args.d_model[0])
        return
    for d_model, g in gaps(args.d_model).items():
        names = list(g[("scale", "")])
        print(f"d_model {d_model}: largest |difference| from the float64 "
              f"oracle (carried: from the tokens; local: from the oracle's "
              f"input to the layer)")
        print(f"{'layer':>12} {'max|x|':>9} {'ref carried':>12} "
              f"{'port carried':>12} {'ref local':>10} {'port local':>10}")
        for k in names:
            print(f"{k:>12} {g[('scale', '')][k]:9.3f} "
                  f"{g[('ref', 'carried')][k]:12.3e} "
                  f"{g[('port', 'carried')][k]:12.3e} "
                  f"{g[('ref', 'local')][k]:10.3e} "
                  f"{g[('port', 'local')][k]:10.3e}")


if __name__ == "__main__":
    main()
