"""Multi-pod dry run — deliverable (e), on DTensors in a fake world.

Counterpart of ``repro/launch/dryrun.py``.  For every (architecture x
input shape) cell, run the production step (``train_step``, the serve
prefill or a decode step) once on the 16x16 single-pod mesh and the
2x16x16 multi-pod mesh, and read from that run what each rank costs:
memory, FLOPs, bytes and the collectives with their groups
(:mod:`repro_torch.analysis.trace_costs`), and the three-term roofline
on the datasheet H100 (:mod:`repro_torch.analysis.roofline`).

The reference lowers and compiles each cell on 512 host devices that XLA
fakes.  Here the world is a ``torch.distributed`` process group of
backend ``"fake"`` (256 or 512 ranks, this process rank 0), the mesh a
``DeviceMesh`` of device type ``"cpu"`` with the reference's dim names,
the parameters, optimizer state, inputs and decode state ``DTensor``\\ s
placed by :mod:`repro_torch.sharding` whose local shards are fake
tensors (nothing is allocated), and the step runs eagerly on them.  On
the CPU every kernel takes its plain version; the report substitutes
the flash kernel's ideal traffic for the attention core's (the ``_flash``
pair), as the reference does.  The world is started inside
:func:`lower_cell`, never at import.

Report keys are the reference's where the quantity exists; per rank:

    mem_args_gb   parameters, optimizer state, the batch and the decode
                  state (``mem_args_bytes``: the same, exact)
    mem_temp_gb   the peak of live storage beyond the arguments (the
                  step's outputs included)
    mem_out_gb    storage the step made that its results still hold
    mem_total_gb  mem_args_gb + mem_temp_gb: the rank's peak
    hlo_flops_scaled, hlo_bytes_scaled   the traced program's FLOPs and
                  bytes (the names kept; nothing is scaled: n_while is 0)
    compute_ms, memory_ms, collective_ms, dominant, collective_intra_gb,
    collective_cross_gb, n_collectives, model_flops, useful_flops_ratio,
    roofline_fraction, attn_scope_bytes, attn_scope_flops,
    memory_ms_flash, roofline_fraction_flash   as the reference's
    attn_saved_bytes   bytes the ``attn_core`` scope saves for the
                  backward pass (new)
    trace_s       wall seconds of the traced run (for the reference's
                  ``lower_s`` and ``compile_s``); ``xla_flops_raw`` has
                  no counterpart and is dropped
    fsdp, microbatch   the policy the cell ran under

Usage (no card needed)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out report.jsonl]
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time
from dataclasses import replace

import torch

from repro_torch.configs import (ARCHS, SHAPES, InputShape, ShapeNotSupported,
                                 get_config, input_specs)
from repro_torch.models.common import Family, ModelConfig

GB = 2 ** 30


def fake_world(size: int) -> None:
    """A ``torch.distributed`` world of ``size`` ranks of backend
    ``"fake"``, this process rank 0; a fake world of another size is
    replaced.  Raises if a real world is running."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} world is running; "
                               f"the dry run needs a fake one")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _build(cfg: ModelConfig):
    """The model's modules, parameters made and never drawn (under the
    caller's fake mode)."""
    from repro_torch.models import encdec, hybrid, ssm_lm, transformer

    if cfg.family in (Family.DENSE, Family.MOE, Family.VLM):
        return transformer.DenseLM(cfg, device="cpu")
    if cfg.family == Family.HYBRID:
        return hybrid.HybridLM(cfg, device="cpu")
    if cfg.family == Family.ENCDEC:
        return encdec.EncDecLM(cfg, device="cpu")
    return ssm_lm.SSMLM(cfg)


def _sharded(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t``'s shape and dtype with ``placements``, its local
    shard a fresh tensor of its own (fake under the caller's mode)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.local import local_shape_offset

    shape, _ = local_shape_offset(t.shape, mesh, placements)
    local = torch.zeros(shape, dtype=t.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place_params(model, cfg, mesh, policy) -> dict:
    from repro_torch.sharding import param_specs

    specs = param_specs(model, cfg, mesh, policy)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = torch.nn.Parameter(
            _sharded(p, mesh, specs[name]), requires_grad=False)
    model._cw = None
    return specs


def _place_tree(tree, specs, mesh):
    """``tree`` with each tensor leaf re-made as a DTensor of its spec
    (``specs``: the same structure, placements at tensor leaves)."""
    if isinstance(tree, torch.Tensor):
        return _sharded(tree, mesh, specs)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_place_tree(t, s, mesh)
                            for t, s in zip(tree, specs)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place_tree(t, s, mesh)
                          for t, s in zip(tree, specs))
    return tree


def _extra_prefix(cfg) -> int:
    if cfg.family == Family.VLM:
        return cfg.img_tokens
    return 0


def _mesh_spec(multi_pod: bool, mesh_override) -> tuple:
    if mesh_override is not None:
        return tuple(mesh_override[0]), tuple(mesh_override[1])
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def lower_cell(arch, shape_name, *, multi_pod: bool = False,
               policy_overrides: dict | None = None,
               mesh_override: tuple | None = None,
               microbatch_override: int | None = None):
    """Run one (arch x shape x mesh) cell on fake DTensors and report it.

    ``arch``: an id of ``ARCHS`` or a ``ModelConfig``; ``shape_name``: a
    key of ``SHAPES`` or an ``InputShape``.  ``mesh_override``:
    ``((shape...), (dim names...))``, another split of the ranks (a fake
    world of its size is started); a mesh of one rank runs the card's
    own program on plain fake tensors, with nothing to place.  Returns
    ``(report dict, costs)`` (the :class:`~repro_torch.analysis.
    trace_costs.TraceCosts`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis.roofline import (flash_adjusted,
                                               model_flops_estimate,
                                               param_counts_analytic,
                                               roofline_terms)
    from repro_torch.analysis.trace_costs import CostTracer
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry
    from repro_torch.sharding import (ShardingPolicy, decode_state_specs,
                                      default_policy, input_specs_sharding)
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import (TrainConfig, auto_microbatch,
                                              train_step)

    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    shape = (shape_name if isinstance(shape_name, InputShape)
             else SHAPES[shape_name])
    specs = input_specs(cfg, shape)          # raises ShapeNotSupported
    mesh_shape, axes = _mesh_spec(multi_pod, mesh_override)
    if math.prod(mesh_shape) > 1:
        fake_world(math.prod(mesh_shape))
        mesh = make_mesh_for(mesh_shape, axes, device_type="cpu")
        policy = default_policy(mesh)
    else:            # one rank runs the card's own program: nothing placed
        mesh = None
        policy = ShardingPolicy(dp_axes=tuple(
            a for a in ("pod", "data") if a in axes))
    # big dense models cannot hold fp32 master+Adam state in TP-only
    # shards: enable FSDP ("d"-dim sharding over dp) when the per-chip
    # optimizer footprint would exceed ~1.5 GB (the reference's switch)
    total_params, _ = param_counts_analytic(cfg)
    tp = dict(zip(axes, mesh_shape))[policy.tp_axis]
    if shape.kind == "train" and total_params * 12.0 / tp > 1.5e9:
        policy = replace(policy, fsdp=True)
    if policy_overrides:
        policy = replace(policy, **policy_overrides)
    mb = 0
    B, S = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        model = _build(cfg)
        if mesh is not None:
            _place_params(model, cfg, mesh, policy)
            ins = input_specs_sharding(specs, cfg, mesh, policy)
            batch = {k: _sharded(v, mesh, ins[k]) for k, v in specs.items()}
        else:
            batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                     for k, v in specs.items()}
        tracer = CostTracer()
        t0 = time.time()
        if shape.kind == "train":
            dp = math.prod(dict(zip(axes, mesh_shape))[a]
                           for a in policy.dp_axes)
            mb = auto_microbatch(cfg, B, S, dp)
            if microbatch_override is not None:
                mb = microbatch_override
            params = dict(model.named_parameters())
            opt = adamw_init(params)
            tracer.track((params, opt, batch))
            with tracer, implicit_replication():
                _, opt, metrics = train_step(model, opt, batch, cfg=cfg,
                                             tcfg=TrainConfig(microbatch=mb))
            costs = tracer.costs(metrics)
        else:
            state = registry.make_decode_state(
                cfg, B, S + _extra_prefix(cfg), device="cpu")
            if mesh is not None:
                state = _place_tree(
                    state, decode_state_specs(state, cfg, mesh, policy), mesh)
            tracer.track((dict(model.named_parameters()), batch, state))
            with tracer, implicit_replication():
                if shape.kind == "prefill":
                    out = registry.prefill(model, batch, cfg, state)
                else:
                    out = registry.decode_step(model, batch["tokens"], cfg,
                                               state)
            costs = tracer.costs(out)
        trace_s = time.time() - t0
    rep = roofline_terms(costs, arch=cfg.name, shape=shape.name,
                         mesh_shape=mesh_shape,
                         model_flops=model_flops_estimate(cfg, shape))
    temp = costs.peak_bytes - costs.args_bytes
    report = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(map(str, mesh_shape)),
        "status": "ok",
        "trace_s": round(trace_s, 2),
        "fsdp": policy.fsdp, "microbatch": mb,
        "mem_args_bytes": costs.args_bytes,
        "mem_args_gb": round(costs.args_bytes / GB, 3),
        "mem_out_gb": round(costs.out_bytes / GB, 3),
        "mem_temp_gb": round(temp / GB, 3),
        "mem_total_gb": round(costs.peak_bytes / GB, 3),
        "hlo_flops_scaled": rep.hlo_flops_per_chip,
        "hlo_bytes_scaled": rep.hlo_bytes_per_chip,
        "compute_ms": round(rep.compute_s * 1e3, 4),
        "memory_ms": round(rep.memory_s * 1e3, 4),
        "collective_ms": round(rep.collective_s * 1e3, 4),
        "dominant": rep.dominant,
        "collective_intra_gb": round(rep.collective_intra_bytes / GB, 4),
        "collective_cross_gb": round(rep.collective_cross_bytes / GB, 4),
        "n_collectives": rep.n_collectives,
        "n_while": costs.n_while,
        "model_flops": rep.model_flops_total,
        "useful_flops_ratio": round(rep.useful_flops_ratio, 4),
        "roofline_fraction": round(rep.roofline_fraction, 4),
        "attn_scope_bytes": costs.scope_bytes.get("attn_core", 0.0),
        "attn_scope_flops": costs.scope_flops.get("attn_core", 0.0),
        "attn_saved_bytes": costs.scope_saved_bytes.get("attn_core", 0.0),
    }
    adj_mem_s, adj_frac = flash_adjusted(rep, costs, cfg, shape)
    report["memory_ms_flash"] = round(adj_mem_s * 1e3, 4)
    report["roofline_fraction_flash"] = round(adj_frac, 4)
    return report, costs


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cells(cells, *, multi_pod: bool, out_path: str | None):
    results = []
    for arch, shape_name in cells:
        tag = f"{arch} x {shape_name} ({_mesh_name(multi_pod)})"
        try:
            rep, _ = lower_cell(arch, shape_name, multi_pod=multi_pod)
            print(f"[ok]   {tag}: mem={rep['mem_total_gb']:.2f}GB/dev "
                  f"dominant={rep['dominant']} "
                  f"compute={rep['compute_ms']:.3f}ms "
                  f"mem={rep['memory_ms']:.3f}ms "
                  f"coll={rep['collective_ms']:.3f}ms "
                  f"(trace {rep['trace_s']:.1f}s)", flush=True)
        except ShapeNotSupported as e:
            rep = {"arch": arch, "shape": shape_name,
                   "mesh": _mesh_name(multi_pod),
                   "status": "skipped", "reason": str(e)}
            print(f"[skip] {tag}: {e}", flush=True)
        except Exception as e:
            rep = {"arch": arch, "shape": shape_name,
                   "mesh": _mesh_name(multi_pod),
                   "status": "error", "reason": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        results.append(rep)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(rep) + "\n")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # DTensor's advice on merging mesh dims, once per redistribution kind
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    results = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        results += run_cells(cells, multi_pod=mp, out_path=args.out)
    n_fail = sum(r["status"] == "error" for r in results)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} documented skips, {n_fail} FAILED")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
