"""Elastic scaling plans: which mesh to rebuild after gaining/losing pods.

Given the healthy device inventory, pick the largest supported mesh
(keeping the model axis intact — TP degree is baked into the sharded
kernels' efficiency — and shrinking/growing the data/pod axes), plus the
batch re-plan that keeps tokens-per-step constant when possible."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ElasticConfig:
    model_axis: int = 16           # fixed TP degree
    min_data_axis: int = 2
    target_global_batch: int = 256


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple              # (pods, data, model) or (data, model)
    axis_names: tuple
    global_batch: int
    grad_accum: int                # microbatch steps to keep token count


class ElasticPlanner:
    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg

    def plan(self, healthy_chips: int) -> ElasticPlan:
        m = self.cfg.model_axis
        if healthy_chips < m * self.cfg.min_data_axis:
            raise ValueError(
                f"{healthy_chips} chips cannot host model axis {m}")
        slices = healthy_chips // m
        # prefer pod-structured meshes when slices factor as pods x data>=16
        if slices >= 32 and slices % 16 == 0:
            pods, data = slices // 16, 16
            shape, names = (pods, data, m), ("pod", "data", "model")
            dp = pods * data
        else:
            shape, names = (slices, m), ("data", "model")
            dp = slices
        gb = self.cfg.target_global_batch
        if gb % dp == 0:
            batch, accum = gb, 1
        else:
            # keep per-device batch >= 1; make up the token budget with
            # gradient accumulation
            per_dev = max(gb // dp, 1)
            batch = per_dev * dp
            accum = max(1, round(gb / batch))
        return ElasticPlan(mesh_shape=shape, axis_names=names,
                           global_batch=batch, grad_accum=accum)
