"""The benchmark's cells cut to the port's SMOKE configurations, for the
CPU tests: the same traffic mixes and limits, at a few rows."""

from __future__ import annotations

import dataclasses

import torch

from perfbench import spec

#: each configuration's architecture in the port's registry
ARCH = {"granite-moe-3b-a800m": "granite-moe-3b-a800m",
        "zamba2-7b": "zamba2-7b"}


def model_dict(cfg) -> dict:
    """A ``ModelConfig`` as a configuration file's ``model`` fields."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = str(v).split(".")[-1]
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


def cell_of(config: str, traffic: str) -> spec.Cell:
    """A cell of a configuration and a traffic mix of ``perfbench/``,
    whether or not ``BENCHMARK.json`` names it (loose limits)."""
    return spec.Cell(
        name=f"{config}.{traffic}",
        config=spec.read_json(spec.HERE / "configs" / f"{config}.json"),
        traffic=spec.read_json(spec.HERE / "traffic" / f"{traffic}.json"),
        limits={})


def smoke_cell(workload: str, dtype=torch.float32, **traffic) -> spec.Cell:
    """``workload`` (a cell of ``BENCHMARK.json``, or a configuration and
    a traffic mix joined by a dot) at its architecture's SMOKE size in
    ``dtype``, with a few rows of its traffic (overridden by
    ``traffic``)."""
    from repro_torch.configs import get_smoke_config

    try:
        cell = spec.load_cell(workload)
    except KeyError:
        cell = cell_of(*workload.rsplit(".", 1))
    arch = ARCH[cell.config["name"]]
    model = model_dict(get_smoke_config(arch).scaled(dtype=dtype))
    tr = dict(cell.traffic)
    if tr["kind"] == "train":
        tr.update(batch=2, seq_len=32, pool=6)
    else:
        tr.update(batch=2, seq_len=24, pool=4, checked_batches=2)
    tr.update(traffic)
    return dataclasses.replace(cell, config=dict(cell.config, model=model),
                               traffic=tr)
