"""A cell of ``BENCHMARK.json`` and the files it is found by.

A cell names a configuration and a traffic mix.  The configuration is
``configs/<config>.json``: its ``model`` object holds every field of the
port's ``ModelConfig`` as it is run, and ``builder`` names the port's
module constructor (``module:Class``).  The traffic mix is
``traffic/<traffic>.json``: its ``generator`` names a module of
``traffic/`` that draws the inputs, its ``kind`` the module of
``kinds/`` that drives the cell (``train`` or ``serve``).  The limits of
the correctness comparison are ``limits/<cell>.json``.  A per-layer
metric ``m`` is read by ``metrics/<m>.py``.  Nothing here imports the
port: :func:`model_config` does so where it is called.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<cell>.json
    chips: int = 1
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)

    @property
    def model(self) -> dict:
        """The configuration's model fields, as run."""
        return self.config["model"]

    @property
    def init(self) -> dict:
        """The configuration's rules for its random weights that replace
        ``perfbench/weights.py``'s defaults."""
        return self.config.get("init", {})


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    """The cell ``name`` of ``benchmark`` with its files read."""
    bench = read_json(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark.name}; "
                       f"have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def generator(traffic: dict):
    """The module of ``traffic/`` that the mix names."""
    return importlib.import_module(f"perfbench.traffic.{traffic['generator']}")


def kind(traffic: dict):
    """The module of ``kinds/`` that drives a mix of this kind."""
    return importlib.import_module(f"perfbench.kinds.{traffic['kind']}")


def reference(model: dict):
    """The plain reference of the configuration's family."""
    return importlib.import_module(f"perfbench.reference.{model['family']}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(model: dict):
    """The port's ``ModelConfig`` of a configuration's ``model`` fields;
    every field of the dataclass has to be given."""
    import dataclasses

    import torch

    from repro_torch.models.common import Family, ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    missing, extra = names - set(model), set(model) - names
    if missing or extra:
        raise ValueError(f"{model.get('name')}: fields missing "
                         f"{sorted(missing)}, unknown {sorted(extra)}")
    kw = dict(model)
    kw["family"] = Family(kw["family"])
    kw["dtype"] = getattr(torch, kw["dtype"])
    kw["param_dtype"] = getattr(torch, kw["param_dtype"])
    return ModelConfig(**kw)


def builder(config: dict):
    """The port's module constructor that ``builder`` names."""
    mod, cls = config["builder"].split(":")
    return getattr(importlib.import_module(mod), cls)
