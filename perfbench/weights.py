"""Random weights from the seed, made on the device in a few large calls.

Both sides get the same numbers: the program's module is filled from
its ``named_parameters()``, the plain reference from its own list of
names and shapes, and a name and shape give the same tensor on the same
device.  The leaves of one kind (the name with its layer indices
replaced by ``*``, ``blocks.*.moe.w_in``) are drawn by one
``torch.randn`` from a generator seeded by the seed and the kind, and
cut in the order of their indices.  The scales are those of the port's
``init_`` (and the reference's ``init_*``): the embedding and an untied
head N(0, 0.02^2), every other matrix N(0, 1/fan_in) with fan_in the
second-to-last dimension (``wo`` over ``H hd``, an expert's ``w_out``
over its width, a conv tap over the kernel width), biases 0, norms and
``d_skip`` 1, ``a_log`` = log(linspace(1, 16, H)), ``dt_bias`` =
log(e - 1).  A configuration's ``init`` may replace a rule:
``{"dt_range": [lo, hi]}`` gives ``dt_bias`` the inverse softplus of
time steps log-spaced over the heads from ``lo`` to ``hi`` (a published
``time_step_min`` and ``time_step_max``), so that ``softplus(dt_bias)``
spans that range.
"""

from __future__ import annotations

import math
import re
import zlib
from collections import OrderedDict

import torch

_INDEX = re.compile(r"\.(\d+)(?=\.|$)")
_ONES = {"ln", "ln1", "ln2", "ln_f", "norm_g", "d_skip"}
_ZEROS = {"bq", "bk", "bv", "conv_x_b", "conv_bb", "conv_cb"}
_EMBED_STD = 0.02


def kind_of(name: str) -> str:
    return _INDEX.sub(".*", name)


def index_of(name: str) -> tuple:
    return tuple(int(i) for i in _INDEX.findall(name))


def kind_seed(seed: int, kind: str) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32(kind.encode())) % (1 << 63)


def kinds(shapes: dict) -> "OrderedDict[str, list]":
    """The leaf names by kind, each kind's in the order of its indices."""
    out: OrderedDict = OrderedDict()
    for name in shapes:
        out.setdefault(kind_of(name), []).append(name)
    for names in out.values():
        names.sort(key=index_of)
    return out


def _rule(name: str, shape: tuple, init: dict):
    last = name.rsplit(".", 1)[-1]
    if last in ("embed", "lm_head"):
        return "normal", _EMBED_STD
    if last in _ONES:
        return "const", 1.0
    if last in _ZEROS:
        return "const", 0.0
    if last == "dt_bias":
        if "dt_range" in init:
            return "dt_range", init["dt_range"]
        return "const", math.log(math.e - 1.0)
    if last == "a_log":
        return "a_log", None
    if len(shape) < 2:
        raise ValueError(f"no init rule for the vector {name} {shape}")
    return "normal", 1.0 / math.sqrt(shape[-2])


def generate(shapes: dict, seed: int, device, only=None, init=None):
    """Yields ``(name, float32 tensor)`` for every leaf of ``shapes``
    (name -> shape), kind by kind; ``only``: the kinds to make (default
    all); ``init``: the configuration's rules that replace the defaults.
    A yielded tensor may be a view of its kind's draw: copy it before
    the next kind."""
    dev = torch.device(device)
    init = init or {}
    for kind, names in kinds(shapes).items():
        if only is not None and kind not in only:
            continue
        shape = tuple(shapes[names[0]])
        if any(tuple(shapes[n]) != shape for n in names):
            raise ValueError(f"{kind}: leaves of different shapes")
        how, arg = _rule(names[0], shape, init)
        if how == "normal":
            gen = torch.Generator(device=dev).manual_seed(
                kind_seed(seed, kind))
            big = torch.randn((len(names), *shape), generator=gen,
                              device=dev, dtype=torch.float32).mul_(arg)
            for i, name in enumerate(names):
                yield name, big[i]
            del big
        elif how == "const":
            t = torch.full(shape, arg, dtype=torch.float32, device=dev)
            for name in names:
                yield name, t
        elif how == "dt_range":
            dt = torch.logspace(math.log10(arg[0]), math.log10(arg[1]),
                                shape[0], dtype=torch.float64, device=dev)
            t = (dt + torch.log(-torch.expm1(-dt))).float()
            for name in names:
                yield name, t
        else:
            t = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                         dtype=torch.float32, device=dev))
            for name in names:
                yield name, t


@torch.no_grad()
def fill(params: dict, seed: int, init=None) -> None:
    """Copies the seed's weights into ``params`` (name -> tensor, the
    program's ``named_parameters()``), in place."""
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    dev = next(iter(params.values())).device
    for name, t in generate(shapes, seed, dev, init=init):
        params[name].copy_(t)


def make(shapes: dict, seed: int, device, init=None) -> dict:
    """The seed's weights as new float32 tensors, name -> tensor."""
    return {n: t.clone() for n, t in generate(shapes, seed, device,
                                              init=init)}


@torch.no_grad()
def change_norms(params: dict, seed: int, init=None) -> dict:
    """name -> ||params[name] - the seed's initial weight|| (float64),
    the initial weights made again kind by kind."""
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    dev = next(iter(params.values())).device
    out = {}
    for name, t in generate(shapes, seed, dev, init=init):
        out[name] = torch.linalg.vector_norm(
            params[name].float() - t, dtype=torch.float64)
    return {n: float(v) for n, v in out.items()}
