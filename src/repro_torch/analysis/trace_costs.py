"""The per-rank costs of a step traced on DTensors in a fake world.

Counterpart of ``repro/analysis/hlo_parse.py``.  The reference lowers a
step with explicit shardings, compiles it for 512 host devices that XLA
fakes, and parses the compiled HLO: what one device runs, with its
collectives and their replica groups.  The port runs the step itself,
eagerly, on DTensors whose local shards are fake tensors (nothing is
allocated) in a ``torch.distributed`` world of backend ``"fake"``.
:class:`CostTracer`, a dispatch mode, sees each op *below* DTensor: the
local op that each rank runs (returning ``NotImplemented`` for DTensor
arguments lets DTensor desugar first), and the ``_c10d_functional``
collectives DTensor issues, whose group names resolve to their ranks.
That program is the port's counterpart of the compiled HLO.  The ops
that DTensor runs at the global shape to propagate output metadata are
not counted.

What it counts, per rank:

  * ``flops`` — matmul and convolution FLOPs (``torch.utils.
    flop_counter``'s formulas: 2 M N K), as the reference counts dot and
    convolution ops only;
  * ``bytes_accessed`` — the port's eager reality: each op reads its
    tensor operands and writes its result, every one counted in full;
    ops whose results only alias their inputs (views) and allocations
    (``empty``) are free.  The reference's ``_BYTES_KINDS`` instead
    models a TPU's fusion, where elementwise ops and copies cost
    nothing; eager PyTorch launches each of them;
  * ``collectives`` — one :class:`CollectiveOp` per collective, with its
    operand and result bytes, its group's size and its first group as
    global ranks in row-major mesh order (the group of rank 0, which is
    the reference's first replica group);
  * ``scope_bytes`` / ``scope_flops`` — the same, for ops run inside a
    region marked by :func:`repro_torch.models.common.scoped` (the
    reference's ``jax.named_scope``; ``attn_core`` is the attention
    core, which the flash kernel B2 replaces), forward and backward: the
    backward nodes a scoped region made run under its scope;
  * ``scope_saved_bytes`` — the bytes of tensors made inside a scope
    that autograd saves for the backward pass (twice where activation
    recomputation runs the scope again); ``scope_saved_at_peak`` — those
    of them still live when the peak was reached (a recomputed layer's
    saved tensors are dropped after its forward: one layer's at most);
  * ``n_while`` is 0: the port's layers are a Python loop, not a scan,
    so every layer's ops are counted as they run.

Memory, per rank: every storage the step allocates is followed by a
weak reference until it is freed; ``peak_bytes`` is the most that was
live at once, the arguments (:meth:`CostTracer.track`) included.  Fake
tensors and the hooks around them put some tensors in reference cycles,
which only the garbage collector frees, at no fixed time; before the
peak grows by more than ``PEAK_SLACK`` past its last collection, the
tracer collects the young generations (a full collection at every step
would cost minutes a cell), so the peak is what reference counts keep
plus what older cycles still hold: the same every run for a one-rank
step, within about 3 % between runs of a multi-rank cell.

Collectives are named as the reference names HLO ops: all-reduce,
all-gather, reduce-scatter, all-to-all, collective-permute.  DTensor's
shard-to-shard moves on a CPU mesh fall back to an all-gather (gloo has
no all-to-all); the tracer sends them through DTensor's own all-to-all
op, as on the card's NCCL, while it is active.
"""

from __future__ import annotations

import functools
import gc
import itertools
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models import common as model_common

#: named scopes tracked for the flash adjustment (models/attention.py
#: marks the region the flash kernel replaces)
TRACKED_SCOPES = ("attn_core",)

#: live bytes the peak may grow by before garbage held in reference
#: cycles is collected and the peak taken again
PEAK_SLACK = 64 << 20

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclass
class CollectiveOp:
    kind: str
    operand_bytes: int          # per participating rank
    result_bytes: int
    multiplier: int             # executions (1: every run is traced)
    group_size: int
    group0_devices: tuple       # global ranks of the first group
    computation: str            # "backward", or "step" outside it
    name: str

    def wire_bytes(self) -> float:
        """Bytes on the wire per rank, ring-algorithm formulas."""
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (n - 1) / n * self.operand_bytes
        if self.kind == "collective-permute":
            return float(self.operand_bytes)
        if self.kind == "all-gather":
            return (n - 1) / n * self.result_bytes      # result = full
        # reduce-scatter / all-to-all: operand is the full local buffer
        return (n - 1) / n * self.operand_bytes


@dataclass
class TraceCosts:
    flops: float                      # per rank
    bytes_accessed: float             # per rank, eager operands + results
    collectives: list                 # [CollectiveOp]
    n_while: int = 0
    scope_bytes: dict = field(default_factory=dict)  # scope -> bytes
    scope_flops: dict = field(default_factory=dict)
    scope_saved_bytes: dict = field(default_factory=dict)
    scope_saved_at_peak: dict = field(default_factory=dict)
    args_bytes: int = 0               # live storage when tracing began
    peak_bytes: int = 0               # most live storage, args included
    out_bytes: int = 0                # storage made by the step still live

    def collective_wire_bytes(self) -> float:
        return sum(c.wire_bytes() * c.multiplier for c in self.collectives)


def _current_node():
    """The autograd node running now (None outside a backward pass, or
    where the torch release cannot say)."""
    get = getattr(torch._C, "_current_autograd_node", None)
    return get() if get is not None else None


def _c10d(name: str):
    return getattr(torch.ops._c10d_functional, name, None)


def _collective_kinds() -> dict:
    """``{op packet: (kind, index of the group name argument)}``."""
    table = {
        "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
        "all_reduce_coalesced": ("all-reduce", 2),
        "all_gather_into_tensor": ("all-gather", 2),
        "all_gather_into_tensor_coalesced": ("all-gather", 2),
        "reduce_scatter_tensor": ("reduce-scatter", 3),
        "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
        "all_to_all_single": ("all-to-all", 3),
        "broadcast": ("collective-permute", 2),
        "broadcast_": ("collective-permute", 2),
    }
    out = {}
    for name, kind in table.items():
        op = _c10d(name)
        if op is not None:
            out[op] = kind
    op = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)
    if op is not None:
        out[op] = ("all-to-all", 3)
    return out


def _group_ranks(group_name) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = (_resolve_process_group(group_name) if isinstance(group_name, str)
          else group_name)
    return tuple(sorted(dist.get_process_group_ranks(pg)))


def _tensors(tree) -> list:
    """The distinct tensors of a tree of arguments or results (an op's
    arguments are tensors, or lists and tuples of them, at the top
    level or one level down; other trees are flattened in full)."""
    seen, out = set(), []

    def add(t):
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    def walk(x, depth):
        if isinstance(x, torch.Tensor):
            add(x)
        elif isinstance(x, (list, tuple)) and depth < 2:
            for y in x:
                walk(y, depth + 1)
        elif isinstance(x, dict) and depth < 2:
            for y in x.values():
                walk(y, depth + 1)
        elif isinstance(x, (list, tuple, dict)):
            for t in tree_flatten(x)[0]:
                if isinstance(t, torch.Tensor):
                    add(t)

    walk(tree, 0)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: ops that allocate, reinterpret or read a scalar: no traffic counted
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "_unsafe_view",
         "set_", "resize_", "_local_scalar_dense", "alias"}


def _is_free(func) -> bool:
    """A view (every result aliases an input without writing it), or an
    op that moves no data."""
    if func._overloadpacket.__name__ in _FREE or func.namespace == "prim":
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _storage(t: torch.Tensor):
    if isinstance(t, DTensor):
        t = t._local_tensor
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class _Propagation:
    """Marks DTensor's output-metadata propagation, whose global-shape
    ops are not a rank's work."""

    depth = 0

    @classmethod
    @contextmanager
    def patched(cls):
        from torch.distributed.tensor import _sharding_prop
        prop = _sharding_prop.ShardingPropagator
        real = getattr(prop, "_propagate_tensor_meta_non_cached", None)
        if real is None:         # a torch release without the hook
            yield
            return

        def marked(self, op_schema):
            cls.depth += 1
            try:
                return real(self, op_schema)
            finally:
                cls.depth -= 1

        prop._propagate_tensor_meta_non_cached = marked
        try:
            yield
        finally:
            prop._propagate_tensor_meta_non_cached = real


def _group_name(mesh, mesh_dim):
    """The process-group name of ``mesh``'s dim ``mesh_dim`` (the
    functional collectives' private helpers differ between torch
    releases)."""
    import torch.distributed._functional_collectives as funcol

    if hasattr(funcol, "_group_or_group_name"):
        return funcol._group_or_group_name(
            funcol._resolve_group((mesh, mesh_dim)))
    return funcol._resolve_group_name((mesh, mesh_dim))


@contextmanager
def _nccl_alltoall():
    """DTensor's shard-to-shard moves through its all-to-all op, as on
    NCCL, not the all-gather that a CPU mesh falls back to (where the
    torch release has that op)."""
    from torch.distributed.tensor import _collective_utils, placement_types

    op = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)
    modules = [m for m in (placement_types, _collective_utils)
               if hasattr(m, "shard_dim_alltoall")]
    if op is None or not modules:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim, _group_name(mesh, mesh_dim))

    real = [(m, m.shard_dim_alltoall) for m in modules]
    for m in modules:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, fn in real:
            m.shard_dim_alltoall = fn


class CostTracer(TorchDispatchMode):
    """Counts what each op below DTensor costs one rank (see the module
    docstring).  Use inside ``FakeTensorMode``::

        tracer = CostTracer()
        tracer.track(args)          # the step's arguments, live already
        with tracer:
            out = step(*args)
        costs = tracer.costs(out)
    """

    def __init__(self):
        super().__init__()
        self._kinds = _collective_kinds()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list = []
        self.scope_bytes = {s: 0.0 for s in TRACKED_SCOPES}
        self.scope_flops = {s: 0.0 for s in TRACKED_SCOPES}
        self.scope_saved = {s: 0.0 for s in TRACKED_SCOPES}
        self.saved_at_peak = {s: 0.0 for s in TRACKED_SCOPES}
        self._saved_live: dict = {}     # storage key -> (scope, bytes)
        self._saved_bytes = {s: 0.0 for s in TRACKED_SCOPES}
        self._scope: list = []          # forward scopes, innermost last
        self._bwd_scope: list = []      # scopes of running backward nodes
        self._scope_made: dict = {}     # scope -> storage keys made in it
        self._live: dict = {}           # storage key -> bytes
        self._refs: dict = {}           # storage key -> weakref
        self.live_bytes = 0
        self.peak_bytes = 0
        self._collected_at = 0
        self.args_bytes = 0
        self._arg_keys: set = set()
        self._counter = itertools.count()
        self._stack = None

    # ------------------------------------------------------------ memory
    def _drop(self, key):
        nb = self._live.pop(key, None)
        self._refs.pop(key, None)
        for made in self._scope_made.values():
            made.discard(key)          # a later storage may take its address
        if key in self._saved_live:
            scope, sb = self._saved_live.pop(key)
            self._saved_bytes[scope] -= sb
        if nb is not None:
            self.live_bytes -= nb

    def _hold(self, t: torch.Tensor) -> int | None:
        """Follow ``t``'s storage; returns its key if it was new."""
        st = _storage(t)
        if st is None:
            return None
        key = st._cdata
        if key in self._live:
            return None
        nb = st.nbytes()
        self._live[key] = nb
        self._refs[key] = weakref.ref(st, lambda _r, k=key: self._drop(k))
        self.live_bytes += nb
        if self.live_bytes > self.peak_bytes:
            if self.live_bytes > self._collected_at + PEAK_SLACK:
                # tensors that only a reference cycle keeps (fake tensors
                # and the hooks around them make some) go first, as
                # reference counts would free them on the card
                gc.collect(1)
                self._collected_at = self.live_bytes
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                self.saved_at_peak = dict(self._saved_bytes)
        return key

    def track(self, tree) -> int:
        """Counts the tensors of ``tree`` (the step's arguments) as live
        from the start; returns their bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            key = self._hold(t)
            if key is not None:
                self._arg_keys.add(key)
        self.args_bytes += self.live_bytes - before
        return self.live_bytes - before

    # ------------------------------------------------------------ scopes
    def _current_scope(self):
        if self._bwd_scope:
            return self._bwd_scope[-1]
        return self._scope[-1] if self._scope else None

    def run_scoped(self, name: str, fn, args, kwargs):
        """``fn(*args, **kwargs)`` under scope ``name``: its ops, the
        backward nodes it makes, and the bytes of what it saves for the
        backward that it made itself.  Saved tensors then go on to the
        hooks that were in force (activation recomputation's, which
        drop them from the forward and bring them back in the
        backward)."""
        made = self._scope_made.setdefault(name, set())
        saved: set = set()
        outer = torch._C._autograd._top_saved_tensors_default_hooks(False)

        def pack(t):
            st = _storage(t)
            if st is not None and st._cdata in made and \
                    st._cdata not in saved:
                saved.add(st._cdata)
                self.scope_saved[name] = \
                    self.scope_saved.get(name, 0.0) + st.nbytes()
                if st._cdata not in self._saved_live:
                    self._saved_live[st._cdata] = (name, st.nbytes())
                    self._saved_bytes[name] = \
                        self._saved_bytes.get(name, 0.0) + st.nbytes()
            if outer is not None:
                return outer[0](t)
            # detached: a saved output held with its grad_fn would make a
            # cycle, freed only by the garbage collector, at no fixed time
            return t.detach()

        unpack = (lambda t: t) if outer is None else outer[1]
        self._scope.append(name)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                out = fn(*args, **kwargs)
        finally:
            self._scope.pop()
        stop = {t.grad_fn for t in _tensors((args, kwargs))
                if t.grad_fn is not None}
        for node in self._nodes(out, stop):
            node.register_prehook(functools.partial(self._enter_bwd, name))
            node.register_hook(self._exit_bwd)
        return out

    def _enter_bwd(self, name, grads):
        self._bwd_scope.append(name)

    def _exit_bwd(self, grad_inputs, grad_outputs):
        self._bwd_scope.pop()

    @staticmethod
    def _nodes(out, stop: set) -> list:
        """The autograd nodes between ``out`` and the nodes ``stop``."""
        todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        seen: set = set()
        nodes = []
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(node)
            nodes.append(node)
            todo.extend(n for n, _ in node.next_functions)
        return nodes

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # in place on NCCL; the fake kernel would return a copy
            return args[0]
        out = func(*args, **kwargs)
        if _Propagation.depth:
            return out
        self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out):
        scope = self._current_scope()
        phase = "backward" if _current_node() is not None else "step"
        new = []
        for t in _tensors(out):
            key = self._hold(t)
            if key is not None:
                new.append(key)
        if scope is not None and self._scope and not self._bwd_scope:
            self._scope_made.setdefault(scope, set()).update(new)
        packet = func._overloadpacket
        if packet in self._kinds:
            kind, gi = self._kinds[packet]
            flat = list(args) + list(kwargs.values())
            group = flat[gi] if gi < len(flat) else flat[-1]
            ranks = _group_ranks(group)
            ins = _tensors(args[:1])
            outs = _tensors(out)
            self.collectives.append(CollectiveOp(
                kind=kind, operand_bytes=sum(map(_nbytes, ins)),
                result_bytes=sum(map(_nbytes, outs)), multiplier=1,
                group_size=len(ranks), group0_devices=ranks,
                computation=phase,
                name=f"{packet.__name__}.{next(self._counter)}"))
        fl = 0.0
        if packet in flop_registry:
            fl = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += fl
        if _is_free(func):
            return
        nb = sum(map(_nbytes, _tensors((args, kwargs)))) + \
            sum(map(_nbytes, _tensors(out)))
        self.bytes += nb
        if scope is not None:
            self.scope_bytes[scope] = self.scope_bytes.get(scope, 0.0) + nb
            self.scope_flops[scope] = self.scope_flops.get(scope, 0.0) + fl

    def __enter__(self):
        self._stack = [_Propagation.patched(), _nccl_alltoall()]
        for cm in self._stack:
            cm.__enter__()
        model_common.SCOPE_TRACERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            model_common.SCOPE_TRACERS.remove(self)
            for cm in reversed(self._stack):
                cm.__exit__(*exc)

    def costs(self, out=None) -> TraceCosts:
        """The counts so far; ``out``: the step's results, whose storage
        made by the step is ``out_bytes``."""
        out_bytes = 0
        seen: set = set()
        for t in _tensors(out):
            st = _storage(t)
            if st is None or st._cdata in seen or st._cdata in self._arg_keys:
                continue
            seen.add(st._cdata)
            out_bytes += st.nbytes()
        return TraceCosts(
            flops=self.flops, bytes_accessed=self.bytes,
            collectives=list(self.collectives),
            scope_bytes=dict(self.scope_bytes),
            scope_flops=dict(self.scope_flops),
            scope_saved_bytes=dict(self.scope_saved),
            scope_saved_at_peak=dict(self.saved_at_peak),
            args_bytes=self.args_bytes, peak_bytes=self.peak_bytes,
            out_bytes=out_bytes)


__all__ = ["COLLECTIVE_KINDS", "CollectiveOp", "CostTracer",
           "TRACKED_SCOPES", "TraceCosts"]
