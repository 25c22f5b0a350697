"""Checkpointing: flattened-tree npz with zstd, async writer thread,
atomic rename, retention, and step-exact resume metadata.

Counterpart of ``repro/ckpt/checkpoint.py``, with the same layout:
<dir>/step_<n>/ {arrays.npz.zst, meta.json}; `latest` symlink is only
flipped after a fully-written checkpoint (crash-safe restore).  Without
``zstandard`` the arrays are zlib-compressed under the same name, as the
reference does.  A tree is nested dicts (keys sorted, as jax sorts
them), tuples, lists and NamedTuples over leaves; a leaf is a tensor
(copied to the host; bf16 kept as float32, the only dtype numpy lacks),
a NumPy array or a number.  Leaf names are the reference's
``jax.tree_util.keystr`` paths (``[0]['blocks.0.attn.wq']``, ``[1].m``),
so a training state ``(model.state_dict(), AdamWState)`` is named by its
state-dict keys and the optimizer's fields, and a checkpoint of the
same tree is read by either package."""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

try:
    import zstandard as zstd
except ModuleNotFoundError:
    # Container without zstandard: fall back to zlib compression behind
    # the same two-class interface.  Fallback checkpoints are NOT
    # zstd-readable (and vice versa) — the decompressor checks the zstd
    # frame magic so a cross-environment restore fails with a clear
    # message instead of a bare zlib.error.
    import zlib

    _ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

    class _ZlibCompressor:
        def __init__(self, level: int = 3):
            self._level = level

        def compress(self, data: bytes) -> bytes:
            return zlib.compress(data, self._level)

    class _ZlibDecompressor:
        def decompress(self, data: bytes) -> bytes:
            if data[:4] == _ZSTD_MAGIC:
                raise RuntimeError(
                    "checkpoint was written with zstandard, which is not "
                    "installed here — install zstandard to restore it")
            return zlib.decompress(data)

    class _ZstdShim:
        ZstdCompressor = staticmethod(
            lambda level=3: _ZlibCompressor(level))
        ZstdDecompressor = staticmethod(_ZlibDecompressor)

    zstd = _ZstdShim()


def _children(tree) -> list | None:
    """``[(path, child), ...]`` of a container, ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def _flatten_with_names(tree, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    names, leaves = [], []
    for path, child in kids:
        n, lv = _flatten_with_names(child, prefix + path)
        names += n
        leaves += lv
    return names, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    vals = [_unflatten(c, leaves) for _, c in kids]
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view of a tensor that training
    goes on updating in place)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.array(leaf)


def to_host(tree):
    """``tree`` with every leaf copied to a NumPy array now."""
    _, leaves = _flatten_with_names(tree)
    return _unflatten(tree, iter([_host(x) for x in leaves]))


def save_checkpoint(ckpt_dir: str, step: int, tree, *, meta: dict = None,
                    keep: int = 3) -> str:
    """Synchronous save.  Returns the checkpoint path."""
    names, leaves = _flatten_with_names(tree)
    arrays = {f"a{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    comp = zstd.ZstdCompressor(level=3).compress(buf.getvalue())
    with open(os.path.join(tmp, "arrays.npz.zst"), "wb") as f:
        f.write(comp)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "names": names, "meta": meta or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _update_latest(ckpt_dir, final)
    _retain(ckpt_dir, keep)
    return final


def _update_latest(ckpt_dir: str, final: str):
    latest = os.path.join(ckpt_dir, "latest")
    tmp_link = latest + ".tmp"
    if os.path.islink(tmp_link) or os.path.exists(tmp_link):
        os.remove(tmp_link)
    os.symlink(os.path.basename(final), tmp_link)
    os.replace(tmp_link, latest)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(
        (int(d.split("_")[1]), d) for d in os.listdir(ckpt_dir)
        if d.startswith("step_"))
    for _, d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def load_checkpoint(ckpt_dir: str, tree_like, *, step: int | None = None):
    """Restore into the structure of `tree_like` (NumPy leaves, shapes
    and dtypes as on disk).  Returns (tree, step, meta).  Raises if the
    leaf names on disk are not ``tree_like``'s."""
    if step is None:
        latest = os.path.join(ckpt_dir, "latest")
        path = os.path.join(ckpt_dir, os.readlink(latest)) \
            if os.path.islink(latest) else latest
    else:
        path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    names, _ = _flatten_with_names(tree_like)
    if meta["names"] != names:
        raise ValueError(f"{path}: its leaves are not the tree's "
                         f"({len(meta['names'])} on disk, {len(names)} "
                         f"wanted)")
    with open(os.path.join(path, "arrays.npz.zst"), "rb") as f:
        raw = zstd.ZstdDecompressor().decompress(f.read())
    arrays = np.load(io.BytesIO(raw))
    leaves = [arrays[f"a{i}"] for i in range(len(arrays.files))]
    return _unflatten(tree_like, iter(leaves)), meta["step"], \
        meta.get("meta", {})


@dataclass
class CheckpointManager:
    """Async manager: save_async() snapshots to host memory synchronously
    (so training can go on updating its tensors in place) and writes to
    disk on a worker thread."""

    ckpt_dir: str
    keep: int = 3
    _thread: threading.Thread = field(default=None, repr=False)
    _error: list = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def save_async(self, step: int, tree, *, meta: dict = None):
        host_tree = to_host(tree)  # snapshot now
        self.wait()

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, meta=meta,
                                keep=self.keep)
            except Exception as e:  # surfaced on next wait()
                self._error.append(e)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def restore(self, tree_like, *, step: int | None = None):
        return load_checkpoint(self.ckpt_dir, tree_like, step=step)

    def latest_step(self) -> int | None:
        try:
            latest = os.path.join(self.ckpt_dir, "latest")
            target = os.readlink(latest)
            return int(target.split("_")[1])
        except OSError:
            return None
