"""The port's checkpoints: the reference's layout, its round trip, the
async writer's retention, and a step-exact restart of ``train_loop``.

A training state ``(params, AdamWState)`` is named leaf by leaf as the
reference names its trees (``jax.tree_util.keystr``), so a checkpoint
of the same tree written by one package is read by the other.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.ckpt.checkpoint import load_checkpoint as ref_load
from repro.ckpt.checkpoint import save_checkpoint as ref_save
from repro_torch.ckpt import (CheckpointManager, load_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models import registry
from repro_torch.train.optimizer import AdamWState, adamw_init


def _state():
    model = registry.init_params(get_smoke_config("qwen2-1.5b"), 0, "cpu")
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    with torch.no_grad():
        for t in opt.m.values():
            t.normal_()
    return params, opt._replace(step=7)


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _state()
    path = save_checkpoint(str(tmp_path), 7, (params, opt),
                           meta={"arch": "t"})
    assert os.path.exists(os.path.join(path, "arrays.npz.zst"))
    assert os.readlink(os.path.join(tmp_path, "latest")) == "step_7"
    (p2, o2), step, meta = load_checkpoint(str(tmp_path), (params, opt))
    assert step == 7 and meta["arch"] == "t"
    assert isinstance(o2, AdamWState) and int(o2.step) == 7
    for name, t in params.items():
        np.testing.assert_array_equal(p2[name], t.detach().numpy())
        np.testing.assert_array_equal(o2.m[name], opt.m[name].numpy())
        np.testing.assert_array_equal(o2.v[name], opt.v[name].numpy())


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same tree saved by one package is read by the other: same
    leaf names in ``meta.json``, same arrays."""
    rng = np.random.default_rng(0)
    tree_np = {"w": rng.standard_normal((3, 4)).astype(np.float32),
               "n": {"b": np.arange(5, dtype=np.int32)}}
    port_tree = {"w": torch.from_numpy(tree_np["w"]),
                 "n": {"b": torch.from_numpy(tree_np["n"]["b"])}}
    ref_tree = jax.tree_util.tree_map(jnp.asarray, tree_np)
    save_checkpoint(str(tmp_path / "port"), 1, port_tree)
    ref_save(str(tmp_path / "ref"), 1, ref_tree)
    names = []
    for d in ("port", "ref"):
        with open(tmp_path / d / "step_1" / "meta.json") as f:
            names.append(json.load(f)["names"])
    assert names[0] == names[1] == ["['n']['b']", "['w']"]
    got, _, _ = ref_load(str(tmp_path / "port"), ref_tree)
    back, _, _ = load_checkpoint(str(tmp_path / "ref"), port_tree)
    for tree in (got, back):
        np.testing.assert_array_equal(np.asarray(tree["w"]), tree_np["w"])
        np.testing.assert_array_equal(np.asarray(tree["n"]["b"]),
                                      tree_np["n"]["b"])


def test_checkpoint_manager_async_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.arange(5)}
    for s in (1, 2, 3):
        mgr.save_async(s, tree, meta={})
        tree["x"] += 1          # the snapshot was taken at save_async
        mgr.wait()
    assert mgr.latest_step() == 3
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_2", "step_3"]     # retention pruned step_1
    got, step, _ = mgr.restore({"x": torch.arange(5)})
    assert step == 3
    np.testing.assert_array_equal(got["x"], np.arange(5) + 2)


def test_restart_resumes_step_exact(tmp_path):
    """Train 10 steps with a checkpoint every 5; then lose everything
    after step 5 and restart: the resumed run ends where the
    uninterrupted one did, bit for bit (the batches replay by step)."""
    cfg = get_smoke_config("qwen2-1.5b")
    kw = dict(steps=10, batch=2, seq=16, seed=0, ckpt_every=5, lr=1e-3,
              device="cpu", log_every=100)
    full, opt_full, losses = train_loop(cfg, ckpt_dir=str(tmp_path), **kw)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_10", "step_5"]
    shutil.rmtree(tmp_path / "step_10")
    os.remove(tmp_path / "latest")
    os.symlink("step_5", tmp_path / "latest")
    resumed, opt_res, tail = train_loop(cfg, ckpt_dir=str(tmp_path), **kw)
    assert opt_res.step == opt_full.step == 10
    assert tail == losses[5:]
    for (name, a), (_, b) in zip(full.named_parameters(),
                                 resumed.named_parameters()):
        assert torch.equal(a, b), name
    for name in opt_full.m:
        assert torch.equal(opt_full.m[name], opt_res.m[name]), name
        assert torch.equal(opt_full.v[name], opt_res.v[name]), name
