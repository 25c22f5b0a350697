"""The port's data package against the reference's, bit for bit.

``repro_torch.data`` is a NumPy copy of ``repro.data``: the same seeded
draws give the same tokens, labels and stub frontend tensors, and the
prefetching pipeline hands out the same batches tagged with their step,
from any step it is started at.
"""

import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.configs.shapes import InputShape
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.data.synthetic import make_batch as ref_make_batch
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, PipelineConfig, SyntheticLM, \
    make_batch


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (1, 3, 0, 4), (1, 3, 1, 4), (7, 123, 2, 3)])
def test_synthetic_batches_are_the_references(seed, step, shard, n_shards):
    kw = dict(seed=seed, step=step, shard=shard, n_shards=n_shards,
              batch_size=4)
    got = SyntheticLM(vocab=100, seq_len=32).batch(**kw)
    _equal(got, RefSyntheticLM(vocab=100, seq_len=32).batch(**kw))
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-large-v3",
                                  "paligemma-3b"])
def test_make_batch_is_the_references(arch):
    """Tokens and labels, and whisper's frames and paligemma's patches."""
    shape = InputShape("t", 16, 6, "train")
    for step, shard in ((0, 0), (5, 1)):
        got = make_batch(get_smoke_config(arch), shape, seed=3, step=step,
                         shard=shard, n_shards=2)
        want = ref_make_batch(ref_smoke(arch), shape, seed=3, step=step,
                              shard=shard, n_shards=2)
        _equal(got, want)
        assert got["tokens"].shape == (3, 16)


def test_pipeline_prefetch_and_resume():
    """Started at step 5 the pipeline hands out steps 5, 6, 7 in order,
    each the reference pipeline's batch and ``make_batch``'s."""
    cfg = get_smoke_config("qwen2-1.5b")
    shape = InputShape("t", 32, 4, "train")
    pipe = DataPipeline(cfg, shape, PipelineConfig(seed=0, prefetch=2)) \
        .start(from_step=5)
    ref = RefPipeline(ref_smoke("qwen2-1.5b"), shape,
                      RefPipelineConfig(seed=0, prefetch=2)).start(
        from_step=5)
    try:
        for step in (5, 6, 7):
            got, want = pipe.next(), ref.next()
            assert got["_step"] == want["_step"] == step
            _equal({k: v for k, v in got.items() if k != "_step"},
                   {k: v for k, v in want.items() if k != "_step"})
            _equal({k: v for k, v in got.items() if k != "_step"},
                   make_batch(cfg, shape, seed=0, step=step))
    finally:
        pipe.stop()
        ref.stop()
    assert pipe._q.empty()
    # a restart from step 6 replays the stream from there
    again = DataPipeline(cfg, shape, PipelineConfig(seed=0)).start(
        from_step=6)
    try:
        b = again.next()
    finally:
        again.stop()
    assert b["_step"] == 6
    np.testing.assert_array_equal(
        b["tokens"], make_batch(cfg, shape, seed=0, step=6)["tokens"])
