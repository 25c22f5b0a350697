"""Deterministic synthetic LM data (a copy of ``repro/data/synthetic.py``).

A Zipf-ish unigram stream with short-range induction structure (token t+1
repeats token t-k with learned-constant probability), so models actually
reduce loss — useful for the end-to-end training examples without any
dataset dependency.  Fully seeded: (seed, step, shard) -> identical batch
anywhere, which is what checkpoint/restart and elastic rescale tests rely
on (a restarted run replays the exact token stream)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    zipf_a: float = 1.2
    induction_p: float = 0.35
    induction_lag: int = 8

    def batch(self, *, seed: int, step: int, shard: int, n_shards: int,
              batch_size: int) -> dict:
        """Deterministic batch for one host shard of one step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, shard]))
        B, S = batch_size, self.seq_len
        ranks = rng.zipf(self.zipf_a, size=(B, S + 1))
        toks = np.minimum(ranks, self.vocab - 1).astype(np.int32)
        # induction structure: with prob p, token repeats t - lag
        rep = rng.random((B, S + 1)) < self.induction_p
        lag = self.induction_lag
        toks[:, lag:] = np.where(rep[:, lag:], toks[:, :-lag],
                                 toks[:, lag:])
        return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}


def make_batch(cfg, shape, *, seed: int = 0, step: int = 0, shard: int = 0,
               n_shards: int = 1) -> dict:
    """Concrete numpy batch for ``shape`` (any object with ``seq_len`` and
    ``global_batch``, as the reference's ``configs.shapes.InputShape``),
    incl. the stub frontend tensors."""
    from repro_torch.models.common import Family

    gen = SyntheticLM(vocab=cfg.vocab, seq_len=shape.seq_len)
    b = shape.global_batch // n_shards
    batch = gen.batch(seed=seed, step=step, shard=shard, n_shards=n_shards,
                      batch_size=b)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard,
                                                        7]))
    if cfg.family == Family.ENCDEC:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == Family.VLM:
        batch["patches"] = rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return batch
