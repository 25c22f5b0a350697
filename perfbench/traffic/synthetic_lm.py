"""Token batches from the seed: the port's ``SyntheticLM`` stream.

A copy of ``repro_torch/data/synthetic.py``'s ``SyntheticLM`` (itself a
copy of the reference's): a Zipf unigram stream in which a token repeats
the one ``induction_lag`` before it with probability ``induction_p``.
Batch ``index`` of a seed is the same on every machine.  A mix's
parameters: ``batch`` rows of ``seq_len`` tokens, ``zipf_a``,
``induction_p``, ``induction_lag``; a train mix gets the labels (the
stream shifted by one), a serve mix the prompts alone.
"""

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
        rep = rng.random((B, S + 1)) < self.induction_p
        lag = self.induction_lag
        toks[:, lag:] = np.where(rep[:, lag:], toks[:, :-lag],
                                 toks[:, lag:])
        return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}


def stream(traffic: dict, vocab: int) -> SyntheticLM:
    return SyntheticLM(vocab=vocab, seq_len=traffic["seq_len"],
                       zipf_a=traffic["zipf_a"],
                       induction_p=traffic["induction_p"],
                       induction_lag=traffic["induction_lag"])


def draw(traffic: dict, vocab: int, seed: int, index: int) -> dict:
    """Batch ``index`` of the seed's stream: ``tokens`` ``[batch,
    seq_len]`` int32, and ``labels`` for a train mix."""
    b = stream(traffic, vocab).batch(seed=seed, step=index, shard=0,
                                     n_shards=1,
                                     batch_size=traffic["batch"])
    if traffic["kind"] != "train":
        del b["labels"]
    return b
