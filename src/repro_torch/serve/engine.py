"""Batched serving engine.

Counterpart of ``repro/serve/engine.py``: a static-batch engine.
Requests are left-padded with token 0 into a fixed batch (no mask, as
in the reference), filler requests ``Request(prompt=[0],
max_new_tokens=0)`` fill the batch, the batch is prefilled once and
then decoded one token per step.  The first token is the argmax of the
prefill's last logits; each step drops the padded vocabulary and picks
greedily at temperature 0 or samples at the batch's highest
temperature.  ``run``'s ``extra`` adds inputs to the prefill batch
(the enc-dec family's ``frames``, the VLM's ``patches``), moved to the
engine's device; the VLM's decode state needs ``img_tokens`` more slots
in ``ServeConfig.max_len``, as the launchers give it.  The engine runs on
the CUDA card unless given ``device="cpu"``.

Sampling draws from a ``torch.Generator`` seeded from ``run``'s
``seed``; it cannot match the reference's ``jax.random`` draws token for
token, only in distribution (:func:`sampling_probs`, :func:`next_tokens`;
tests/test_torch_serve.py holds both against the reference).  Greedy
decoding matches exactly.

Optional comm policy (``repro_torch.policy``): multi-pod serving moves
the prefill KV cache to the decode replicas; ``ServeConfig.comm_policy``
routes that transfer per batch through the unified PolicyEngine (DIRECT
or HIERARCHICAL, :mod:`repro_torch.collectives`), one decision per
``run()`` before the prefill, fed by the ICI cost model at the port's
``H100`` spec.  At that spec the cost model's stall term is 0 for both
modes, so the policy settles on DIRECT (ROADMAP C).  Several engines may
share one PolicyEngine (``comm_engine=``), each on its allocation's
scoped site.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.collectives.modes import CollectiveMode
from repro_torch.collectives.selector import ICICostModel, MeshSpec
from repro_torch.models import registry as model_registry
from repro_torch.models.common import ModelConfig
from repro_torch.policy import DecisionBatch, make_engine
from repro_torch.runtime import resolve_device


@dataclass
class Request:
    prompt: list                     # token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = field(default_factory=list)


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    max_len: int = 1024
    eos_id: int = -1                 # -1: never stop early
    #: repro_torch.policy name routing the prefill->decode KV transfer
    #: (None: no policy, single-replica serving)
    comm_policy: Optional[str] = None
    n_pods: int = 2
    inner_chips: int = 256
    #: multi-allocation serving: the fabric-level tenant id of this
    #: engine.  KV-transfer decisions are keyed on the scoped site
    #: ``(allocation_id, "kv_transfer")`` so several ServeEngines sharing
    #: one PolicyEngine keep independent Algorithm-1 automatons.
    allocation_id: Optional[str] = None


def route_kv_transfer(comm_engine, cost_model, nbytes: int, *,
                      site="kv_transfer", transfer=None, max_retries: int = 2,
                      backoff_s: float = 0.0, fallback_mode=None,
                      sleep=None):
    """One policy decision + model-fed feedback for a KV-cache transfer.

    ``transfer`` (optional) is the callable that moves the bytes with the
    decided mode; a False return or an exception counts as a failed
    attempt.  The decided mode is retried up to ``max_retries`` times
    with exponential backoff (``backoff_s``, doubling; ``sleep`` is
    injectable and defaults to ``time.sleep``), then the transfer falls
    back to ``fallback_mode`` (default ``CollectiveMode.DIRECT``, the
    single-path mode with no hierarchical staging to lose).  Feedback is
    published for the mode that finally carried the bytes.
    ``transfer=None`` decides and predicts only.  Returns that mode."""
    mode = comm_engine.decide(DecisionBatch.single(nbytes, site=site))[0]
    used = mode
    if transfer is not None:
        def attempt(m):
            try:
                return transfer(m) is not False
            except Exception:
                return False

        if sleep is None:
            sleep = time.sleep
        ok = attempt(mode)
        delay = backoff_s
        for _ in range(max_retries):
            if ok:
                break
            if delay > 0.0:
                sleep(delay)
                delay *= 2.0
            ok = attempt(mode)
        if not ok:
            if fallback_mode is None:
                fallback_mode = CollectiveMode.DIRECT
            used = fallback_mode
            if not attempt(used):
                raise RuntimeError(
                    f"kv transfer failed: {max_retries} retries of "
                    f"{mode} and the {used} fallback all failed")
    perf = cost_model.predict(nbytes, used)
    comm_engine.bus.publish_flow_arrays(
        [perf.latency_cycles / 1e3], [perf.stall_cycles_per_flit],
        source="model")
    return used


def kv_bytes(cfg: ModelConfig, prompt_tokens: int) -> int:
    """KV cache volume of one prefilled batch (bf16, all layers), as the
    reference counts it (head dim ``d_model // n_heads``), over all
    ``n_layers``: for the hybrid family that counts every Mamba2 layer
    although only the shared block's applications hold a cache, and for
    the enc-dec family it leaves the cross-attention K/V out, and for the
    VLM it counts the text tokens only, not the ``img_tokens`` image slots
    each row also holds (ROADMAP C10, kept for parity)."""
    heads_kv = cfg.n_kv_heads or cfg.n_heads
    head_dim = cfg.d_model // max(cfg.n_heads, 1)
    return int(2 * cfg.n_layers * heads_kv * head_dim
               * prompt_tokens * 2)  # K+V, bf16


def sampling_probs(lg: torch.Tensor, temperature: float) -> torch.Tensor:
    """The distribution a sampled step draws from: ``softmax(lg /
    max(T, 1e-6))`` over the last axis of float32 logits ``lg`` (the
    reference's ``jax.random.categorical`` argument)."""
    return torch.softmax(lg / max(temperature, 1e-6), dim=-1)


def next_tokens(lg: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
    """``[B]`` int32 tokens from float32 logits ``lg`` ``[B, V]`` (the
    vocabulary without its padding): the argmax at temperature 0, else a
    draw from :func:`sampling_probs` with ``gen``."""
    if temperature > 0:
        probs = sampling_probs(lg, temperature)
        tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
    else:
        tok = torch.argmax(lg, dim=-1)
    return tok.to(torch.int32)


def make_serve_step(cfg: ModelConfig):
    """One-token decode step: ``(model, token, state, temperature,
    generator) -> (token [B,1] int32, state)``."""

    def step(model, token, state, temperature: float,
             gen: torch.Generator):
        logits, state = model_registry.decode_step(model, token, cfg, state)
        lg = logits[:, -1, :cfg.vocab].float()          # drop vocab pad
        return next_tokens(lg, temperature, gen)[:, None], state

    return step


def make_prefill(cfg: ModelConfig):
    def pre(model, batch, state):
        return model_registry.prefill(model, batch, cfg, state)

    return pre


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 comm_engine=None, device=None):
        self.device = resolve_device(device)
        held = {p.device.type for p in params.parameters()}
        if held != {self.device.type}:
            raise ValueError(f"the model is on {sorted(held)}, the engine "
                             f"on {self.device}")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self._step = make_serve_step(cfg)
        self._prefill = make_prefill(cfg)
        self.comm_engine = self._cost_model = None
        #: [(kv_bytes, mode)] per run(): the KV-transfer schedule log
        self.policy_decisions: list = []
        if scfg.comm_policy or comm_engine is not None:
            self._cost_model = ICICostModel(
                MeshSpec(n_pods=scfg.n_pods, inner_chips=scfg.inner_chips))
            self.comm_engine = comm_engine if comm_engine is not None \
                else make_engine(scfg.comm_policy,
                                 mode_a=CollectiveMode.HIERARCHICAL,
                                 mode_b=CollectiveMode.DIRECT,
                                 mode_a_alltoall=CollectiveMode.HIERARCHICAL,
                                 static_mode=CollectiveMode.DIRECT)

    @property
    def kv_site(self):
        """Decision site of this engine's KV transfers: scoped to the
        allocation when ``ServeConfig.allocation_id`` is set."""
        if self.scfg.allocation_id is not None:
            return (self.scfg.allocation_id, "kv_transfer")
        return "kv_transfer"

    def _route_kv_transfer(self, prompt_tokens: int):
        """One engine decision for this batch's prefill->decode transfer."""
        nbytes = kv_bytes(self.cfg, prompt_tokens)
        mode = route_kv_transfer(self.comm_engine, self._cost_model,
                                 nbytes, site=self.kv_site)
        self.policy_decisions.append((nbytes, mode))
        return mode

    def _pad_batch(self, requests: List[Request]) -> torch.Tensor:
        maxp = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.scfg.batch, maxp), np.int32)
        for i, r in enumerate(requests):
            toks[i, maxp - len(r.prompt):] = r.prompt  # left-pad
        return torch.from_numpy(toks).to(self.device)

    def run(self, requests: List[Request], *, seed: int = 0,
            extra: Optional[dict] = None) -> List[Request]:
        assert len(requests) <= self.scfg.batch
        while len(requests) < self.scfg.batch:
            requests.append(Request(prompt=[0], max_new_tokens=0))
        toks = self._pad_batch(requests)
        state = model_registry.make_decode_state(
            self.cfg, self.scfg.batch, self.scfg.max_len, device=self.device)
        batch = {"tokens": toks}
        if extra:   # the enc-dec family's frames, the VLM's patches
            batch.update({k: torch.as_tensor(v, device=self.device)
                          for k, v in extra.items()})
        if self.comm_engine is not None:
            self._route_kv_transfer(self.scfg.batch * toks.shape[1])
        logits, state = self._prefill(self.params, batch, state)
        tok = torch.argmax(logits[:, -1, :self.cfg.vocab],
                           dim=-1).to(torch.int32)[:, None]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        temp = float(max(r.temperature for r in requests))
        n_steps = max(r.max_new_tokens for r in requests)
        done = np.zeros(self.scfg.batch, bool)
        for _ in range(n_steps):
            host = tok[:, 0].tolist()
            for i, r in enumerate(requests):
                if not done[i] and len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(host[i]))
                    if host[i] == self.scfg.eos_id:
                        done[i] = True
                else:
                    done[i] = True
            if bool(done.all()):
                break
            tok, state = self._step(self.params, tok, state, temp, gen)
        return requests
