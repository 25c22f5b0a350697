"""Batched serving engine.

Counterpart of ``repro/serve/engine.py``: a static-batch engine.
Requests are left-padded with token 0 into a fixed batch (no mask, as
in the reference), filler requests ``Request(prompt=[0],
max_new_tokens=0)`` fill the batch, the batch is prefilled once and
then decoded one token per step.  The first token is the argmax of the
prefill's last logits; each step drops the padded vocabulary and picks
greedily at temperature 0 or samples at the batch's highest
temperature.  The engine runs on the CUDA card unless given
``device="cpu"``.

Sampling draws from a ``torch.Generator`` seeded from ``run``'s
``seed``; it cannot match the reference's ``jax.random`` draws token for
token, only in distribution.  Greedy decoding matches exactly.

Routing the prefill->decode KV transfer through a communication policy
(``ServeConfig.comm_policy``, a shared ``comm_engine``,
``route_kv_transfer``) waits for the policy and collectives port
(ROADMAP A.2 / A.4) and raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import registry as model_registry
from repro_torch.models.common import ModelConfig
from repro_torch.runtime import resolve_device

_POLICY_PENDING = ("KV-transfer routing through a communication policy "
                   "is not ported yet (ROADMAP A.2 / A.4)")


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
    #: policy name routing the prefill->decode KV transfer (not ported:
    #: anything but None raises)
    comm_policy: Optional[str] = None
    n_pods: int = 2
    inner_chips: int = 256
    allocation_id: Optional[str] = None


def route_kv_transfer(*args, **kwargs):
    """Not ported yet: see ROADMAP A.2 / A.4."""
    raise NotImplementedError(_POLICY_PENDING)


def make_serve_step(cfg: ModelConfig):
    """One-token decode step: ``(model, token, state, temperature,
    generator) -> (token [B,1] int32, state)``."""

    def step(model, token, state, temperature: float,
             gen: torch.Generator):
        logits, state = model_registry.decode_step(model, token, cfg, state)
        lg = logits[:, -1, :cfg.vocab].float()          # drop vocab pad
        if temperature > 0:
            probs = torch.softmax(lg / max(temperature, 1e-6), dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(lg, dim=-1)
        return tok.to(torch.int32)[:, None], state

    return step


def make_prefill(cfg: ModelConfig):
    def pre(model, batch, state):
        return model_registry.prefill(model, batch, cfg, state)

    return pre


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 comm_engine=None, device=None):
        if scfg.comm_policy or comm_engine is not None:
            raise NotImplementedError(_POLICY_PENDING)
        self.device = resolve_device(device)
        held = {p.device.type for p in params.parameters()}
        if held != {self.device.type}:
            raise ValueError(f"the model is on {sorted(held)}, the engine "
                             f"on {self.device}")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self._step = make_serve_step(cfg)
        self._prefill = make_prefill(cfg)

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
        if extra:
            batch.update(extra)
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
