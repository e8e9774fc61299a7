"""Batched serving engine: prefill and a decode loop (the port of
``repro.serve.engine``).

Fixed-size batch slots, greedy or temperature sampling, EOS handling, the
KV cache threaded through functionally. The host checks for batch
completion only every ``sync_every`` decode steps, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["GenerationConfig", "Engine", "AdmissionController"]


@dataclasses.dataclass
class AdmissionController:
    """Deadline / queue-depth admission control for a serving loop.

    The graceful-degradation policy shared with the cycle-accurate NoC
    serving model (``noc.online.simulate_online``): a request
    offered while ``max_queue_depth`` admitted requests are still
    outstanding is *shed* (rejected at admission, never started), and an
    admitted request whose completion latency exceeds ``deadline`` time
    units - or that completes ``failed`` - misses its SLO. This object is
    pure bookkeeping: the caller drives time (cycles, seconds - any
    monotone clock) through ``offer``/``complete`` and reads ``stats``.

    Goodput counts only SLO-attained completions, per 1000 time units of
    busy span (first offer to last completion), matching
    ``OnlineResult.goodput`` so engine-level and NoC-level numbers are
    directly comparable.
    """
    max_queue_depth: Optional[int] = None
    deadline: Optional[float] = None
    offered: int = 0
    shed: int = 0
    failed: int = 0
    slo_attained: int = 0
    completed: int = 0
    _outstanding: dict = dataclasses.field(default_factory=dict)
    _t_first: Optional[float] = None
    _t_last: Optional[float] = None

    def __post_init__(self):
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 when set")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError("deadline must be > 0 when set")

    @property
    def queue_depth(self) -> int:
        return len(self._outstanding)

    def offer(self, req_id, now: float) -> bool:
        """Offer a request at time ``now``; True iff admitted."""
        self.offered += 1
        if self._t_first is None or now < self._t_first:
            self._t_first = now
        if (self.max_queue_depth is not None
                and len(self._outstanding) >= self.max_queue_depth):
            self.shed += 1
            return False
        if req_id in self._outstanding:
            raise ValueError(f"request {req_id!r} already outstanding")
        self._outstanding[req_id] = now
        return True

    def complete(self, req_id, now: float, failed: bool = False) -> bool:
        """Mark an admitted request finished; True iff it made its SLO."""
        start = self._outstanding.pop(req_id)
        self.completed += 1
        self._t_last = now if self._t_last is None else max(self._t_last, now)
        if failed:
            self.failed += 1
            return False
        ok = self.deadline is None or (now - start) <= self.deadline
        self.slo_attained += int(ok)
        return ok

    def stats(self) -> dict:
        span = (None if self._t_first is None or self._t_last is None
                else max(self._t_last - self._t_first, 1.0))
        return {
            "offered": self.offered,
            "admitted": self.offered - self.shed,
            "shed": self.shed,
            "completed": self.completed,
            "failed": self.failed,
            "outstanding": len(self._outstanding),
            "slo_attained": self.slo_attained,
            "slo_attainment": (self.slo_attained / self.offered
                               if self.offered else None),
            "goodput": (1000.0 * self.slo_attained / span
                        if span else None),
        }


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0         # 0 = greedy
    eos_id: int = -1                 # -1 = never stop early
    sync_every: int = 8              # decode steps between host done-checks


class Engine:
    def __init__(self, model, params, context: int):
        self.model = model
        self.params = params
        self.context = context
        self._decode = model.decode_step

    def generate(self, prompts: torch.Tensor, gen: GenerationConfig,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """prompts (B, S) int -> (B, L) int32, L <= max_new_tokens.

        The decode loop reads ``done`` on the host only every
        ``gen.sync_every`` steps: a per-step read blocks on every decode
        step. Finished rows keep emitting ``eos_id``, so the output of a
        per-step early-exit loop is recovered from the tokens alone: trim to
        the first step at which every row's output holds ``eos_id``. The
        result equals the per-step loop's; early exit still happens, within
        ``sync_every`` steps of batch completion.

        Temperature sampling draws from ``generator`` (a ``torch.Generator``
        on the prompts' device; a fresh one seeded 0 when None).
        """
        b, s = prompts.shape
        logits, cache = self.model.prefill(self.params, prompts, self.context)
        if gen.temperature > 0.0 and generator is None:
            generator = torch.Generator(prompts.device).manual_seed(0)
        sync = max(1, gen.sync_every)
        out = []
        tok = self._sample(logits, gen, generator)
        done = torch.zeros((b,), dtype=torch.bool, device=prompts.device)
        for i in range(gen.max_new_tokens):
            out.append(tok)
            done = done | (tok == gen.eos_id)
            if i == gen.max_new_tokens - 1:
                break
            if i % sync == sync - 1 and bool(done.all()):
                break
            pos = torch.full((b,), s + i, dtype=torch.int32,
                             device=prompts.device)
            logits, cache = self._decode(self.params, tok, cache, pos)
            tok = self._sample(logits, gen, generator)
            tok = torch.where(done, gen.eos_id, tok)
        toks = torch.stack(out, dim=1)
        all_done = np.logical_or.accumulate(
            toks.cpu().numpy() == gen.eos_id, axis=1).all(axis=0)
        if all_done.any():
            toks = toks[:, :int(all_done.argmax()) + 1]
        return toks

    @staticmethod
    def _sample(logits, gen: GenerationConfig, generator):
        if gen.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / gen.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
