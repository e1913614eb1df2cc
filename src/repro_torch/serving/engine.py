"""Single-replica batched serving engine (continuous batching over a fixed
slot grid) — the port's counterpart of ``repro.serving.engine``.

A replica owns one KV cache of shape (L, max_batch, max_len, Hkv, HD) on the
model's device; requests claim free slots, are prefilled (prompt prefill
with batch=1, copied into the slot), then advance one token per decode
round together with every other slot. Finished slots are recycled. Greedy
sampling (argmax, first index on ties) keeps the engine deterministic.

A decode round runs the model over every slot, active or not (an inactive
slot's position stays where it was, inside the cache), and brings the
round's tokens to the host in one copy, not one per slot. Positions live on
the host and go to the device once per round.

Queue-depth accounting (``backlog_tokens``) is what the POTUS dispatcher
consumes as ``Q_in`` (paper eq. 16). Fractional ``service_rate`` credit is
accounted exactly with :class:`ServiceCredit`: ``n`` slots at rate ``r``
grant exactly ``floor(n * Fraction(r))`` decode rounds.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from ..models import model_zoo

__all__ = ["Request", "ServiceCredit", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # prompt
    max_new: int = 16
    slot: int = -1
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServiceCredit:
    """Exact fractional service-credit accumulator.

    ``add(rate)`` banks one slot of capacity; ``take()`` withdraws whole
    units (decode rounds) and keeps the exact rational remainder, so the
    carry never drifts however many slots pass and however the per-slot rate
    varies.
    """

    def __init__(self) -> None:
        self._credit = Fraction(0)

    def add(self, rate: float | Fraction) -> None:
        self._credit += Fraction(rate)

    def take(self) -> int:
        units = int(self._credit)  # floor for the non-negative credit
        self._credit -= units
        return units

    @property
    def fractional(self) -> Fraction:
        """The banked sub-unit remainder (exact)."""
        return self._credit


class ServingEngine:
    """One replica serving ``model`` (a ``model_zoo.DenseDecoder``) on the
    model's device: the attention kernels on CUDA, their plain versions on
    the CPU."""

    def __init__(self, cfg, model, max_batch: int = 4, max_len: int = 128,
                 service_rate: float = 1.0):
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        # decode rounds of service capacity per scheduler slot (heterogeneity
        # knob); fractional rates carry exactly via ServiceCredit
        self.service_rate = service_rate
        self._credit = ServiceCredit()
        self.tokens_served = 0  # generated tokens, all requests (throughput ledger)
        self.decode_rounds = 0  # model decode steps run (each over every slot)

        self.device = model.embed.device
        self.cache = model_zoo.init_cache(cfg, max_batch, max_len, self.device)
        self.pos = np.zeros(max_batch, np.int32)  # host copy; sent once per round
        self.cur_tok = torch.zeros((max_batch, 1), dtype=torch.long, device=self.device)
        self.active = np.zeros(max_batch, bool)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []  # admitted, awaiting a slot
        self._pending_emit: list[tuple[int, int]] = []

    # ---- dispatcher-facing metrics -------------------------------------
    @property
    def backlog_tokens(self) -> float:
        """Outstanding work in tokens (queued prompts + remaining decodes)."""
        q = sum(len(r.tokens) + r.max_new for r in self.queue)
        a = sum(
            (r.max_new - len(r.generated)) for r in self.slot_req if r is not None and not r.done
        )
        return float(q + a)

    @property
    def n_free_slots(self) -> int:
        return int((~self.active).sum())

    # ---- request lifecycle ----------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit_one(self) -> bool:
        if not self.queue or not (~self.active).any():
            return False
        slot = int(np.nonzero(~self.active)[0][0])
        req = self.queue.pop(0)
        prompt = torch.as_tensor(np.asarray(req.tokens), dtype=torch.long,
                                 device=self.device)[None, :]
        logits, cache1 = model_zoo.prefill(self.model, self.cfg, {"tokens": prompt},
                                           self.max_len)
        for name, dst in self.cache.items():  # the batch=1 cache into this slot
            dst[:, slot] = cache1[name][:, 0]
        nxt = torch.argmax(logits[0, -1])
        self.cur_tok[slot, 0] = nxt
        tok = int(nxt)
        self.pos[slot] = prompt.shape[1]
        self.active[slot] = True
        req.slot = slot
        req.generated.append(tok)
        self.tokens_served += 1
        self._pending_emit.append((req.rid, tok))
        self.slot_req[slot] = req
        return True

    def _decode_round(self) -> np.ndarray:
        """One decode step over every slot; returns the (max_batch,) greedy
        tokens on the host (one device-to-host copy)."""
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = model_zoo.decode_step(self.model, self.cfg, self.cur_tok, pos,
                                                   self.cache)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        self.cur_tok = nxt[:, None]
        self.decode_rounds += 1
        return nxt.cpu().numpy()

    def step(self, rate: float | None = None, t: int | None = None) -> list[tuple[int, int]]:
        """Advance one scheduler slot; returns [(rid, token)] emitted.

        ``rate`` overrides ``service_rate`` for this slot only — the hook an
        event trace (straggler/throttle ``mu_t`` rows, DESIGN.md §9) drives a
        model-backed fleet through. ``t`` (the slot) is accepted for the
        fleet's common ``step`` protocol and not used.

        Whole decode rounds the slot cannot use (queue and slots empty) are
        forfeited, not banked: an idle replica does not accumulate a service
        burst. Only the sub-unit fractional remainder carries across slots.
        """
        self._credit.add(self.service_rate if rate is None else rate)
        emitted: list[tuple[int, int]] = []
        for _ in range(self._credit.take()):
            emitted.extend(self._pending_emit)
            self._pending_emit.clear()
            while self._admit_one():
                pass
            if not self.active.any():
                break
            nxt = self._decode_round()
            self.pos = self.pos + self.active.astype(np.int32)
            for slot in np.nonzero(self.active)[0]:
                req = self.slot_req[slot]
                tok = int(nxt[slot])
                req.generated.append(tok)
                self.tokens_served += 1
                emitted.append((req.rid, tok))
                if len(req.generated) >= req.max_new or self.pos[slot] >= self.max_len - 1:
                    req.done = True
                    self.active[slot] = False
                    self.slot_req[slot] = None
        emitted.extend(self._pending_emit)
        self._pending_emit.clear()
        return emitted
