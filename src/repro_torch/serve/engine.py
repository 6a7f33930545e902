"""Serving engine: batched prefill + single-token decode with KV caches.

Port of ``repro.serve.engine``.  ``make_serve_step`` builds the decode
step: ONE new token per request against a cache of ``max_len`` rows.
``ServeEngine`` is the host-side continuous-batching wrapper, with the
reference's semantics kept exactly, so that its tokens are the
reference's: a new request is prefilled one token at a time through the
full-batch decode step (every other slot's row at that index is written
with token 0, and its SSM state advanced), and a step decodes every slot
at ``cache_index = positions.max()``.  A step reads its tokens back with
one ``.cpu()``; prefill tokens are written on the device, with no sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.transformer import Model


def make_serve_step(model: Model, *, greedy: bool = True, temperature: float = 1.0):
    """decode step: (cache, tokens (B, 1), cache_index[, generator]) ->
    (next_tokens (B, 1) int64, new_cache, last logits (B, vocab)).  Sampling
    (``greedy=False``) draws from ``softmax(logits / temperature)`` with the
    explicit ``torch.Generator`` it is given."""

    def serve_step(cache, tokens, cache_index, generator: Optional[torch.Generator] = None):
        logits, new_cache = model.apply({"tokens": tokens}, cache=cache,
                                        cache_index=cache_index)
        last = logits[:, -1]
        if greedy:
            nxt = torch.argmax(last, dim=-1)
        else:
            if generator is None:
                raise ValueError("sampling needs a torch.Generator")
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt[:, None], new_cache, last

    return serve_step


def make_prefill_step(model: Model):
    """prefill step: (cache, batch) -> (logits, new_cache), the batch's
    tokens written from cache row 0."""

    def prefill_step(cache, batch):
        return model.apply(batch, cache=cache, cache_index=0)

    return prefill_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Minimal continuous-batching engine (fixed batch slots).

    Slots hold independent requests; decode advances all active slots in one
    step.  Finished slots are refilled from the queue.  The cache is float32
    on the model's device.
    """

    def __init__(self, model: Model, *, slots: int = 4, max_len: int = 512):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.cache = model.init_cache(slots, max_len, dtype=torch.float32)
        self.positions = np.zeros(slots, np.int64)
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self._decode = make_serve_step(model)
        self._uid = 0

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt), max_new))
        return self._uid

    def _fill_slots(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                # prefill this slot token by token through the decode step;
                # each token is filled in on the device (a copy from pageable
                # host memory would wait for the step before it)
                for t in req.prompt:
                    tok = torch.zeros((self.slots, 1), dtype=torch.int64,
                                      device=self.model.device)
                    tok[s].fill_(int(t))
                    _, self.cache, _ = self._decode(self.cache, tok, int(self.positions[s]))
                    self.positions[s] += 1

    def step(self) -> list[tuple[int, list]]:
        """One decode step over all active slots; returns finished
        (uid, tokens)."""
        self._fill_slots()
        if not any(self.active):
            return []
        last_tokens = np.zeros((self.slots, 1), np.int64)
        for s, req in enumerate(self.active):
            if req is not None:
                last_tokens[s, 0] = req.out[-1] if req.out else req.prompt[-1]
        nxt, self.cache, _ = self._decode(self.cache,
                                          torch.from_numpy(last_tokens).to(self.model.device),
                                          int(self.positions.max()))
        nxt = nxt.cpu().numpy()
        finished = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[s, 0]))
            self.positions[s] += 1
            if len(req.out) >= req.max_new:
                finished.append((req.uid, req.out))
                self.active[s] = None
        return finished

    def run(self) -> dict[int, list]:
        done = {}
        while any(self.active) or self.queue:
            for uid, out in self.step():
                done[uid] = out
        return done
