"""Batched serving engine with a slot-based KV cache pool (port of
``repro/serving/engine.py``).

Per-request positions (ragged decode), slot reuse on completion, greedy or
temperature sampling, max-token and EOS stopping.  One decode step is one
forward over the whole slot pool with sampling on the device, and one host
sync (the sampled tokens).  Greedy is ``argmax`` (first index on ties, as in
JAX); temperature sampling is Gumbel-max with noise from the engine's own
``torch.Generator``, so a seeded engine is deterministic.

The forward functions are pluggable: the split runtime's bank supplies its
prefill/decode/cloud-step closures, shared by every engine of a split;
stand-alone engines use ``models.model``.  For the streamed decode transport
(``submit_streamed`` + ``stream_step``) the request holds no pool slot: the
caller owns its cloud-side stage cache.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.runtime import metrics
from repro_torch.tree import tree_map


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    record_logits: bool = False         # keep per-step logits (host copies)
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    logits_history: list = dataclasses.field(default_factory=list)
    done: bool = False


def _write_slot(pool, new, slot: int):
    """Copy a single-request cache (batch 1) into batch slot ``slot`` of the
    pool, in place.  Seq axes (axis 2 up) shorter than the pool's are padded
    with zeros, so a reused slot keeps nothing of its last request."""
    def copy(pool_leaf, new_leaf):
        dst = pool_leaf[:, slot:slot + 1]
        dst.zero_()
        dst[(slice(None), slice(None)) +
            tuple(slice(0, s) for s in new_leaf.shape[2:])].copy_(new_leaf)
    tree_map(copy, pool, new)


def _sample_rows(row: torch.Tensor, temps: torch.Tensor,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    """row (B, V) f32, temps (B,) -> (B,) int64 tokens on the device: greedy
    where temp <= 0, Gumbel-max over row / temp elsewhere."""
    greedy = torch.argmax(row, dim=-1)
    if gen is None:
        return greedy
    u = torch.rand(row.shape, generator=gen, device=row.device)
    gumbel = -torch.log(-torch.log(u))
    safe_t = torch.clamp(temps, min=1e-6)[:, None]
    sampled = torch.argmax(row / safe_t + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


class ServingEngine:
    def __init__(self, params, built: M.BuiltModel, *, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0, stages=None,
                 prefill_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None,
                 stream_fn: Optional[Callable] = None, device="cuda",
                 profiler=None, profile_key: tuple = (), cache_cfg=None,
                 cache_in: Optional[Callable] = None):
        self.device = dev_lib.resolve(device)
        self.params = params
        self.built = built
        self.cfg = built.cfg
        self.max_batch = max_batch
        self.max_len = max_len
        dt = dev_lib.torch_dtype(self.cfg.dtype)
        stage_segs = stages if stages is not None else \
            [list(segs) for segs in built.stages]
        # a tensor-parallel engine's pool holds its rank's kv heads
        # (``cache_cfg``), and ``cache_in`` brings admitted caches to them
        self.cache = [tfm.init_stage_cache(list(segs), cache_cfg or self.cfg,
                                           max_batch, max_len, dt, self.device)
                      for segs in stage_segs]
        self._cache_in = cache_in
        self.positions = np.zeros((max_batch,), np.int64)   # next write pos
        self.active: List[Optional[Request]] = [None] * max_batch
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = prefill_fn or self._default_prefill
        self._decode = decode_fn or self._default_decode
        self._stream = stream_fn
        self._last = np.zeros((max_batch, 1), np.int64)     # last token/slot
        self._temps = np.zeros((max_batch,), np.float32)
        self._uid = 0
        self.decode_steps = 0
        # opt-in wall-clock attribution of the sampled steps
        # (runtime.metrics.JitProfiler); profile_key tells apart engines that
        # share the bank's step functions (the bank's (split, mp))
        self._profiler = profiler
        self._profile_key = tuple(profile_key)

    # ------------------------------------------------------------------ api
    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               record_logits: bool = False) -> Request:
        req = self._new_request(np.asarray(prompt, np.int32), max_new_tokens,
                                temperature, eos_id, record_logits)
        slot = self._free_slot()
        S = len(req.prompt)
        self._check_len(S)
        toks = dev_lib.as_tensor(req.prompt[None], self.device)
        logits, caches = self._prefill(self.params, toks)
        self._admit(slot, req, S, caches, logits[0, -1])
        return req

    def submit_prefilled(self, prompt_len: int, caches, last_logits,
                         max_new_tokens: int = 32, temperature: float = 0.0,
                         eos_id: Optional[int] = None,
                         record_logits: bool = False) -> Request:
        """Admit a request whose prefill ran elsewhere (the split runtime's
        edge/cloud halves): copy its per-stage caches (batch 1) into a free
        slot and sample the first token from the given last-position
        logits."""
        self._check_len(prompt_len)
        req = self._new_request(np.zeros((prompt_len,), np.int32),
                                max_new_tokens, temperature, eos_id,
                                record_logits)
        self._admit(self._free_slot(), req, prompt_len, caches,
                    dev_lib.as_tensor(last_logits, self.device))
        return req

    def submit_streamed(self, prompt_len: int, last_logits,
                        max_new_tokens: int = 32, temperature: float = 0.0,
                        eos_id: Optional[int] = None,
                        record_logits: bool = False) -> Request:
        """Admit a streamed-decode request: it holds NO pool slot; the
        caller owns the cloud-side stage cache and applies each arrived row
        through :meth:`stream_step`."""
        self._check_len(prompt_len)
        req = self._new_request(np.zeros((prompt_len,), np.int32),
                                max_new_tokens, temperature, eos_id,
                                record_logits)
        last_logits = dev_lib.as_tensor(last_logits, self.device)
        if req.record_logits:
            req.logits_history.append(last_logits.cpu().numpy())
        tok = self._sample(last_logits, req)
        req.generated.append(tok)
        if (req.eos_id is not None and tok == req.eos_id) or \
                req.max_new_tokens <= 1:
            req.done = True
        return req

    def stream_step(self, req: Request, cache, payload, scales, pos: int):
        """Single-slot streamed decode: apply one edge row to ``cache`` (the
        request's cloud-side stage cache, updated in place) and return
        ``(token, cache)``."""
        if self._stream is None:
            raise RuntimeError("engine built without stream_fn")

        def sampled_step(payload, scales, cache, pos):
            logits, cache = self._stream(self.params, payload, scales, cache,
                                         pos)
            row = logits[:, 0].float()
            temps = torch.tensor([req.temperature], dtype=torch.float32,
                                 device=self.device)
            gen = self.gen if req.temperature > 0 else None
            return _sample_rows(row, temps, gen), row, cache

        toks, row, cache = self._dispatch(
            "engine_stream_step", sampled_step,
            dev_lib.as_tensor(payload, self.device),
            dev_lib.as_tensor(scales, self.device), cache,
            torch.tensor([pos], dtype=torch.int64, device=self.device))
        tok = int(toks.cpu()[0])                            # the one host sync
        if req.record_logits:
            req.logits_history.append(row[0].cpu().numpy())
        req.generated.append(tok)
        self.decode_steps += 1
        if (req.eos_id is not None and tok == req.eos_id) or \
                len(req.generated) >= req.max_new_tokens:
            req.done = True
        return tok, cache

    @property
    def num_active(self) -> int:
        return sum(1 for r in self.active if r is not None)

    def run(self, requests_done: Optional[Callable[[], bool]] = None,
            max_steps: int = 10_000):
        """Decode until all slots drain, ``max_steps`` elapse, or the
        ``requests_done`` predicate (checked between steps) fires."""
        steps = 0
        while any(r is not None for r in self.active) and steps < max_steps:
            if requests_done is not None and requests_done():
                break
            self.step()
            steps += 1

    # ------------------------------------------------------------- internals
    def _check_len(self, prompt_len: int):
        if prompt_len >= self.max_len:
            raise ValueError(f"prompt of {prompt_len} tokens exceeds the "
                             f"{self.max_len}-long cache")

    def _new_request(self, prompt, max_new_tokens, temperature, eos_id,
                     record_logits) -> Request:
        req = Request(self._uid, prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_id=eos_id,
                      record_logits=record_logits)
        self._uid += 1
        return req

    def _free_slot(self) -> int:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        raise RuntimeError("engine full; drain before submitting")

    def _default_prefill(self, params, toks):
        return M.forward_prefill(params, self.built, {"tokens": toks})

    def _default_decode(self, params, tokens, caches, pos):
        return M.forward_decode(params, self.built, tokens, caches, pos)

    def _admit(self, slot: int, req: Request, prompt_len: int, caches,
               last_logits):
        if self._cache_in is not None:
            caches = self._cache_in(caches)
        _write_slot(self.cache, caches, slot)
        self.positions[slot] = prompt_len
        self.active[slot] = req
        if req.record_logits:
            req.logits_history.append(last_logits.cpu().numpy())
        self._emit(slot, req, self._sample(last_logits, req))

    def _emit(self, slot: int, req: Request, tok: int):
        """Record a sampled first token and retire single-token requests."""
        req.generated.append(tok)
        self._last[slot, 0] = tok
        self._temps[slot] = req.temperature
        if (req.eos_id is not None and tok == req.eos_id) or \
                req.max_new_tokens <= 1:
            req.done = True
            self.active[slot] = None

    def _dispatch(self, kind: str, fn, *args):
        """Run a sampled step, through the wall-clock profiler if one is
        attached, inside the span ``engine.<step>`` (``kind`` without its
        ``engine_``; ``runtime.metrics.span``)."""
        with metrics.span("engine." + kind.removeprefix("engine_"),
                          self.device):
            if self._profiler is None:
                return fn(*args)
            return self._profiler.timed((kind,) + self._profile_key, fn,
                                        *args)

    def _sampled_decode(self, tokens, caches, pos, temps):
        logits, caches = self._decode(self.params, tokens, caches, pos)
        row = logits[:, 0].float()                          # (B, V)
        gen = self.gen if bool((self._temps > 0).any()) else None
        return _sample_rows(row, temps, gen), row, caches

    def _sample(self, logits, req: Request) -> int:
        row = logits.reshape(1, -1).float()
        temps = torch.tensor([req.temperature], dtype=torch.float32,
                             device=row.device)
        gen = self.gen if req.temperature > 0 else None
        return int(_sample_rows(row, temps, gen).cpu()[0])

    def step(self):
        """One batched decode step over all active slots: one forward with
        sampling on the device and a single host sync for the tokens."""
        if not any(r is not None for r in self.active):
            return
        toks, row, self.cache = self._dispatch(
            "engine_step", self._sampled_decode,
            torch.tensor(self._last, device=self.device), self.cache,
            torch.tensor(self.positions, device=self.device),
            torch.tensor(self._temps, device=self.device))
        toks_host = toks.cpu().numpy()                      # the one host sync
        logits_host = None
        self.decode_steps += 1
        for i, r in enumerate(self.active):
            if r is None:
                continue
            self.positions[i] += 1
            tok = int(toks_host[i])
            self._last[i, 0] = tok
            if r.record_logits:
                if logits_host is None:
                    logits_host = row.cpu().numpy()
                r.logits_history.append(logits_host[i])
            r.generated.append(tok)
            if (r.eos_id is not None and tok == r.eos_id) or \
                    len(r.generated) >= r.max_new_tokens or \
                    self.positions[i] >= self.max_len - 1:
                r.done = True
                self.active[i] = None
