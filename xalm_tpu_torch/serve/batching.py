"""Continuous batching: a slot scheduler over a fixed-batch decode step
(counterpart of ``xalm_tpu/serve/batching.py``, its API and semantics).

- The KV cache is allocated once for ``max_batch`` slots; requests are
  admitted into free slots and retired at EOS or their token limit, and
  every call keeps its shapes, so the captured graphs stay bound to the
  cache's planes (``Engine`` graphs, ``runtime/graphs.py``).
- Free and prefilling slots are masked with the forward's ``valid`` rows:
  their writes go to the ``kv_pos == max_seq_len`` sentinel and they do
  not re-rotate their sinks.
- Prefill is incremental, budgeted and packed: each tick advances every
  admitting request by one chunk of at most ``prefill_budget`` tokens in
  one masked (B, bucket) step (positions are per row), then runs a decode
  segment for every decoding slot.
- Prefix cache: a request that shares at least ``_PREFIX_MIN`` prompt
  tokens with an active slot copies that lane's rows (``copy_lane``, in
  place) instead of prefilling them.
- Per-request sampling: each slot carries its own threefry key
  (``prng.py``), temperature and top-p, so a request's stream depends on
  its seed alone, whatever it is batched with; greedy rows ride
  temperature 0 through the same per-row sampler.

A decode segment is ``segment`` steps of ``Engine.decode_scan`` (greedy)
or ``Engine.sample_scan_rows`` (a batch with a sampled or a logprobs
request), CUDA-graph replays on the card; at ``segment == 1`` a greedy
batch steps eagerly. The keys live on the device, in the sampled scan's
state, and are read back only where the host changes a row's key: at
admission and after a first-token draw.

Each tick's spans (``tick_stats``): the host seconds of the packed prefill
calls, the finishing probe with its first-token pass, the decode segment
with its read, and the rest of the tick; on the card with ``device_times``
also the device milliseconds of the first three (CUDA events, folded into
the totals at the end of each tick, so a running server keeps none).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from xalm_tpu_torch import prng
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.sampler import sample_rows

__all__ = ["Request", "ContinuousBatcher"]

# the widest packed prefill call: the engine's largest chunk bucket
_MAX_CHUNK = Engine.chunk_buckets[-1]
_SPANS = ("prefill", "probe", "decode")


def _event():
    """A timing event on the current CUDA stream (a span's start or end)."""
    return torch.cuda.Event(enable_timing=True)


@dataclasses.dataclass
class Request:
    prompt_ids: list[int]
    max_new_tokens: int = 128
    on_token: Callable[[int], None] | None = None
    stop_on_eos: bool = True
    # per-request sampling (0 = greedy) under the request's own key
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int | None = None
    # OpenAI-style logprobs: 0 = off; N > 0 collects the chosen token's
    # log-prob and min(N, 5) top alternatives per generated token
    logprobs: int = 0
    out_logprobs: list[float] = dataclasses.field(default_factory=list)
    out_top_logprobs: list[list[tuple[int, float]]] = dataclasses.field(default_factory=list)
    # filled by the batcher
    id: int = -1
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_s: float = 0.0
    admitted_s: float = 0.0  # prefill start (slot assigned)
    first_token_s: float = 0.0  # first generated token delivered
    finished_s: float = 0.0


class ContinuousBatcher:
    _PREFIX_MIN = 16  # below this the lane copy costs more than it saves

    def __init__(self, engine: Engine, max_batch: int = 8, segment: int | None = None,
                 prefill_budget: int = 256, device_times: bool = False):
        """``segment``: decode steps a tick (default 8 on the card, 1 on the
        CPU): more than one replays the captured step and reads the tokens
        once a segment; EOS is then seen up to segment - 1 steps late (the
        greedy tokens do not change). ``prefill_budget``: the most prompt
        tokens a tick advances, the bound on how long decoding slots wait
        behind an admitting prompt. ``device_times``: on the card, also time
        each span's device work (two CUDA events a span)."""
        self.engine = engine
        self.max_batch = max_batch
        if segment is None:
            segment = 8 if engine.device.type == "cuda" else 1
        self.segment = max(1, segment)
        self.prefill_budget = max(1, prefill_budget)
        self.cache = engine.new_cache(max_batch)
        self.slots: list[Request | None] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)  # next position a slot
        self._next_tok = np.zeros(max_batch, np.int32)  # the token to feed next
        # the prefill frontier a slot; -1: decoding (or free)
        self._prefill_pos = np.full(max_batch, -1, np.int32)
        self._pend_lp = [None] * max_batch  # the pending token's log-prob
        self._pend_top = [None] * max_batch  # and its top-5
        # the per-slot sampling state; the host's keys are current only
        # while _keys_dev is None (see _samp_np)
        self._keys = np.zeros((max_batch, 2), np.uint32)
        self._temps = np.zeros(max_batch, np.float32)
        self._top_ps = np.ones(max_batch, np.float32)
        self._keys_dev: torch.Tensor | None = None  # the sampled scan's own key buffer
        self._samp_dev = None  # (temps, top_ps) on the device
        self._waiting: list[Request] = []
        self._next_id = 0
        self.completed: list[Request] = []
        self.decode_steps = 0
        self.decoded_tokens = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.ticks = 0
        self._host_s = dict.fromkeys(_SPANS + ("tick",), 0.0)
        self._timed = device_times and engine.device.type == "cuda"
        self._events: list[tuple] = []  # (span, start, end) not yet folded
        self._device_ms = dict.fromkeys(_SPANS, 0.0)

    # ------------------------------------------------- sampling state

    def _samp_np(self) -> np.ndarray:
        """The host's keys, read back from the device first where the
        device's are newer. Call before the host changes a key."""
        if self._keys_dev is not None:
            self._keys = prng.to_numpy(self._keys_dev)
            self._keys_dev = None
        return self._keys

    def _samp_dirty(self) -> None:
        """The host's temperatures or top-ps changed: upload them again at
        the next sampled tick."""
        self._samp_dev = None

    def _samp_rows(self):
        """(temps, top_ps) on the device, uploaded again after a change."""
        if self._samp_dev is None:
            dev = self.engine.device
            self._samp_dev = (torch.from_numpy(self._temps.copy()).to(dev),
                              torch.from_numpy(self._top_ps.copy()).to(dev))
        return self._samp_dev

    def _keys_on_device(self) -> torch.Tensor:
        """The keys on the device: the sampled scan's own buffer where it
        holds the newest, else the host's uploaded."""
        if self._keys_dev is not None:
            return self._keys_dev
        return prng.from_numpy(self._keys).to(self.engine.device)

    # ------------------------------------------------------------ spans

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        if self._timed:
            ev0 = _event()
            ev0.record()
        yield
        if self._timed:
            ev1 = _event()
            ev1.record()
            self._events.append((name, ev0, ev1))
        self._host_s[name] += time.perf_counter() - t0

    def _fold_events(self, wait: bool = False) -> None:
        """Add each finished span's device ms to the totals and drop its
        events; with ``wait``, wait for all of them first."""
        keep = []
        for name, ev0, ev1 in self._events:
            if wait:
                ev1.synchronize()
            if wait or ev1.query():
                self._device_ms[name] += ev0.elapsed_time(ev1)
            else:
                keep.append((name, ev0, ev1))
        self._events = keep

    def tick_stats(self) -> dict:
        """Mean milliseconds a tick: host clock of the packed prefill calls,
        the finishing probe (with the first-token pass and its read), the
        decode segment (with its read) and the host's own work (the rest of
        the tick), and with ``device_times`` on the card the device time of
        the first three (CUDA events around each). A span's host time
        includes waiting for device work that an earlier span enqueued."""
        n = max(self.ticks, 1)
        host = {k: self._host_s[k] * 1e3 / n for k in _SPANS}
        host["own"] = (self._host_s["tick"] - sum(self._host_s[k] for k in _SPANS)) * 1e3 / n
        out = {"ticks": self.ticks, "host_ms": host}
        if self._timed:
            self._fold_events(wait=True)
            out["device_ms"] = {k: v / n for k, v in self._device_ms.items()}
        return out

    def slot_state(self) -> dict:
        """A copy of each slot's decode state: the token it feeds next and
        its position, whether it decodes (not free, not prefilling), its
        threefry key (uint32 pairs, read back from the device where the
        sampled scan holds the newer; the next sampled segment then starts
        from these), temperature and top-p."""
        decoding = np.zeros(self.max_batch, bool)
        decoding[self.decoding_slots()] = True
        return {"token": self._next_tok.copy(), "pos": self._pos.copy(), "decoding": decoding,
                "keys": self._samp_np().copy(), "temps": self._temps.copy(),
                "top_ps": self._top_ps.copy()}

    # ------------------------------------------------------------ warmup

    def warmup(self, sampled: bool = True, logprobs: bool = True) -> float:
        """Build and capture everything the serving loop can run, before
        traffic: a packed prefill call at every bucket a tick can emit, the
        finishing probe, the greedy masked scan, the sampled scan with and
        without log-probs (each captured on the card) and the first-token
        pass. Every call is fully masked: no slot's state or cache row
        changes (masked rows write the sentinel row and keep their keys).
        Returns the seconds spent."""
        t0 = time.perf_counter()
        b, eng = self.max_batch, self.engine
        chunk = min(self.prefill_budget, _MAX_CHUNK)
        for t in sorted({1, *[x for x in eng.chunk_buckets if x <= chunk]}):
            eng.step(np.zeros((b, t), np.int32), np.zeros(b, np.int32), self.cache,
                     np.zeros((b, t), bool), logits_mode="none")
        probe, _ = eng.step(np.zeros((b, 1), np.int32), np.zeros(b, np.int32), self.cache,
                            np.zeros((b, 1), bool), logits_mode="last")
        mask = np.zeros(b, bool)
        out, _ = eng.decode_scan(self._next_tok.copy(), self._pos.copy(), self.cache,
                                 self.segment, valid=mask)
        out.cpu()
        if sampled:
            dev = eng.device
            keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
            temps = torch.zeros((b,), dtype=torch.float32, device=dev)
            tps = torch.ones((b,), dtype=torch.float32, device=dev)
            for lp in (False, True) if logprobs else (False,):
                outs = eng.sample_scan_rows(self._next_tok.copy(), self._pos.copy(), self.cache,
                                            keys, temps, tps, self.segment, valid=mask,
                                            want_lp=lp)
                outs[0].cpu()
            with torch.inference_mode():
                prng.split(keys).cpu()
                sample_rows(probe, keys, temps, tps).cpu()
                if logprobs:
                    for o in sample_rows(probe, keys, temps, tps, return_logprobs=True):
                        o.cpu()
        torch.argmax(probe, -1).cpu()
        return time.perf_counter() - t0

    # ------------------------------------------------------------ lifecycle

    def submit(self, req: Request) -> int:
        if (req.temperature > 0 or req.logprobs) and self.engine.sample_scan_rows is None:
            raise NotImplementedError(
                "this engine has no per-row sampled scan (PipelinedEngine): "
                "submit greedy requests without logprobs"
            )
        req.id = self._next_id
        req.submitted_s = time.perf_counter()
        self._next_id += 1
        self._waiting.append(req)
        return req.id

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self._waiting)

    def cancel(self, req_id: int) -> bool:
        """Stop a request early (a client gone, a stop string matched). Call
        it from the thread that runs ``step``. The request still lands in
        ``completed`` with what it emitted."""
        for j, r in enumerate(self._waiting):
            if r.id == req_id:
                self._waiting.pop(j)
                r.done = True
                r.finished_s = time.perf_counter()
                self.completed.append(r)
                return True
        for i, r in enumerate(self.slots):
            if r is not None and r.id == req_id:
                self._retire(i)
                return True
        return False

    def _shared_prefix(self, req: Request) -> tuple[int, int]:
        """The longest prompt prefix already prefilled in an active slot ->
        (src slot, shared tokens), or (-1, 0) below ``_PREFIX_MIN``. Only a
        slot that has not wrapped its ring (a wrapped slot has overwritten
        its early rows); its rows are valid up to its prefill frontier, or
        the whole prompt once it decodes."""
        best, best_n = -1, 0
        s = self.engine.cfg.max_seq_len
        for j, r in enumerate(self.slots):
            if r is None or int(self._pos[j]) >= s:
                continue
            pj = r.prompt_ids
            avail = len(pj) if self._prefill_pos[j] < 0 else int(self._prefill_pos[j])
            n = 0
            lim = min(len(req.prompt_ids) - 1, avail, s - 1)
            while n < lim and req.prompt_ids[n] == pj[n]:
                n += 1
            if n > best_n:
                best, best_n = j, n
        return (best, best_n) if best_n >= self._PREFIX_MIN else (-1, 0)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self._waiting:
                req = self._waiting.pop(0)
                req.admitted_s = time.perf_counter()
                src, shared = self._shared_prefix(req)
                self.slots[i] = req
                self._prefill_pos[i] = 0
                self._pos[i] = 0
                if src >= 0:
                    # the src lane's rows past `shared` are junk that kv_len
                    # hides until this slot writes over them
                    with torch.inference_mode():
                        self.engine.copy_lane(self.cache, i, src)
                    self._prefill_pos[i] = shared
                    self._pos[i] = shared
                    self.prefix_hits += 1
                    self.prefix_tokens_saved += shared
                self._temps[i] = max(req.temperature, 0.0)
                self._top_ps[i] = req.top_p
                self._samp_dirty()
                if req.temperature > 0:
                    seed = req.seed if req.seed is not None else req.id
                    self._samp_np()[i] = prng.to_numpy(prng.PRNGKey(seed))

    def _prefill_tick(self, slots: list[int]) -> None:
        """Advance every admitting slot by one budgeted chunk in one packed,
        masked step call (rows at their own offsets). The call's width is
        the bucket of the longest chunk; a slot whose bucket would cross the
        ring boundary runs alone at its exact width (a prompt at or past
        the window)."""
        s = self.engine.cfg.max_seq_len
        chunk = min(self.prefill_budget, _MAX_CHUNK)
        plan = []  # (slot, pos, t)
        for i in slots:
            pos = int(self._prefill_pos[i])
            n = len(self.slots[i].prompt_ids)
            if pos + 1 >= s and n - pos > 1:
                t = 1  # the ring would wrap: a token at a time
            else:
                t = min(n - pos, chunk, max(s - pos, 1))
            plan.append((i, pos, t))
        bucket = min(self.engine.chunk_bucket(max(t for _, _, t in plan)), chunk)
        packed = [e for e in plan if e[1] + bucket <= s]
        solo = [e for e in plan if e[1] + bucket > s]
        if packed:
            self._prefill_call(packed, bucket)
        for e in solo:
            # exact width: padding must not cross the ring boundary (the
            # chunk write clamps its window's start, which would misplace
            # the valid rows)
            self._prefill_call([e], e[2])

    def _prefill_call(self, entries: list[tuple[int, int, int]], bucket: int) -> None:
        b, eng = self.max_batch, self.engine
        tokens = np.zeros((b, bucket), np.int32)
        valid = np.zeros((b, bucket), bool)
        posv = self._pos.copy()
        finishing = []
        for i, pos, t in entries:
            ids = self.slots[i].prompt_ids
            tokens[i, :t] = ids[pos:pos + t]
            valid[i, :t] = True
            posv[i] = pos
            if pos + t >= len(ids):
                finishing.append((i, t))
        with self._span("prefill"):
            eng.step(tokens, posv, self.cache, valid, logits_mode="none")
        if finishing:
            with self._span("probe"):
                self._first_tokens(finishing, posv)
        for i, pos, t in entries:
            n = len(self.slots[i].prompt_ids)
            done = pos + t >= n
            self._prefill_pos[i] = -1 if done else pos + t
            self._pos[i] = n if done else pos + t

    def _first_tokens(self, finishing: list[tuple[int, int]], posv: np.ndarray) -> None:
        """The finishing rows' first tokens: one fully masked (B, 1) "last"
        step feeds each its final prompt token at its final position (the
        packed call already wrote that row, and kv_len lets the row attend
        to it; the step writes nothing), then one first-token pass over the
        whole padded batch, whose draws and key advances are kept for the
        finishing rows alone."""
        b, eng = self.max_batch, self.engine
        toks2 = np.zeros((b, 1), np.int32)
        pos2 = posv.copy()
        for i, _ in finishing:
            ids_i = self.slots[i].prompt_ids
            toks2[i, 0] = ids_i[-1]
            pos2[i] = len(ids_i) - 1
        probe, _ = eng.step(toks2, pos2, self.cache, np.zeros((b, 1), bool), logits_mode="last")
        rows = [i for i, _ in finishing]
        lp1 = top1v = top1i = None
        with torch.inference_mode():
            if any(self.slots[i].temperature > 0 or self.slots[i].logprobs for i in rows):
                any_lp = any(self.slots[i].logprobs for i in rows)
                kall = self._samp_np()
                both = prng.split(prng.from_numpy(kall).to(eng.device))  # (B, 2, 2)
                temps, tps = self._samp_rows()
                outs = sample_rows(probe, both[:, 0], temps, tps, return_logprobs=any_lp)
                if any_lp:
                    draw, lp1, top1v, top1i = (o.cpu().numpy() for o in outs)
                else:
                    draw = outs.cpu().numpy()
                adv = prng.to_numpy(both[:, 1])
                kall[rows] = adv[rows]  # the other rows' keys stay as they were
            else:
                draw = torch.argmax(probe, -1).cpu().numpy()
        for i in rows:
            self._next_tok[i] = int(draw[i])
            if self.slots[i].logprobs and lp1 is not None:
                self._pend_lp[i] = float(lp1[i])
                self._pend_top[i] = list(zip(top1i[i].tolist(), top1v[i].tolist()))
            else:
                self._pend_lp[i] = self._pend_top[i] = None

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        req.finished_s = time.perf_counter()
        self.completed.append(req)
        self.slots[slot] = None
        self._prefill_pos[slot] = -1

    def _emit(self, slot: int, tok: int, lp=None, top=None) -> bool:
        """Deliver one generated token; True if the request stops."""
        req = self.slots[slot]
        if not req.out_tokens:
            req.first_token_s = time.perf_counter()
        req.out_tokens.append(tok)
        if req.logprobs and lp is not None:
            req.out_logprobs.append(float(lp))
            req.out_top_logprobs.append(top[:min(req.logprobs, 5)] if top else [])
        if req.on_token:
            req.on_token(tok)
        tokenizer = self.engine.tokenizer
        stop = req.stop_on_eos and tokenizer is not None and tokenizer.is_stop(tok)
        return stop or len(req.out_tokens) >= req.max_new_tokens

    # ------------------------------------------------------------ tick

    def step(self) -> bool:
        """One scheduler tick: admit, packed budgeted prefill chunks, a
        decode segment for every decoding slot, retire. Returns False when
        nothing is left to do."""
        t0 = time.perf_counter()
        try:
            return self._tick()
        finally:
            self.ticks += 1
            self._host_s["tick"] += time.perf_counter() - t0
            if self._events:  # the tick's reads waited for its spans' work
                self._fold_events()

    def decoding_slots(self) -> list[int]:
        """The slots that decode: holding a request whose prompt is in."""
        return [i for i, s in enumerate(self.slots) if s is not None and self._prefill_pos[i] < 0]

    def _tick(self) -> bool:
        self._admit()
        prefilling = [i for i, s in enumerate(self.slots)
                      if s is not None and self._prefill_pos[i] >= 0]
        if prefilling:
            self._prefill_tick(prefilling)
        decoding = self.decoding_slots()
        if not decoding:
            return bool(self._waiting) or any(s is not None for s in self.slots)
        # each decoding slot's _next_tok is its freshly drawn token: emit it
        for i in decoding:
            if self._emit(i, int(self._next_tok[i]), lp=self._pend_lp[i], top=self._pend_top[i]):
                self._retire(i)
        decoding = self.decoding_slots()
        if not decoding:
            return bool(self._waiting) or any(s is not None for s in self.slots)

        b, eng = self.max_batch, self.engine
        sampling = any(self.slots[i].temperature > 0 or self.slots[i].logprobs for i in decoding)
        if self.segment > 1 or sampling:
            # every non-decoding row is masked: a free or prefilling slot's
            # junk decode would run through its ring and, past the window,
            # overwrite live rows and re-rotate its sinks
            mask = np.zeros(b, bool)
            mask[decoding] = True
            lps = topv = topi = None
            with self._span("decode"):
                if sampling:
                    want_lp = any(self.slots[i].logprobs for i in decoding)
                    temps, tps = self._samp_rows()
                    outs = eng.sample_scan_rows(self._next_tok.copy(), self._pos.copy(),
                                                self.cache, self._keys_on_device(), temps, tps,
                                                self.segment, valid=mask, want_lp=want_lp)
                    self._keys_dev = outs[-1]  # stays on the device
                    out = outs[0].cpu().numpy()
                    if want_lp:
                        lps, topv, topi = (o.cpu().numpy() for o in outs[1:4])
                else:
                    out, _ = eng.decode_scan(self._next_tok.copy(), self._pos.copy(), self.cache,
                                             self.segment, valid=mask)
                    out = out.cpu().numpy()

            def tt(i, j):
                if topi is None:
                    return None, None
                return lps[i, j], list(zip(topi[i, j].tolist(), topv[i, j].tolist()))

            delivered = 0
            for i in decoding:
                stopped = False
                # emit all but the last token; the last is the pending
                # _next_tok, emitted at the next tick
                for j, tok in enumerate(out[i, :-1]):
                    delivered += 1
                    lp_j, top_j = tt(i, j)
                    if self._emit(i, int(tok), lp=lp_j, top=top_j):
                        stopped = True
                        break
                if stopped:
                    self._retire(i)
                else:
                    self._next_tok[i] = int(out[i, -1])
                    self._pend_lp[i], self._pend_top[i] = tt(i, self.segment - 1)
                    self._pos[i] += self.segment
                    delivered += 1  # the pending token, emitted next tick
            self.decode_steps += self.segment
            self.decoded_tokens += delivered
            return True

        valid = np.zeros((b, 1), bool)
        valid[decoding] = True
        with self._span("decode"):
            logits, _ = eng.step(self._next_tok.reshape(b, 1).copy(), self._pos.copy(),
                                 self.cache, valid, logits_mode="last")
            nxt = torch.argmax(logits, -1).cpu().numpy()
        for i in decoding:
            self._next_tok[i] = int(nxt[i])
            self._pend_lp[i], self._pend_top[i] = None, None
            self._pos[i] += 1
        self.decode_steps += 1
        self.decoded_tokens += len(decoding)
        return True

    def run(self) -> list[Request]:
        """Drain every submitted request to completion."""
        while self.step():
            pass
        return self.completed

    # ------------------------------------------------------------ reporting

    def latency_stats(self) -> dict:
        """p50/p95 latencies over the completed requests (seconds): queue
        wait (submit -> slot), time to the first token (submit -> first
        generated token) and the per-token decode latency."""
        done = [r for r in self.completed if r.out_tokens]
        if not done:
            return {}

        def pct(vals, q):
            return float(np.percentile(np.asarray(vals), q))

        queue = [r.admitted_s - r.submitted_s for r in done]
        ttft = [r.first_token_s - r.submitted_s for r in done]
        tok_lat = [(r.finished_s - r.first_token_s) / max(len(r.out_tokens) - 1, 1) for r in done]
        return {
            "completed": len(done),
            "queue_wait_p50_s": pct(queue, 50),
            "queue_wait_p95_s": pct(queue, 95),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "tok_latency_p50_s": pct(tok_lat, 50),
            "tok_latency_p95_s": pct(tok_lat, 95),
        }
