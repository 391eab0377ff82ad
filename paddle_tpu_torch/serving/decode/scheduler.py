"""Continuous-batching scheduler: prefill/decode split, slot admission,
eviction under KV-pool pressure.

The shape insight (vLLM-style continuous batching, translated to AOT
artifacts): the decode step is ONE fixed-shape dispatch — one token per
slot — so sequences of wildly different lengths share a batch, and a
sequence that finishes frees its slot for a WAITING sequence at the very
next iteration. There is no drain-to-empty barrier: admission happens
into the in-flight batch. The alternative (static batching: admit N,
decode until ALL N finish) wastes every slot whose sequence finished
early — the `decode` bench config measures exactly that gap, and this
scheduler also implements the static mode (`continuous=False`) to BE the
honest baseline.

Split responsibilities:

    prefill   the prompt runs ONCE through the length-bucketed
              full-attention artifacts (the PR-5 ModelVersion, padding
              and all), emitting the first token AND every layer's K/V
              rows, which seed the sequence's pool blocks;
    decode    each iteration advances every RUNNING sequence one token
              through the paged decode-step artifact.

Eviction/preemption: when a sequence needs a KV block and the pool has
none, the lowest-priority (then youngest) victim is preempted — blocks
freed, sequence re-queued at the waiting front. A resumed sequence
re-prefills prompt+generated (greedy decode is a pure function of the
prefix, so the continuation is token-identical — tested). Shedding is
typed through PR-5's admission machinery: `Overloaded` (queue/pool
pressure, retryable) and `DeadlineExceeded` (the remaining-token
estimate — tokens left x EWMA step seconds — says the deadline is
unmeetable, or it already passed).

KV economics (PT_KV_SHARE / PT_SPEC_DRAFT, decode/prefix.py +
decode/spec.py): with a prefix index armed, admission aliases the
resident prefix of a new prompt into its block table (pool refcounts;
one copy backs N sessions) and copy-on-write keeps shared blocks
immutable — the first decode write into an aliased partial block
copies it out first (`_cow_for_write`). Under pool pressure the
scheduler releases cached-prefix references LRU-leaf-first BEFORE
preempting running sequences. With a drafter armed, idle slots verify
drafted tokens in the same fixed-shape step (decode/spec.py explains
the slot-packing), greedy acceptance keeps output token-identical to
plain decode, and block growth is provisioned for the FULL draft
window up front — speculation may be dropped for a step (never evicts
a peer) when the pool can't cover it.

Copied from ``paddle_tpu/serving/decode/scheduler.py``; the port
carries its own copy because it never imports the JAX package.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np

from ...obs import trace as obs_trace
from ...resilience import faults
from ..admission import (AdmissionController, DeadlineExceeded,
                         ModelUnavailable, Overloaded)
from ..metrics import DecodeMetrics
from .kv_cache import KVBlockPool, PoolExhausted, block_table_row
from .spec import accept_greedy

__all__ = ["GenerationHandle", "Sequence", "DecodeScheduler"]

_TOK, _DONE, _ERR = 0, 1, 2


class GenerationHandle:
    """The caller's view of one generation: a token stream plus a final
    result. Tokens arrive on an internal queue as the scheduler emits
    them; `stream()` yields them live, `result()` blocks to the end.
    Terminal failures (typed serving errors) raise from either."""

    def __init__(self, prompt_len: int):
        self.prompt_len = prompt_len
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None

    # -- scheduler side ------------------------------------------------------
    def _put_token(self, tok: int) -> None:
        self._q.put((_TOK, tok))

    def _finish(self, result: dict) -> None:
        self._result = result
        self._done.set()
        self._q.put((_DONE, result))

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()
        self._q.put((_ERR, exc))

    # -- caller side ---------------------------------------------------------
    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as they are generated; returns when the sequence
        finishes, raises its typed error if it was shed/failed, raises
        TimeoutError (like result()) when no token arrives in time."""
        while True:
            try:
                kind, val = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    "generation still in progress") from None
            if kind == _TOK:
                yield val
            elif kind == _DONE:
                return
            else:
                raise val

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until the sequence finishes; returns {"tokens",
        "finish_reason", "evictions", "prompt_len"}."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in progress")
        if self._error is not None:
            raise self._error
        return dict(self._result)

    def done(self) -> bool:
        return self._done.is_set()


class Sequence:
    """Scheduler-internal state of one generation request."""

    __slots__ = ("sid", "prompt", "max_new", "deadline_t", "priority",
                 "eos_id", "handle", "t_submit", "generated", "blocks",
                 "slot", "cached_len", "evictions", "ctx")

    def __init__(self, sid: int, prompt: List[int], max_new: int,
                 deadline_t: Optional[float], priority: int,
                 eos_id: Optional[int], handle: GenerationHandle):
        self.sid = sid
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_t = deadline_t
        self.priority = priority
        self.eos_id = eos_id
        self.handle = handle
        self.t_submit = time.monotonic()
        self.generated: List[int] = []
        self.blocks: List[int] = []
        self.slot: Optional[int] = None
        #: pool positions holding this sequence's K/V; the LAST generated
        #: token is never cached (it is the next step's input)
        self.cached_len = 0
        self.evictions = 0
        #: submitter's trace context (the HTTP ingress span) — the
        #: scheduler thread parents this sequence's prefill/evict/resume
        #: events under it (obs/trace.py)
        self.ctx = obs_trace.current_context() if obs_trace.enabled() \
            else None

    @property
    def tokens_so_far(self) -> List[int]:
        return self.prompt + self.generated

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.generated)


class DecodeScheduler:
    """One model's generation scheduler: a submission queue drained by
    one scheduler thread that interleaves prefill admission with
    fixed-shape decode steps over the in-flight slot batch.

    model: DecodeModel-like — max_prompt_len, max_context, slots,
    block_size, eos_id, prefill(tokens) -> (last_logits, kv_rows),
    seed_sequence(blocks, kv_rows), decode_step(tokens, lens, tables)
    -> logits [slots, vocab], free capacity given by the injected pool.
    """

    def __init__(self, model, pool: KVBlockPool,
                 admission: AdmissionController,
                 metrics: Optional[DecodeMetrics] = None, *,
                 continuous: bool = True, name: str = "model",
                 prefix_index=None, drafter=None, spec_k: int = 0):
        self.model = model
        self.pool = pool
        self.admission = admission
        self.metrics = metrics or DecodeMetrics(name)
        self.continuous = continuous
        self.name = name
        #: scheduler-thread-owned, like _waiting/_running
        self.index = prefix_index
        self.drafter = drafter
        self.spec_k = max(0, int(spec_k)) if drafter is not None else 0
        self._cv = threading.Condition()
        self._incoming: List[Sequence] = []
        self._waiting: List[Sequence] = []   # scheduler-thread-owned
        self._running: List[Sequence] = []   # scheduler-thread-owned
        self._load = 0                       # live sequences, any state
        self._next_sid = 0
        self._closed = False
        self._drained = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"pt-decode[{name}]")
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def queued(self) -> int:
        with self._cv:
            return self._load

    def submit(self, prompt: Seq[int], max_new: int,
               deadline_ms: Optional[float] = None, priority: int = 0,
               eos_id: Optional[int] = None) -> GenerationHandle:
        """Admit one generation request. Typed admission errors raise
        HERE (reject-fast); later shedding surfaces on the handle."""
        deadline_t = self.admission.deadline_for(deadline_ms)
        handle = GenerationHandle(len(prompt))
        with self._cv:
            if self._closed:
                raise ModelUnavailable(
                    f"decode engine {self.name!r} is shut down")
            try:
                self.admission.admit(self._load, deadline_t,
                                     model=self.name)
            except DeadlineExceeded:
                self.metrics.on_shed("deadline")
                raise
            except Exception:
                self.metrics.on_shed("overload")
                raise
            seq = Sequence(self._next_sid, list(prompt), int(max_new),
                           deadline_t, int(priority),
                           eos_id if eos_id is not None
                           else self.model.eos_id, handle)
            self._next_sid += 1
            self._incoming.append(seq)
            self._load += 1
            self.metrics.on_received()
            self._cv.notify()
        return handle

    def while_idle(self, fn):
        """Run fn() under the scheduler lock with ZERO live sequences —
        submit() blocks on the same lock, so nothing can be admitted (and
        no decode step can start) while fn mutates pool state. Raises if
        any sequence is live in any state (incoming/waiting/running)."""
        with self._cv:
            if self._load:
                raise RuntimeError(
                    f"engine {self.name!r} has {self._load} live "
                    "sequence(s); idle-only maintenance refused")
            return fn()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """drain=True generates every admitted sequence to completion
        first; drain=False fails the backlog fast."""
        with self._cv:
            self._closed = True
            self._drain_on_close = drain
            self._cv.notify()
        self._drained.wait(timeout)
        self._thread.join(timeout)

    # -- scheduler thread ----------------------------------------------------
    def _loop(self) -> None:
        self._drain_on_close = True
        try:
            while True:
                with self._cv:
                    while True:
                        if self._incoming:
                            self._waiting.extend(self._incoming)
                            self._incoming.clear()
                        if self._closed:
                            break
                        if self._waiting or self._running:
                            break
                        self._cv.wait()
                    if self._closed and not self._drain_on_close:
                        self._fail_backlog()
                    if self._closed and not (self._waiting
                                             or self._running):
                        return
                # heavy work outside the lock: only this thread touches
                # _waiting/_running
                self._shed_unmeetable()
                self._admit()
                self._step()
                self._publish_gauges()
        finally:
            self._drained.set()

    def _fail_backlog(self) -> None:
        for seq in self._waiting + self._running:
            self._terminate(seq, error=ModelUnavailable(
                f"decode engine {self.name!r} shut down before "
                "completion"))
        self._waiting.clear()
        self._running.clear()

    def _publish_gauges(self) -> None:
        self.metrics.set_gauges(
            active=len(self._running), waiting=len(self._waiting),
            blocks_in_use=self.pool.blocks_in_use,
            blocks_capacity=self.pool.capacity,
            high_water=self.pool.high_water,
            blocks_shared=self.pool.blocks_shared,
            blocks_indexed=(self.index.blocks_indexed
                            if self.index is not None else 0))

    # -- terminal transitions ------------------------------------------------
    def _terminate(self, seq: Sequence, *, result: Optional[dict] = None,
                   error: Optional[BaseException] = None) -> None:
        """Free-on-finish: every block goes back to the pool, whatever
        the outcome."""
        if seq.blocks:
            self.pool.free(seq.blocks)
            seq.blocks = []
        seq.slot = None
        with self._cv:
            self._load -= 1
        if error is not None:
            self.metrics.on_finished(False)
            seq.handle._fail(error)
        else:
            self.metrics.on_finished(True)
            seq.handle._finish(result)

    def _finish(self, seq: Sequence, reason: str) -> None:
        self._terminate(seq, result={
            "tokens": list(seq.generated), "finish_reason": reason,
            "evictions": seq.evictions, "prompt_len": len(seq.prompt)})

    def _finish_reason(self, seq: Sequence, tok: int) -> Optional[str]:
        if seq.eos_id is not None and tok == seq.eos_id:
            return "eos"
        if len(seq.generated) >= seq.max_new:
            return "length"
        return None

    # -- deadline shedding ---------------------------------------------------
    def _shed_unmeetable(self) -> None:
        """Expired deadlines always shed; un-expired ones shed when the
        remaining-token estimate (tokens left x EWMA step seconds) says
        the deadline cannot be met — the cold engine (no estimate yet)
        never sheds on a guess."""
        now = time.monotonic()
        est = self.admission.estimated_batch_s()
        for lst in (self._waiting, self._running):
            for seq in list(lst):
                if seq.deadline_t is None:
                    continue
                expired = now >= seq.deadline_t
                unmeetable = (est is not None and
                              now + seq.remaining * est > seq.deadline_t)
                if expired or unmeetable:
                    lst.remove(seq)
                    self.metrics.on_shed("deadline")
                    why = ("deadline expired" if expired else
                           f"~{seq.remaining} tokens x {est * 1000:.1f} "
                           "ms/step exceed the deadline")
                    self._terminate(seq, error=DeadlineExceeded(
                        f"sequence shed: {why} (model {self.name!r})"))

    # -- eviction ------------------------------------------------------------
    def _evict(self, victim: Sequence) -> None:
        """Preempt: free blocks+slot, requeue at the waiting FRONT. If
        its grown context can no longer re-prefill (past the largest
        bucket), shed instead — resuming would be impossible."""
        self._running.remove(victim)
        self.pool.free(victim.blocks)
        victim.blocks = []
        victim.slot = None
        victim.cached_len = 0
        victim.evictions += 1
        self.metrics.on_evicted()
        obs_trace.instant("evict", cat="decode", parent=victim.ctx,
                          model=self.name, sid=victim.sid,
                          generated=len(victim.generated))
        if len(victim.tokens_so_far) > self.model.max_prompt_len:
            self.metrics.on_shed("overload")
            self._terminate(victim, error=Overloaded(
                f"evicted under KV-pool pressure and its context "
                f"({len(victim.tokens_so_far)} tokens) exceeds the "
                f"largest prefill bucket {self.model.max_prompt_len} — "
                "cannot resume (model {0!r})".format(self.name)))
        else:
            self._waiting.insert(0, victim)

    def _evict_for(self, seq: Sequence, need: int,
                   allow_peers: bool) -> bool:
        """Evict running sequences until `need` blocks are free. Victims
        must rank strictly below `seq` — lower priority, or (only when
        allow_peers, the mid-decode growth case, which guarantees the
        oldest sequence always progresses) same priority but younger."""

        def rank(s: Sequence):
            return (s.priority, -s.t_submit)   # low priority, young first

        while not self.pool.can_alloc(need):
            # cached prefixes go first: dropping an index reference costs
            # a future alias, evicting a running sequence costs a full
            # re-prefill — cache beats nothing, live work beats cache
            if self.index is not None and self.index.release_lru(1):
                continue
            victims = [s for s in self._running if s is not seq
                       and (s.priority < seq.priority
                            or (allow_peers
                                and s.priority == seq.priority
                                and s.t_submit > seq.t_submit))]
            if not victims:
                return False
            self._evict(min(victims, key=rank))
        return True

    # -- admission (prefill) -------------------------------------------------
    def _admit(self) -> None:
        if not self._waiting:
            return
        if not self.continuous and self._running:
            return   # the static baseline: drain-to-empty barrier
        # priority first, then arrival order (evictees keep their
        # original t_submit, so they resume before younger peers)
        order = sorted(self._waiting, key=lambda s: (-s.priority,
                                                     s.t_submit))
        for seq in order:
            if len(self._running) >= self.model.slots:
                break
            try:
                self._admit_one(seq)
            except Exception as e:  # noqa: BLE001 — one bad sequence
                # must never kill the scheduler thread: fail IT typed
                # (its blocks free in _terminate) and keep admitting
                if seq in self._waiting:
                    self._waiting.remove(seq)
                self._terminate(seq, error=e if isinstance(
                    e, (Overloaded, DeadlineExceeded)) else
                    _request_failed(self.name, e))

    def _admit_one(self, seq: Sequence) -> None:
        tokens = seq.tokens_so_far
        shared: List[int] = []
        matched = 0
        if self.index is not None:
            shared, matched = self.index.match(tokens)
        if shared:
            # alias the resident prefix: take OUR reference per block AT
            # MATCH TIME — under pressure _evict_for drops index
            # references (release_lru), possibly on these very blocks,
            # and only this pin keeps them (and the `need` arithmetic
            # below) live until admission resolves
            self.pool.share(shared)
            seq.blocks = list(shared)
        need = self.pool.blocks_for_tokens(len(tokens)) - len(shared)
        if not self.pool.can_alloc(need) and \
                not self._evict_for(seq, need, allow_peers=False):
            if shared:
                self.pool.free(shared)   # unpin the aliased prefix
                seq.blocks = []
            return   # stays waiting; capacity frees as others end
        self._waiting.remove(seq)
        if seq.evictions:
            self.metrics.on_resumed()
            obs_trace.instant("resume", cat="decode", parent=seq.ctx,
                              model=self.name, sid=seq.sid)
        if shared:
            # write NOTHING below `matched` — those rows are, byte for
            # byte, what this prompt's prefill would write
            self.metrics.on_prefix_hit(matched, len(shared))
            obs_trace.instant("prefix_hit", cat="decode",
                              parent=seq.ctx, model=self.name,
                              sid=seq.sid, tokens=matched)
        if need:
            seq.blocks = seq.blocks + self.pool.alloc(need)
        t0 = time.monotonic()
        try:
            last_logits, kv_rows = self.model.prefill(tokens)
            self.model.seed_sequence(seq.blocks, kv_rows,
                                     skip_rows=matched)
        except Exception as e:  # noqa: BLE001 — typed + delivered
            self._terminate(seq, error=e if isinstance(
                e, (Overloaded, DeadlineExceeded)) else
                _request_failed(self.name, e))
            return
        dt = time.monotonic() - t0
        self.metrics.on_prefill(len(tokens), dt)
        obs_trace.complete("prefill", dt, cat="decode",
                           parent=seq.ctx, model=self.name,
                           sid=seq.sid, tokens=len(tokens))
        seq.cached_len = len(tokens)
        if self.index is not None:
            # register this sequence's full prompt blocks (decode
            # writes land strictly past the prompt, so they stay
            # immutable while indexed)
            self.index.insert(tokens, seq.blocks)
        tok = int(np.argmax(last_logits))
        seq.generated.append(tok)
        seq.handle._put_token(tok)
        reason = self._finish_reason(seq, tok)
        if reason is not None:
            self._finish(seq, reason)
            return
        free_slots = [i for i in range(self.model.slots)
                      if all(r.slot != i for r in self._running)]
        seq.slot = free_slots[0]
        self._running.append(seq)

    # -- copy-on-write -------------------------------------------------------
    def _cow_for_write(self, seq: Sequence) -> bool:
        """Make the block holding this step's first write position
        (cached_len) exclusively `seq`'s. Only an aliased PARTIAL tail
        block can be hit — every block past the prompt was freshly
        allocated — so at most ONE copy per sequence lifetime. Returns
        False when the sequence had to be preempted for the copy target
        (pool exhausted with no lower-ranked victim): a shared block is
        NEVER written in place."""
        bi = seq.cached_len // self.pool.block_size
        if bi >= len(seq.blocks):
            return True   # the write lands in a to-be-allocated block
        old = seq.blocks[bi]
        if self.pool.refcount(old) <= 1:
            return True   # exclusively owned already
        if not self.pool.can_alloc(1) and \
                not self._evict_for(seq, 1, allow_peers=True):
            self._evict(seq)
            return False
        new = self.pool.alloc(1)[0]
        self.model.copy_block(old, new)
        self.pool.free([old])   # drop OUR reference; other owners keep it
        seq.blocks[bi] = new
        self.metrics.on_cow()
        obs_trace.instant("cow", cat="decode", parent=seq.ctx,
                          model=self.name, sid=seq.sid, block=old)
        return True

    # -- speculation ---------------------------------------------------------
    def _gather_drafts(self, budget: int) -> Dict[int, List[int]]:
        """Ask the drafter for up to spec_k tokens per running sequence,
        bounded by idle slots, the generation budget, and the context
        limit. A drafter crash (chaos site spec_verify) falls back to
        plain decode for that sequence's step — never kills it."""
        out: Dict[int, List[int]] = {}
        for seq in sorted(self._running,
                          key=lambda s: (-s.priority, s.t_submit)):
            if budget <= 0:
                break
            k = min(self.spec_k, budget, seq.remaining - 1,
                    self.model.max_context - seq.cached_len - 1,
                    (self.model.max_blocks_per_seq
                     * self.pool.block_size) - seq.cached_len - 1)
            if k < 1:
                continue
            try:
                faults.crash_point("spec_verify")
                proposed = self.drafter.propose(seq.tokens_so_far, k)
            except Exception:   # noqa: BLE001 — degrade, don't die
                self.metrics.on_spec_fallback()
                obs_trace.instant("spec_fallback", cat="decode",
                                  parent=seq.ctx, model=self.name,
                                  sid=seq.sid)
                continue
            drafts: List[int] = []
            for t in list(proposed)[:k]:
                t = int(t)
                if not 0 <= t < self.model.vocab_size:
                    break   # truncate, don't filter: a chain has no holes
                drafts.append(t)
            if drafts:
                out[seq.sid] = drafts
                budget -= len(drafts)
        return out

    # -- one decode step -----------------------------------------------------
    def _step(self) -> None:
        if not self._running:
            return
        slots = self.model.slots
        drafts: Dict[int, List[int]] = {}
        if self.drafter is not None and self.spec_k > 0:
            drafts = self._gather_drafts(slots - len(self._running))
        # grow block capacity in priority order so the important
        # sequences claim blocks (and pick victims) first
        for seq in sorted(list(self._running),
                          key=lambda s: (-s.priority, s.t_submit)):
            if seq not in self._running:
                drafts.pop(seq.sid, None)
                continue   # evicted by a higher-priority peer this pass
            if not self._cow_for_write(seq):
                drafts.pop(seq.sid, None)
                continue   # preempted hunting a copy target
            # provision the FULL draft window up front — acceptance is
            # variable but the pool must cover the maximum
            g = 1 + len(drafts.get(seq.sid, ()))
            need = (self.pool.blocks_for_tokens(seq.cached_len + g)
                    - len(seq.blocks))
            if need > 0 and g > 1 and not self.pool.can_alloc(need):
                # speculation never evicts a peer: drop the drafts and
                # retry as a plain one-token step
                drafts.pop(seq.sid, None)
                need = (self.pool.blocks_for_tokens(seq.cached_len + 1)
                        - len(seq.blocks))
            if need <= 0:
                continue
            if not self.pool.can_alloc(need) and \
                    not self._evict_for(seq, need, allow_peers=True):
                # no victims rank below it and the pool is dry: preempt
                # ITSELF — resume when capacity frees. Progress is
                # guaranteed: the oldest highest-priority sequence always
                # either allocates or finds victims, so the pool drains
                # toward completion rather than thrashing. (A sequence
                # that can never fit at all was already shed typed at
                # submit by the engine's peak-residency check.)
                drafts.pop(seq.sid, None)
                self._evict(seq)
                continue
            seq.blocks.extend(self.pool.alloc(need))
        active = list(self._running)
        if not active:
            return
        # slot packing: each drafted sequence borrows idle slots — slot
        # j of its chain feeds draft j with context_len L+1+j over the
        # SAME block table, so the step's kv-write phase lays down the
        # whole chain's rows before its attention phase reads them
        free_ids = [i for i in range(slots)
                    if all(r.slot != i for r in active)]
        spec_slots: Dict[int, List[int]] = {}
        for seq in active:
            d = drafts.get(seq.sid)
            if not d:
                continue
            take = free_ids[:len(d)]
            if len(take) < len(d):
                drafts[seq.sid] = d = d[:len(take)]
            if not d:
                drafts.pop(seq.sid, None)
                continue
            spec_slots[seq.sid] = take
            free_ids = free_ids[len(take):]
        tokens = np.zeros(slots, np.int64)
        lens = np.zeros(slots, np.int32)
        tables = np.zeros((slots, self.model.max_blocks_per_seq), np.int32)
        for seq in active:
            row = block_table_row(seq.blocks,
                                  self.model.max_blocks_per_seq)
            tokens[seq.slot] = seq.generated[-1]
            lens[seq.slot] = seq.cached_len + 1
            tables[seq.slot] = row
            for j, (sl, d) in enumerate(zip(spec_slots.get(seq.sid, ()),
                                            drafts.get(seq.sid, ())),
                                        start=1):
                tokens[sl] = d
                lens[sl] = seq.cached_len + 1 + j
                tables[sl] = row
        t0 = time.monotonic()
        logits = self.model.decode_step(tokens, lens, tables)
        dt = time.monotonic() - t0
        self.admission.observe_batch(dt)
        used = len(active) + sum(len(v) for v in spec_slots.values())
        if obs_trace.enabled():
            # one fixed-shape dispatch serving every running sequence:
            # the span records which sids shared it (a single-sequence
            # step adopts that sequence's trace)
            obs_trace.complete(
                "decode_step", dt, cat="decode",
                parent=(active[0].ctx if len(active) == 1 else None),
                model=self.name, n=len(active),
                sids=[s.sid for s in active])
        emitted_total = 0
        for seq in active:
            d = drafts.get(seq.sid, [])
            if d:
                chain = accept_greedy(
                    d, [int(np.argmax(logits[seq.slot]))]
                    + [int(np.argmax(logits[sl]))
                       for sl in spec_slots[seq.sid]])
                self.metrics.on_spec(len(d), len(chain) - 1)
            else:
                chain = [int(np.argmax(logits[seq.slot]))]
            reason = None
            advanced = 0
            for tok in chain:
                seq.generated.append(tok)
                seq.handle._put_token(tok)
                advanced += 1
                reason = self._finish_reason(seq, tok)
                if reason is not None:
                    break
            # every emitted token's K/V row is now resident (the LAST
            # one stays the next step's input, exactly as in plain
            # decode); rejected draft rows sit past cached_len, masked,
            # and are rewritten before the mask ever reaches them
            seq.cached_len += advanced
            emitted_total += advanced
            if reason is not None:
                self._running.remove(seq)
                self._finish(seq, reason)
        self.metrics.on_step(used, slots, dt, emitted_total)


def _request_failed(name: str, cause: BaseException):
    from ..admission import RequestFailed
    return RequestFailed(
        f"decode engine {name!r} failed running prefill: {cause}",
        cause=cause)
