"""Speculative decoding: a cheap drafter proposes k tokens, the
fixed-shape decode step verifies them in ONE batched dispatch.

The verification trick costs no new artifact. Decode slots are
STATELESS — a slot is a row of the fixed-shape step, and all per-token
state lives in the block tables — so one sequence can occupy g = 1 + k
slots for one step: slot j carries input token x_{L+j} (j = 0 the
pending token, j >= 1 the drafts) with context_len L+1+j and the SAME
block table. The step's paged_kv_write scatters every slot's K/V row
(distinct positions L..L+g-1 of the shared table) before
paged_attention reads the pool, so slot j's attention over
[0, L+1+j) sees slots 0..j's fresh rows: the slot axis doubles as a
draft-chain axis. logits[slot j] then predicts position L+1+j exactly
as a sequential decode would have.

Greedy acceptance keeps the output BIT-IDENTICAL to plain decode:
emit e_0 = argmax(logits[slot 0]) — by construction the token plain
decode would emit — then accept e_j while the drafter's d_j equals
e_{j-1}; the first mismatch ends the chain. Rows written for rejected
positions are garbage but masked (context_len stops at the accepted
length) and rewritten before the mask ever reaches them — the same
argument that makes freed-block reuse safe.

Drafters (PT_SPEC_DRAFT):

    ngram       prompt-lookup decoding: propose the continuation that
                followed the most recent occurrence of the current
                n-gram earlier in the context. Zero extra model, wins
                on repetitive text (code, structured output).
    self        the target bundle's own prefill buckets re-predict the
                next k tokens greedily. Acceptance is 100% by
                construction — the deterministic upper bound the
                identity tests pin. A CORRECTNESS/TESTING harness, not
                a throughput win: each proposal runs k sequential
                full-context prefills on the scheduler thread, each
                costing more than the decode step being accelerated,
                and every peer's token cadence stalls while it drafts.
    <dir>       a separate (smaller) decode bundle loaded through the
                registry's ModelVersion machinery; its prefill side
                drafts greedily. The classic small-drafter setup — use
                this (or ngram) in production.

A drafter that crashes mid-step (chaos site `spec_verify`) degrades to
plain decode for that step — never kills the session.

Copied from ``paddle_tpu/serving/decode/spec.py``; the port
carries its own copy because it never imports the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["NGramDrafter", "PrefillDrafter", "resolve_drafter",
           "accept_greedy"]


class NGramDrafter:
    """Prompt-lookup drafting: match the last `n` context tokens against
    earlier context; propose the k tokens that followed the most recent
    earlier occurrence. No model, no state."""

    name = "ngram"

    def __init__(self, n: int = 3):
        self.n = max(1, int(n))

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        toks = list(context)
        n = self.n
        if k < 1 or len(toks) <= n:
            return []
        tail = toks[-n:]
        # most recent earlier occurrence wins (locality beats frequency)
        for start in range(len(toks) - n - 1, -1, -1):
            if toks[start:start + n] == tail:
                cont = toks[start + n:start + n + k]
                if cont:
                    return [int(t) for t in cont]
        return []


class PrefillDrafter:
    """Greedy drafting through a prefill-capable model: k sequential
    next-token predictions, each one full-context prefill ON THE
    SCHEDULER THREAD. `model` needs prefill(tokens) ->
    (last_logits, kv_rows) and max_prompt_len — DecodeModel satisfies
    it, so `self` drafting reuses the target bundle (the deterministic
    100%-acceptance harness for identity tests; its drafting costs more
    than the steps it saves, so it is NOT a production speedup) and a
    drafter DIR loads its own smaller bundle, which is."""

    def __init__(self, model, name: str = "prefill"):
        self.model = model
        self.name = name

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        toks = [int(t) for t in context]
        out: List[int] = []
        for _ in range(max(0, int(k))):
            if len(toks) > self.model.max_prompt_len:
                break   # the drafter's buckets cap its reach, not ours
            logits, _ = self.model.prefill(toks)
            tok = int(np.argmax(logits))
            out.append(tok)
            toks.append(tok)
        return out


def resolve_drafter(spec: Optional[str], model):
    """PT_SPEC_DRAFT -> a drafter: '' / None / '0' = off, 'ngram' =
    NGramDrafter, 'self' = the target's own prefill, anything else = a
    decode-bundle directory loaded fresh (warmup skipped — the drafter
    only prefills)."""
    if not spec or spec in ("0", "off", "none"):
        return None
    if spec == "ngram":
        return NGramDrafter()
    if spec == "self":
        return PrefillDrafter(model, name="self")
    from .engine import DecodeModel
    return PrefillDrafter(DecodeModel(spec, device=model.device,
                                      warmup=False), name=spec)


def accept_greedy(drafts: Sequence[int],
                  emitted: Sequence[int]) -> List[int]:
    """The acceptance rule, pure for testing. `emitted[j]` is
    argmax(logits[slot j]); `drafts[j]` fed slot j+1. Returns the token
    chain to emit: e_0 always (plain decode's token), then e_{j+1}
    while drafts[j] == e_j."""
    out = [int(emitted[0])]
    for j, d in enumerate(drafts):
        if int(d) != out[-1] or j + 1 >= len(emitted):
            break
        out.append(int(emitted[j + 1]))
    return out
