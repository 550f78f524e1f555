"""Speculative decoding: the draftsmen that propose up to K tokens a slot,
and the rule the engine's verify lane accepts them by (counterpart of
``hetu_tpu/serving/speculative.py``).

The verify lane (``ServingEngine(spec_depth=K)``) feeds each active slot
its last token plus its drafts as K+1 query rows; one forward writes their
KV and gives each row's target distribution. :func:`speculative_verify`
then commits the leading drafts the rule accepts plus one token of its
own:

- at temperature 0, the drafts that equal the target's argmax, in order,
  then the argmax at the first mismatch (bit for bit the greedy decode);
- at temperature > 0, Leviathan et al.'s rejection sampling: draft i
  survives while ``u * q(d) < p(d)``, the first rejection is resampled
  from the normalised ``max(0, p - q)``, and when every draft survives
  the extra token is a fresh draw from row K. ``p`` is the softmax of
  :func:`~hetu_tpu_torch.serving.sampling.adjust_logits`, the sampler's
  own masking; ``q`` the draftsman's proposal rows (one-hot for the
  n-gram draftsman, whose proposals are deterministic).

Either way a bad draftsman costs only speed.

**The PRNG rule** (the port's own: ``jax.random`` streams cannot be
reproduced in PyTorch). A sampled slot draws from the request's own
``torch.Generator`` (seeded at admission, as for spec-off sampling), in
this order at every verify: first ``d`` accept uniforms
(``torch.rand(d)``, only when its depth ``d`` is above 0), then exactly
one ``torch.multinomial(w, 1)`` for the token at the first rejected
column (``w`` the residual, or the row's ``p`` when the residual has no
mass or every draft survived). Accepted drafts take no draw of their own.
A slot at depth 0 draws only that multinomial, over the probabilities
:func:`~hetu_tpu_torch.serving.sampling.sample_slots` computes for one
row, so a sampled request that never gets a draft is token-identical to
the spec-off engine at the same seed and the same logits.

:class:`ModelDraftsman` samples its chain from a stream of its own: at
each draft step a warm sampled slot's uniforms (``(K, V)``) come from a
generator seeded from the request's seed and its committed-token count,
so a request's drafts depend on the request alone (not on its slot, its
neighbours or a spill); they are Gumbel-max sampled inside the captured
draft step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from hetu_tpu_torch.nn.moe import refuse_batch_coupled
from hetu_tpu_torch.serving.sampling import adjust_logits


class SpeculativeConfigError(ValueError):
    """A speculation configuration that could never run soundly, raised
    when the engine is built (never mid-decode): a draft depth whose
    verify window cannot fit a slot, or a draft model whose gate couples
    co-batched rows."""

    def __init__(self, msg: str):
        super().__init__(msg)


def check_draft_depth(spec_depth: int, max_len: int) -> int:
    """Validate the engine's draft depth against the slot budget: the
    verify lane feeds ``spec_depth + 1`` rows a slot, so a depth that
    cannot fit even an empty slot raises."""
    k = int(spec_depth)
    if k < 0:
        raise SpeculativeConfigError(
            f"spec_depth must be >= 0, got {k}")
    if k and k + 1 > int(max_len):
        raise SpeculativeConfigError(
            f"spec_depth {k} would overflow a slot: the verify lane "
            f"writes {k + 1} rows per iteration but max_len is "
            f"{max_len} — lower spec_depth or raise max_len")
    return k


def check_draft_model(draft_model) -> None:
    """Refuse a draft model whose gate routes each row as a function of
    the whole batch (the balance gate): its drafts and its own KV would
    not be a function of one request."""
    try:
        refuse_batch_coupled(draft_model)
    except NotImplementedError as e:
        gate = next(type(m.gate).__name__ for m in draft_model.modules()
                    if getattr(getattr(m, "gate", None), "batch_coupled",
                               False))
        raise SpeculativeConfigError(
            f"draft model uses a batch-coupled gate ({gate}): its "
            f"routing depends on which other requests share the batch, "
            f"so its drafts are not a function of one request — use a "
            f"per-token gate (topk/ktop1/sam) for the draft model") from e


def check_sampled_draft(draftsman) -> None:
    """Refuse speculation at temperature > 0 with a draftsman that does
    not surface its proposal probabilities (``surfaces_q``)."""
    if draftsman is None:
        return
    if not getattr(draftsman, "surfaces_q", False):
        raise SpeculativeConfigError(
            f"draftsman {type(draftsman).__name__} does not surface "
            f"per-token proposal probabilities (q): speculation at "
            f"temperature > 0 runs the rejection-sampling accept test "
            f"min(1, p/q), which needs the draftsman's q rows "
            f"(surfaces_q = True) and a per-request seed "
            f"(SamplingParams.seed) for a reproducible PRNG stream — "
            f"add q support to the draftsman or submit the request "
            f"with temperature == 0")


def _to_host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def speculative_verify(logits, drafts, depth, q, temperature, top_k, top_p,
                       generators: Sequence, *, greedy=None):
    """The verify rule over the whole slot batch.

    ``logits`` (S, K+1, V) fp32 target rows; ``drafts`` (S, K) int
    (tensor or array); ``depth`` (S,) each slot's draft count; ``q`` (S,
    K, V) the proposal rows the drafts were sampled from, or None for
    deterministic proposals (one-hot q); ``temperature``/``top_k``/
    ``top_p`` (S,) host knobs; ``generators[s]`` the generator of sampled
    slot ``s``; ``greedy`` the rows' argmax when the caller has it.
    Returns host ``(committed (S, K+1) int64, ncommit (S,) int64)``:
    slot s commits ``committed[s, :ncommit[s]]``. Draws follow the
    module's PRNG rule."""
    S, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    depth = np.asarray(depth, np.int64)
    temp = np.asarray(temperature, np.float32)
    drafts_h = _to_host(drafts).astype(np.int64)
    if greedy is None:
        greedy = logits.argmax(dim=-1)
    greedy_h = _to_host(greedy).astype(np.int64)
    lane = np.arange(K)
    ok = (drafts_h == greedy_h[:, :K]) & (lane[None, :] < depth[:, None])
    a = np.cumprod(ok, axis=1).sum(axis=1) if K else np.zeros(S, np.int64)
    tok = greedy_h[np.arange(S), a]

    sampled = np.nonzero(temp > 0)[0]
    for r in sampled:
        if depth[r] == 0:
            # the spec-off sampler's one draw (``sample_slots``)
            probs = torch.softmax(adjust_logits(
                logits[r, 0], float(temperature[r]), int(top_k[r]),
                float(top_p[r])), dim=-1)
            a[r] = 0
            tok[r] = int(torch.multinomial(probs, 1,
                                           generator=generators[r])[0])
    deep = [int(r) for r in sampled if depth[r] > 0]
    if deep:
        n = len(deep)
        idx = torch.as_tensor(deep, device=dev)
        dd = torch.as_tensor(depth[deep], device=dev)
        u = torch.ones((n, K), dtype=torch.float32, device=dev)
        for i, r in enumerate(deep):
            u[i, :depth[r]] = torch.rand(int(depth[r]),
                                         generator=generators[r], device=dev)
        knob = {name: torch.as_tensor(np.asarray(x)[deep],
                                      device=dev)[:, None]
                for name, x in (("t", temperature), ("k", top_k),
                                ("p", top_p))}
        p = torch.softmax(adjust_logits(
            logits.index_select(0, idx), knob["t"], knob["k"].long(),
            knob["p"]).float(), dim=-1)                       # (n, K+1, V)
        dr = torch.as_tensor(drafts_h[deep], device=dev)      # (n, K)
        if q is None:
            qs = torch.zeros((n, K, V), dtype=torch.float32, device=dev)
            qs.scatter_(2, dr[..., None], 1.0)
        else:
            qs = q.index_select(0, idx).float()
        p_d = p[:, :K].gather(2, dr[..., None])[..., 0]
        q_d = qs.gather(2, dr[..., None])[..., 0]
        acc = (u * q_d < p_d) \
            & (torch.arange(K, device=dev)[None] < dd[:, None])
        na = acc.long().cumprod(dim=1).sum(dim=1)             # (n,)
        at = na[:, None, None].expand(n, 1, V)
        p_a = p.gather(1, at)[:, 0]
        q_a = torch.cat([qs, qs.new_zeros((n, 1, V))],
                        dim=1).gather(1, at)[:, 0]
        resid = (p_a - q_a).clamp_min(0.0)
        use = (na < dd) & (resid.sum(dim=-1) > 0)
        w = torch.where(use[:, None], resid, p_a)
        drawn = torch.cat([torch.multinomial(w[i], 1, generator=generators[r])
                           for i, r in enumerate(deep)])
        a[deep] = _to_host(na)
        tok[deep] = _to_host(drawn)

    committed = np.zeros((S, K + 1), np.int64)
    for r in range(S):
        committed[r, :a[r]] = drafts_h[r, :a[r]]
        committed[r, a[r]] = tok[r]
    return committed, a + 1


class NgramDraftsman:
    """Per-slot prompt-lookup drafting over the request's own tokens: an
    incremental index maps every n-gram (``n = ngram`` down to 1) to the
    position after its latest occurrence, and :meth:`propose` drafts what
    followed the previous occurrence of the current tail (longest n-gram
    first). Host bookkeeping only, nothing on the device."""

    #: no device work per iteration (the engine proposes under its lock)
    host_only = True

    #: proposals are deterministic: their q is the one-hot of the draft,
    #: which the verify rule builds itself
    surfaces_q = True

    def __init__(self, slots: int, *, ngram: int = 3):
        self.ngram = max(1, int(ngram))
        self._index: list[dict] = [dict() for _ in range(slots)]
        self._prev: list[dict] = [dict() for _ in range(slots)]
        self._seq: list[list[int]] = [[] for _ in range(slots)]

    def reset(self, slot: int, tokens: Sequence[int]) -> None:
        """(Re)bind ``slot`` to a request whose history is ``tokens``
        (the prompt at admission; prompt + emitted on a spill-resume)."""
        self._index[slot] = {}
        self._prev[slot] = {}
        self._seq[slot] = []
        self.extend(slot, tokens)

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        """Append committed tokens and index the new suffixes; an
        n-gram's previous occurrence is kept beside its latest (the
        tail's latest occurrence is always itself)."""
        seq = self._seq[slot]
        idx = self._index[slot]
        prev = self._prev[slot]
        for t in tokens:
            seq.append(int(t))
            end = len(seq)
            for n in range(1, self.ngram + 1):
                if end >= n:
                    key = tuple(seq[end - n:end])
                    old = idx.get(key)
                    if old is not None:
                        prev[key] = old
                    idx[key] = end

    def propose(self, slot: int, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the slot's tail (an n-gram
        whose only occurrence is the tail itself proposes nothing)."""
        if k <= 0:
            return []
        seq = self._seq[slot]
        idx = self._index[slot]
        prev = self._prev[slot]
        end = len(seq)
        for n in range(min(self.ngram, end), 0, -1):
            key = tuple(seq[end - n:end])
            j = idx.get(key)
            if j == end:                 # the tail is its own latest hit
                j = prev.get(key)
            if j is not None and j < end:
                return seq[j:j + k]
        return []


def _noise_seed(seed: int, committed: int) -> int:
    """The draft-noise seed of a request at ``committed`` tokens."""
    return (int(seed) * 0x9E3779B1 + int(committed) * 0x85EBCA6B
            + 0xD4AF7) % (1 << 63)


class ModelDraftsman:
    """Drafting with a (small) model of the zoo: the draft model keeps
    its own paged KV arena, and one step, captured once as the
    ``serving_draft_step`` graph, first catches up on the tokens the
    target committed since the last step (a ``(S, K+1)`` window of
    masked rows, through ``generation.decode(row_mask=)``), then drafts
    K tokens by K-1 single-row decodes. A slot drafts only when fully
    caught up (``draft_pos == pos + 1``): admissions and spill-resumes
    warm up over a few iterations, with no draft prefill lane.

    The arena: ``hetu_tpu`` gives each slot one wide block of ``max_len +
    K + 1`` rows; here each slot owns ``ceil((max_len + K + 1) /
    block_size)`` consecutive blocks of the engine's ``block_size``
    (contiguous identity tables), which computes the same function and
    runs kernel #1 at the block size its lanes are built for.

    Sampled slots draw their chain from the adjusted softmax of the draft
    logits (Gumbel-max over uniforms drawn as the module docstring says)
    and :meth:`propose_all` returns those softmax rows as q; greedy slots
    take the argmax (q one-hot). Draft logits past ``target_vocab`` are
    masked out and q is given over the target's vocabulary."""

    host_only = False
    surfaces_q = True

    def __init__(self, model, *, slots: int, max_len: int,
                 spec_depth: int, block_size: int,
                 target_vocab: Optional[int] = None):
        from hetu_tpu_torch.models.generation import init_kv_caches
        from hetu_tpu_torch.engine.step_graph import StepGraph

        check_draft_model(model)
        self.model = model
        self.device = model.device
        self.K = int(spec_depth)
        self.H = self.K + 1                  # catch-up window width
        self.slots = int(slots)
        # the deepest speculative write (pos + K - 1 <= max_len + K - 2)
        # stays inside the slot's own rows
        self.row_len = int(max_len) + self.K + 1
        max_pos = model.cfg.max_positions
        if self.row_len > max_pos:
            raise SpeculativeConfigError(
                f"draft model max_positions {max_pos} cannot address "
                f"the target's max_len {max_len} + spec_depth "
                f"{self.K} rows — use a draft model with a longer "
                f"context or lower spec_depth")
        self.vocab = model.cfg.vocab_size
        self.target_vocab = int(target_vocab) if target_vocab is not None \
            else self.vocab
        self.block_size = int(block_size)
        self.table_width = -(-self.row_len // self.block_size)
        S, W = self.slots, self.table_width
        # slot r owns blocks 1 + r*W .. (r+1)*W; block 0 is the null block
        self.caches = init_kv_caches(model, S * W + 1, self.block_size)
        self.draft_pos = np.zeros(S, np.int64)
        #: draft steps run (each replays the captured step once)
        self.steps = 0
        i64 = torch.int64
        shapes = {"tok": ((S, self.H), i64), "pos": ((S, 1), i64),
                  "len": ((S,), i64), "active": ((S,), torch.bool),
                  "temp": ((S,), torch.float32), "topk": ((S,), i64),
                  "topp": ((S,), torch.float32),
                  "noise": ((S, self.K, self.vocab), torch.float32)}
        self._ops = {k: torch.zeros(shape, dtype=dt, device=self.device)
                     for k, (shape, dt) in shapes.items()}
        self._tables = torch.arange(1, S * W + 1, dtype=torch.int32,
                                    device=self.device).view(S, W)
        self._noise_gen = torch.Generator(device=self.device)
        self.graph = StepGraph("serving_draft_step", self._body,
                               idle=self._idle,
                               operands=list(self._ops.values()),
                               device=self.device)

    def _idle(self) -> None:
        for t in self._ops.values():
            t.zero_()

    def _pick(self, lg, j: int):
        """Draft token ``j`` of every slot from its draft logits (S, Vd):
        the argmax at temperature 0, else a Gumbel-max draw from the
        adjusted softmax; returns ``(tok (S,), q rows (S, Vt))``."""
        ops, Vd, Vt = self._ops, self.vocab, self.target_vocab
        if Vd > Vt:
            lg = lg.masked_fill(torch.arange(Vd, device=lg.device) >= Vt,
                                float("-inf"))
        masked = adjust_logits(lg, ops["temp"], ops["topk"], ops["topp"])
        gumbel = -torch.log(-torch.log(ops["noise"][:, j].clamp_min(1e-30)))
        greedy = ops["temp"] == 0.0
        tok = torch.where(greedy, lg.argmax(dim=-1),
                          (masked + gumbel).argmax(dim=-1))
        probs = torch.softmax(masked.float(), dim=-1)
        onehot = torch.zeros_like(probs).scatter_(1, tok[:, None], 1.0)
        q = torch.where(greedy[:, None], onehot, probs)
        if Vd > Vt:
            q = q[:, :Vt]
        elif Vd < Vt:
            q = torch.cat([q, q.new_zeros((q.shape[0], Vt - Vd))], dim=1)
        return tok, q

    def _body(self):
        from hetu_tpu_torch.models import generation
        ops, model, K, H = self._ops, self.model, self.K, self.H
        S, top = self.slots, self.row_len - 1
        lane = torch.arange(H, device=self.device)[None, :]
        positions = ops["pos"] + lane                         # (S, H)
        valid = (lane < ops["len"][:, None]) & ops["active"][:, None] \
            & (positions <= top)
        logits = generation.decode(
            model, ops["tok"], positions.clamp(max=top), self.caches,
            slot_mask=ops["active"], block_tables=self._tables,
            row_mask=valid)
        seed_row = (ops["len"] - 1).clamp(0, H - 1)
        lg = logits.gather(1, seed_row[:, None, None].expand(
            S, 1, logits.shape[-1]))[:, 0]
        tok, q = self._pick(lg, 0)
        toks, qs = [tok], [q]
        base = ops["pos"][:, 0] + ops["len"]          # the first draft's row
        for j in range(K - 1):
            pos = (base + j)[:, None]
            # rows that consumed nothing this call have no seed: their
            # chain is garbage and must not write
            ok = ops["active"][:, None] & (ops["len"] > 0)[:, None] \
                & (pos <= top)
            lg = generation.decode(
                model, tok[:, None], pos.clamp(max=top), self.caches,
                slot_mask=ops["active"], block_tables=self._tables,
                row_mask=ok)[:, 0]
            tok, q = self._pick(lg, j + 1)
            toks.append(tok)
            qs.append(q)
        return torch.stack(toks, dim=1), torch.stack(qs, dim=1)

    def reset(self, slot: int, tokens: Sequence[int]) -> None:
        """A new (or resumed) request owns ``slot``: its draft KV is cold,
        catch-up restarts from position 0."""
        self.draft_pos[slot] = 0

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        """Committed tokens are consumed by the catch-up, not here."""

    def propose_all(self, seqs: list, pos: np.ndarray, active: np.ndarray,
                    budget: np.ndarray, *, temps=None, topks=None,
                    topps=None, seeds=None):
        """One draft step for the whole slot pool. ``seqs[r]`` is slot
        r's committed history (prompt + emitted, None for an empty slot),
        ``pos[r]`` the target's next KV write index (``seqs[r][pos[r]]``
        is the token not yet fed), ``budget[r]`` the engine's depth clamp;
        ``temps``/``topks``/``topps`` the per-slot knobs (default greedy)
        and ``seeds[r]`` a sampled slot's request seed. Returns ``(drafts
        (S, K) int64, draft_len (S,) host int64, q (S, K, Vt) fp32)``, the
        device tensors being the step's static outputs (valid until the
        next step); cold or inactive slots get length 0."""
        S, H = self.slots, self.H
        hist_tok = np.zeros((S, H), np.int64)
        hist_pos = np.zeros(S, np.int64)
        hist_len = np.zeros(S, np.int64)
        warm = np.zeros(S, bool)
        for r in range(S):
            if not active[r] or seqs[r] is None:
                continue
            avail = int(pos[r]) + 1 - int(self.draft_pos[r])
            if avail <= 0:
                continue       # nothing new to consume: skip this turn
            h = min(H, avail)
            lo = int(self.draft_pos[r])
            hist_tok[r, :h] = seqs[r][lo:lo + h]
            hist_pos[r] = lo
            hist_len[r] = h
            self.draft_pos[r] = lo + h
            warm[r] = (lo + h) == int(pos[r]) + 1
        temps = np.zeros(S, np.float32) if temps is None \
            else np.asarray(temps, np.float32)
        feed = {"tok": hist_tok, "pos": hist_pos[:, None], "len": hist_len,
                "active": np.asarray(active, bool), "temp": temps,
                "topk": np.zeros(S, np.int64) if topks is None
                else np.asarray(topks, np.int64),
                "topp": np.zeros(S, np.float32) if topps is None
                else np.asarray(topps, np.float32)}
        for name, arr in feed.items():
            self._ops[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        for r in np.nonzero(warm & (temps > 0))[0]:
            self._noise_gen.manual_seed(
                _noise_seed(seeds[r], int(pos[r]) + 1))
            self._ops["noise"][r].uniform_(generator=self._noise_gen)
        drafts, q = self.graph.replay()
        self.steps += 1
        draft_len = np.where(warm & np.asarray(active, bool), budget,
                             0).astype(np.int64)
        return drafts, draft_len, q


__all__ = ["ModelDraftsman", "NgramDraftsman", "SpeculativeConfigError",
           "check_draft_depth", "check_draft_model", "check_sampled_draft",
           "speculative_verify"]
