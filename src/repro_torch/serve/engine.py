"""Serving engine: persistent-slot continuous batching with a fixed-shape
decode step, WFQ slot packing, and per-tenant admission control.

**Slot lifecycle** (``scheduler="continuous"``):

1. The engine preallocates ONE ``(layers, max_batch, kv_cache_len, ...)``
   KV cache whose batch rows are long-lived *slots*, plus per-slot
   position / token vectors (layers/kvcache.py slot helpers).
2. A granted request is prefilled alone (batch 1), right-padded to a
   power-of-two *prompt bucket* — right padding sits causally after every
   real token, so bucketing never perturbs logits.  A recurrent model
   (``Model.recurrent``, the mamba state of hymba) is prefilled at its
   exact length instead: a pad token would advance its recurrence.
3. The prefilled cache is written into the free slot in place; the slot
   joins the batch at its own position.
4. One decode step advances ALL slots each tick.  Its shapes are
   functions of the slot geometry only, so there is one decode shape per
   engine (``decode_compile_count``).
5. A slot that finishes (EOS or token budget) is refilled from the queue
   mid-decode.

**WFQ slot packing** (:class:`WFQScheduler`) keeps a virtual time per
tenant with weights from ``QoSPolicy.rates``; the host token bucket
(:class:`~repro_torch.core.mediation.HostTokenBucket`) gates admission
underneath, charging ``len(prompt)`` tokens per request.  A per-tenant
slot budget (``ServeConfig.max_slots_per_tenant`` or
:meth:`Engine.set_slot_budget`) is enforced by preemption with exact
temperature-0 resume.

**Paged KV pool** (``ServeConfig.block_size > 0``): instead of one
``kv_cache_len`` stripe per slot, the engine owns one shared pool of
fixed-size blocks and a host block table per slot (``kv_pool_*`` in
layers/kvcache.py).  Each decode tick gathers every slot's blocks into a
dense cache, runs the unchanged slot decode step and scatters the one
written token back, so paged decode gives the stripe's tokens.  A grant
claims the request's prefill cover in blocks; decode growth claims one
block at a time, and pool pressure preempts the active slot whose tenant
has the largest WFQ virtual time (or the slot itself), with exact
resume.  A prompt longer than any stripe is served while blocks are
free.  Only a cache of ``k``/``v`` stripes is pageable: a recurrent
model with ``block_size > 0`` raises :class:`ServeError`.

**Chunked prefill** (``ServeConfig.prefill_chunk > 0``, models with
``Model.prefill_chunk``): a prompt longer than one chunk is prefilled one
``(1, prefill_chunk)`` chunk per engine tick, interleaved with the decode
ticks of the other slots, and each chunk pays its mediation edges like a
decode tick.  A slot preempted mid-prefill replays its chunks from the
start.

``scheduler="gang"`` keeps the batch-to-completion baseline.

**Timelines** (``Engine(..., obs=CounterTimeline(...))``, core/obs.py):
every ``obs_every``-th decode tick appends one snapshot of the serve
counter block (:meth:`Engine.runtime_counters`, host arithmetic) with
the ``active_slots`` / ``queued`` (and, paged, ``free_blocks``) gauges,
and only then calls the control-plane hook ``on_tick(engine)``; without
a timeline the hook is never called.  A snapshot reads no tensor, so
served tokens are the same with a timeline or without.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import telemetry as tl
from repro_torch.core.mediation import HostTokenBucket
from repro_torch.core.policies import QoSPolicy
from repro_torch.layers.kvcache import (
    BlockAllocator,
    kv_cache_constrain,
    kv_pool_gather,
    kv_pool_init,
    kv_pool_insert,
    kv_pool_scatter_chunk,
    kv_pool_scatter_token,
    slot_vectors_init,
    state_slot_insert,
)

# Bound on consecutive all-throttled refill rounds before the engine
# force-admits the queue head (guarantees progress under any rate config).
_MAX_STARVED_ROUNDS = 10_000
_MIN_PROMPT_BUCKET = 8


class ServeError(ValueError):
    """A request or configuration the engine cannot serve — raised before
    any decoding starts."""


@dataclass(eq=False)                 # identity semantics: rid is
class Request:                       # caller-supplied and prompt is an
    rid: int                         # ndarray (elementwise ==)
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int = 16
    tenant: str = "default"
    out_tokens: list = field(default_factory=list)
    done: bool = False
    t_first: float | None = None     # perf_counter stamp of the first token


def sample(logits: torch.Tensor, gen: torch.Generator | None,
           temperature: float) -> torch.Tensor:
    """Greedy at temperature 0 (first maximum on ties), else a draw from
    softmax(logits / temperature) with ``gen``."""
    if temperature <= 0:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[..., 0].to(torch.int32)


def prompt_bucket(n: int) -> int:
    """Power-of-two prompt capacity ≥ max(n, 8)."""
    b = _MIN_PROMPT_BUCKET
    while b < n:
        b *= 2
    return b


class WFQScheduler:
    """Weighted fair queueing over decode slots: each grant advances the
    tenant's virtual time by cost / weight; the backlogged tenant with
    the smallest virtual time wins the next free slot.  A monotone
    virtual clock stops idle tenants from hoarding credit."""

    def __init__(self, weights: dict[str, float] | None = None,
                 default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self.vtime: dict[str, float] = {}
        self.vclock = 0.0

    def weight(self, tenant: str) -> float:
        return max(float(self.weights.get(tenant, self.default_weight)),
                   1e-9)

    def order(self, tenants) -> list[str]:
        return sorted(tenants, key=lambda t: self.vtime.get(t, 0.0))

    def note_backlog(self, tenants) -> None:
        vs = [self.vtime.get(t, 0.0) for t in tenants]
        if vs:
            self.vclock = max(self.vclock, min(vs))

    def grant(self, tenant: str, cost: float) -> None:
        v = max(self.vtime.get(tenant, 0.0), self.vclock)
        self.vtime[tenant] = v + float(cost) / self.weight(tenant)


class Engine:
    def __init__(self, model, params, cfg: ModelConfig, serve: ServeConfig,
                 dp=None, eos_id: int = 1, obs=None, obs_every: int = 1):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.scfg = serve
        self.dp = dp
        self.eos_id = eos_id
        self.device = model.device
        # optional CounterTimeline: one snapshot of the per-tenant serve
        # counter block + run gauges every ``obs_every``-th decode tick
        self.obs = obs
        self.obs_every = max(int(obs_every), 1)
        self._obs_tick_no = 0
        # control-plane hook: called as ``on_tick(engine)`` right after a
        # timeline snapshot lands, between decode ticks
        self.on_tick = None
        self._budget_cap = 0             # 0 = use scfg.max_slots_per_tenant
        qos = next((p for p in (dp.policies if dp is not None else [])
                    if isinstance(p, QoSPolicy)), None)
        self._buckets = HostTokenBucket.from_policy(
            qos, scale=serve.admission_token_scale)
        self._wfq = WFQScheduler(qos.rates if qos is not None else {})
        self.tenant_stats: dict[str, dict[str, float]] = defaultdict(
            lambda: {"requests": 0, "tokens": 0, "deferrals": 0,
                     "wfq_grants": 0, "occupancy_steps": 0,
                     "preemptions": 0, "restores": 0})
        self._tenant_ids: dict[str, int] = {}
        self._decode_shapes: set[tuple] = set()
        self._recurrent = bool(getattr(model, "recurrent", False))

        # ---- paged KV block pool (block_size > 0) ---------------------
        bs = serve.block_size
        self.paged = bs > 0
        if self.paged:
            spec = model.init_cache(1, bs)
            pageable = (isinstance(spec, dict) and set(spec) == {"k", "v"}
                        and all(v.dim() == 5 for v in spec.values()))
            if not pageable:
                raise ServeError(
                    f"paged KV (block_size={bs}) is not supported for the "
                    f"{cfg.family!r} family ({cfg.name}): its decode cache "
                    f"holds recurrent/cross-attention state that cannot be "
                    f"block-paged. Set ServeConfig.block_size=0 "
                    f"(--block-size 0) to serve this family on the fixed "
                    f"stripe layout (continuous batching, chunk-exact "
                    f"preemption and WFQ budgets all still apply).")
            ks = spec["k"]
            # (layers, kv_heads, head_dim, dtype) of the model's own cache
            self._pool_geom = (ks.shape[0], ks.shape[3], ks.shape[4],
                               ks.dtype)
            self._n_usable = serve.n_blocks or \
                (serve.max_batch * serve.kv_cache_len // bs)
            self._tables_len = self._n_usable

        # ---- chunked prefill (prefill_chunk > 0) ----------------------
        self.chunked = (serve.prefill_chunk > 0
                        and getattr(model, "prefill_chunk", None) is not None)
        # per-run chunk state (reset by _run_continuous)
        self._prefills: dict[int, dict] = {}
        self._prefill_q: deque = deque()

    # ------------------------------------------------------------------
    # model calls (the dataplane edges are issued inside them)
    # ------------------------------------------------------------------
    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _prefill(self, toks: np.ndarray, last):
        """Batch-1 prefill (bucketed, chunk cover, or exact for a recurrent
        model) into a cache of its own; returns (logits, cache), which the
        caller writes into its slot or its pool blocks."""
        pc = self.model.init_cache(1, toks.shape[1])
        return self.model.prefill(
            self.params, {"tokens": self._tensor(toks)},
            kv_cache_constrain(self.dp, pc), dp=self.dp,
            last_pos=self._tensor(last))

    def _chunk(self, toks: np.ndarray, pc, off: int, last):
        """One prefill chunk into the request's batch-1 cache ``pc``."""
        return self.model.prefill_chunk(
            self.params, {"tokens": self._tensor(toks)},
            kv_cache_constrain(self.dp, pc), off, dp=self.dp,
            last_pos=self._tensor(last))

    def _step_pool(self, tok: np.ndarray, pool, tables: np.ndarray,
                   pos: np.ndarray, act: np.ndarray):
        """Paged decode tick: gather the slots' blocks into a dense cache,
        run the slot decode step on it, scatter each active slot's new
        token back into the pool."""
        bs = self.scfg.block_size
        dense = kv_pool_gather(pool, tables, bs)
        logits, dense = self.model.decode_step_slots(
            self.params, self._tensor(tok), dense,
            self._tensor(pos, torch.int32), dp=self.dp)
        return logits, kv_pool_scatter_token(pool, dense, tables, pos, act,
                                             bs)

    def _tenant_id(self, tenant: str) -> int:
        return self._tenant_ids.setdefault(tenant, len(self._tenant_ids))

    # ------------------------------------------------------------------
    # tenant admission (host-side token bucket)
    # ------------------------------------------------------------------
    @staticmethod
    def _admission_cost(r: Request, bucket: HostTokenBucket | None) -> float:
        cost = float(len(r.prompt))
        return min(cost, bucket.burst) if bucket is not None else cost

    def _admit_batch(self, queue: list[Request]) -> tuple[list[Request],
                                                          list[Request]]:
        """Gang admission: up to ``max_batch`` requests the buckets admit;
        refills until at least one is admissible."""
        B = self.scfg.max_batch
        for round_ in range(_MAX_STARVED_ROUNDS):
            for b in self._buckets.values():
                b.refill()
            admitted, deferred = [], []
            for r in queue:
                bucket = self._buckets.get(r.tenant)
                cost = self._admission_cost(r, bucket)
                if bucket is not None and not bucket.can_take(cost):
                    if round_ == 0:
                        self.tenant_stats[r.tenant]["deferrals"] += 1
                    deferred.append(r)
                elif len(admitted) < B:
                    if bucket is not None:
                        bucket.take(cost)
                    admitted.append(r)
                else:
                    deferred.append(r)
            if admitted:
                return admitted, deferred
        return queue[:1], queue[1:]

    def _obs_snapshot(self, *, active: int, queued: int) -> None:
        """Feed the attached timeline one engine tick: the serve counter
        block (WFQ grants / tokens / occupancy / deferrals in telemetry
        column layout, host numbers) plus slot-level run gauges, then the
        control-plane hook."""
        if self.obs is None:
            return
        self._obs_tick_no += 1
        if self._obs_tick_no % self.obs_every:
            return
        ctrs, tenants = self.runtime_counters()
        gauges = {"active_slots": active, "queued": queued}
        if self.paged and getattr(self, "_alloc", None) is not None:
            gauges["free_blocks"] = self._alloc.free_blocks
        self.obs.snapshot_block(self._obs_tick_no, ctrs, tenants,
                                gauges=gauges)
        if self.on_tick is not None:
            self.on_tick(self)

    # ------------------------------------------------------------------
    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        cap = max(max(len(r.prompt) for r in reqs), 8)
        toks = np.zeros((len(reqs), cap), np.int32)
        for i, r in enumerate(reqs):
            toks[i, -len(r.prompt):] = r.prompt      # left-pad
        return toks

    def _finish(self, r: Request, done: list[Request]) -> None:
        r.done = True
        stats = self.tenant_stats[r.tenant]
        stats["requests"] += 1
        stats["tokens"] += len(r.out_tokens)
        done.append(r)

    def _emit(self, r: Request, token: int) -> None:
        if not r.out_tokens:
            r.t_first = time.perf_counter()
        r.out_tokens.append(token)

    # ------------------------------------------------------------------
    # public entry
    # ------------------------------------------------------------------
    def run(self, requests: list[Request], rng=None,
            scheduler: str | None = None) -> list[Request]:
        """Serve all requests to completion; returns them with outputs.
        ``rng`` is a ``torch.Generator`` or seed (used at temperature >
        0); ``scheduler`` overrides ``ServeConfig.scheduler``."""
        gen = rng
        if not isinstance(rng, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0 if rng is None else int(rng))
        sched = scheduler or self.scfg.scheduler
        if sched not in ("continuous", "gang"):
            raise ValueError(f"unknown scheduler {sched!r}; "
                             f"expected 'continuous' or 'gang'")
        if sched == "continuous":
            return self._run_continuous(list(requests), gen)
        for r in requests:
            need = len(r.prompt) + \
                min(r.max_new_tokens, self.scfg.max_new_tokens) + 1
            if need > self.scfg.kv_cache_len:
                raise ServeError(
                    f"gang request needs {need} cache positions (prompt "
                    f"{len(r.prompt)} + new tokens + 1) but kv_cache_len "
                    f"is {self.scfg.kv_cache_len}")
        return self._run_gang(list(requests), gen)

    # ------------------------------------------------------------------
    # continuous: persistent slots, fixed-shape decode, WFQ packing
    # ------------------------------------------------------------------
    def _cover(self, n: int) -> int:
        """Prefill cache capacity for an ``n``-token sequence: the chunk
        cover (smallest multiple of ``prefill_chunk`` ≥ n) when chunked
        prefill applies, else the power-of-two prompt bucket; for a
        recurrent model the exact length (padding would fold pad tokens
        into the slot state)."""
        if self._recurrent:
            return max(n, 1)
        C = self.scfg.prefill_chunk
        if self.chunked and n > C:
            return -(-n // C) * C
        return prompt_bucket(n)

    @staticmethod
    def _resume_len(r: Request) -> int:
        """Tokens re-prefilled when ``r`` restarts: the prompt plus every
        emitted token but the last (the pending decode input)."""
        k = len(r.out_tokens)
        return len(r.prompt) + k - 1 if k else len(r.prompt)

    def _blocks_for(self, r: Request) -> int:
        return -(-self._cover(self._resume_len(r)) // self.scfg.block_size)

    def _check_capacity(self, r: Request) -> None:
        """Submit-time check.  Paged: the worst-case blocks over the
        request's life (prefill cover, the resume cover after a worst-case
        preemption, the decode high-water mark) must fit the pool.  Stripe:
        prefill cover and decode budget must fit ``kv_cache_len``."""
        if self.paged:
            L = len(r.prompt)
            limit = min(r.max_new_tokens, self.scfg.max_new_tokens)
            need = max(self._cover(L), self._cover(L + max(limit - 1, 0)),
                       L + limit) + 1
            nblk = -(-need // self.scfg.block_size)
            if nblk > self._n_usable:
                raise ServeError(
                    f"request needs {nblk} pool blocks ({need} cache "
                    f"positions / block_size {self.scfg.block_size}) but the "
                    f"pool has only {self._n_usable} usable blocks")
            return
        cap = self._cover(len(r.prompt))
        need = cap + self.scfg.max_new_tokens + 1
        if need > self.scfg.kv_cache_len:
            raise ServeError(
                f"request needs {need} cache positions (prefill cover {cap}"
                f" + max_new_tokens {self.scfg.max_new_tokens} + 1) but "
                f"kv_cache_len is {self.scfg.kv_cache_len}")

    def _resume_fits(self, r: Request) -> bool:
        """Whether a preempted ``r`` can restart: always under paging (the
        submit check covered the worst-case resume), else inside its
        stripe."""
        if self.paged:
            return True
        eff = self._resume_len(r)
        limit = min(r.max_new_tokens, self.scfg.max_new_tokens)
        return max(self._cover(eff),
                   len(r.prompt) + limit) + 1 <= self.scfg.kv_cache_len

    def set_slot_budget(self, n: int) -> int:
        """Tighten (or with 0, relax back to ServeConfig) the per-tenant
        cap on concurrently held slots; over-budget tenants lose their
        most recent slots on the next tick.  Returns the previous raw
        override (0 = none)."""
        prev, self._budget_cap = self._budget_cap, max(int(n), 0)
        return prev

    def slot_budget(self) -> int:
        """The effective per-tenant slot cap right now."""
        return int(self._budget_cap or self.scfg.max_slots_per_tenant
                   or self.scfg.max_batch)

    def _release_slot(self, slot: int, vecs) -> None:
        """Return a slot's pool blocks and clear its slot vectors."""
        if self.paged and self._slot_blocks[slot]:
            self._alloc.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._tables[slot, :] = 0
        vecs["active"][slot] = False
        vecs["tenant"][slot] = -1

    def _preempt_slot(self, slot: int, slots, vecs, ntok, queue) -> None:
        """Evict the resident request; its emitted tokens are the snapshot
        and it re-queues at the front for an exact resume."""
        r = slots[slot]
        if self._prefills.pop(slot, None) is not None:
            # mid-chunk-prefill: drop the partial prefill, replay on resume
            if slot in self._prefill_q:
                self._prefill_q.remove(slot)
        slots[slot] = None
        self._release_slot(slot, vecs)
        vecs["pos"][slot] = 0
        ntok[slot] = 0
        self.tenant_stats[r.tenant]["preemptions"] += 1
        queue.appendleft(r)

    def _enforce_budget(self, slots, vecs, ntok, queue) -> None:
        cap = self._budget_cap or self.scfg.max_slots_per_tenant
        if not cap:
            return
        held: dict[str, list[int]] = defaultdict(list)
        for i, r in enumerate(slots):
            if r is not None:
                held[r.tenant].append(i)
        for tenant, idxs in held.items():
            extra = len(idxs) - cap
            if extra <= 0:
                continue
            for i in sorted(idxs, key=lambda j: self._slot_started[j],
                            reverse=True):
                if extra <= 0:
                    break
                if not self._resume_fits(slots[i]):
                    continue
                self._preempt_slot(i, slots, vecs, ntok, queue)
                extra -= 1

    def _ensure_blocks(self, i: int, slots, vecs, ntok, queue) -> bool:
        """Make slot ``i`` own the block its next decode write lands in,
        claiming from the pool.  Pool pressure preempts the active slot
        whose tenant has the largest WFQ virtual time; with no other
        candidate the slot preempts itself (the submit check bounds any one
        request's need by the pool).  False when slot ``i`` was
        preempted."""
        bs = self.scfg.block_size
        while vecs["active"][i] and \
                int(vecs["pos"][i]) // bs >= len(self._slot_blocks[i]):
            got = self._alloc.alloc(1)
            if got is not None:
                self._slot_blocks[i].append(got[0])
                self._tables[i, len(self._slot_blocks[i]) - 1] = got[0]
                continue
            cands = [j for j in range(self.scfg.max_batch)
                     if j != i and slots[j] is not None and vecs["active"][j]]
            if not cands:
                self._preempt_slot(i, slots, vecs, ntok, queue)
                return False
            victim = max(cands, key=lambda j: (
                self._wfq.vtime.get(slots[j].tenant, 0.0),
                self._slot_started[j]))
            self._preempt_slot(victim, slots, vecs, ntok, queue)
        return bool(vecs["active"][i])

    def _activate(self, r: Request, slot: int, logits, slots, vecs, tok,
                  ntok, done, gen, *, eff: int, k: int) -> None:
        """Post-prefill slot activation: a fresh request samples and emits
        its first token; a resumed one re-enters with its pending token."""
        limit = min(r.max_new_tokens, self.scfg.max_new_tokens)
        if k == 0:
            t = int(sample(logits[:, -1, :], gen, self.scfg.temperature)[0])
            self._emit(r, t)
            if t == self.eos_id or limit <= 1:
                self._finish(r, done)
                slots[slot] = None
                self._release_slot(slot, vecs)
                return
            nt = 1
        else:
            self.tenant_stats[r.tenant]["restores"] += 1
            t = int(r.out_tokens[-1])
            nt = k
        slots[slot] = r
        vecs["pos"][slot] = eff
        vecs["active"][slot] = True
        vecs["tenant"][slot] = self._tenant_id(r.tenant)
        tok[slot, 0] = t
        ntok[slot] = nt
        self._slot_seq += 1
        self._slot_started[slot] = self._slot_seq

    def _start_request(self, r: Request, slot: int, cache, slots, vecs, tok,
                       ntok, done, gen) -> None:
        """Prefill one request (batch 1) into ``slot``, whole when it fits
        one chunk, else queued for chunk-at-a-time prefill, and emit /
        restore its next decode token.  With paging ``cache`` is the
        block pool."""
        scfg = self.scfg
        k = len(r.out_tokens)            # > 0 ⇒ resume after preemption
        eff = self._resume_len(r)
        seq = (np.concatenate([np.asarray(r.prompt, np.int32),
                               np.asarray(r.out_tokens[:-1], np.int32)])
               if k else np.asarray(r.prompt, np.int32))
        cover = self._cover(eff)
        if self.paged:
            ids = self._alloc.alloc(-(-cover // scfg.block_size))
            if ids is None:              # callers check free_blocks first
                raise RuntimeError("block pool exhausted at grant")
            self._slot_blocks[slot] = list(ids)
            self._tables[slot, :] = 0
            self._tables[slot, :len(ids)] = ids
        toks = np.zeros((1, cover), np.int32)
        toks[0, :eff] = seq              # right-pad
        if self.chunked and eff > scfg.prefill_chunk:
            # one chunk per engine tick (run loop); the slot is held but
            # not active until its last chunk lands
            self._prefills[slot] = {
                "r": r, "toks": toks, "eff": eff, "off": 0, "cover": cover,
                "pcache": self.model.init_cache(1, cover), "k": k}
            self._prefill_q.append(slot)
            slots[slot] = r
            vecs["tenant"][slot] = self._tenant_id(r.tenant)
            self._slot_seq += 1
            self._slot_started[slot] = self._slot_seq
            return
        logits, pc = self._prefill(toks, np.asarray([eff - 1]))
        if self.paged:
            kv_pool_insert(cache, pc, ids, scfg.block_size)
        else:
            state_slot_insert(cache, pc, slot)
        self._activate(r, slot, logits, slots, vecs, tok, ntok, done, gen,
                       eff=eff, k=k)

    def _advance_chunk(self, cache, slots, vecs, tok, ntok, done,
                       gen) -> None:
        """Advance the oldest chunk-prefilling slot by ONE chunk, scattering
        the chunk's blocks when paged, and activate it when its last chunk
        lands."""
        slot = self._prefill_q.popleft()
        st = self._prefills[slot]
        C = self.scfg.prefill_chunk
        off = st["off"]
        logits, st["pcache"] = self._chunk(st["toks"][:, off:off + C],
                                           st["pcache"], off,
                                           np.asarray([st["eff"] - 1]))
        if self.paged:
            kv_pool_scatter_chunk(cache, st["pcache"], self._tables[slot],
                                  off, C, self.scfg.block_size)
        st["off"] = off + C
        if st["off"] < st["cover"]:
            self._prefill_q.append(slot)
            return
        self._prefills.pop(slot)         # last chunk: logits are at eff-1
        if not self.paged:
            state_slot_insert(cache, st["pcache"], slot)
        self._activate(st["r"], slot, logits, slots, vecs, tok, ntok, done,
                       gen, eff=st["eff"], k=st["k"])

    def _fill_slots(self, slots, queue, cache, vecs, tok, ntok, done,
                    gen) -> int:
        """WFQ slot packing: hand each free slot to the backlogged tenant
        with the smallest virtual time whose bucket admits its head
        request.  Returns the number of grants."""
        scfg = self.scfg
        granted_n = 0
        if not queue:
            return granted_n
        for b in self._buckets.values():
            b.refill()                   # one refill per scheduling round
        occupancy = Counter(s.tenant for s in slots if s is not None)
        self._wfq.note_backlog({r.tenant for r in queue} | set(occupancy))
        heads: dict[str, Request] = {}
        for r in queue:                  # FIFO head per backlogged tenant
            heads.setdefault(r.tenant, r)
        deferred_round: set[str] = set()
        for tenant, r in heads.items():
            bucket = self._buckets.get(tenant)
            if bucket is not None and \
                    not bucket.can_take(self._admission_cost(r, bucket)):
                self.tenant_stats[tenant]["deferrals"] += 1
                deferred_round.add(tenant)
        slot_cap = self._budget_cap or scfg.max_slots_per_tenant
        for slot in range(scfg.max_batch):
            if slots[slot] is not None or not heads:
                continue
            granted = None
            for tenant in self._wfq.order(heads):
                r = heads[tenant]
                if slot_cap and occupancy[tenant] >= slot_cap:
                    continue
                bucket = self._buckets.get(tenant)
                cost = self._admission_cost(r, bucket)
                if bucket is not None and not bucket.can_take(cost):
                    if tenant not in deferred_round:
                        self.tenant_stats[tenant]["deferrals"] += 1
                        deferred_round.add(tenant)
                    continue
                if self.paged and \
                        self._blocks_for(r) > self._alloc.free_blocks:
                    continue             # pool pressure: wait or try next
                if bucket is not None:
                    bucket.take(cost)
                granted = r
                break
            if granted is None:
                break
            for qi, q in enumerate(queue):
                if q is granted:         # remove by identity
                    del queue[qi]
                    break
            nxt = next((q for q in queue if q.tenant == granted.tenant),
                       None)
            if nxt is None:
                heads.pop(granted.tenant)
            else:
                heads[granted.tenant] = nxt
            self._wfq.grant(granted.tenant,
                            cost=min(granted.max_new_tokens,
                                     scfg.max_new_tokens))
            self.tenant_stats[granted.tenant]["wfq_grants"] += 1
            occupancy[granted.tenant] += 1
            granted_n += 1
            self._start_request(granted, slot, cache, slots, vecs, tok,
                                ntok, done, gen)
            if slots[slot] is None:      # finished on its first token
                occupancy[granted.tenant] -= 1
        return granted_n

    def _run_continuous(self, requests: list[Request], gen) -> list[Request]:
        scfg = self.scfg
        B = scfg.max_batch
        for r in requests:
            self._check_capacity(r)
        if self.paged:
            layers, kvh, hd, dt = self._pool_geom
            cache = kv_pool_init(layers, self._n_usable, scfg.block_size,
                                 kvh, hd, dtype=dt, device=self.device)
            self._alloc = BlockAllocator(self._n_usable)
            self._tables = np.zeros((B, self._tables_len), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(B)]
        else:
            cache = self.model.init_cache(B, scfg.kv_cache_len)
        vecs = slot_vectors_init(B)
        self._slot_vecs = vecs
        self._prefills = {}
        self._prefill_q = deque()
        self._slot_started = [0] * B
        self._slot_seq = 0
        tok = np.zeros((B, 1), np.int32)
        ntok = np.zeros(B, np.int32)
        slots: list[Request | None] = [None] * B
        queue = deque(requests)
        done: list[Request] = []
        starved = 0

        while queue or vecs["active"].any() or self._prefills:
            self._enforce_budget(slots, vecs, ntok, queue)
            granted = self._fill_slots(slots, queue, cache, vecs, tok, ntok,
                                       done, gen)
            if self._prefill_q:          # one chunk per tick, interleaved
                self._advance_chunk(cache, slots, vecs, tok, ntok, done, gen)
            if self.paged:               # claim this tick's write blocks
                for i in np.nonzero(vecs["active"])[0]:
                    if vecs["active"][i]:
                        self._ensure_blocks(int(i), slots, vecs, ntok, queue)
            active = np.nonzero(vecs["active"])[0]
            if not len(active):
                if not queue and not self._prefills:
                    break
                starved = 0 if granted or self._prefills else starved + 1
                if starved > _MAX_STARVED_ROUNDS:
                    r = queue.popleft()
                    self._start_request(r, 0, cache, slots, vecs, tok, ntok,
                                        done, gen)
                    starved = 0
                continue
            starved = 0

            if self.paged:
                self._decode_shapes.add(("pool", B,
                                         self._tables_len * scfg.block_size))
                logits, cache = self._step_pool(tok, cache, self._tables,
                                                vecs["pos"], vecs["active"])
            else:
                self._decode_shapes.add(("slots", B, scfg.kv_cache_len))
                logits, cache = self.model.decode_step_slots(
                    self.params, self._tensor(tok), cache,
                    self._tensor(vecs["pos"], torch.int32), dp=self.dp)
            nxt = sample(logits[:, -1, :], gen, scfg.temperature).cpu().numpy()
            for i in active:
                r = slots[i]
                t = int(nxt[i])
                self._emit(r, t)
                self.tenant_stats[r.tenant]["occupancy_steps"] += 1
                ntok[i] += 1
                vecs["pos"][i] += 1
                tok[i, 0] = t
                if t == self.eos_id or \
                        ntok[i] >= min(r.max_new_tokens, scfg.max_new_tokens):
                    self._finish(r, done)
                    slots[i] = None
                    self._release_slot(i, vecs)
            self._obs_snapshot(active=int(vecs["active"].sum()),
                               queued=len(queue))
        return done

    # ------------------------------------------------------------------
    # gang (baseline): batch to completion
    # ------------------------------------------------------------------
    def _run_gang(self, requests: list[Request], gen) -> list[Request]:
        queue = list(requests)
        done: list[Request] = []

        while queue:
            batch_reqs, queue = self._admit_batch(queue)
            toks = self._pad_prompts(batch_reqs)
            b, prompt_len = toks.shape
            cache_len = prompt_len + self.scfg.max_new_tokens + 1
            cache = self.model.init_cache(b, cache_len)
            logits, cache = self.model.prefill(
                self.params, {"tokens": self._tensor(toks)},
                kv_cache_constrain(self.dp, cache), dp=self.dp)
            tok = sample(logits[:, -1, :], gen, self.scfg.temperature)[:, None]
            limits = [min(r.max_new_tokens, self.scfg.max_new_tokens)
                      for r in batch_reqs]
            active = np.ones(b, bool)
            for j, (r, t) in enumerate(zip(batch_reqs,
                                           tok[:, 0].cpu().numpy())):
                self._emit(r, int(t))
                if t == self.eos_id or limits[j] <= 1:
                    active[j] = False

            for i in range(self.scfg.max_new_tokens - 1):
                if not active.any():
                    break
                self._decode_shapes.add(("gang", b, cache_len))
                logits, cache = self.model.decode_step(
                    self.params, tok.to(torch.int64), cache, prompt_len + i,
                    dp=self.dp)
                tok = sample(logits[:, -1, :], gen,
                             self.scfg.temperature)[:, None]
                arr = tok[:, 0].cpu().numpy()
                for j, r in enumerate(batch_reqs):
                    if active[j]:
                        self._emit(r, int(arr[j]))
                        if arr[j] == self.eos_id or \
                                len(r.out_tokens) >= limits[j]:
                            active[j] = False
                self._obs_snapshot(active=int(active.sum()),
                                   queued=len(queue))
            for r in batch_reqs:
                self._finish(r, done)
        return done

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def tenant_report(self) -> dict[str, dict[str, float]]:
        """Per-tenant serve accounting: requests, tokens, deferrals, WFQ
        grants, decode-slot occupancy steps, preemptions, restores."""
        return {t: dict(v) for t, v in self.tenant_stats.items()}

    def slot_report(self) -> list[dict]:
        """Live per-slot view (position, active, tenant name)."""
        vecs = getattr(self, "_slot_vecs", None)
        if vecs is None:
            return []
        names = {i: t for t, i in self._tenant_ids.items()}
        return [{"slot": i, "pos": int(vecs["pos"][i]),
                 "active": bool(vecs["active"][i]),
                 "tenant": names.get(int(vecs["tenant"][i]))}
                for i in range(len(vecs["pos"]))]

    def runtime_counters(self) -> tuple[np.ndarray, tuple[str, ...]]:
        """Serve accounting in per-tenant counter-block layout: ops = WFQ
        slot grants, bytes = served tokens, chunks = occupancy steps,
        throttled = bucket deferrals, plus preemptions / restores."""
        tenants = tuple(self.tenant_stats)
        ctrs = np.zeros((len(tenants), tl.NUM_COUNTERS), np.float32)
        for i, t in enumerate(tenants):
            s = self.tenant_stats[t]
            ctrs[i, tl.CTR_OPS] = s["wfq_grants"] or s["requests"]
            ctrs[i, tl.CTR_BYTES] = s["tokens"]
            ctrs[i, tl.CTR_CHUNKS] = s["occupancy_steps"]
            ctrs[i, tl.CTR_THROTTLED] = s["deferrals"]
            ctrs[i, tl.CTR_PREEMPTIONS] = s["preemptions"]
            ctrs[i, tl.CTR_RESTORES] = s["restores"]
        return ctrs, tenants

    def decode_compile_count(self) -> int:
        """Distinct decode-step shapes run so far: 1 per engine under
        continuous batching, one per distinct batch shape under gang
        scheduling (what ``repro`` counts as decode compiles)."""
        return len(self._decode_shapes)


__all__ = ["Engine", "Request", "ServeError", "WFQScheduler", "sample",
           "prompt_bucket"]
