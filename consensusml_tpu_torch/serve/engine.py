"""The serving engine: one loop thread over a paged KV pool.

Port of ``consensusml_tpu/serve/engine.py`` in its paged mode. Clients
touch only the bounded submit queue and per-request handles; the engine
thread does all device work — admission prefills under a per-tick token
budget, one decode step for every resident slot per tick, recompute
preemption of the youngest stream when the pool runs out of blocks — so
the pages, the block table and the slot table need no locks.

On a CUDA device the thread binds that device, every kernel goes to
PyTorch's current stream, and the host copy of each step's sampled
tokens is the one fence per step. ``attn_impl="auto"`` (the default)
resolves to the hand-written CUDA kernels on the card and to their plain
PyTorch versions on the CPU; :meth:`stats` reports the resolved tier and
the kernels' launch counts.

The train-to-serve handoff: :func:`load_engine` builds an engine from a
serving artifact (:mod:`.export`), :meth:`Engine.score` is the prefill-
only scoring path held to the consensus-mean model, and
:meth:`Engine.watch` flips to each new generation of the artifact
between steps (:mod:`.pool.hotswap`). ``spec_decode=SpecConfig(draft,
k)`` replaces the one-token decode step by a speculative round
(:mod:`.pool.spec`), and ``ServeConfig(prefix_cache=True)`` prefills only
the unshared suffix of a prompt whose block-aligned prefix is cached
(:mod:`.pool.prefix`).

Telemetry, the reference's (:mod:`consensusml_tpu_torch.obs`): the
``serve.prefill``, ``serve.decode_step`` and ``serve.spec_step`` spans;
a request trace a request (``submit(trace=)`` takes the client's
:class:`~consensusml_tpu_torch.obs.TraceContext`, else one is minted),
with its admission, defer, prefill, decode, preempt and hot-swap events;
every ``consensusml_serve_*``, ``consensusml_pool_*``,
``consensusml_prefix_*`` and ``consensusml_spec_*`` family, the SLO
histograms carrying request ids as exemplars; the per-tenant
``consensusml_tenant_*`` children; and one wide event a terminal request
(:mod:`~consensusml_tpu_torch.obs.events`), which joins its request's
device cost from the cost ledger once :meth:`Engine.register_costs` has
counted every stage (before that, zeros with ``cost_joined: False``, as
the reference's without a ledger). None of it reads a device value.

Deferred to later slices: the reference's per-slot (``kv_impl="slot"``)
path.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.paged_attention import resolve_attention_impl
from consensusml_tpu_torch.obs import TraceContext, get_registry, get_request_registry, get_tracer
from consensusml_tpu_torch.obs.events import get_wide_event_log, sanitize_tenant
from consensusml_tpu_torch.obs.metrics import DEFAULT_SLO_BUCKETS
from consensusml_tpu_torch.serve import pool as P
from consensusml_tpu_torch.serve.batcher import (
    GenResult,
    Request,
    RequestHandle,
    Slot,
    SlotTable,
)
from consensusml_tpu_torch.serve.decode import DecodeModel, prefill_buckets
from consensusml_tpu_torch.serve.pool.hotswap import tree_spec

__all__ = ["ServeConfig", "Engine", "load_engine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine geometry + admission policy (fixed at construction)."""

    num_slots: int = 8  # decode batch lanes
    max_len: int = 0  # cache length; 0 = the model's max_len
    queue_depth: int = 64  # bounded admission queue
    max_new_tokens: int = 16  # default per-request generation cap
    eos_id: int | None = None  # default stop token; submit() can override
    idle_wait_s: float = 0.02  # loop block when nothing is in flight
    temperature: float = 0.0  # default sampling; 0 = greedy argmax
    top_p: float = 1.0
    block_size: int = 8  # tokens per physical KV block (must divide max_len)
    num_blocks: int = 0  # pool size; 0 = num_slots * max_len / block_size + 1
    prefill_budget: int = 0  # prefill tokens per tick; 0 = one max_len bucket
    # refcounted prefix sharing (pool/prefix.py): a matched block-aligned
    # prompt prefix maps into the slot's table and only the suffix prefills
    prefix_cache: bool = False
    # paged-attention tier: "auto" = the CUDA kernel on the card, its
    # plain version on the CPU; "torch" / "cuda" by name
    attn_impl: str = "auto"


class Engine:
    """In-process serving engine. ``Engine(model, config, device=...)``
    takes a ``GPT2LM`` or a ``LlamaLM``, moves it to ``device`` (``None``
    = CUDA; raises without a GPU) and casts its Dense, adapter and
    embedding parameters to the compute dtype in place
    (:meth:`GPT2LM.to_compute_dtype`, :meth:`LlamaLM.to_compute_dtype`),
    then :meth:`submit` from any thread. ``spec_decode`` (a
    :class:`~.pool.spec.SpecConfig`) serves speculatively with its draft,
    cast and moved the same way. Use as a context manager or call
    :meth:`shutdown`, which drains in-flight work by default."""

    def __init__(self, model: Any, config: ServeConfig | None = None, *, device=None, spec_decode: Any = None):
        self.config = cfg = config or ServeConfig()
        self.device = resolve_device(device)
        # the live parameters' names, shapes and dtypes before the cast (what
        # an artifact holds): a hot swap must match them leaf for leaf
        self._artifact_spec = tree_spec(dict(model.named_parameters()))
        # the compute-dtype cast happens once here (the model's f32 masters
        # are a training concern): per-op casts then do nothing
        model = model.to(self.device).eval().to_compute_dtype()
        self._dm = dm = DecodeModel.wrap(model)
        self.max_len = cfg.max_len or dm.max_len
        if not 0 < self.max_len <= dm.max_len:
            raise ValueError(f"max_len {self.max_len} outside (0, {dm.max_len}]")
        if cfg.num_slots < 1:
            raise ValueError(f"num_slots must be positive, got {cfg.num_slots}")
        # resolved ONCE: the reported tier is the executed tier
        self.attn_impl = resolve_attention_impl(cfg.attn_impl, self.device)
        self.buckets = prefill_buckets(self.max_len, smallest=max(8, cfg.block_size))
        misaligned = [b for b in self.buckets if b % cfg.block_size]
        if misaligned:
            raise ValueError(
                f"block_size {cfg.block_size} does not divide prefill bucket(s) "
                f"{misaligned}; use a power-of-two block_size"
            )
        self._pool = P.BlockPool(cfg.num_slots, self.max_len, cfg.block_size, cfg.num_blocks)
        self._pages = P.init_pages(dm, self._pool.num_blocks, cfg.block_size)
        self._prefill_fn = P.make_paged_prefill_fn(dm, attn_impl=self.attn_impl)
        self._decode_fn = P.make_paged_decode_fn(dm, attn_impl=self.attn_impl)
        self._sched = P.AdmissionScheduler(cfg.prefill_budget or self.max_len)
        # content-addressed prefix sharing: the index forgets a block the
        # moment a fresh pop recycles it, and freed blocks it still names
        # park at the bottom of the free stack
        self._prefix = None
        if cfg.prefix_cache:
            self._prefix = P.PrefixIndex(cfg.block_size)
            self._pool.reuse_hook = self._prefix.invalidate_block
            self._pool.cached_hook = self._prefix.cached
            self._prefix_prefill_fn = P.make_prefix_prefill_fn(dm, attn_impl=self.attn_impl)
        # speculative decode: the draft's own (smaller) pages over the pool's
        # block table, one k+1 verify on the target a round
        self.spec = spec_decode
        if spec_decode is not None:
            self._draft_artifact_spec = tree_spec(dict(spec_decode.model.named_parameters()))
            draft = spec_decode.model.to(self.device).eval().to_compute_dtype()
            self._draft_dm = sd = DecodeModel.wrap(draft)
            if sd.vocab_size != dm.vocab_size:
                raise ValueError(
                    f"draft vocab {sd.vocab_size} != target vocab {dm.vocab_size}; speculative "
                    "acceptance compares distributions over one shared vocabulary"
                )
            if sd.max_len < self.max_len:
                raise ValueError(
                    f"draft max_len {sd.max_len} < engine max_len {self.max_len}; the draft must "
                    "reach every position the target serves"
                )
            self._draft_pages = P.init_pages(sd, self._pool.num_blocks, cfg.block_size)
            self._draft_prefill_fn = P.make_paged_prefill_fn(sd, attn_impl=self.attn_impl)
            self._propose_fn = P.make_draft_propose_fn(sd, spec_decode.k, attn_impl=self.attn_impl)
            self._verify_fn = P.make_verify_fn(dm, spec_decode.k, attn_impl=self.attn_impl)
            self._spec_extra_cols = (
                P.spec_table_cols(self._pool.blocks_per_slot, cfg.block_size, spec_decode.k)
                - self._pool.blocks_per_slot
            )
            if self._prefix is not None:
                # the draft's pages share the block geometry: a hit skips its prefill too
                self._draft_prefix_prefill_fn = P.make_prefix_prefill_fn(sd, attn_impl=self.attn_impl)
        self._cost_ledger = None  # set by register_costs()
        self._generation = 0  # artifact generation (load_engine seeds it)
        self._watcher = None
        # a score() holds this across its forward and a flip across its
        # pointer moves: a score never sees half of one generation
        self._params_lock = threading.Lock()

        self._queue: "queue.Queue[Request]" = queue.Queue(cfg.queue_depth)
        # evicted continuations and deferred admissions, ahead of arrivals
        self._requeue: "collections.deque[Request]" = collections.deque()
        self._table = SlotTable(cfg.num_slots)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._warmed = threading.Event()
        self._error: BaseException | None = None

        # host-side SLO accumulators (bounded rings; totals are lifetime)
        self._ttfts: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._step_times: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._occupancy_sum = 0.0
        self._block_occupancy_sum = 0.0
        self._decode_steps = 0
        self._tokens_out = 0
        self._tokens_in = 0
        self._decode_time_s = 0.0
        self._evictions = 0
        self._prefill_tokens_computed = 0
        self._swaps = 0
        self._swap_rejected = 0
        self._streams_at_flip: list[int] = []  # streams in flight at each flip
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_hit_blocks = 0
        self._prefix_cow_copies = 0
        self._prefix_bytes_saved = 0
        self._ttfts_hit: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._ttfts_miss: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_tokens = 0
        self._init_telemetry()

        self._thread = threading.Thread(target=self._loop, name="serve-engine", daemon=True)
        self._thread.start()

    def _init_telemetry(self) -> None:
        """The reference's families, spans and request planes (engine
        construction; the registry dedupes by name, so engines share
        them)."""
        self._tracer = get_tracer()
        self._rt = get_request_registry()
        # the engine is a producer: it arms the global wide-event log
        self._events = get_wide_event_log()
        self._registry = reg = get_registry()
        self._tenant_children: dict[str, dict[str, Any]] = {}
        self._m_requests = reg.counter("consensusml_serve_requests_total", "requests accepted by submit()")
        self._m_rejected = reg.counter("consensusml_serve_rejected_total",
                                       "requests rejected (bounded queue full or engine draining)")
        self._m_completed = reg.counter("consensusml_serve_completed_total", "requests served to completion")
        self._m_tokens = reg.counter("consensusml_serve_tokens_total", "tokens generated (prefill + decode)")
        self._m_ttft = reg.histogram("consensusml_serve_ttft_seconds",
                                     "time to first token: arrival -> first generated token",
                                     buckets=DEFAULT_SLO_BUCKETS)
        self._m_intertoken = reg.histogram("consensusml_serve_intertoken_seconds",
                                           "per-decode-step latency (== inter-token gap for resident slots)",
                                           buckets=DEFAULT_SLO_BUCKETS)
        self._m_prefill = reg.histogram("consensusml_serve_prefill_seconds", "prefill forward wall time",
                                        buckets=DEFAULT_SLO_BUCKETS)
        self._m_queue = reg.gauge("consensusml_serve_queue_depth", "requests waiting for a slot")
        self._m_occupancy = reg.gauge("consensusml_serve_batch_occupancy",
                                      "active decode slots / num_slots (sampled per step)")
        self._m_tps = reg.gauge("consensusml_serve_tokens_per_sec",
                                "decode throughput: active slots / step wall time (sampled)")
        self._m_generation = reg.gauge("consensusml_serve_generation", "artifact generation currently serving")
        self._m_swaps = reg.counter("consensusml_serve_swaps_total",
                                    "drain-free hot swaps applied (params flipped between steps)")
        self._m_evictions = reg.counter("consensusml_pool_evictions_total",
                                        "streams preempted by recompute on block-pool exhaustion")
        self._m_loop_heartbeat = reg.gauge(
            "consensusml_serve_loop_heartbeat_seconds",
            "unix time of the engine loop's latest iteration (liveness; staleness means the serving thread is "
            "wedged or dead)")
        self._m_loop_heartbeat.set(time.time())
        if self.spec is not None:
            self._m_spec_rounds = reg.counter("consensusml_spec_rounds_total",
                                              "speculative rounds (one draft scan + one fused verify)")
            self._m_spec_proposed = reg.counter("consensusml_spec_proposed_total",
                                                "draft tokens proposed across all live lanes")
            self._m_spec_accepted = reg.counter("consensusml_spec_accepted_total",
                                                "draft tokens accepted by the target's rejection sampler")
            self._m_spec_rate = reg.gauge(
                "consensusml_spec_acceptance_rate",
                "accepted / proposed over the engine lifetime (sampled per verify round) — the k-tuning signal")
        self._params_nbytes = _nbytes(self._dm.model.parameters())
        self._m_params_bytes = reg.gauge("consensusml_serve_params_bytes",
                                         "device bytes of the serving params tree (current generation)")
        self._m_params_bytes.set(self._params_nbytes)
        self._m_blocks_free = reg.gauge("consensusml_pool_blocks_free", "free physical KV blocks (trash block excluded)")
        self._m_block_occ = reg.gauge("consensusml_pool_block_occupancy",
                                      "allocated blocks / usable blocks (sampled per step)")
        self._m_blocks_free.set(self._pool.free_blocks)
        self._m_block_occ.set(0.0)
        pool_bytes = _nbytes(t for pg in self._pages for t in pg.values())
        self._block_nbytes = pool_bytes // max(self._pool.num_blocks, 1)
        if self.spec is not None:
            self._draft_block_nbytes = _nbytes(t for pg in self._draft_pages for t in pg.values()) // max(
                self._pool.num_blocks, 1)
        self._m_pool_hbm = reg.gauge("consensusml_pool_hbm_bytes",
                                     "device bytes held by the paged KV block pool (all layers)")
        self._m_pool_hbm.set(pool_bytes)
        self._m_pool_hbm_free = reg.gauge(
            "consensusml_pool_hbm_free_bytes",
            "KV bytes still allocatable (free blocks x per-block bytes) — the per-engine serving HBM headroom signal")
        self._m_pool_hbm_free.set(self._pool.free_blocks * self._block_nbytes)
        if self._prefix is not None:
            self._m_prefix_hits = reg.counter("consensusml_prefix_hits_total",
                                              "admissions that adopted at least one indexed prefix block")
            self._m_prefix_misses = reg.counter("consensusml_prefix_misses_total",
                                                "admissions that prefilled from scratch (no indexed prefix)")
            self._m_prefix_hit_blocks = reg.counter(
                "consensusml_prefix_hit_blocks_total",
                "KV blocks mapped in from the prefix index instead of prefilled")
            self._m_prefix_cow_copies = reg.counter(
                "consensusml_prefix_cow_copies_total",
                "copy-on-write block copies (full-match divergence: the last shared block copied to a fresh page "
                "in-jit)")
            self._m_prefix_bytes_saved = reg.counter(
                "consensusml_prefix_bytes_saved_total",
                "KV bytes NOT materialized thanks to prefix sharing (adopted blocks x per-block bytes, draft pages "
                "included)")
            self._m_prefix_entries = reg.gauge("consensusml_prefix_entries",
                                               "live prefix-index entries (current generation)")
            self._m_prefix_shared_blocks = reg.gauge("consensusml_prefix_shared_blocks",
                                                     "physical blocks currently held by more than one stream")

    # -- client API ---------------------------------------------------------

    def submit(
        self,
        ids: Sequence[int],
        max_new_tokens: int | None = None,
        *,
        block: bool = True,
        timeout: float | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        eos_id: int | None = None,
        trace: TraceContext | None = None,
        tenant: str | None = None,
    ) -> RequestHandle:
        """Enqueue one request; returns its :class:`RequestHandle`.

        ``temperature``/``top_p``/``seed`` sample this request (defaults:
        the config's, and a fresh seed for sampled requests); the resolved
        triple is echoed on the result so the stream replays. Raises
        ``queue.Full`` when the bounded queue is full, ``RuntimeError``
        once the engine is draining, ``ValueError`` on a bad request
        (token ids must lie in ``[0, vocab_size)``: PyTorch raises or
        device-asserts on an out-of-range lookup). ``trace`` is the
        request's :class:`~consensusml_tpu_torch.obs.TraceContext` (minted
        when ``None``); ``tenant`` labels the request for attribution and
        namespaces the prefix cache (sanitized; ``None``: ``"default"``).
        """
        cfg = self.config
        max_new = cfg.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
        temp = cfg.temperature if temperature is None else float(temperature)
        tp = cfg.top_p if top_p is None else float(top_p)
        if temp < 0:
            raise ValueError(f"temperature must be >= 0, got {temp}")
        if not 0 < tp <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {tp}")
        if seed is None:
            seed = 0 if temp == 0 else int.from_bytes(os.urandom(4), "little")
        seed = int(seed) & 0xFFFFFFFF
        eos = cfg.eos_id if eos_id is None else int(eos_id)
        if self._draining.is_set() or self._stop.is_set():
            self._m_rejected.inc()
            if self._error is not None:
                raise RuntimeError(
                    f"engine died on {type(self._error).__name__}: {self._error}"
                ) from self._error
            raise RuntimeError("engine is draining/closed; not accepting requests")
        ids = [int(t) for t in ids]
        if not ids:
            raise ValueError("empty prompt")
        if min(ids) < 0 or max(ids) >= self._dm.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self._dm.vocab_size})")
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be positive, got {max_new}")
        if len(ids) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(ids)}) + max_new_tokens ({max_new}) exceeds the "
                f"cache length {self.max_len}"
            )
        tenant_s = sanitize_tenant(tenant)
        ctx = trace if trace is not None else TraceContext.mint("srv")
        handle = RequestHandle(len(ids))
        req = Request(ids, max_new, handle, ctx=ctx, temperature=temp, top_p=tp, seed=seed, eos_id=eos,
                      tenant=tenant_s)
        self._rt.start(ctx, len(ids), max_new_tokens=max_new, generation=self._generation, tenant=tenant_s)
        try:
            self._queue.put(req, block=block, timeout=timeout)
        except queue.Full:
            self._m_rejected.inc()
            self._rt.finish(ctx.request_id, "rejected", detail="queue_full")
            raise
        if self._drained.is_set():
            # lost the race against loop exit: nothing will service it
            self._cancel_queued()
            self._m_rejected.inc()
            raise RuntimeError("engine is draining/closed; not accepting requests")
        self._m_requests.inc()
        self._m_queue.set(self._queue.qsize())
        return handle

    def warmup(self) -> dict[str, int]:
        """Build the CUDA kernels (on the card) and run every stage once at
        every shape it serves: a prefill per prompt bucket and a decode
        step; with the prefix cache a suffix prefill per bucket; with a
        draft its prefill per bucket, a propose and a verify (and its
        suffix prefills). On the caller's thread against throwaway
        one-block pools (all-zero block rows route every write to their
        block 0), so first-request latency pays no kernel build and no
        library initialisation. Returns the counts of warmed stages."""
        dm, s, bs = self._dm, self.config.num_slots, self.config.block_size
        bks, bps = self.buckets, self._pool.blocks_per_slot
        if self.attn_impl == "cuda":
            kernels.build()
        dev = self.device
        counts = {"prefill": len(bks), "decode": 1}
        models = [(dm, self._prefill_fn, getattr(self, "_prefix_prefill_fn", None))]
        if self.spec is not None:
            models.append((self._draft_dm, self._draft_prefill_fn, getattr(self, "_draft_prefix_prefill_fn", None)))
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            zeros = torch.zeros((s,), dtype=torch.int32, device=dev)
            samp = (zeros.float(), torch.ones((s,), device=dev), zeros.long())
            for m, prefill, prefix_prefill in models:
                pages = P.init_pages(m, 1, bs)
                for b in bks:
                    ids = torch.zeros((1, b), dtype=torch.int64, device=dev)
                    prefill(pages, ids, 1, torch.zeros((b // bs,), dtype=torch.int64, device=dev), 0.0, 1.0, 0)
                    if prefix_prefill is not None:
                        row = torch.zeros((bps + b // bs,), dtype=torch.int32, device=dev)
                        prefix_prefill(pages, ids, 1, 0, row, P.TRASH_BLOCK, P.TRASH_BLOCK, 0.0, 1.0, 0)
                if m is dm:
                    self._decode_fn(pages, torch.zeros((s, bps), dtype=torch.int32, device=dev), zeros, zeros, *samp)
            if self.spec is not None:
                table = torch.zeros((s, bps + self._spec_extra_cols), dtype=torch.int32, device=dev)
                dpages, tpages = P.init_pages(self._draft_dm, 1, bs), P.init_pages(dm, 1, bs)
                props, q_sel, q_probs = self._propose_fn(dpages, table, zeros, zeros, *samp)
                self._verify_fn(tpages, table, zeros, props, q_sel, q_probs, zeros, *samp)
                counts.update(draft_prefill=len(bks), propose=1, verify=1)
            if self._prefix is not None:
                counts["prefix_prefill"] = len(bks) * len(models)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._warmed.set()
        return counts

    def register_costs(self, ledger: Any = None) -> dict[str, Any]:
        """Count every serving stage into the cost ledger
        (:mod:`consensusml_tpu_torch.obs.costs`; the reference's
        ``register_costs``): one prefill row a prompt bucket
        (``serve.prefill.b<L>``), with the prefix cache one suffix-prefill
        row a bucket (``serve.prefix_prefill.b<L>``), the decode row
        (``serve.decode``), with a draft its prefill rows, ``serve.spec.
        propose`` and ``serve.spec.verify``, and the hot-swap staging
        transfer (``serve.hotswap.stage``). Each stage runs once, at the
        shapes :meth:`warmup` serves, on fake copies of the model, the
        pages and its inputs (built in the pass): nothing launches, nothing
        is allocated on the card, the live pages and parameters are not
        written and the engine thread is not touched, so it may run beside
        traffic (it costs one pass a stage on the caller's thread, so run
        it with :meth:`warmup`, not per request). The rows price the
        engine's resolved tier (``attn_impl``); the reference's ``.fused``
        side-by-side rows have no counterpart (the port resolves one tier
        an engine). From then on every wide event joins its request's rows.
        Returns ``{name: ExecutableCost}``."""
        if ledger is None:
            from consensusml_tpu_torch.obs.costs import CostLedger, device_kind, get_cost_ledger

            ledger = get_cost_ledger() if self.device.type == "cuda" else CostLedger(platform=device_kind("cpu"))
        from consensusml_tpu_torch.workcount import fakes

        cfg, dev, impl = self.config, self.device, self.attn_impl
        s, bs, bps = cfg.num_slots, cfg.block_size, self._pool.blocks_per_slot
        # one fake copy of the models and pages, shared by every stage's pass
        dm, pages, draft_dm, draft_pages = fakes(self._dm, self._pages, getattr(self, "_draft_dm", None),
                                                 getattr(self, "_draft_pages", None))
        base = {"kv_impl": "paged", "num_slots": s, "max_len": self.max_len, "attn_impl": impl, "block_size": bs}
        rows: dict[str, Any] = {}
        z = lambda shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        samp = lambda: (z((s,), torch.float32), torch.ones((s,), device=dev), z((s,), torch.int64))  # noqa: E731

        def prefill_rows(prefix: str, m: DecodeModel, pages, meta):
            for b in self.buckets:
                name = f"{prefix}prefill.b{b}"
                rows[name] = ledger.register(
                    name, lambda m, pg, ids, row: P.make_paged_prefill_fn(m, attn_impl=impl)(pg, ids, b, row, 0.0,
                                                                                             1.0, 0),
                    m, pages, setup=lambda m, pg: (z((1, b), torch.int64), z((b // bs,), torch.int64)),
                    meta={**meta, "bucket": b})
                if self._prefix is not None:
                    name = f"{prefix}prefix_prefill.b{b}"
                    rows[name] = ledger.register(
                        name, lambda m, pg, ids, row: P.make_prefix_prefill_fn(m, attn_impl=impl)(
                            pg, ids, b, 0, row, P.TRASH_BLOCK, P.TRASH_BLOCK, 0.0, 1.0, 0),
                        m, pages, setup=lambda m, pg: (z((1, b), torch.int64), z((bps + b // bs,))),
                        meta={**meta, "bucket": b})

        prefill_rows("serve.", dm, pages, base)
        rows["serve.decode"] = ledger.register(
            "serve.decode", lambda m, pg, *a: P.make_paged_decode_fn(m, attn_impl=impl)(pg, *a), dm, pages,
            setup=lambda m, pg: (z((s, bps)), z((s,)), z((s,)), *samp()),
            meta={**base, "num_blocks": self._pool.num_blocks})
        if self.spec is not None:
            k = self.spec.k
            cols = bps + self._spec_extra_cols
            spec_meta = {**base, "k": k}
            prefill_rows("serve.draft_", draft_dm, draft_pages, spec_meta)

            def propose(m, pg, table, toks, pos, *sm):
                return P.make_draft_propose_fn(m, k, attn_impl=impl)(pg, table, toks, pos, *sm)

            rows["serve.spec.propose"] = ledger.register(
                "serve.spec.propose", propose, draft_dm, draft_pages,
                setup=lambda m, pg: (z((s, cols)), z((s,)), z((s,)), *samp()), meta=spec_meta)

            def verify_inputs(m, pg, dmm, dpg):
                table, toks, sm = z((s, cols)), z((s,)), samp()
                with torch.inference_mode():
                    props, q_sel, q_probs = propose(dmm, dpg, table, toks, toks, *sm)
                return table, toks, props, q_sel, q_probs, toks, *sm

            rows["serve.spec.verify"] = ledger.register(
                "serve.spec.verify",
                lambda m, pg, dmm, dpg, *a: P.make_verify_fn(m, k, attn_impl=impl)(pg, *a),
                dm, pages, draft_dm, draft_pages, setup=verify_inputs, meta=spec_meta)
        # the hot-swap stage is a transfer, not a program: one params tree
        # staged onto the card by the watcher
        rows["serve.hotswap.stage"] = ledger.register_transfer(
            "serve.hotswap.stage", self._dm.model, meta={**base, "generation": self._generation})
        self._cost_ledger = ledger
        return rows

    def score(self, ids) -> torch.Tensor:
        """Prefill-only scoring: f32 logits ``(B, S, V)`` of a token batch
        (``(B, S)`` ints) under the generation now serving, the forward the
        consensus-mean model runs (the check that an export matches its
        source). On the caller's thread; a hot swap waits for it."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(self.device)
        with self._params_lock, torch.inference_mode():
            return self._dm.model(ids, attn_impl=self.attn_impl)

    def watch(self, path: str, poll_s: float = 0.25):
        """Arm the drain-free hot swap: poll ``path`` for a newer artifact
        generation, stage it off the engine thread, flip between steps
        (:mod:`.pool.hotswap`). A speculative engine stages the draft
        riding in ``path/draft/`` with it, so target and draft flip
        together. Returns the watcher."""
        if self._watcher is not None:
            raise RuntimeError("engine is already watching an artifact dir")
        like = {n: p.dtype for n, p in self._dm.model.named_parameters()}
        draft_like = None
        if self.spec is not None:
            draft_like = {n: p.dtype for n, p in self._draft_dm.model.named_parameters()}
        self._watcher = P.GenerationWatcher(
            path, device=self.device, like=like, draft_like=draft_like,
            current_generation=self._generation, poll_s=poll_s,
        )
        return self._watcher

    @property
    def generation(self) -> int:
        """The artifact generation now serving (0: a model given directly)."""
        return self._generation

    def _maybe_swap(self) -> None:
        """Flip to a staged generation (engine thread, between steps). The
        staged tree must match the live one leaf for leaf (names, shapes,
        the artifact's dtypes), and the draft's too where one was staged:
        target and draft flip together or not at all. A mismatch is
        rejected and counted, and the current generation keeps serving."""
        if self._watcher is None:
            return
        sw = self._watcher.take()
        if sw is None:
            return
        ok = sw.spec == self._artifact_spec
        if self.spec is not None and sw.draft_params is not None:
            ok = ok and sw.draft_spec == self._draft_artifact_spec
        if not ok:
            self._watcher.reject(sw)
            self._swap_rejected += 1
            return
        flips = [(self._dm.model, sw.params)]
        if self.spec is not None and sw.draft_params is not None:
            flips.append((self._draft_dm.model, sw.draft_params))
        if sw.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(sw.event)  # ordered after the staging copies; no host wait
        with self._params_lock:
            for model, staged in flips:
                for name, p in model.named_parameters():
                    t = staged[name]
                    if sw.event is not None:
                        t.record_stream(stream)  # allocated on the watcher's stream, now used on this one
                    p.data = t
        self._generation = sw.generation
        self._params_nbytes = _nbytes(self._dm.model.parameters())
        self._m_params_bytes.set(self._params_nbytes)
        for _i, slot in self._table.active:
            slot.generation = sw.generation
            # a mid-stream flip is part of the request's story
            self._rt.event(slot.request.request_id, "hotswap", generation=sw.generation)
        self._streams_at_flip.append(self._table.num_active)
        self._swaps += 1
        self._m_swaps.inc()
        self._m_generation.set(sw.generation)
        if self._prefix is not None:
            # stale entries are unreachable already (lookups key on the
            # generation); this reclaims them and their cached blocks
            self._prefix.drop_stale(sw.generation)
            self._m_prefix_entries.set(len(self._prefix))

    @property
    def warmed(self) -> bool:
        return self._warmed.is_set()

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admitting; serve everything queued and in flight to
        completion. True when fully drained."""
        self._draining.set()
        return self._drained.wait(timeout)

    def shutdown(self, drain: bool = True, timeout: float | None = None) -> None:
        if drain:
            self.drain(timeout)
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def stats(self) -> dict[str, Any]:
        """Host-side SLO summary; percentiles over the last 4096 samples,
        totals lifetime. With the prefix cache, TTFT apart for hits and
        misses and the index's counts; with a draft, the acceptance rate
        and the tokens a round; with a watcher, the generations staged and
        the staging times."""

        def pct(xs, q):
            return float(np.percentile(list(xs), q)) if xs else float("nan")

        steps = self._decode_steps
        out = {
            "device": str(self.device),
            "attn_impl": self.attn_impl,
            "kernel_launches": kernels.launch_counts(),
            "tokens_in": self._tokens_in,
            "tokens_out": self._tokens_out,
            "decode_steps": steps,
            "ttft_p50_ms": 1e3 * pct(self._ttfts, 50),
            "ttft_p99_ms": 1e3 * pct(self._ttfts, 99),
            "intertoken_p50_ms": 1e3 * pct(self._step_times, 50),
            "intertoken_p99_ms": 1e3 * pct(self._step_times, 99),
            "mean_batch_occupancy": self._occupancy_sum / steps if steps else 0.0,
            "decode_tokens_per_sec": (
                self._tokens_out / self._decode_time_s if self._decode_time_s > 0 else 0.0
            ),
            "generation": self._generation,
            "swaps": self._swaps,
            "swap_rejected": self._swap_rejected,
            "warmed": self.warmed,
            "evictions": self._evictions,
            "prefill_tokens_computed": self._prefill_tokens_computed,
            "pool": {
                "num_blocks": self._pool.num_blocks,
                "block_size": self._pool.block_size,
                "usable_blocks": self._pool.usable_blocks,
                "free_blocks": self._pool.free_blocks,
                "mean_block_occupancy": (
                    self._block_occupancy_sum / steps if steps else 0.0
                ),
            },
        }
        if self._prefix is not None:
            lookups = self._prefix_hits + self._prefix_misses
            out["prefix_cache"] = {
                "hits": self._prefix_hits,
                "misses": self._prefix_misses,
                "hit_rate": self._prefix_hits / lookups if lookups else 0.0,
                "hit_blocks": self._prefix_hit_blocks,
                "cow_copies": self._prefix_cow_copies,
                "bytes_saved": self._prefix_bytes_saved,
                "entries": len(self._prefix),
                "indexed_blocks": self._prefix.indexed_blocks,
                "shared_blocks": self._pool.shared_blocks,
                "invalidations": self._prefix.invalidations,
                "ttft_hit_p50_ms": 1e3 * pct(self._ttfts_hit, 50),
                "ttft_miss_p50_ms": 1e3 * pct(self._ttfts_miss, 50),
            }
        if self.spec is not None:
            out["spec"] = {
                "k": self.spec.k,
                "rounds": self._spec_rounds,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance_rate": self._spec_accepted / self._spec_proposed if self._spec_proposed else 0.0,
                # tokens the rounds emitted (prefill firsts excluded) a round
                "tokens_per_round": self._spec_tokens / self._spec_rounds if self._spec_rounds else 0.0,
            }
        if self._watcher is not None:
            out["hotswap"] = {"staged": self._watcher.staged, "rejected": self._watcher.rejected,
                              "stage_seconds": list(self._watcher.stage_seconds),
                              "streams_at_flip": list(self._streams_at_flip)}
        return out

    # -- engine thread ------------------------------------------------------

    def _loop(self) -> None:
        q = self._queue
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                self._m_loop_heartbeat.set(time.time())
                self._maybe_swap()  # flip a staged generation between steps
                self._sched.start_tick()
                self._admit_waiting()
                if self._table.num_active:
                    if self.spec is not None:
                        self._spec_step()
                    else:
                        self._decode_step()
                    continue
                if self._draining.is_set() and q.empty() and not self._requeue:
                    break
                if self._requeue:  # deferred by budget; retry next tick
                    continue
                try:
                    req = q.get(timeout=self.config.idle_wait_s)
                except queue.Empty:
                    continue
                self._m_queue.set(q.qsize())
                # through _admit_waiting's capacity/budget gate next tick
                self._requeue.append(req)
        except BaseException as e:
            # a device error mid-serving must not leave clients parked on
            # silent handles: mark the engine dead, fail everything, and
            # re-raise so the thread's death is loud
            self._error = e
            raise
        finally:
            self._stop.set()
            self._draining.set()
            if self._watcher is not None:
                self._watcher.stop()
            for i, slot in self._table.active:
                self._table.release(i)
                # settle block-seconds for the wide event (the pool is not
                # released: nothing re-admits)
                self._settle_block_seconds(slot.request, i)
                self._finish_handle(slot.request, "cancelled")
            self._cancel_queued()
            self._drained.set()

    def _cancel_queued(self) -> None:
        while self._requeue:
            try:
                req = self._requeue.popleft()
            except IndexError:
                break
            self._finish_handle(req, "cancelled")
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._finish_handle(req, "cancelled")

    def _pop_waiting(self) -> Request:
        if self._requeue:
            return self._requeue.popleft()
        req = self._queue.get_nowait()
        self._m_queue.set(self._queue.qsize())
        return req

    def _admit_waiting(self) -> None:
        while self._table.free_slot() is not None:
            try:
                req = self._pop_waiting()
            except queue.Empty:
                return
            # the plan is made again at every attempt: a deferred tick may
            # find matched blocks recycled or new ones indexed
            plan = self._prefix_plan(req)
            if plan is None:
                bucket = self._bucket(len(req.ids))
                need = P.blocks_for_tokens(len(req.ids) + 1, self.config.block_size)
            else:  # only what the hit consumes: fresh pops, revived blocks, the suffix bucket
                bucket, need = plan["bucket"], plan["free_needed"]
            # defer (don't drop) when the pool can't hold the prompt yet or
            # this tick's prefill budget is spent; the request keeps its
            # place at the head of the line, each deferred tick on its trace
            if not self._pool.can_admit(need):
                self._rt.event(req.request_id, "admission.defer", reason="blocks")
                self._requeue.appendleft(req)
                return
            if not self._sched.try_admit(bucket):
                self._rt.event(req.request_id, "admission.defer", reason="budget")
                self._requeue.appendleft(req)
                return
            self._admit(req, plan)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.buckets[-1]}")

    def _prefix_plan(self, req: Request) -> dict | None:
        """``req``'s admission against the prefix index: None = the full
        prefill (no index, or no match); else the blocks to adopt, the
        copy-on-write source (a FULL match recomputes its last token inside
        its last block, which others share: the slot takes a fresh block,
        copied from the shared one before the write), the suffix's start
        and length, and the free blocks it costs (fresh pops and revivals
        of matched blocks parked on the free list)."""
        if self._prefix is None:
            return None
        n = len(req.ids)
        match = self._prefix.lookup(req.tenant, self._generation, req.ids)
        if not match:
            return None
        bs = self.config.block_size
        if len(match) * bs == n:
            adopted, cow_src, start = match[:-1], match[-1], n - 1
        else:
            adopted, cow_src, start = match, None, len(match) * bs
        fresh = P.blocks_for_tokens(n + 1, bs) - len(adopted)
        revive = sum(1 for b in adopted if self._pool.refcount(b) == 0)
        if cow_src is not None and self._pool.refcount(cow_src) == 0:
            revive += 1
        return {"match": match, "adopted": adopted, "cow_src": cow_src, "start": start,
                "suffix_len": n - start, "bucket": self._bucket(n - start), "fresh": fresh,
                "free_needed": fresh + revive}

    def _admit(self, req: Request, plan: dict | None = None) -> None:
        """Prefill ``req`` into a free slot. A raise mid-admission cancels
        this request's handle before propagating (it is out of the queue
        but not yet in the slot table, so no exit sweep would reach it)."""
        try:
            self._admit_inner(req, plan)
        except BaseException:
            self._finish_handle(req, "cancelled")
            raise

    def _admit_inner(self, req: Request, plan: dict | None) -> None:
        idx = self._table.free_slot()
        n = len(req.ids)
        bucket = self._bucket(n) if plan is None else plan["bucket"]
        bs = self.config.block_size
        # an evicted continuation re-prefills prompt + generated-so-far;
        # its TTFT already happened and its token count keeps running
        already = len(req.handle._all)
        # every admission's bucket feeds the wide event (each is paid for)
        req.prefill_buckets.append(bucket)
        req.prefill_kinds.append("prefix" if plan is not None else "full")
        rid = req.request_id
        self._rt.event(rid, "admission", slot=idx, bucket=bucket, continuation=bool(already),
                       prefix_blocks=len(plan["match"]) if plan is not None else 0)
        t0 = time.perf_counter()
        ids = np.zeros((1, bucket), np.int64)
        if plan is None:
            ids[0, :n] = req.ids
        else:
            ids[0, : plan["suffix_len"]] = req.ids[plan["start"]:]
        ids = torch.from_numpy(ids).to(self.device)
        samp = (req.temperature, req.top_p, req.seed)
        with self._tracer.span("serve.prefill", bucket=bucket, slot=idx):
            if plan is not None:
                tok = int(self._prefix_admit(idx, req, plan, bucket, ids, samp))  # device fence
            else:
                if self._prefix is not None:
                    self._prefix_misses += 1
                    self._m_prefix_misses.inc()
                # cover the prompt AND the first decode write (position n)
                self._pool.alloc(idx, P.blocks_for_tokens(n + 1, bs))
                try:
                    row = torch.from_numpy(self._pool.block_row(idx, bucket // bs)).to(self.device)
                    tok_dev, _logits = self._prefill_fn(self._pages, ids, n, row, *samp)
                    if self.spec is not None:
                        # the draft's pages need the prompt too (its token is not used)
                        self._draft_prefill_fn(self._draft_pages, ids, n, row, *samp)
                    tok = int(tok_dev)  # device fence: the first token is real now
                except BaseException:
                    self._pool.release(idx)  # no leaked blocks on a raise
                    raise
        self._prefill_tokens_computed += bucket
        if self._prefix is not None:
            # index the PROMPT's full chunks only (positions a prefill wrote;
            # a continuation's decoded tokens stay out); first writer wins
            self._prefix.insert(req.tenant, self._generation, req.ids[: req.handle.prompt_len],
                                self._pool.owned(idx))
            self._m_prefix_entries.set(len(self._prefix))
            self._m_prefix_shared_blocks.set(self._pool.shared_blocks)
        now = time.perf_counter()
        self._m_prefill.observe(now - t0, exemplar=rid)
        self._rt.event(rid, "prefill", bucket=bucket, seconds=round(now - t0, 6))
        if already == 0:
            ttft = now - req.arrival_t
            self._m_ttft.observe(ttft, exemplar=rid)
            self._ttfts.append(ttft)
            if self._prefix is not None:
                (self._ttfts_miss if plan is None else self._ttfts_hit).append(ttft)
            req.handle._ttft_s = ttft
            self._tokens_in += n
            self._tenant_metrics(req.tenant)["ttft"].observe(ttft, exemplar=rid)
        else:
            ttft = req.handle._ttft_s
        req.handle._emit(tok)
        self._m_tokens.inc()
        self._tokens_out += 1
        if already + 1 >= req.max_new_tokens or tok == req.eos_id:
            self._settle_block_seconds(req, idx)
            self._pool.release(idx)
            self._finish_handle(req, "eos" if tok == req.eos_id else "max_tokens", ttft=ttft)
            return
        self._table.occupy(
            idx, Slot(request=req, next_pos=n, pending=tok, generated=already + 1, ttft_s=ttft, last_token_t=now,
                      generation=self._generation)
        )

    def _settle_block_seconds(self, req: Request, idx: int) -> None:
        """Fold slot ``idx``'s hold-time integral onto ``req`` before its
        blocks go back: the unshared part charged (the wide event's
        ``block_seconds``), the prefix-shared part apart."""
        unshared, shared = self._pool.block_seconds_split(idx)
        req.block_seconds += unshared
        req.shared_block_seconds += shared

    def _prefix_admit(self, idx: int, req: Request, plan: dict, bucket: int, ids: torch.Tensor,
                      samp: tuple) -> torch.Tensor:
        """A prefix hit's device work: adopt the matched blocks, pop fresh
        ones for the suffix, run the suffix prefill (and the draft's on a
        speculative engine: its pages share the block geometry). Returns
        the first token on the device; on a raise every reference the slot
        took is let go."""
        pool, bs = self._pool, self.config.block_size
        pool.begin(idx)  # outside the unwind: a double-alloc raise here must not release the owner's blocks
        cow = plan["cow_src"]
        pinned = False
        try:
            pool.adopt(idx, plan["adopted"])
            if cow is not None:
                # hold the source across the prefill: the extend below must
                # not pop it off the free list as this slot's "fresh" block
                pool.pin(cow)
                pinned = True
            fresh = pool.extend(idx, plan["fresh"])
            src, dst = (cow, fresh[0]) if cow is not None else (P.TRASH_BLOCK, P.TRASH_BLOCK)
            row = torch.from_numpy(pool.block_row(idx, pool.blocks_per_slot + bucket // bs)).to(self.device)
            args = (ids, plan["suffix_len"], plan["start"], row, src, dst, *samp)
            tok_dev, _logits = self._prefix_prefill_fn(self._pages, *args)
            if self.spec is not None:
                self._draft_prefix_prefill_fn(self._draft_pages, *args)
        except BaseException:
            if pinned:
                pool.unpin(cow)
            pool.release(idx)
            raise
        if pinned:
            # the copy is queued on the stream ahead of any later write to the source
            pool.unpin(cow)
        hit_blocks = len(plan["match"])
        req.prefix_hit_blocks += hit_blocks
        self._prefix_hits += 1
        self._m_prefix_hits.inc()
        self._prefix_hit_blocks += hit_blocks
        self._m_prefix_hit_blocks.inc(hit_blocks)
        if cow is not None:
            self._prefix_cow_copies += 1
            self._m_prefix_cow_copies.inc()
        saved = hit_blocks * self._block_nbytes
        if self.spec is not None:
            saved += hit_blocks * self._draft_block_nbytes
        self._prefix_bytes_saved += saved
        self._m_prefix_bytes_saved.inc(saved)
        return tok_dev

    def _youngest_active(self) -> int:
        """Eviction victim: the most recently arrived stream."""
        return max(self._table.active, key=lambda t: (t[1].request.arrival_t, t[0]))[0]

    def _evict(self, idx: int) -> None:
        """Recompute preemption: free ``idx``'s blocks and re-enqueue its
        stream (prompt + everything generated) at the head of the line —
        tokens already streamed stand, none drop."""
        req = self._table.release(idx).request
        # settle the hold-time integral before the blocks go back
        self._settle_block_seconds(req, idx)
        self._pool.release(idx)
        req.ids = list(req.ids[: req.handle.prompt_len]) + list(req.handle._all)
        self._rt.event(req.request_id, "preempt", reason="blocks_exhausted", generated=len(req.handle._all))
        self._requeue.appendleft(req)
        self._evictions += 1
        self._m_evictions.inc()

    def _grow_blocks(self, extra_tokens: int = 0) -> None:
        """Before a step: give every lane the blocks its writes need, the
        next position plus ``extra_tokens`` more for a verify window,
        evicting youngest-first when the pool is exhausted (the lane may
        itself be the youngest and preempt itself). Window positions past
        the slot's row are not allocated: they go to the trash columns."""
        bs = self.config.block_size
        bps = self._pool.blocks_per_slot
        for i, _slot in self._table.active:
            while True:
                slot = self._table.slots[i]
                if slot is None:
                    break  # evicted while resolving an earlier lane
                if len(self._pool.owned(i)) >= min(bps, (slot.next_pos + extra_tokens) // bs + 1):
                    break
                try:
                    self._pool.extend(i, 1)
                except P.NoFreeBlocks:
                    victim = self._youngest_active()
                    self._evict(victim)
                    if victim == i:
                        break

    def _slot_arrays(self, active) -> list[torch.Tensor]:
        """The step's per-lane inputs on the device: pending tokens, write
        positions, temperatures, top-p, seeds (free lanes stay zero:
        greedy garbage into the trash block)."""
        s = self.config.num_slots
        tokens = np.zeros((s,), np.int32)
        positions = np.zeros((s,), np.int32)
        temps = np.zeros((s,), np.float32)
        tops = np.ones((s,), np.float32)
        seeds = np.zeros((s,), np.int64)
        for i, slot in active:
            tokens[i] = slot.pending
            positions[i] = slot.next_pos
            temps[i] = slot.request.temperature
            tops[i] = slot.request.top_p
            seeds[i] = slot.request.seed
        return [torch.from_numpy(a).to(self.device) for a in (tokens, positions, temps, tops, seeds)]

    def _record_step(self, dt: float, active) -> None:
        """A step's host statistics, gauges and resident ticks, before its
        tokens are emitted (a stream the step finishes carries the tick).
        The exemplar is the oldest resident stream, the one that has paid
        this step time the longest."""
        self._m_intertoken.observe(
            dt, exemplar=min(active, key=lambda t: t[1].request.arrival_t)[1].request.request_id)
        self._step_times.append(dt)
        self._decode_time_s += dt
        self._decode_steps += 1
        occ = len(active) / self.config.num_slots
        self._occupancy_sum += occ
        self._m_occupancy.set(occ)
        block_occ = self._pool.used_blocks / self._pool.usable_blocks
        self._block_occupancy_sum += block_occ
        self._m_block_occ.set(block_occ)
        self._m_blocks_free.set(self._pool.free_blocks)
        self._m_pool_hbm_free.set(self._pool.free_blocks * self._block_nbytes)
        # one lock round-trip covers every resident slot's tick
        self._rt.decode_ticks([slot.request.request_id for _i, slot in active])
        for _i, slot in active:
            slot.request.decode_ticks += 1  # the wide event's resident ticks

    def _decode_step(self) -> None:
        self._grow_blocks()
        active = self._table.active
        if not active:  # everything preempted
            return
        t0 = time.perf_counter()
        with self._tracer.span("serve.decode_step", active=len(active)):
            next_dev, _logits = self._decode_fn(self._pages, self._pool.device_table(self.device),
                                                *self._slot_arrays(active))
            next_toks = next_dev.cpu().numpy()  # the per-step device fence
        now = time.perf_counter()
        self._record_step(now - t0, active)
        if now > t0:
            self._m_tps.set(len(active) / (now - t0))
        for i, slot in active:
            self._emit_and_advance(i, slot, [int(next_toks[i])], now)

    def _spec_step(self) -> None:
        """One speculative round: the draft proposes ``k`` tokens a lane,
        the target verifies every lane's window in ONE forward, and each
        lane commits its accepted prefix and the replacement or bonus
        token, 1 to ``k + 1`` tokens; one host fence."""
        k = self.spec.k
        self._grow_blocks(extra_tokens=k)
        active = self._table.active
        if not active:  # everything preempted
            return
        tokens, positions, temps, tops, seeds = self._slot_arrays(active)
        table = self._pool.device_table(self.device, self._spec_extra_cols)
        t0 = time.perf_counter()
        with self._tracer.span("serve.spec_step", active=len(active), k=k):
            props, q_sel, q_probs = self._propose_fn(self._draft_pages, table, tokens, positions, temps, tops,
                                                     seeds)
            n_acc, finals, _logits = self._verify_fn(self._pages, table, tokens, props, q_sel, q_probs, positions,
                                                     temps, tops, seeds)
            props, n_acc, finals = (t.cpu().numpy() for t in (props, n_acc, finals))  # the round's fence
        now = time.perf_counter()
        dt = now - t0
        self._record_step(dt, active)
        # per-stream accounting before emission: a stream this round
        # finishes carries its final round on its trace too
        rows, accepted = [], 0
        for i, slot in active:
            n = int(n_acc[i])
            slot.request.spec_proposed += k
            slot.request.spec_accepted += n
            accepted += n
            rows.append((slot.request.request_id, k, n))
        self._rt.spec_ticks(rows)
        emitted = 0
        for i, slot in active:
            n = int(n_acc[i])
            emitted += self._emit_and_advance(i, slot, [int(t) for t in props[i, :n]] + [int(finals[i])], now)
        if dt > 0:
            self._m_tps.set(emitted / dt)
        if self._pool.free_blocks == 0:
            # the rejected window tails' blocks go back only under pool
            # pressure: otherwise the next round would extend the same lanes
            bs = self.config.block_size
            for i, slot in self._table.active:
                self._pool.shrink(i, slot.next_pos // bs + 1)
        self._spec_rounds += 1
        self._spec_proposed += k * len(active)
        self._spec_accepted += accepted
        self._spec_tokens += emitted
        self._m_spec_rounds.inc()
        self._m_spec_proposed.inc(k * len(active))
        self._m_spec_accepted.inc(accepted)
        self._m_spec_rate.set(self._spec_accepted / self._spec_proposed if self._spec_proposed else 0.0)

    def _emit_and_advance(self, i: int, slot: Slot, toks: list[int], now: float) -> int:
        """Emit ``toks`` (a decode token, or a round's accepted prefix and
        final token) on lane ``i`` one at a time, so an eos, token-cap or
        length stop lands at the right token and the rest are dropped.
        Returns the tokens emitted."""
        req = slot.request
        for emitted, tok in enumerate(toks, start=1):
            req.handle._emit(tok)
            self._m_tokens.inc()
            self._tokens_out += 1
            slot.generated += 1
            slot.next_pos += 1
            slot.pending = tok
            slot.last_token_t = now
            reason = None
            if tok == req.eos_id:
                reason = "eos"
            elif slot.generated >= req.max_new_tokens:
                reason = "max_tokens"
            elif slot.next_pos >= self.max_len:
                reason = "length"  # safety net; submit() validation bounds it
            if reason is not None:
                self._table.release(i)
                self._settle_block_seconds(req, i)
                self._pool.release(i)
                self._finish_handle(req, reason, ttft=slot.ttft_s, generation=slot.generation)
                return emitted
        return len(toks)

    def _tenant_metrics(self, tenant: str) -> dict[str, Any]:
        """The ``consensusml_tenant_*`` labeled children of one tenant,
        made on first touch and cached."""
        m = self._tenant_children.get(tenant)
        if m is not None:
            return m
        reg, labels = self._registry, {"tenant": tenant}
        m = self._tenant_children[tenant] = {
            "requests": reg.counter("consensusml_tenant_requests_total",
                                    "terminal requests per tenant (any finish reason)", labels=labels),
            "tokens": reg.counter("consensusml_tenant_tokens_total", "generated tokens per tenant", labels=labels),
            "tflops": reg.counter("consensusml_tenant_tflops_total", "ledger-joined TFLOPs consumed per tenant",
                                  labels=labels),
            "block_seconds": reg.counter("consensusml_tenant_block_seconds_total",
                                         "KV block-seconds held per tenant (pool hold-time integral)",
                                         labels=labels),
            "ttft": reg.histogram("consensusml_tenant_ttft_seconds",
                                  "time to first token per tenant (the per-tenant SLO series)",
                                  buckets=DEFAULT_SLO_BUCKETS, labels=labels),
        }
        return m

    def _request_cost(self, req: Request) -> dict[str, Any]:
        """Ledger-join one request's device cost (the reference's
        ``_request_cost``): each admission's prefill-bucket row (the
        suffix bucket's prefix-prefill row on a prefix hit; plus the
        draft's on a speculative engine), plus ``decode_ticks`` x the step
        row — ``serve.decode``, or ``serve.spec.propose + serve.spec.verify``
        a round on the speculative path. Rows are counted from the
        engine's own stages (:meth:`register_costs`), never guessed; with
        no ledger registered the event still emits, zeros and
        ``cost_joined: False``."""
        ledger = self._cost_ledger
        flops = bytes_ = 0.0
        joined = ledger is not None
        if ledger is not None:
            rows = []
            kinds = req.prefill_kinds or ["full"] * len(req.prefill_buckets)
            for b, kind in zip(req.prefill_buckets, kinds):
                rows.append(ledger.row(f"{'serve.prefix_prefill' if kind == 'prefix' else 'serve.prefill'}.b{b}"))
                if self.spec is not None:
                    stem = "serve.draft_prefix_prefill" if kind == "prefix" else "serve.draft_prefill"
                    rows.append(ledger.row(f"{stem}.b{b}"))
            if self.spec is not None:
                step_rows = [ledger.row("serve.spec.propose"), ledger.row("serve.spec.verify")]
            else:
                step_rows = [ledger.row("serve.decode")]
            for row in rows:
                if row is None:
                    joined = False
                    continue
                flops += row.flops
                bytes_ += row.bytes_accessed
            for row in step_rows:
                if row is None:
                    joined = False
                    continue
                flops += req.decode_ticks * row.flops
                bytes_ += req.decode_ticks * row.bytes_accessed
        return {"flops": flops, "hbm_bytes": bytes_, "tflops": flops / 1e12, "cost_joined": joined}

    _STAGES = ("submit", "admission", "prefill", "decode", "complete")

    def _emit_wide_event(self, req: Request, tokens: list, reason: str, ttft: float, latency: float,
                         generation: int) -> None:
        """The terminal wide event, the reference's keys: one record
        joining the request's trace timings, token counts, block-seconds
        and attention tier; then its tenant's children."""
        rid = req.request_id
        tr = self._rt.get(rid) if rid else None
        stages_us: dict[str, float] = {}
        defer_ticks = preemptions = 0
        if tr is not None:
            for ev in tr.events:
                name = ev.get("name")
                if name in self._STAGES and name not in stages_us:
                    stages_us[name] = round(ev["ts_us"] - tr.t_start_us, 3)
            defer_ticks = tr.defer_ticks
            preemptions = tr.preemptions
        ev = {
            "trace_id": getattr(req.ctx, "trace_id", ""),
            "request_id": rid,
            "tenant": req.tenant,
            "finish_reason": reason,
            "prompt_len": req.handle.prompt_len,
            "tokens_out": len(tokens),
            "ttft_s": round(ttft, 6) if tokens else None,
            "latency_s": round(latency, 6),
            "decode_ticks": req.decode_ticks,
            "defer_ticks": defer_ticks,
            "preemptions": preemptions,
            "generation": generation,
            "spec_proposed": req.spec_proposed,
            "spec_accepted": req.spec_accepted,
            "block_seconds": round(req.block_seconds, 6),
            "shared_block_seconds": round(req.shared_block_seconds, 6),
            "prefix_hit_blocks": req.prefix_hit_blocks,
            "attn_impl": self.attn_impl,
            "kv_impl": "paged",
            "prefill_buckets": list(req.prefill_buckets),
            "stages_us": stages_us,
        }
        ev.update(self._request_cost(req))
        self._events.emit(ev)
        tm = self._tenant_metrics(req.tenant)
        tm["requests"].inc()
        if tokens:
            tm["tokens"].inc(len(tokens))
        if ev["tflops"] > 0:
            tm["tflops"].inc(ev["tflops"])
        if req.block_seconds > 0:
            tm["block_seconds"].inc(req.block_seconds)

    def _finish_handle(self, req: Request, reason: str, ttft: float = 0.0, generation: int | None = None) -> None:
        now = time.perf_counter()
        latency = now - req.arrival_t
        tokens = list(req.handle._all)
        gen = self._generation if generation is None else generation
        req.handle._finish(
            GenResult(
                tokens=tokens,
                finish_reason=reason,
                ttft_s=ttft,
                latency_s=latency,
                prompt_len=req.handle.prompt_len,
                generation=gen,
                trace_id=getattr(req.ctx, "trace_id", ""),
                request_id=req.request_id,
                temperature=req.temperature,
                top_p=req.top_p,
                seed=req.seed,
                spec_proposed=req.spec_proposed,
                spec_accepted=req.spec_accepted,
                tenant=req.tenant,
                block_seconds=req.block_seconds,
                shared_block_seconds=req.shared_block_seconds,
                prefix_hit_blocks=req.prefix_hit_blocks,
            )
        )
        self._rt.finish(req.request_id, reason, tokens=len(tokens), ttft_s=round(ttft, 6),
                        latency_s=round(latency, 6))
        # the wide event reads the completed trace, so it goes after
        self._emit_wide_event(req, tokens, reason, ttft, latency, gen)
        if reason != "cancelled":
            self._m_completed.inc()


def _nbytes(tensors) -> int:
    """Bytes of some tensors (shapes only, no device read)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def load_engine(path: str, config: ServeConfig | None = None, *, spec_k: int = 0, device=None) -> Engine:
    """An :class:`Engine` over a serving artifact (:mod:`.export`): the
    meta's config rebuilds the architecture, the consensus mean loads in,
    and the engine's ``generation`` starts at the artifact's (a watcher
    then takes only newer ones). ``spec_k > 0`` also loads the draft in
    ``path/draft/`` and serves speculatively with ``k = spec_k`` (raises
    where there is none). ``device``: ``None`` = CUDA (raises without a
    GPU); the CPU only when asked."""
    from consensusml_tpu_torch.serve.export import DRAFT_SUBDIR, build_serving_model, load_serving

    meta, params, _model_state = load_serving(path)
    model = build_serving_model(meta, params, device)
    spec, draft_params = None, None
    if spec_k:
        dmeta, draft_params, _dms = load_serving(os.path.join(path, DRAFT_SUBDIR))  # raises with context
        spec = P.SpecConfig(model=build_serving_model(dmeta, draft_params, device), k=spec_k)
    engine = Engine(model, config, device=device, spec_decode=spec)
    # what a swap must match: the artifact's own leaves (a LoRA base is
    # stored in the compute dtype)
    engine._artifact_spec = tree_spec(params)
    if draft_params is not None:
        engine._draft_artifact_spec = tree_spec(draft_params)
    engine._generation = int(meta.get("generation", 0))
    engine._m_generation.set(engine._generation)
    return engine
