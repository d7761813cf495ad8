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

Deferred to later slices: speculative decode, hot swap, the prefix
cache, the observability registry and wide events, and the reference's
per-slot (``kv_impl="slot"``) path.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
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
from consensusml_tpu_torch.serve import pool as P
from consensusml_tpu_torch.serve.batcher import (
    GenResult,
    Request,
    RequestHandle,
    Slot,
    SlotTable,
)
from consensusml_tpu_torch.serve.decode import DecodeModel, prefill_buckets

__all__ = ["ServeConfig", "Engine"]


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
    # paged-attention tier: "auto" = the CUDA kernel on the card, its
    # plain version on the CPU; "torch" / "cuda" by name
    attn_impl: str = "auto"


class Engine:
    """In-process serving engine. ``Engine(model, config, device=...)``
    takes a ``GPT2LM`` or a ``LlamaLM``, moves it to ``device`` (``None``
    = CUDA; raises without a GPU) and casts its Dense, adapter and
    embedding parameters to the compute dtype in place
    (:meth:`GPT2LM.to_compute_dtype`, :meth:`LlamaLM.to_compute_dtype`),
    then :meth:`submit` from any thread. Use as a context manager or call
    :meth:`shutdown`, which drains in-flight work by default."""

    def __init__(self, model: Any, config: ServeConfig | None = None, *, device=None):
        self.config = cfg = config or ServeConfig()
        self.device = resolve_device(device)
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

        self._queue: "queue.Queue[Request]" = queue.Queue(cfg.queue_depth)
        # evicted continuations and deferred admissions, ahead of arrivals
        self._requeue: "collections.deque[Request]" = collections.deque()
        self._table = SlotTable(cfg.num_slots)
        self._ids = itertools.count()
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

        self._thread = threading.Thread(target=self._loop, name="serve-engine", daemon=True)
        self._thread.start()

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
        request_id: str | None = None,
    ) -> RequestHandle:
        """Enqueue one request; returns its :class:`RequestHandle`.

        ``temperature``/``top_p``/``seed`` sample this request (defaults:
        the config's, and a fresh seed for sampled requests); the resolved
        triple is echoed on the result so the stream replays. Raises
        ``queue.Full`` when the bounded queue is full, ``RuntimeError``
        once the engine is draining, ``ValueError`` on a bad request
        (token ids must lie in ``[0, vocab_size)``: PyTorch raises or
        device-asserts on an out-of-range lookup).
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
        handle = RequestHandle(len(ids))
        req = Request(
            ids, max_new, handle,
            request_id=request_id or f"srv-{next(self._ids)}",
            temperature=temp, top_p=tp, seed=seed, eos_id=eos,
        )
        self._queue.put(req, block=block, timeout=timeout)
        if self._drained.is_set():
            # lost the race against loop exit: nothing will service it
            self._cancel_queued()
            raise RuntimeError("engine is draining/closed; not accepting requests")
        return handle

    def warmup(self) -> dict[str, int]:
        """Build the CUDA kernels (on the card) and run one prefill per
        prompt bucket and one decode step, on the caller's thread against
        a throwaway one-block pool (all-zero block rows route every write
        to its block 0), so first-request latency pays no kernel build
        and no library initialisation. Returns the counts of warmed
        stages."""
        dm, s, bs = self._dm, self.config.num_slots, self.config.block_size
        bks = self.buckets
        if self.attn_impl == "cuda":
            kernels.build()
        dev = self.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            pages = P.init_pages(dm, 1, bs)
            for b in bks:
                ids = torch.zeros((1, b), dtype=torch.int64, device=dev)
                row = torch.zeros((b // bs,), dtype=torch.int64, device=dev)
                self._prefill_fn(pages, ids, 1, row, 0.0, 1.0, 0)
            zeros = torch.zeros((s,), dtype=torch.int32, device=dev)
            self._decode_fn(
                pages,
                torch.zeros((s, self._pool.blocks_per_slot), dtype=torch.int32, device=dev),
                zeros, zeros, zeros.float(), torch.ones((s,), device=dev), zeros.long(),
            )
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._warmed.set()
        return {"prefill": len(bks), "decode": 1}

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
        totals lifetime."""

        def pct(xs, q):
            return float(np.percentile(list(xs), q)) if xs else float("nan")

        steps = self._decode_steps
        return {
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

    # -- engine thread ------------------------------------------------------

    def _loop(self) -> None:
        q = self._queue
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                self._sched.start_tick()
                self._admit_waiting()
                if self._table.num_active:
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
            for i, slot in self._table.active:
                self._table.release(i)
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
        return self._queue.get_nowait()

    def _admit_waiting(self) -> None:
        while self._table.free_slot() is not None:
            try:
                req = self._pop_waiting()
            except queue.Empty:
                return
            bucket = self._bucket(len(req.ids))
            need = P.blocks_for_tokens(len(req.ids) + 1, self.config.block_size)
            # defer (don't drop) when the pool can't hold the prompt yet or
            # this tick's prefill budget is spent; the request keeps its
            # place at the head of the line
            if not self._pool.can_admit(need) or not self._sched.try_admit(bucket):
                self._requeue.appendleft(req)
                return
            self._admit(req)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.buckets[-1]}")

    def _admit(self, req: Request) -> None:
        """Prefill ``req`` into a free slot. A raise mid-admission cancels
        this request's handle before propagating (it is out of the queue
        but not yet in the slot table, so no exit sweep would reach it)."""
        try:
            self._admit_inner(req)
        except BaseException:
            self._finish_handle(req, "cancelled")
            raise

    def _admit_inner(self, req: Request) -> None:
        idx = self._table.free_slot()
        n = len(req.ids)
        bucket = self._bucket(n)
        bs = self.config.block_size
        # an evicted continuation re-prefills prompt + generated-so-far;
        # its TTFT already happened and its token count keeps running
        already = len(req.handle._all)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = req.ids
        # cover the prompt AND the first decode write (position n)
        self._pool.alloc(idx, P.blocks_for_tokens(n + 1, bs))
        try:
            row = torch.from_numpy(self._pool.block_row(idx, bucket // bs))
            tok_dev, _logits = self._prefill_fn(
                self._pages, torch.from_numpy(ids).to(self.device), n,
                row.to(self.device), req.temperature, req.top_p, req.seed,
            )
            tok = int(tok_dev)  # device fence: the first token is real now
        except BaseException:
            self._pool.release(idx)  # no leaked blocks on a raise
            raise
        self._prefill_tokens_computed += bucket
        now = time.perf_counter()
        if already == 0:
            ttft = now - req.arrival_t
            self._ttfts.append(ttft)
            req.handle._ttft_s = ttft
            self._tokens_in += n
        else:
            ttft = req.handle._ttft_s
        req.handle._emit(tok)
        self._tokens_out += 1
        if already + 1 >= req.max_new_tokens or tok == req.eos_id:
            self._pool.release(idx)
            self._finish_handle(req, "eos" if tok == req.eos_id else "max_tokens", ttft=ttft)
            return
        self._table.occupy(
            idx, Slot(request=req, next_pos=n, pending=tok, generated=already + 1, ttft_s=ttft)
        )

    def _youngest_active(self) -> int:
        """Eviction victim: the most recently arrived stream."""
        return max(self._table.active, key=lambda t: (t[1].request.arrival_t, t[0]))[0]

    def _evict(self, idx: int) -> None:
        """Recompute preemption: free ``idx``'s blocks and re-enqueue its
        stream (prompt + everything generated) at the head of the line —
        tokens already streamed stand, none drop."""
        req = self._table.release(idx).request
        self._pool.release(idx)
        req.ids = list(req.ids[: req.handle.prompt_len]) + list(req.handle._all)
        self._requeue.appendleft(req)
        self._evictions += 1

    def _grow_blocks(self) -> None:
        """Before a decode step: give every lane the block its next write
        needs, evicting youngest-first when the pool is exhausted (the
        lane may itself be the youngest and preempt itself)."""
        bs = self.config.block_size
        for i, _slot in self._table.active:
            while True:
                slot = self._table.slots[i]
                if slot is None:
                    break  # evicted while resolving an earlier lane
                if len(self._pool.owned(i)) >= slot.next_pos // bs + 1:
                    break
                try:
                    self._pool.extend(i, 1)
                except P.NoFreeBlocks:
                    victim = self._youngest_active()
                    self._evict(victim)
                    if victim == i:
                        break

    def _decode_step(self) -> None:
        self._grow_blocks()
        active = self._table.active
        if not active:  # everything preempted
            return
        s = self.config.num_slots
        tokens = np.zeros((s,), np.int32)
        positions = np.zeros((s,), np.int32)
        temps = np.zeros((s,), np.float32)
        tops = np.ones((s,), np.float32)
        seeds = np.zeros((s,), np.int64)
        for i, slot in active:  # free lanes stay zero: greedy garbage into trash
            tokens[i] = slot.pending
            positions[i] = slot.next_pos
            temps[i] = slot.request.temperature
            tops[i] = slot.request.top_p
            seeds[i] = slot.request.seed
        dev = self.device
        t0 = time.perf_counter()
        next_dev, _logits = self._decode_fn(
            self._pages,
            self._pool.device_table(dev),
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(temps).to(dev),
            torch.from_numpy(tops).to(dev),
            torch.from_numpy(seeds).to(dev),
        )
        next_toks = next_dev.cpu().numpy()  # the per-step device fence
        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        self._decode_time_s += dt
        self._decode_steps += 1
        self._occupancy_sum += len(active) / s
        self._block_occupancy_sum += self._pool.used_blocks / self._pool.usable_blocks
        for i, slot in active:
            self._emit_and_advance(i, slot, int(next_toks[i]))

    def _emit_and_advance(self, i: int, slot: Slot, tok: int) -> None:
        req = slot.request
        req.handle._emit(tok)
        self._tokens_out += 1
        slot.generated += 1
        slot.next_pos += 1
        slot.pending = tok
        reason = None
        if tok == req.eos_id:
            reason = "eos"
        elif slot.generated >= req.max_new_tokens:
            reason = "max_tokens"
        elif slot.next_pos >= self.max_len:
            reason = "length"  # safety net; submit() validation bounds it
        if reason is not None:
            self._table.release(i)
            self._pool.release(i)
            self._finish_handle(req, reason, ttft=slot.ttft_s)

    def _finish_handle(self, req: Request, reason: str, ttft: float = 0.0) -> None:
        req.handle._finish(
            GenResult(
                tokens=list(req.handle._all),
                finish_reason=reason,
                ttft_s=ttft,
                latency_s=time.perf_counter() - req.arrival_t,
                prompt_len=req.handle.prompt_len,
                request_id=req.request_id,
                temperature=req.temperature,
                top_p=req.top_p,
                seed=req.seed,
            )
        )
