"""Open-loop Poisson load generator for the serving engine (port of
``tools/loadgen.py``).

Drives an exported consensus artifact (in-process engine, the port's
:func:`~consensusml_tpu_torch.serve.engine.load_engine` on the card, or on
the CPU with ``--device cpu``) or a running
:class:`consensusml_tpu_torch.serve.server.ServeServer` (socket mode) with
open-loop traffic: arrivals follow a Poisson process at ``--rate`` req/s
REGARDLESS of completions — the honest way to measure serving SLOs
(closed-loop generators self-throttle and hide queueing collapse).
Prompt lengths draw from ``--prompt-len LO:HI`` — uniformly by default
(every prefill bucket gets hit) or with ``--len-dist zipf`` as the
heavy-tail production mix the paged KV pool is sized for. With
``--swap-every N`` every N-th arrival first bumps the artifact's
generation so the engine's hot-swap watcher reloads MID-TRAFFIC (tail
latency under drain-free rollout). Reports client-observed TTFT /
end-to-end latency percentiles, goodput, and (in-process mode) the
engine's own SLO stats, as one ``LOADGEN`` JSON line.

The same ``--seed`` gives the reference's arrival times, prompt lengths,
token ids, tenants, trace ids and sampling seeds bit for bit.
``--obs-snapshot DIR`` additionally writes the client-observed SLOs as
``obs-loadgen-<seed>.json`` in the cluster plane's snapshot format
(:class:`~consensusml_tpu_torch.obs.cluster.ClusterWriter`, role
``loadgen``), the client's history rings sampled during the run with it:
point it at the serving or training side's ``--obs-cluster-dir`` and
``python -m consensusml_tpu_torch.tools.obs_report`` shows the client
SLOs beside the ranks.

    # in-process: load the artifact and serve it right here
    python -m consensusml_tpu_torch.tools.loadgen --artifact /tmp/art --rate 50 --requests 200

    # against a socket server (one connection per request, as an
    # L4-balanced fleet would)
    python -m consensusml_tpu_torch.tools.loadgen --connect 127.0.0.1:9000 --rate 50 --requests 200
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import threading
import time

import numpy as np


def parse_tenant_weights(spec: str | None) -> list[tuple[str, float]] | None:
    """``"a=3,b=1"`` -> ``[("a", 3.0), ("b", 1.0)]`` — the weighted
    tenant mix ``--tenants`` drives (bare names weight 1). Labels are
    sanitized with the same boundary rule the server applies, so the
    client's per-tenant twins and the server's ``consensusml_tenant_*``
    children land on identical label values."""
    from consensusml_tpu_torch.obs import sanitize_tenant

    if not spec:
        return None
    out: list[tuple[str, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition("=")
        weight = float(w) if w else 1.0
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0: {part!r}")
        out.append((sanitize_tenant(name), weight))
    if not out:
        raise ValueError(f"no tenants in {spec!r}")
    return out


def sample_prompt_len(rng, lo: int, hi: int, dist: str = "uniform") -> int:
    """One prompt length in ``[lo, hi]``.

    ``uniform`` exercises every prefill bucket evenly; ``zipf`` is the
    heavy-tail production mix (most prompts short, a fat tail of long
    ones — Zipf(a=1.5) offsets clipped into the range), the distribution
    under which per-slot max-length caches waste the most HBM and the
    paged pool's occupancy advantage shows (bench serving section)."""
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    if dist == "zipf":
        return min(lo + int(rng.zipf(1.5)) - 1, hi)
    raise ValueError(f"unknown length distribution {dist!r}")


def run_loadgen(
    submit,
    *,
    n_requests: int,
    rate_rps: float,
    prompt_lens: tuple[int, int],
    vocab: int,
    max_new_tokens: int,
    seed: int = 0,
    len_dist: str = "uniform",
    swap_every: int = 0,
    swap_fn=None,
    temperature: float = 0.0,
    top_p: float = 1.0,
    tenants: list[tuple[str, float]] | None = None,
    shared_prefix: tuple[int, float] | None = None,
    history=None,
    history_tick_s: float = 0.25,
) -> dict:
    """Open-loop driver over any ``submit(ids, max_new, ctx, sampling)
    -> result_dict`` callable (``result_dict``: ``ttft_s``,
    ``latency_s``, ``tokens``; ``ctx`` is the minted
    :class:`~consensusml_tpu_torch.obs.TraceContext` the submitter should
    propagate so the server's trace joins the client's observation;
    ``sampling`` is the per-request ``temperature``/``top_p``/``seed``
    dict the submitter forwards on the wire). Each arrival runs on its
    own thread so a slow request never delays the next arrival (that is
    what makes the loop open). With ``swap_every`` + ``swap_fn``, every
    ``swap_every``-th arrival first triggers ``swap_fn()`` (the hot-swap
    poke: bump the artifact's generation mid-traffic) — tail latency
    under live reload is part of the SLO story, not a separate
    benchmark.

    Per-request seeds derive deterministically from ``(seed, arrival
    index)`` — like the trace ids — so a fixture replays to the SAME
    sampled token streams end to end (the engine's ``(seed, position)``
    fold keys make the stream a pure function of the request).

    ``shared_prefix`` (``(len, frac)``, from ``--shared-prefix
    LEN:FRAC``) models the system-prompt workload the serving prefix
    cache (docs/serving.md "Prefix sharing") exists for: ONE fixed
    ``len``-token prefix is drawn from the fixture rng up front, and
    each arrival prepends it with probability ``frac`` (the remaining
    arrivals stay fully random, so the run exercises hits and misses in
    one mix). The draw is deterministic per seed — a replay offers the
    identical hit pattern — and the sampled per-arrival length from
    ``--prompt-len`` becomes the UNSHARED suffix length, which is what
    the engine actually prefills on a hit.

    ``tenants`` (``[(name, weight), ...]``, from ``--tenants
    "a=3,b=1"``) assigns each arrival a tenant label by weighted draw
    from the fixture rng — deterministic per seed, so a replay issues
    the identical (tenant, arrival) schedule, and each request's
    sampling seed additionally folds the tenant in (crc32), so two
    tenants' streams stay distinct under the same arrival index. The
    label rides the wire / ``submit(tenant=)``, the terminal record
    echoes the SERVER-resolved label, and the client records per-tenant
    labeled SLO twins of its TTFT/latency families — the client half of
    the per-tenant accounting join (docs/observability.md "Wide events
    & tenant accounting").

    With ``history`` (a :class:`~consensusml_tpu_torch.obs.MetricsHistory`
    over this process's registry), the ``loadgen-history`` sampler
    thread (docs/threads.md) records the client-side rings every
    ``history_tick_s`` during the run — client SLO observations stream
    per COMPLETION into the registry (not post-hoc), so the rings carry
    the client-observed TTFT trend on the same wall-clock windows the
    server side records, and ``tools/obs_report.py`` can render
    client-vs-server sparklines joined in time."""
    from consensusml_tpu_torch.obs import TraceContext

    rng = np.random.default_rng(seed)
    lo, hi = prompt_lens
    prefix_ids: list[int] = []
    prefix_frac = 0.0
    if shared_prefix is not None:
        plen, prefix_frac = shared_prefix
        if plen < 1 or not (0.0 < prefix_frac <= 1.0):
            raise ValueError(
                f"shared_prefix needs len >= 1 and 0 < frac <= 1, "
                f"got {shared_prefix}"
            )
        # ONE fixed prefix per fixture seed: every sharing arrival
        # offers the identical block-aligned chunks to the server's
        # prefix index
        prefix_ids = [int(t) for t in rng.integers(0, vocab - 1, size=plen)]
    metrics = _LoadgenMetrics(rate_rps, tenant_mode=bool(tenants))
    results: list[dict] = []
    errors: list[str] = []
    lock = threading.Lock()
    threads = []
    swaps = 0

    def one(ids, ctx, sampling, tenant):
        try:
            r = submit(ids, max_new_tokens, ctx, sampling)
            r.setdefault("trace_id", ctx.trace_id)
            r.setdefault("request_id", ctx.request_id)
            # the SERVER-resolved label wins (it sanitized at its
            # boundary); the issued label is the fallback for plain
            # result dicts from tenant-unaware submitters
            r.setdefault("tenant", tenant)
            metrics.observe_result(r)
            with lock:
                results.append(r)
        except Exception as e:
            metrics.observe_error()
            with lock:
                errors.append(f"{type(e).__name__}: {e}")

    sampler = None
    sampler_stop = threading.Event()
    if history is not None:

        def sample_loop():
            while not sampler_stop.wait(history_tick_s):
                history.record()

        sampler = threading.Thread(
            target=sample_loop, name="loadgen-history", daemon=True
        )
        sampler.start()

    tenant_names: list[str] = []
    tenant_p = None
    if tenants:
        import zlib

        tenant_names = [t for t, _w in tenants]
        total_w = sum(w for _t, w in tenants)
        tenant_p = [w / total_w for _t, w in tenants]
        tenant_crc = {
            t: zlib.crc32(t.encode()) & 0xFFFFFFFF for t in tenant_names
        }

    t_start = time.perf_counter()
    for i in range(n_requests):
        if swap_fn is not None and swap_every and i and i % swap_every == 0:
            swap_fn()
            swaps += 1
        n = sample_prompt_len(rng, lo, hi, len_dist)
        ids = [int(t) for t in rng.integers(0, vocab - 1, size=n)]
        shared_arrival = bool(prefix_ids) and float(rng.random()) < prefix_frac
        if shared_arrival:  # sampled length = the UNSHARED suffix
            ids = prefix_ids + ids
        # deterministic trace identity (seed + arrival index): the same
        # fixture replays to the same ids, and client + server sides of
        # one request join on trace_id (docs/observability.md)
        ctx = TraceContext(f"lg{seed:x}-{i:05d}")
        req_seed = ((seed << 20) ^ i) & 0xFFFFFFFF
        tenant = "default"
        if tenant_names:
            # weighted draw from the fixture rng (deterministic per
            # seed); crc32 folds the tenant into the request seed so
            # tenants draw distinct streams at the same arrival index
            tenant = tenant_names[int(rng.choice(len(tenant_names), p=tenant_p))]
            req_seed ^= tenant_crc[tenant]
        sampling = {
            "temperature": temperature,
            "top_p": top_p,
            # 32-bit per-request seed, disjoint across fixture seeds
            "seed": req_seed,
        }
        if tenant_names:
            sampling["tenant"] = tenant
        t = threading.Thread(
            target=one, args=(ids, ctx, sampling, tenant)
        )
        threads.append(t)
        metrics.observe_issued()
        t.start()
        # exponential inter-arrival gap == Poisson arrivals
        time.sleep(float(rng.exponential(1.0 / rate_rps)))
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    if sampler is not None:
        sampler_stop.set()
        sampler.join(timeout=max(2.0, 4 * history_tick_s))

    pct = lambda key, q: (
        float(np.percentile([r[key] for r in results], q)) if results else float("nan")
    )
    tokens_out = int(sum(len(r["tokens"]) for r in results))
    metrics.finalize(len(results), tokens_out, wall)
    if history is not None:
        history.record()  # final point carries the end-of-run gauges
    # the client-observed worst tail, with identity: each row's
    # trace_id/request_id resolves to a server-side RequestTrace
    slowest = sorted(results, key=lambda r: -r["latency_s"])[:8]
    # per-target client SLOs: populated when the submitter tags results
    # with "target" (multi-target / fleet mode); None single-target
    target_report = None
    if any("target" in r for r in results):
        target_report = {}
        for tgt in sorted({r.get("target", "?") for r in results}):
            rs = [r for r in results if r.get("target", "?") == tgt]
            gpct = lambda key, q: (
                float(np.percentile([r[key] for r in rs], q))
                if rs
                else float("nan")
            )
            target_report[tgt] = {
                "completed": len(rs),
                "tokens_out": int(sum(len(r["tokens"]) for r in rs)),
                "ttft_p50_ms": 1e3 * gpct("ttft_s", 50),
                "ttft_p99_ms": 1e3 * gpct("ttft_s", 99),
                "latency_p50_ms": 1e3 * gpct("latency_s", 50),
                "latency_p99_ms": 1e3 * gpct("latency_s", 99),
            }
    tenant_report = None
    if tenants:
        tenant_report = {}
        for t, _w in tenants:
            rs = [r for r in results if r.get("tenant") == t]
            tpct = lambda key, q: (
                float(np.percentile([r[key] for r in rs], q))
                if rs
                else float("nan")
            )
            tenant_report[t] = {
                "completed": len(rs),
                "tokens_out": int(sum(len(r["tokens"]) for r in rs)),
                "ttft_p50_ms": 1e3 * tpct("ttft_s", 50),
                "ttft_p99_ms": 1e3 * tpct("ttft_s", 99),
                "latency_p50_ms": 1e3 * tpct("latency_s", 50),
                "latency_p99_ms": 1e3 * tpct("latency_s", 99),
            }
    return {
        "slowest": [
            {
                "trace_id": r.get("trace_id", ""),
                "request_id": r.get("request_id", ""),
                "tenant": r.get("tenant", "default"),
                "ttft_ms": round(1e3 * r["ttft_s"], 3),
                "latency_ms": round(1e3 * r["latency_s"], 3),
                "tokens": len(r["tokens"]),
            }
            for r in slowest
        ],
        # per-tenant client-observed SLOs (None without --tenants); the
        # server-side rollup twin is WideEventLog.rollup()
        "tenants": tenant_report,
        # per-target client-observed SLOs (None unless the submitter
        # tags results with "target", i.e. --targets multi-target mode)
        "targets": target_report,
        "requests": n_requests,
        "completed": len(results),
        "errors": len(errors),
        "error_sample": errors[:3],
        "len_dist": len_dist,
        # the offered sharing mix (None without --shared-prefix); the
        # server-side hit accounting is engine.stats()["prefix_cache"]
        "shared_prefix": (
            {"len": len(prefix_ids), "frac": prefix_frac}
            if prefix_ids
            else None
        ),
        "temperature": temperature,
        "top_p": top_p,
        # speculative-decode roll-up (0/0 against a non-spec engine)
        "spec_proposed": int(sum(r.get("spec_proposed", 0) for r in results)),
        "spec_accepted": int(sum(r.get("spec_accepted", 0) for r in results)),
        "swaps_triggered": swaps,
        "offered_rate_rps": rate_rps,
        "achieved_rps": len(results) / wall if wall > 0 else 0.0,
        "tokens_out": tokens_out,
        "tokens_per_sec": tokens_out / wall if wall > 0 else 0.0,
        "ttft_p50_ms": 1e3 * pct("ttft_s", 50),
        "ttft_p99_ms": 1e3 * pct("ttft_s", 99),
        "latency_p50_ms": 1e3 * pct("latency_s", 50),
        "latency_p99_ms": 1e3 * pct("latency_s", 99),
        "wall_s": wall,
    }


class _LoadgenMetrics:
    """The ``consensusml_loadgen_*`` families — the client-observed half
    of the serving SLO story, in the same registry/snapshot format the
    server side exports (docs/observability.md). Observations STREAM in
    per completion (from the per-arrival threads; every metric carries
    its own lock) so the history sampler sees the TTFT/latency
    distributions move during the run, not one post-hoc dump."""

    def __init__(self, rate_rps: float, tenant_mode: bool = False):
        from consensusml_tpu_torch.obs import get_registry
        from consensusml_tpu_torch.obs.metrics import DEFAULT_SLO_BUCKETS

        reg = get_registry()
        self._reg = reg
        self._slo_buckets = DEFAULT_SLO_BUCKETS
        # per-tenant CLIENT twins of the SLO families (labeled children,
        # created lazily per observed tenant under --tenants): the
        # client-observed half of the per-tenant accounting story, in
        # the same tenant= label space as the server's
        # consensusml_tenant_* families
        self.tenant_mode = tenant_mode
        self._twins: dict[str, dict] = {}
        self.ttft = reg.histogram(
            "consensusml_loadgen_ttft_seconds",
            "client-observed time to first token",
            buckets=DEFAULT_SLO_BUCKETS,
        )
        self.lat = reg.histogram(
            "consensusml_loadgen_latency_seconds",
            "client-observed end-to-end request latency",
            buckets=DEFAULT_SLO_BUCKETS,
        )
        self.requests = reg.counter(
            "consensusml_loadgen_requests_total", "requests issued"
        )
        self.completed = reg.counter(
            "consensusml_loadgen_completed_total", "requests completed"
        )
        self.errors = reg.counter(
            "consensusml_loadgen_errors_total", "requests that errored"
        )
        self.tokens = reg.counter(
            "consensusml_loadgen_tokens_total", "tokens received"
        )
        reg.gauge(
            "consensusml_loadgen_offered_rate_rps", "Poisson arrival rate"
        ).set(rate_rps)
        self.achieved = reg.gauge(
            "consensusml_loadgen_achieved_rps", "completions per wall second"
        )
        self.goodput = reg.gauge(
            "consensusml_loadgen_tokens_per_sec", "token goodput"
        )

    def observe_issued(self) -> None:
        # at ARRIVAL, not completion: the live requests-vs-completed gap
        # is the queue-buildup signal the history rings exist to show
        self.requests.inc()

    def _tenant_twins(self, tenant: str) -> dict:
        tw = self._twins.get(tenant)
        if tw is None:
            labels = {"tenant": tenant}
            tw = self._twins[tenant] = {
                "ttft": self._reg.histogram(
                    "consensusml_loadgen_tenant_ttft_seconds",
                    "client-observed time to first token per tenant",
                    buckets=self._slo_buckets,
                    labels=labels,
                ),
                "lat": self._reg.histogram(
                    "consensusml_loadgen_tenant_latency_seconds",
                    "client-observed end-to-end latency per tenant",
                    buckets=self._slo_buckets,
                    labels=labels,
                ),
            }
        return tw

    def observe_result(self, r: dict) -> None:
        # exemplar-bearing: the worst buckets remember WHICH request
        rid = r.get("request_id") or None
        self.ttft.observe(r["ttft_s"], exemplar=rid)
        self.lat.observe(r["latency_s"], exemplar=rid)
        if self.tenant_mode:
            tw = self._tenant_twins(r.get("tenant") or "default")
            tw["ttft"].observe(r["ttft_s"], exemplar=rid)
            tw["lat"].observe(r["latency_s"], exemplar=rid)
        self.completed.inc()
        self.tokens.inc(len(r["tokens"]))

    def observe_error(self) -> None:
        self.errors.inc()

    def finalize(self, completed: int, tokens_out: int, wall: float) -> None:
        self.achieved.set(completed / wall if wall > 0 else 0.0)
        self.goodput.set(tokens_out / wall if wall > 0 else 0.0)


def _engine_submit(engine):
    def submit(ids, max_new, ctx=None, sampling=None):
        s = sampling or {}
        h = engine.submit(
            ids, max_new, trace=ctx,
            temperature=s.get("temperature"), top_p=s.get("top_p"),
            seed=s.get("seed"), tenant=s.get("tenant"),
        )
        r = h.result(timeout=300)
        return {
            "ttft_s": r.ttft_s, "latency_s": r.latency_s, "tokens": r.tokens,
            "trace_id": r.trace_id, "request_id": r.request_id,
            "temperature": r.temperature, "top_p": r.top_p, "seed": r.seed,
            "spec_proposed": r.spec_proposed,
            "spec_accepted": r.spec_accepted,
            "tenant": r.tenant,
        }

    return submit


def _socket_submit(host: str, port: int):
    def submit(ids, max_new, ctx=None, sampling=None):
        t0 = time.perf_counter()
        req = {"ids": ids, "max_new_tokens": max_new}
        if sampling:
            req.update(sampling)
        if ctx is not None:
            req["trace_id"] = ctx.trace_id
            req["request_id"] = ctx.request_id
        with socket.create_connection((host, port), timeout=300) as conn:
            f = conn.makefile("rwb")
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            ttft = None
            tokens = []
            for line in f:
                msg = json.loads(line)
                if "error" in msg:
                    raise RuntimeError(msg["error"])
                if msg.get("done"):
                    return {
                        "ttft_s": ttft if ttft is not None else 0.0,
                        "latency_s": time.perf_counter() - t0,
                        "tokens": msg["tokens"],
                        # server-echoed identity (joins on trace_id even
                        # if the server minted its own request_id) and
                        # resolved sampling triple (replay contract)
                        "trace_id": msg.get("trace_id", ""),
                        "request_id": msg.get("request_id", ""),
                        "temperature": msg.get("temperature", 0.0),
                        "top_p": msg.get("top_p", 1.0),
                        "seed": msg.get("seed", 0),
                        "spec_proposed": msg.get("spec_proposed", 0),
                        "spec_accepted": msg.get("spec_accepted", 0),
                        # server-RESOLVED tenant label (sanitized there)
                        "tenant": msg.get("tenant", "default"),
                    }
                if ttft is None:  # first streamed token, client-observed
                    ttft = time.perf_counter() - t0
                tokens.append(msg["token"])
        raise RuntimeError("connection closed before the terminal record")

    return submit


def _multi_socket_submit(addrs: list[tuple[str, int]]):
    """Round-robin submit over several ``HOST:PORT`` targets (``--targets``
    multi-target mode — a poor-man's balancer for comparing N standalone
    servers, or for driving a fleet's replicas directly, bypassing the
    router). Each result is tagged ``target`` so ``run_loadgen`` emits a
    per-target report block alongside the fleet-wide percentiles."""
    singles = [
        (f"{h}:{p}", _socket_submit(h, p)) for h, p in addrs
    ]
    lock = threading.Lock()
    nxt = [0]

    def submit(ids, max_new, ctx=None, sampling=None):
        with lock:
            name, one = singles[nxt[0] % len(singles)]
            nxt[0] += 1
        r = one(ids, max_new, ctx, sampling)
        r["target"] = name
        return r

    return submit


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m consensusml_tpu_torch.tools.loadgen", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    tgt = p.add_mutually_exclusive_group(required=True)
    tgt.add_argument("--artifact", help="serving artifact dir (in-process engine)")
    tgt.add_argument("--connect", help="HOST:PORT of a running ServeServer")
    tgt.add_argument("--targets", metavar="HOST:PORT,...",
                     help="comma-separated HOST:PORT list: round-robin the "
                          "arrivals over several running servers (or a "
                          "fleet's replicas, bypassing the router) and "
                          "report per-target SLO blocks alongside the "
                          "aggregate")
    p.add_argument("--rate", type=float, default=20.0, help="Poisson arrivals/s")
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--prompt-len", default="4:24", metavar="LO:HI")
    p.add_argument("--len-dist", default="uniform", choices=("uniform", "zipf"),
                   help="prompt-length mix: uniform hits every prefill "
                        "bucket evenly; zipf is the heavy-tail production "
                        "mix (mostly short prompts, fat tail to HI) that "
                        "the paged KV pool's occupancy bound is sized for")
    p.add_argument("--swap-every", type=int, default=0, metavar="N",
                   help="every N arrivals, bump the artifact's generation "
                        "(serve/export.bump_generation) so the engine's "
                        "hot-swap watcher reloads mid-traffic — proves "
                        "tail latency under drain-free reload (artifact "
                        "mode only)")
    p.add_argument("--slots", type=int, default=8, help="engine slots (artifact mode)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="per-request sampling temperature (0 = greedy); "
                        "sent on the wire per request and echoed on the "
                        "terminal record")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass per request (1.0 = full "
                        "distribution)")
    p.add_argument("--spec-k", type=int, default=0, metavar="K",
                   help="artifact mode: serve speculatively with the "
                        "draft/ subartifact proposing K tokens per round "
                        "(serve.export.export_draft installs one)")
    p.add_argument("--shared-prefix", default=None, metavar="LEN:FRAC",
                   help="prepend ONE fixed LEN-token prefix (drawn once "
                        "from the fixture seed) to FRAC of arrivals — "
                        "the system-prompt mix the serving prefix cache "
                        "deduplicates; --prompt-len then sizes the "
                        "unshared suffix (docs/serving.md)")
    p.add_argument("--tenants", default=None, metavar="SPEC",
                   help="weighted tenant mix, e.g. 'a=3,b=1' (bare names "
                        "weight 1): each arrival draws a tenant label "
                        "deterministically from the fixture seed, sends "
                        "it on the wire / submit(tenant=), and records "
                        "per-tenant client SLO twins — the client half "
                        "of the server's wide-event tenant accounting "
                        "(docs/observability.md)")
    p.add_argument("--seed", type=int, default=0,
                   help="fixture seed: arrival pattern, prompt ids, trace "
                        "ids, AND per-request sampling seeds all derive "
                        "from it — same seed, same token streams")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="artifact mode: the engine's device (the card unless --device cpu; no CPU fallback)")
    p.add_argument("--obs-snapshot", default=None, metavar="DIR",
                   help="write the consensusml_loadgen_* metrics snapshot "
                        "to DIR (obs-loadgen-<seed>.json, cluster snapshot "
                        "format), including the client-side history rings "
                        "sampled during the run — point it at the serving "
                        "side's --obs-cluster-dir and obs_report "
                        "shows client + server SLOs (and joined TTFT "
                        "sparklines) in one report")
    args = p.parse_args(argv)

    lo, hi = (int(x) for x in args.prompt_len.split(":"))
    shared_prefix = None
    if args.shared_prefix:
        plen, _, frac = args.shared_prefix.partition(":")
        shared_prefix = (int(plen), float(frac) if frac else 1.0)
    engine = None
    swap_fn = None
    if args.artifact:
        from consensusml_tpu_torch.serve.engine import ServeConfig, load_engine

        engine = load_engine(
            args.artifact,
            ServeConfig(
                num_slots=args.slots,
                max_new_tokens=args.max_new,
                # --shared-prefix load is only meaningful against the
                # prefix index; plain runs keep the lean seed warmup
                prefix_cache=shared_prefix is not None,
            ),
            spec_k=args.spec_k,
            device=args.device,
        )
        engine.warmup()
        # the resolved attention tier, loudly: "auto" means the KERNEL
        # path resolved at engine construction — the executed tier must
        # always be the reported tier (models/paged_attention.py)
        print(
            "engine: kv_impl=paged "
            f"attn_impl={engine.attn_impl} "
            f"(requested {engine.config.attn_impl!r})",
            flush=True,
        )
        vocab = engine._dm.vocab_size
        submit = _engine_submit(engine)
        if args.swap_every:
            from consensusml_tpu_torch.serve.export import bump_generation

            engine.watch(args.artifact, poll_s=0.05)
            swap_fn = lambda: bump_generation(args.artifact)
    else:
        if args.swap_every:
            print("error: --swap-every needs --artifact (the generation "
                  "bump touches the artifact dir)", file=sys.stderr)
            return 2
        vocab = 64  # socket mode cannot introspect the model; ids stay tiny
        if args.targets:
            addrs = []
            for part in args.targets.split(","):
                part = part.strip()
                if not part:
                    continue
                host, _, port = part.partition(":")
                addrs.append((host, int(port)))
            if not addrs:
                print(f"error: no targets in {args.targets!r}",
                      file=sys.stderr)
                return 2
            submit = _multi_socket_submit(addrs)
        else:
            host, _, port = args.connect.partition(":")
            submit = _socket_submit(host, int(port))

    history = None
    if args.obs_snapshot:
        # client-side history rings: the sampler thread records the
        # loadgen families at cadence DURING the run, so the snapshot's
        # digest carries the client TTFT trend on the same wall-clock
        # windows as the server's
        from consensusml_tpu_torch.obs import get_history

        history = get_history()
    report = run_loadgen(
        submit,
        n_requests=args.requests,
        rate_rps=args.rate,
        prompt_lens=(lo, hi),
        vocab=vocab,
        max_new_tokens=args.max_new,
        seed=args.seed,
        len_dist=args.len_dist,
        swap_every=args.swap_every,
        swap_fn=swap_fn,
        temperature=args.temperature,
        top_p=args.top_p,
        tenants=parse_tenant_weights(args.tenants),
        shared_prefix=shared_prefix,
        history=history,
    )
    if engine is not None:
        report["engine"] = engine.stats()
        engine.shutdown()
    if args.obs_snapshot:
        from consensusml_tpu_torch.obs import ClusterWriter, get_request_registry

        # in-process mode the engine fed this process's request-trace
        # registry, so the snapshot carries the server-side traces the
        # exemplar request_ids resolve against; socket mode leaves it to
        # the server's own snapshot
        path = ClusterWriter(args.obs_snapshot, rank=args.seed, role="loadgen", history=history).write(
            extra={"report": report, "request_traces": get_request_registry().snapshot()})
        print(f"obs snapshot: {path}", flush=True)
    print("LOADGEN " + json.dumps(report), flush=True)
    return 0 if report["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
