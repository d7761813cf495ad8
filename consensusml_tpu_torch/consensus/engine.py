"""The gossip round: exact mixing or CHOCO compressed mixing, on the
simulated backend and the collective one (port of
``consensusml_tpu/consensus/engine.py``).

CHOCO-SGD update (gamma = consensus step size, Q = compressor):

    q_i     = Q(x_i - xhat_i)               # compressed innovation
    xhat_i <- xhat_i + dec(q_i)             # everyone can track this
    s_i    <- s_i + sum_j W[i,j] dec(q_j)   # only q travels the wire
    x_i    <- x_i + gamma * (s_i - xhat_i)

The bucketed wire is ported: exact mixing over dense buckets, and CHOCO
over codec buckets either through the fused one-pass encode (the int8,
int4 and fp8 quantizers: one kernel launch per bucket per exchange) or
through the two-step wire (any other codec with a ``bucket_alignment``,
or ``fused_wire=False``: per bucket, ``compress`` then ``decompress`` of
the innovation). The warm-up and periodic dense-refresh rounds of the
reference (``lax.cond`` on the round counter) are a Python ``if`` on the
host's round counter here.

Two backends. :meth:`ConsensusEngine.round_simulated` runs every worker
stacked on one device (the worker axis written out where the reference
vmaps) and mixes through the matrix. :meth:`ConsensusEngine.
round_collective` runs ONE worker per process (its
:class:`~consensusml_tpu_torch.comm.mesh.WorkerMesh`): its payloads ride
the mesh's transport to its neighbours, and its receive folds them in,
self first then each shift in order: the fused wire's one
``fused_dequantize_accumulate`` launch a bucket, or the two-step wire's
``decompress_accumulate`` (the chunked top-k's accumulating
``chunk_scatter``). Every topology family runs on both; a time-varying
one takes phase ``step % period`` (the simulated caller passes that
phase's matrix, the collective round picks the phase itself).

``path_filter(path) -> bool`` (any callable on a leaf's key path in the
port's trees, e.g. ``("params", "layer_0.q_proj.lora_a")``) restricts the
round to the selected leaves, as the reference's ``_select``: the bucket
plan, the mixing or CHOCO state, the payloads and the wire bytes cover
those leaves only, in flatten order, and every other leaf passes through
untouched (the same tensor). LoRA's ``lora_gossip_filter`` is one such
filter.

Not ported yet, and refused with ``NotImplementedError`` when set: the
per-leaf wire (``bucket_bytes=None``, or a codec without a
``bucket_alignment``), ``compress_filter`` other than
``"auto"`` (and, under CHOCO, its exact-mixed ``model_state`` leaves;
exact mixing gossips ``model_state`` like the params), faults,
push-sum, ``fused_codec``, overlap gossip and its pipelining, and
stochastic codecs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from consensusml_tpu_torch.comm import collectives, simulated
from consensusml_tpu_torch.compress.base import Compressor
from consensusml_tpu_torch.consensus.bucketing import (
    BucketPlan,
    FusedWirePlan,
    build_fused_plan,
    build_plan,
)
from consensusml_tpu_torch.topology import Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = ["GossipConfig", "ChocoState", "ConsensusEngine"]


class ChocoState(NamedTuple):
    """Compressed-gossip state: per-bucket f32 buffers, ``(W, total)``
    stacked (or ``(total,)`` per worker)."""

    xhat: list
    s: list


# field -> its default; any other value is a path this slice does not port
_NOT_PORTED = {
    "compress_filter": "auto",
    "faults": None,
    "push_sum": False,
    "fused_codec": False,
    "overlap": False,
    "pipeline_depth": 1,
}


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """How one consensus round is performed (the reference's fields; those
    this slice reads are documented there)."""

    topology: Topology
    compressor: Compressor | None = None  # None => exact mixing
    gamma: float = 1.0
    path_filter: Any = None
    compress_filter: Any = "auto"
    faults: Any = None
    push_sum: bool | str = False
    fused_codec: bool = False
    overlap: bool = False
    gossip_steps: int = 1
    codec_warmup_rounds: int = 0
    codec_refresh_every: int = 0
    bucket_bytes: int | None = 4 * 2**20
    fused_wire: bool | str = "auto"
    pipeline_depth: int = 1

    def __post_init__(self):
        for name, default in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"GossipConfig.{name}={getattr(self, name)!r} is not ported yet "
                    f"(only the default {default!r})"
                )
        if self.path_filter is not None and not callable(self.path_filter):
            raise ValueError(f"path_filter must be a callable on a key path, got {self.path_filter!r}")
        if self.bucket_bytes is None:
            raise NotImplementedError("the per-leaf wire (bucket_bytes=None) is not ported yet")
        if self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got {self.bucket_bytes}")
        if self.fused_wire not in (True, False, "auto"):
            raise ValueError(f"fused_wire must be True, False or 'auto', got {self.fused_wire!r}")
        comp = self.compressor
        if comp is not None:
            from consensusml_tpu_torch.compress.kernels import fused_bucket_codec

            if comp.stochastic:
                raise NotImplementedError("stochastic codecs are not ported yet")
            if comp.bucket_alignment() is None:
                raise NotImplementedError(
                    f"{type(comp).__name__} does not decompose per chunk (bucket_alignment() is "
                    "None), so it needs the per-leaf wire, which is not ported yet"
                )
            if self.fused_wire is True and fused_bucket_codec(comp) is None:
                raise NotImplementedError(
                    f"fused_wire=True but {type(comp).__name__} has no fused one-pass wire "
                    "(only the per-chunk int8/int4/fp8 quantizers fuse; composed/sparse codecs "
                    "keep the two-step bucketed wire, fused_wire='auto')"
                )
        elif self.fused_wire is True:
            raise NotImplementedError("fused_wire=True without a compressor has nothing to fuse")
        if self.gossip_steps < 1:
            raise ValueError(f"gossip_steps must be >= 1, got {self.gossip_steps}")
        for name in ("codec_warmup_rounds", "codec_refresh_every"):
            value = getattr(self, name)
            if value < 0:
                raise ValueError(f"{name} must be >= 0, got {value}")
            if value > 0 and comp is None:
                raise NotImplementedError(f"{name} without a compressor is meaningless")


def _check_bucket_state(packed: list, xhat: list) -> None:
    shapes = lambda xs: [tuple(b.shape) for b in xs]
    if len(xhat) != len(packed) or shapes(xhat) != shapes(packed):
        raise ValueError(
            "bucketed CHOCO state does not match this round's bucket layout: params pack "
            f"to {shapes(packed)} but the state holds {shapes(xhat)}. For stacked params, "
            "init_state needs world_size=...; rebuild state after changing bucket_bytes, "
            "the codec, or the tree."
        )


def _check_no_model_state(paths: list) -> None:
    # CHOCO only: its compress_filter="auto" mixes model_state leaves
    # exactly beside the compressed params, a split not ported yet. Exact
    # mixing takes model_state (BatchNorm statistics) like any leaf.
    for path in paths:
        if path and path[0] == "model_state":
            raise NotImplementedError(
                "exact-mixed model_state leaves (compress_filter='auto') are not ported yet"
            )


@dataclasses.dataclass(frozen=True)
class ConsensusEngine:
    config: GossipConfig

    @property
    def topology(self) -> Topology:
        return self.config.topology

    @property
    def compressed(self) -> bool:
        return self.config.compressor is not None

    @property
    def bucketed(self) -> bool:
        """Always true here (the config refuses the per-leaf wire)."""
        return True

    @property
    def fused_wire_active(self) -> bool:
        """Whether compressed rounds run the fused one-pass wire: a codec
        with a fused wire and the config not opting out (the reference's
        rule); otherwise CHOCO runs the two-step bucketed wire."""
        cfg = self.config
        if cfg.compressor is None or cfg.fused_wire is False:
            return False
        from consensusml_tpu_torch.compress.kernels import fused_bucket_codec

        return fused_bucket_codec(cfg.compressor) is not None

    def _dense_plan(self, leaves: list, stacked: bool = False) -> BucketPlan:
        return build_plan(
            [(tuple(x.shape[1:] if stacked else x.shape), x.dtype) for x in leaves],
            bucket_bytes=self.config.bucket_bytes,
        )

    def _codec_plan(self, leaves: list, stacked: bool = False) -> BucketPlan:
        """CHOCO layout: f32 buffers, leaves padded to the codec's chunk,
        buckets capped on the estimated codec payload."""
        comp = self.config.compressor
        align = comp.bucket_alignment()
        rate = comp.wire_bytes((align,), torch.float32)
        return build_plan(
            [(tuple(x.shape[1:] if stacked else x.shape), torch.float32) for x in leaves],
            bucket_bytes=self.config.bucket_bytes,
            align=align,
            wire_bytes=lambda n, dtype: (n // align) * rate,
        )

    def _select(self, tree: Any):
        """``(paths, leaves, rebuild)`` of the leaves that gossip: with a
        ``path_filter`` those it selects, in flatten order, and
        ``rebuild(new_leaves)`` the tree with them replaced and every other
        leaf as it was; without one, every leaf."""
        flat = T.flatten_with_paths(tree)
        spec = T.flatten(tree)[1]
        flt = self.config.path_filter
        keep = [True if flt is None else bool(flt(path)) for path, _ in flat]

        def rebuild(new: list) -> Any:
            it = iter(new)
            return T.unflatten(spec, [next(it) if k else x for k, (_, x) in zip(keep, flat)])

        chosen = [(path, x) for k, (path, x) in zip(keep, flat) if k]
        return [p for p, _ in chosen], [x for _, x in chosen], rebuild

    def bucket_plan(self, params: Any, stacked: bool = False) -> BucketPlan:
        """The bucket layout one gossip round of ``params`` uses (the
        selected leaves only); only shapes are read."""
        _, leaves, _ = self._select(params)
        if self.compressed:
            return self._codec_plan(leaves, stacked=stacked)
        return self._dense_plan(leaves, stacked=stacked)

    # ---- state ----------------------------------------------------------
    def init_state(self, params: Any, world_size: int | None = None) -> ChocoState | None:
        """Zero per-bucket CHOCO state for ``params`` (stacked leaves with
        ``world_size``, per-worker leaves without), or ``None`` for exact
        mixing."""
        if not self.compressed:
            return None
        paths, leaves, _ = self._select(params)
        _check_no_model_state(paths)
        plan = self._codec_plan(leaves, stacked=world_size is not None)
        device = leaves[0].device if leaves else None
        lead = () if world_size is None else (world_size,)
        xhat = [torch.zeros(lead + (b.total,), dtype=torch.float32, device=device) for b in plan.buckets]
        return ChocoState(xhat=xhat, s=[torch.zeros_like(z) for z in xhat])

    # ---- simulated round ------------------------------------------------
    def round_simulated(self, params: Any, state: ChocoState | None, w: torch.Tensor,
                        step: int | None = None):
        """One gossip round on stacked tensors (leading axis = workers).
        ``step`` is the round counter, needed when warm-up or refresh
        rounds are configured. Returns ``(new_params, new_state)``."""

        def mix(bufs):
            # bucket by bucket, each input buffer released once mixed (the
            # list is consumed, as ``_round`` allows): the round holds one
            # extra copy of the stacked tree, not two (BERT-base at 32
            # workers: 14 GB)
            out = []
            for i in range(len(bufs)):
                out.append(simulated.mix_stacked(bufs[i], w))
                bufs[i] = None
            return out

        def exchange(x, xhat, s, fused):
            if fused is not None:
                return self._innovation_exchange_fused_simulated(x, xhat, s, w, fused)
            return self._innovation_exchange_simulated(x, xhat, s, w)

        return self._round(params, state, step, mix, exchange, stacked=True)

    def _round(self, params: Any, state: ChocoState | None, step: int | None, mix, exchange, stacked: bool):
        """The round both backends share: ``mix(bufs)`` mixes a list of
        bucket buffers exactly once and consumes the list (it may set its
        entries to ``None`` as it goes, as the simulated backend does to
        free each bucket once mixed), so nothing here reads a list after
        passing it to ``mix``; ``exchange(x, xhat, s, fused)`` is the
        innovation exchange (``fused`` the :class:`FusedWirePlan`, or
        ``None`` for the two-step wire) and returns ``(xhat, s)``."""
        cfg = self.config
        if step is None and (cfg.codec_warmup_rounds > 0 or cfg.codec_refresh_every > 0):
            raise ValueError("codec_warmup_rounds/codec_refresh_every need the round counter (step=...)")
        n_iter = cfg.gossip_steps
        paths, leaves, rebuild = self._select(params)
        if not self.compressed:
            if not leaves:
                return params, None
            plan = self._dense_plan(leaves, stacked=stacked)
            bufs = plan.pack(leaves, stacked=stacked)
            for _ in range(n_iter):
                bufs = mix(bufs)
            return rebuild(plan.unpack(bufs, stacked=stacked)), None

        _check_no_model_state(paths)
        x32 = [x.to(torch.float32) for x in leaves]
        plan = self._codec_plan(x32, stacked=stacked)
        fused = build_fused_plan(plan, cfg.compressor) if self.fused_wire_active else None
        x = plan.pack(x32, stacked=stacked)
        del x32
        xhat, s = list(state.xhat), list(state.s)
        _check_bucket_state(x, xhat)

        warm, refresh = cfg.codec_warmup_rounds, cfg.codec_refresh_every
        if (warm > 0 and step < warm) or (refresh > 0 and step % refresh == 0):
            # dense mixing, while the innovation exchange keeps xhat/s warm
            xhat, s = exchange(x, xhat, s, fused)
            for _ in range(n_iter):
                x = mix(x)
        else:
            for _ in range(n_iter):
                xhat, s = exchange(x, xhat, s, fused)
                x = [xi + cfg.gamma * (si - hi) for xi, si, hi in zip(x, s, xhat)]
        new = [piece.to(old.dtype) for piece, old in zip(plan.unpack(x, stacked=stacked), leaves)]
        return rebuild(new), ChocoState(xhat=xhat, s=s)

    def _innovation_exchange_fused_simulated(self, x: list, xhat: list, s: list,
                                             w: torch.Tensor, fused: FusedWirePlan):
        """The fused wire's exchange on stacked ``(W, total)`` buffers: one
        encode launch per bucket (the worker axis only adds rows), then the
        decoded innovations mix through the matrix. Bucket by bucket, so
        only one bucket's temporaries are alive at a time; the buckets are
        independent, so this is the reference's all-buckets-at-once math."""
        fused._check(x, "encode")
        new_hat, new_s = [], []
        for xb, hb, sb in zip(x, xhat, s):
            q, hat = fused.codec.encode(xb, hb)
            recv = simulated.mix_stacked(fused.codec.decode(q), w)
            new_hat.append(hat)
            new_s.append(sb + recv)
        return new_hat, new_s

    def _innovation_exchange_simulated(self, x: list, xhat: list, s: list, w: torch.Tensor):
        """The two-step wire's exchange on stacked ``(W, total)`` buffers:
        ``dec = decompress(compress(x - xhat))`` with every worker's slice
        compressed on its own (the reference's vmap; one launch of each
        codec kernel covers all workers), ``xhat += dec``, ``s += W @
        dec``. Bucket by bucket, as the fused exchange."""
        comp = self.config.compressor
        new_hat, new_s = [], []
        for xb, hb, sb in zip(x, xhat, s):
            dec = comp.decompress(comp.compress(xb - hb, stacked=True))
            new_hat.append(hb + dec)
            new_s.append(sb + simulated.mix_stacked(dec, w))
        return new_hat, new_s

    # ---- collective round (one worker per process) ----------------------
    def round_collective(self, params: Any, state: ChocoState | None, mesh, step: int | None = None):
        """One gossip round of THIS rank's worker (per-worker leaves and
        per-worker CHOCO state, :meth:`init_state` without ``world_size``)
        over ``mesh``'s transport. ``step`` is the round counter, needed
        for a time-varying topology (phase ``step % period``, the same on
        every rank) and for warm-up or refresh rounds. Returns
        ``(new_params, new_state)``."""
        topo = self.topology
        if mesh.topology != topo:
            raise ValueError("the mesh is bound to another topology than this engine's")
        if topo.is_time_varying:
            if step is None:
                raise ValueError(f"{type(topo).__name__} is time-varying: round_collective needs step=...")
            topo = topo.phases[step % topo.period]

        def mix(bufs):
            # every bucket exact-mixed in one exchange (the BN statistics
            # ride beside the weights)
            return collectives.mix_buckets(bufs, topo, mesh)

        def exchange(x, xhat, s, fused):
            if fused is not None:
                return self._innovation_exchange_fused_collective(topo, x, xhat, s, fused, mesh)
            return self._innovation_exchange_collective(topo, x, xhat, s, mesh)

        return self._round(params, state, step, mix, exchange, stacked=False)

    @staticmethod
    def _ppermute_payloads(payloads: list, topo: Topology, mesh) -> list[list]:
        """Every bucket's payload along every shift of ``topo`` in one
        exchange: per shift, the payloads this rank receives."""
        per = [p.wire_tensors() for p in payloads]
        flat = [t for ts in per for t in ts]
        received = collectives.ppermute_shifts(flat, topo, topo.shifts, mesh)
        out = []
        for recv in received:
            it = iter(recv)
            out.append([p.with_wire([next(it) for _ in ts]) for p, ts in zip(payloads, per)])
        return out

    def _innovation_exchange_collective(self, topo: Topology, x: list, xhat: list, s: list, mesh):
        """The two-step wire's exchange (per-worker view): compress the
        innovation of every bucket, decode it (``xhat += dec``), ship the
        payloads to every neighbour, and fold ``self_weight * dec`` plus
        each neighbour's payload into ``s`` through the codec's
        ``decompress_accumulate`` (the chunked top-k's accumulating
        ``chunk_scatter``: no dense temporary a neighbour)."""
        comp = self.config.compressor
        delta = [xb - hb for xb, hb in zip(x, xhat)]
        q = [comp.compress(d) for d in delta]
        dec = [comp.decompress(p) for p in q]
        xhat = [hb + d for hb, d in zip(xhat, dec)]
        if topo.uses_psum:
            recv = collectives.all_reduce_mean(dec, mesh)
        else:
            recv = [topo.self_weight * d for d in dec]
            inflight = self._ppermute_payloads(q, topo, mesh)
            for shift, q_nbr in zip(topo.shifts, inflight):
                recv = [comp.decompress_accumulate(p, r, shift.weight) for p, r in zip(q_nbr, recv)]
        return xhat, [sb + r for sb, r in zip(s, recv)]

    def _innovation_exchange_fused_collective(self, topo: Topology, x: list, xhat: list, s: list,
                                              fused: FusedWirePlan, mesh):
        """The fused wire's exchange (per-worker view): one encode launch a
        bucket gives the payload and ``xhat'``, the payloads ride the
        transport exactly as the two-step wire's, and one
        ``fused_dequantize_accumulate`` launch a bucket folds self and
        every neighbour into ``s`` (sources self first, then each shift
        in order). A dense topology means the decoded innovations."""
        q, xhat = fused.encode(x, xhat)
        if topo.uses_psum:
            recv = collectives.all_reduce_mean(fused.decode(q), mesh)
            return xhat, [sb + r for sb, r in zip(s, recv)]
        inflight = self._ppermute_payloads(q, topo, mesh)
        weights = (topo.self_weight,) + tuple(sh.weight for sh in topo.shifts)
        sources = [[qb] + [nbr[i] for nbr in inflight] for i, qb in enumerate(q)]
        return xhat, fused.decode_accumulate(s, sources, weights)

    # ---- accounting -----------------------------------------------------
    def wire_bytes_per_round(self, params: Any) -> int:
        """Bytes ONE worker sends per steady-state round (``params`` are
        per-worker leaves; only their shapes are read): the codec payload
        of every bucket (dense f32 for exact mixing) of the selected
        leaves (a leaf the ``path_filter`` leaves out ships nothing), times
        the sends of a round (:meth:`_sends_per_round`), times
        ``gossip_steps``. Warm-up and refresh rounds ship the dense params
        besides and are not folded in, as in the reference."""
        comp = self.config.compressor
        _, leaves, _ = self._select(params)
        if comp is None:
            payload = sum(4 * int(torch.Size(x.shape).numel()) for x in leaves)
        else:
            plan = self._codec_plan(leaves)
            payload = sum(comp.wire_bytes((b.total,), torch.float32) for b in plan.buckets)
        return int(payload * self._sends_per_round() * self.config.gossip_steps)

    def _sends_per_round(self) -> float:
        """Payloads a worker sends per round: one per neighbour shift, one
        for a dense topology (an all-reduce mean), and for a time-varying
        topology the average over its period."""
        topo = self.topology
        if topo.is_time_varying:
            return sum((1 if p.uses_psum else len(p.shifts)) for p in topo.phases) / topo.period
        return 1 if topo.uses_psum else len(topo.shifts)

    def consensus_error_collective(self, params: Any, mesh) -> torch.Tensor:
        """This rank's view of the consensus error of per-worker ``params``
        (the same value on every rank)."""
        return collectives.consensus_error(params, self.topology, mesh)

    def consensus_error_simulated(self, params: Any) -> torch.Tensor:
        return simulated.consensus_error_stacked(params, self.topology.world_size)
