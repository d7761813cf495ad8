"""The gossip round: exact mixing, CHOCO compressed mixing or push-sum,
with or without faults, on the simulated backend and the collective one
(port of ``consensusml_tpu/consensus/engine.py``).

CHOCO-SGD update (gamma = consensus step size, Q = compressor):

    q_i     = Q(x_i - xhat_i)               # compressed innovation
    xhat_i <- xhat_i + dec(q_i)             # everyone can track this
    s_i    <- s_i + sum_j W[i,j] dec(q_j)   # only q travels the wire
    x_i    <- x_i + gamma * (s_i - xhat_i)

Two wires. The bucketed one (``bucket_bytes`` set): exact mixing over
dense buckets, CHOCO over codec buckets either through the fused
one-pass encode (the int8, int4 and fp8 quantizers: one kernel launch
per bucket per exchange) or through the two-step wire (any other codec
with a ``bucket_alignment``, or ``fused_wire=False``: per bucket,
``compress`` then ``decompress`` of the innovation). The per-leaf one
(``bucket_bytes=None``, a codec without a ``bucket_alignment`` such as
the global top-k, and every push-sum round): each leaf mixed, or
compressed, shipped and decoded, on its own, the chunked codecs'
chunk clamped to the leaf's size as the reference's (a bucket would pad
the leaf to the codec's chunk instead). CHOCO state lives per bucket on
the bucketed wire and per compressed leaf on the per-leaf one. The
warm-up and periodic dense-refresh rounds of the reference (``lax.cond``
on the round counter) are a Python ``if`` on the host's round counter.

``compress_filter`` picks the gossiped leaves that ride CHOCO; the rest
mix exactly every round, in step with the compressed ones. ``"auto"``
(the default) mixes the ``model_state`` subtree (BatchNorm statistics)
exactly; ``None`` compresses every leaf; a callable on a key path
decides per leaf.

Faults (``faults=FaultConfig(...)``, :mod:`.faults`) take a 0/1 alive
mask a round: the simulated round mixes through
``masked_mixing_matrix``, the collective one through
``collectives.mix_buckets`` with this worker's flag, the neighbours'
flags exchanged once a round. Push-sum (``push_sum``, :mod:`.pushsum`)
carries a mass beside the parameters; ``init_state`` returns its
:class:`~.pushsum.PushSumState`. The reference's legality rules hold:
no faults or push-sum with a compressor, no faults on a directed graph
without push-sum, one consensus iteration a push-sum round.

Two backends. :meth:`ConsensusEngine.round_simulated` runs every worker
stacked on one device (the worker axis written out where the reference
vmaps) and mixes through the matrix. :meth:`ConsensusEngine.
round_collective` runs ONE worker per process (its
:class:`~consensusml_tpu_torch.comm.mesh.WorkerMesh`): its payloads ride
the mesh's transport to its neighbours, and its receive folds them in,
self first then each shift in order: the fused wire's one
``fused_dequantize_accumulate`` launch a bucket, or the two-step and
per-leaf wires' ``decompress_accumulate`` (the chunked top-k's
accumulating ``chunk_scatter``). Every topology family runs on both; a
time-varying one takes phase ``step % period`` (the simulated caller
passes that phase's matrix, the collective round picks the phase
itself).

``path_filter(path) -> bool`` (any callable on a leaf's key path in the
port's trees, e.g. ``("params", "layer_0.q_proj.lora_a")``) restricts the
round to the selected leaves, as the reference's ``_select``: the bucket
plan, the mixing or CHOCO state, the payloads and the wire bytes cover
those leaves only, in flatten order, and every other leaf passes through
untouched (the same tensor). LoRA's ``lora_gossip_filter`` is one such
filter.

``fused_codec`` runs the codec once over the whole compressed tree laid
end to end (one f32 vector a worker, ``(W, n)`` stacked): its chunks
span leaf boundaries, so it is a codec-semantics switch, and the CHOCO
state is that one vector. It rides the per-leaf exchange as a tree of one
leaf; ``fused_wire`` stays off on it.

Overlap gossip (``overlap``, combine-then-adapt): the round becomes ``z
<- z + u + (W - I) z``, the mixing correction computed from the params
before the local steps and applied at the next round's start, so its
exchange can run under the local steps (:meth:`ConsensusEngine.
correction_collective_start` posts it, the returned
its ``wait()`` finishes it). Compressed overlap (the
bucketed wire only) computes ``gamma (s - xhat)`` from one CHOCO
innovation exchange instead, BN statistics getting the plain ``(W - I)
z``. ``pipeline_depth`` D keeps D corrections in flight, each computed
from the params plus the corrections still queued
(:class:`OverlapState`).

Not ported yet, and refused with ``NotImplementedError`` when set (after
the reference's own refusals): stochastic codecs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from consensusml_tpu_torch.comm import collectives, simulated
from consensusml_tpu_torch.comm.transport import InFlight
from consensusml_tpu_torch.compress.base import Compressor
from consensusml_tpu_torch.compress.reference import fma_f32
from consensusml_tpu_torch.consensus.bucketing import (
    BucketPlan,
    FusedWirePlan,
    build_fused_plan,
    build_plan,
)
from consensusml_tpu_torch.consensus.faults import FaultConfig, masked_mixing_matrix
from consensusml_tpu_torch.consensus.pushsum import (
    PushSumState,
    pushsum_init,
    pushsum_round_collective,
    pushsum_round_simulated,
)
from consensusml_tpu_torch.topology import Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = ["GossipConfig", "ChocoState", "OverlapState", "ConsensusEngine"]


class ChocoState(NamedTuple):
    """Compressed-gossip state, f32: per bucket on the bucketed wire
    (``(W, total)`` stacked, ``(total,)`` per worker), per compressed leaf
    on the per-leaf wire (the leaf's shape, stacked or not)."""

    xhat: list
    s: list


class OverlapState(NamedTuple):
    """Overlap gossip's carry: ``correction``, computed last round from
    that round's params before its local steps and applied at this
    round's start (the gossiped tree's structure; with a ``path_filter``
    the list of the selected leaves); ``choco``, CHOCO's per-bucket state
    when the correction is compressed; ``pending``, the ``pipeline_depth
    - 1`` corrections computed but not applied yet, oldest first, so the
    correction computed at round r lands at round r + D. Depth 1 keeps
    ``pending = ()``."""

    correction: Any
    choco: ChocoState | None = None
    pending: tuple = ()


# elements an f64 pass of the CHOCO update takes at once: the fused
# codec's one vector a worker is a whole model (GPT-2-medium: 1.4e9
# elements stacked), whose f64 temporaries would not fit at once
_UPDATE_SLICE = 1 << 26


def _choco_update(gamma: torch.Tensor, x: torch.Tensor, s: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """``x + gamma * (s - xhat)`` with one rounding (:func:`fma_f32`), as
    the reference's compiled program contracts it, in slices of
    ``_UPDATE_SLICE`` elements."""
    if x.numel() <= _UPDATE_SLICE:
        return fma_f32(gamma, s - xhat, x)
    out = torch.empty_like(x)
    flat, xf, sf, hf = out.view(-1), x.reshape(-1), s.reshape(-1), xhat.reshape(-1)
    for lo in range(0, flat.numel(), _UPDATE_SLICE):
        hi = lo + _UPDATE_SLICE
        flat[lo:hi] = fma_f32(gamma, sf[lo:hi] - hf[lo:hi], xf[lo:hi])
    return out


def _ravel(leaves: list, stacked: bool):
    """``fused_codec``'s boundary: ``(vec, unravel)``, the leaves laid end
    to end in flatten order, ``(n,)`` or, stacked, ``(W, n)`` (each
    worker's row its own leaves), and ``unravel(vec)`` the leaves back as
    views of ``vec``."""
    shapes = [tuple(x.shape) for x in leaves]
    if stacked:
        lead = shapes[0][0]
        sizes = [x.numel() // lead for x in leaves]
        vec = torch.cat([x.reshape(lead, -1) for x in leaves], dim=1)
    else:
        sizes = [x.numel() for x in leaves]
        vec = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(v: torch.Tensor) -> list:
        parts = torch.split(v, sizes, dim=1 if stacked else 0)
        return [p.reshape(shape) for p, shape in zip(parts, shapes)]

    return vec, unravel


def _owned(bufs: list, leaves: list) -> list:
    """``bufs`` with every buffer that shares memory with one of ``leaves``
    copied: what an in-flight correction keeps must survive the local
    steps writing the parameters in place."""
    theirs = {x.untyped_storage().data_ptr() for x in leaves}
    return [b.clone() if b.untyped_storage().data_ptr() in theirs else b for b in bufs]


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """How one consensus round is performed (the reference's fields and
    their meaning; :mod:`.engine`'s docstring says what each wire does)."""

    topology: Topology
    compressor: Compressor | None = None  # None => exact mixing
    gamma: float = 1.0
    path_filter: Any = None
    compress_filter: Any = "auto"  # "auto", None or a callable on a key path
    faults: FaultConfig | None = None
    push_sum: bool | str = False  # False, True or "auto"
    fused_codec: bool = False
    overlap: bool = False
    gossip_steps: int = 1
    codec_warmup_rounds: int = 0
    codec_refresh_every: int = 0
    bucket_bytes: int | None = 4 * 2**20  # None => the per-leaf wire
    fused_wire: bool | str = "auto"
    pipeline_depth: int = 1

    @property
    def push_sum_enabled(self) -> bool:
        """The resolved switch: ``"auto"`` engages push-sum exactly when
        faults are configured on a directed topology."""
        if self.push_sum == "auto":
            return self.faults is not None and not self.topology.symmetric
        return bool(self.push_sum)

    def __post_init__(self):
        # the reference's checks, in its order and with its exception types
        if self.push_sum not in (True, False, "auto"):
            raise ValueError(f"push_sum must be True, False or 'auto', got {self.push_sum!r}")
        if self.fused_wire not in (True, False, "auto"):
            raise ValueError(f"fused_wire must be True, False or 'auto', got {self.fused_wire!r}")
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {self.pipeline_depth}")
        if self.pipeline_depth > 1 and not self.overlap:
            raise NotImplementedError("pipeline_depth > 1 is overlap-mode pipelining; it needs overlap=True")
        comp = self.compressor
        if self.fused_wire is True:
            from consensusml_tpu_torch.compress.kernels import fused_bucket_codec

            if comp is None:
                raise NotImplementedError("fused_wire=True without a compressor has nothing to fuse")
            if self.bucket_bytes is None or self.fused_codec or self.push_sum_enabled:
                raise NotImplementedError(
                    "fused_wire=True requires the bucketed transport (bucket_bytes set, no fused_codec, "
                    "no push_sum): the fused kernels are per bucket"
                )
            if fused_bucket_codec(comp) is None:
                raise NotImplementedError(
                    f"fused_wire=True but {type(comp).__name__} has no fused one-pass wire "
                    "(only the per-chunk int8/int4/fp8 quantizers fuse; composed/sparse codecs "
                    "keep the two-step bucketed wire, fused_wire='auto')"
                )
        if self.bucket_bytes is not None and self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive (or None for the per-leaf wire), got {self.bucket_bytes}")
        if self.gossip_steps < 1:
            raise ValueError(f"gossip_steps must be >= 1, got {self.gossip_steps}")
        for name in ("codec_warmup_rounds", "codec_refresh_every"):
            value = getattr(self, name)
            if value < 0:
                raise ValueError(f"{name} must be >= 0, got {value}")
            if value > 0 and comp is None:
                raise NotImplementedError(f"{name} without a compressor is meaningless")
        if self.gossip_steps > 1 and self.push_sum_enabled:
            raise NotImplementedError(
                "gossip_steps > 1 with push-sum is not supported: the mass ratio's bias correction is "
                "defined per round"
            )
        if self.gossip_steps > 1 and self.overlap:
            raise NotImplementedError("gossip_steps > 1 with overlap gossip is not supported")
        if self.fused_codec and comp is None:
            raise NotImplementedError("fused_codec without a compressor has nothing to fuse")
        if self.overlap and comp is not None:
            if self.bucket_bytes is None or self.fused_codec or comp.bucket_alignment() is None:
                raise NotImplementedError("overlap + compression is only supported on the bucketed gossip path")
            if comp.stochastic:
                raise NotImplementedError("overlap + a stochastic compressor is not supported")
            if self.path_filter is not None:
                raise NotImplementedError("overlap + compression + path_filter is not supported")
            if self.codec_warmup_rounds > 0 or self.codec_refresh_every > 0:
                raise NotImplementedError(
                    "overlap + compression does not compose with codec_warmup_rounds/codec_refresh_every"
                )
        if self.overlap and self.push_sum_enabled:
            raise NotImplementedError("overlap + push-sum is not supported")
        if self.overlap and self.faults is not None:
            raise NotImplementedError("overlap + fault injection is not supported")
        if comp is not None and self.faults is not None:
            raise NotImplementedError(
                "fault-tolerant COMPRESSED gossip is not supported: CHOCO's xhat tracking assumes every "
                "peer applies every innovation, which a dropped round violates"
            )
        if comp is not None and self.push_sum_enabled:
            raise NotImplementedError(
                "compressed push-sum is not supported: CHOCO's innovation tracking assumes the "
                "row-stochastic mixing update"
            )
        if self.faults is not None and not self.topology.symmetric and not self.push_sum_enabled:
            raise NotImplementedError(
                "fault masking requires a SYMMETRIC topology: folding a dead peer's weight onto self "
                f"keeps W doubly stochastic only when W = W^T; a directed graph ({self.topology.name}) "
                "would bias the network mean each faulty round. Use push_sum=True on it"
            )
        # the port's own: what it does not run yet
        if self.path_filter is not None and not callable(self.path_filter):
            raise ValueError(f"path_filter must be a callable on a key path, got {self.path_filter!r}")
        if comp is not None and comp.stochastic:
            raise NotImplementedError("stochastic codecs are not ported yet")


def _check_state(packed: list, xhat: list, bucketed: bool) -> None:
    shapes = lambda xs: [tuple(b.shape) for b in xs]
    if len(xhat) != len(packed) or shapes(xhat) != shapes(packed):
        what = "bucket layout" if bucketed else "compressed leaves"
        raise ValueError(
            f"CHOCO state does not match this round's {what}: the params give {shapes(packed)} but the "
            f"state holds {shapes(xhat)}. For stacked params, init_state needs world_size=...; rebuild "
            "state after changing bucket_bytes, the codec, the filters or the tree."
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
        """Whether rounds ride the bucketed wire: ``bucket_bytes`` set, no
        push-sum, and exact mixing or a codec with a ``bucket_alignment``
        (else the per-leaf wire)."""
        cfg = self.config
        if cfg.bucket_bytes is None or cfg.fused_codec or cfg.push_sum_enabled:
            return False
        comp = cfg.compressor
        return comp is None or comp.bucket_alignment() is not None

    @property
    def fused_wire_active(self) -> bool:
        """Whether compressed rounds run the fused one-pass wire: the
        bucketed wire, a codec with a fused wire and the config not opting
        out (the reference's rule); otherwise CHOCO runs the two-step
        bucketed wire or the per-leaf one."""
        cfg = self.config
        if cfg.compressor is None or cfg.fused_wire is False or not self.bucketed:
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
        """``(leaves, rebuild)`` of the leaves that gossip: with a
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

        return [x for k, (_, x) in zip(keep, flat) if k], rebuild

    def _compress_filter(self):
        cf = self.config.compress_filter
        if cf == "auto":
            return lambda path: not (path and path[0] == "model_state")
        return cf

    def _partition(self, tree: Any):
        """One flatten, both filters on the tree's own paths:
        ``(compressed, exact, rebuild)``: the gossiped leaves that ride
        CHOCO and those mixed exactly (``compress_filter``), in flatten
        order, and ``rebuild(compressed_new, exact_new)`` the tree with
        every leaf the ``path_filter`` leaves out as it was."""
        flat = T.flatten_with_paths(tree)
        spec = T.flatten(tree)[1]
        pf, cf = self.config.path_filter, self._compress_filter()
        tags = ["r" if pf is not None and not pf(p) else "e" if cf is not None and not cf(p) else "c"
                for p, _ in flat]

        def rebuild(c_new: list, e_new: list) -> Any:
            its = {"c": iter(c_new), "e": iter(e_new)}
            return T.unflatten(spec, [x if t == "r" else next(its[t]) for t, (_, x) in zip(tags, flat)])

        by = lambda tag: [x for t, (_, x) in zip(tags, flat) if t == tag]  # noqa: E731
        return by("c"), by("e"), rebuild

    def bucket_plan(self, params: Any, stacked: bool = False) -> BucketPlan | None:
        """The bucket layout one gossip round of ``params`` uses (the
        gossiped leaves; under CHOCO the compressed ones), or ``None`` on
        the per-leaf wire; only shapes are read."""
        if not self.bucketed:
            return None
        if self.compressed:
            return self._codec_plan(self._partition(params)[0], stacked=stacked)
        return self._dense_plan(self._select(params)[0], stacked=stacked)

    # ---- state ----------------------------------------------------------
    def init_state(self, params: Any, world_size: int | None = None
                   ) -> ChocoState | PushSumState | OverlapState | None:
        """Gossip state for ``params`` (stacked leaves with ``world_size``,
        per-worker leaves without): unit push-sum mass; with ``overlap``,
        zero corrections (``pipeline_depth - 1`` of them queued) and, when
        compressed, zero per-bucket CHOCO state over the compressed
        leaves; zero CHOCO state (one flat vector with ``fused_codec``,
        per bucket, or per compressed leaf on the per-leaf wire); or
        ``None`` for exact mixing."""
        leaves = T.leaves(params)
        device = leaves[0].device if leaves else None
        cfg = self.config
        if cfg.push_sum_enabled:
            return pushsum_init(world_size, device=device)
        if cfg.overlap:
            sel = self._gossiped_sel(params)[0]
            zeros = lambda: T.tree_map(torch.zeros_like, sel)  # noqa: E731
            # pipeline_depth - 1 more in flight: the first rounds apply nothing while the queue fills
            pending = tuple(zeros() for _ in range(cfg.pipeline_depth - 1))
            choco = None
            if self.compressed:
                hat = self._bucket_zeros(self._partition(params)[0], world_size, device)
                choco = ChocoState(xhat=hat, s=[torch.zeros_like(z) for z in hat])
            return OverlapState(correction=zeros(), choco=choco, pending=pending)
        if not self.compressed:
            return None
        compressed, _, _ = self._partition(params)
        if cfg.fused_codec:
            # one flat vector a worker, the fused round's compress domain
            n = sum(x.numel() for x in compressed)
            shape = (n,) if world_size is None else (world_size, n // world_size)
            xhat = [torch.zeros(shape, dtype=torch.float32, device=device)]
        elif self.bucketed:
            xhat = self._bucket_zeros(compressed, world_size, device)
        else:
            xhat = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in compressed]
        return ChocoState(xhat=xhat, s=[torch.zeros_like(z) for z in xhat])

    def _bucket_zeros(self, compressed: list, world_size: int | None, device) -> list:
        """Zero f32 buffers of the compressed leaves' codec buckets, ``(W,
        total)`` with ``world_size``."""
        plan = self._codec_plan(compressed, stacked=world_size is not None)
        lead = () if world_size is None else (world_size,)
        return [torch.zeros(lead + (b.total,), dtype=torch.float32, device=device) for b in plan.buckets]

    # ---- simulated round ------------------------------------------------
    def round_simulated(self, params: Any, state, w: torch.Tensor, step: int | None = None,
                        alive: torch.Tensor | None = None):
        """One gossip round on stacked tensors (leading axis = workers).
        ``step`` is the round counter, needed when warm-up or refresh
        rounds are configured. ``alive`` (``(world,)`` of 0/1 floats, with
        ``config.faults``): the round's participation mask, mixed through
        the masked matrix (or push-sum's send-side one). Returns
        ``(new_params, new_state)``."""
        if self.config.push_sum_enabled:
            leaves, rebuild = self._select(params)
            mixed, state = pushsum_round_simulated(leaves, state, w, alive)
            return rebuild(mixed), state
        if alive is not None and not self.compressed:
            w = masked_mixing_matrix(w.to(torch.float32), alive)

        def mix(bufs):
            # buffer by buffer, each input released once mixed (the list
            # is consumed, as ``_round`` allows): the round holds one extra
            # copy of the stacked tree, not two (BERT-base at 32 workers:
            # 14 GB)
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

    def _mix_exact(self, leaves: list, mix, n_iter: int, stacked: bool) -> list:
        """``n_iter`` exact mixes of a leaf list: over dense buckets on the
        bucketed wire, leaf by leaf on the per-leaf one (the same numbers:
        the mixing is elementwise)."""
        if not leaves:
            return []
        if not self.bucketed:
            out = list(leaves)
            for _ in range(n_iter):
                out = mix(out)
            return out
        plan = self._dense_plan(leaves, stacked=stacked)
        bufs = plan.pack(leaves, stacked=stacked)
        for _ in range(n_iter):
            bufs = mix(bufs)
        return plan.unpack(bufs, stacked=stacked)

    def _round(self, params: Any, state: ChocoState | None, step: int | None, mix, exchange, stacked: bool):
        """The round both backends share: ``mix(bufs)`` mixes a list of
        buffers (buckets, or leaves on the per-leaf wire) exactly once and
        consumes the list (it may set its entries to ``None`` as it goes,
        as the simulated backend does to free each one once mixed), so
        nothing here reads a list after passing it to ``mix``;
        ``exchange(x, xhat, s, fused)`` is the innovation exchange over
        buckets or leaves (``fused`` the :class:`FusedWirePlan`, or
        ``None`` for the two-step and per-leaf wires) and returns ``(xhat,
        s)``."""
        cfg = self.config
        if step is None and (cfg.codec_warmup_rounds > 0 or cfg.codec_refresh_every > 0):
            raise ValueError("codec_warmup_rounds/codec_refresh_every need the round counter (step=...)")
        n_iter = cfg.gossip_steps
        if not self.compressed:
            leaves, rebuild = self._select(params)
            if not leaves:
                return params, None
            return rebuild(self._mix_exact(leaves, mix, n_iter, stacked)), None

        compressed, exact, rebuild = self._partition(params)
        # the exact-mixed leaves (BatchNorm statistics under "auto") stay
        # in step with the compressed ones
        mixed_exact = self._mix_exact(exact, mix, n_iter, stacked)
        x = [t.to(torch.float32) for t in compressed]
        plan = fused = unravel = None
        if cfg.fused_codec:
            # one codec call over the whole tree (a per-leaf exchange of one leaf)
            vec, unravel = _ravel(x, stacked)
            x = [vec]
            del vec
        elif self.bucketed:
            plan = self._codec_plan(x, stacked=stacked)
            fused = build_fused_plan(plan, cfg.compressor) if self.fused_wire_active else None
            x = plan.pack(x, stacked=stacked)
        xhat, s = list(state.xhat), list(state.s)
        _check_state(x, xhat, self.bucketed)

        warm, refresh = cfg.codec_warmup_rounds, cfg.codec_refresh_every
        if (warm > 0 and step < warm) or (refresh > 0 and step % refresh == 0):
            # dense mixing, while the innovation exchange keeps xhat/s warm
            xhat, s = exchange(x, xhat, s, fused)
            for _ in range(n_iter):
                x = mix(x)
        else:
            gamma = torch.tensor(cfg.gamma, dtype=torch.float32)
            for _ in range(n_iter):
                xhat, s = exchange(x, xhat, s, fused)
                # x + gamma * (s - xhat) with one rounding, as the
                # reference's compiled program contracts it
                x = [_choco_update(gamma.to(xi.device), xi, si, hi) for xi, si, hi in zip(x, s, xhat)]
        if plan is not None:
            x = plan.unpack(x, stacked=stacked)
        elif unravel is not None:
            x = unravel(x[0])
        new = [piece.to(old.dtype) for piece, old in zip(x, compressed)]
        return rebuild(new, mixed_exact), ChocoState(xhat=xhat, s=s)

    def _innovation_exchange_fused_simulated(self, x: list, xhat: list, s: list,
                                             w: torch.Tensor, fused: FusedWirePlan):
        """The fused wire's exchange on stacked ``(W, total)`` buffers: one
        encode launch per bucket (the worker axis only adds rows), then the
        decoded innovations mix through the matrix. Bucket by bucket, so
        only one bucket's temporaries are alive at a time; the buckets are
        independent, so this is the reference's all-buckets-at-once math."""
        fused._check(x, "encode")
        pairs = [self._exchange_bucket_simulated(xb, hb, sb, w, fused) for xb, hb, sb in zip(x, xhat, s)]
        return [h for h, _ in pairs], [sb for _, sb in pairs]

    def _innovation_exchange_simulated(self, x: list, xhat: list, s: list, w: torch.Tensor):
        """The two-step wire's exchange on stacked ``(W, total)`` buffers:
        ``dec = decompress(compress(x - xhat))`` with every worker's slice
        compressed on its own (the reference's vmap; one launch of each
        codec kernel covers all workers), ``xhat += dec``, ``s += W @
        dec``. Bucket by bucket, as the fused exchange."""
        pairs = [self._exchange_bucket_simulated(xb, hb, sb, w, None) for xb, hb, sb in zip(x, xhat, s)]
        return [h for h, _ in pairs], [sb for _, sb in pairs]

    def _exchange_bucket_simulated(self, xb: torch.Tensor, hb: torch.Tensor, sb: torch.Tensor, w: torch.Tensor,
                                   fused: FusedWirePlan | None):
        """One stacked buffer's innovation exchange: ``(xhat', s')``."""
        if fused is not None:
            q, hat = fused.codec.encode(xb, hb)
            return hat, sb + simulated.mix_stacked(fused.codec.decode(q), w)
        comp = self.config.compressor
        dec = comp.decompress(comp.compress(xb - hb, stacked=True))
        return hb + dec, sb + simulated.mix_stacked(dec, w)

    # ---- collective round (one worker per process) ----------------------
    def round_collective(self, params: Any, state, mesh, step: int | None = None, alive=None):
        """One gossip round of THIS rank's worker (per-worker leaves and
        per-worker state, :meth:`init_state` without ``world_size``) over
        ``mesh``'s transport. ``step`` is the round counter, needed for a
        time-varying topology (phase ``step % period``, the same on every
        rank) and for warm-up or refresh rounds. ``alive`` (this worker's
        0/1 flag, with ``config.faults``): the masked round, the
        neighbours' flags exchanged once. Returns ``(new_params,
        new_state)``."""
        topo = self.topology
        if mesh.topology != topo:
            raise ValueError("the mesh is bound to another topology than this engine's")
        if topo.is_time_varying:
            if step is None:
                raise ValueError(f"{type(topo).__name__} is time-varying: round_collective needs step=...")
            topo = topo.phases[step % topo.period]
        if self.config.push_sum_enabled:
            leaves, rebuild = self._select(params)
            mixed, state = pushsum_round_collective(leaves, state, topo, mesh, alive)
            return rebuild(mixed), state
        if self.compressed:
            alive = None  # the config refuses faults with a compressor
        nbrs = None
        if alive is not None and not topo.uses_psum:
            nbrs = collectives.neighbour_flags(alive, topo, mesh)

        def mix(bufs):
            # every buffer mixed in one exchange (the BN statistics ride
            # beside the weights)
            return collectives.mix_buckets(bufs, topo, mesh, alive, nbrs)

        def exchange(x, xhat, s, fused):
            if fused is not None:
                return self._innovation_exchange_fused_collective(topo, x, xhat, s, fused, mesh)
            return self._innovation_exchange_collective(topo, x, xhat, s, mesh)

        return self._round(params, state, step, mix, exchange, stacked=False)

    def _innovation_exchange_collective(self, topo: Topology, x: list, xhat: list, s: list, mesh):
        """The two-step wire's exchange (per-worker view): compress the
        innovation of every bucket, decode it (``xhat += dec``), ship the
        payloads to every neighbour, and fold ``self_weight * dec`` plus
        each neighbour's payload into ``s`` through the codec's
        ``decompress_accumulate`` (the chunked top-k's accumulating
        ``chunk_scatter``: no dense temporary a neighbour)."""
        xhat, finish = self._exchange_start(topo, x, xhat, None, mesh, [], transport=mesh.transport)
        return xhat, finish(s)[0]

    def _innovation_exchange_fused_collective(self, topo: Topology, x: list, xhat: list, s: list,
                                              fused: FusedWirePlan, mesh):
        """The fused wire's exchange (per-worker view): one encode launch a
        bucket gives the payload and ``xhat'``, the payloads ride the
        transport exactly as the two-step wire's, and one
        ``fused_dequantize_accumulate`` launch a bucket folds self and
        every neighbour into ``s`` (sources self first, then each shift
        in order). A dense topology means the decoded innovations."""
        xhat, finish = self._exchange_start(topo, x, xhat, fused, mesh, [], transport=mesh.transport)
        return xhat, finish(s)[0]

    def _exchange_start(self, topo: Topology, x: list, xhat: list, fused: FusedWirePlan | None, mesh,
                        exact: list, computed: list | None = None, transport=None):
        """Both wires' innovation exchange (per-worker view), posted: the
        encode (``xhat'`` and the payloads; the two-step wire's own decode
        too), then one exchange of the payloads with the buffers ``exact``
        beside them (mixed exactly), on ``transport`` (default: the mesh's
        in-flight one). Returns ``(xhat', finish)``; ``finish(s)`` waits
        and gives ``(s', exact_mixed)``: the receive folded into ``s`` (the
        fused wire's one ``fused_dequantize_accumulate`` a bucket, self
        first then each shift; the two-step wire's ``self_weight * dec``
        then each neighbour's ``decompress_accumulate``), and ``exact``
        mixed (``computed[i]``: :meth:`_exact_bufs`'s flag for buffer
        ``i``)."""
        comp = self.config.compressor
        if fused is not None:
            q, xhat = fused.encode(x, xhat)
            dec = fused.decode(q) if topo.uses_psum else None
        else:
            q = [comp.compress(xb - hb) for xb, hb in zip(x, xhat)]
            dec = [comp.decompress(p) for p in q]
            xhat = [hb + d for hb, d in zip(xhat, dec)]
        nb = len(q)
        if topo.uses_psum:
            posted = collectives.all_reduce_mean_start(dec + list(exact), mesh, transport)

            def finish(s):
                means = posted.wait()
                return [sb + r for sb, r in zip(s, means[:nb])], means[nb:]

            return xhat, finish
        per = [p.wire_tensors() for p in q]
        flat = [t for ts in per for t in ts]
        posted = collectives.ppermute_shifts_start(flat + list(exact), topo, topo.shifts, mesh, transport)
        self_dec = None if fused is not None else dec
        del dec

        def finish(s):
            received = posted.wait()
            inflight = []
            for recv in received:
                it = iter(recv[: len(flat)])
                inflight.append([p.with_wire([next(it) for _ in ts]) for p, ts in zip(q, per)])
            mixed = [collectives.combine(e, topo, [recv[len(flat) + i] for recv in received],
                                         computed=computed[i]) for i, e in enumerate(exact)]
            if fused is not None:
                weights = (topo.self_weight,) + tuple(sh.weight for sh in topo.shifts)
                sources = [[qb] + [nbr[i] for nbr in inflight] for i, qb in enumerate(q)]
                return fused.decode_accumulate(s, sources, weights), mixed
            recv = [topo.self_weight * d for d in self_dec]
            for shift, q_nbr in zip(topo.shifts, inflight):
                recv = [comp.decompress_accumulate(p, r, shift.weight) for p, r in zip(q_nbr, recv)]
            return [sb + r for sb, r in zip(s, recv)], mixed

        return xhat, finish

    # ---- overlap gossip (combine-then-adapt) ----------------------------
    def _gossiped_sel(self, tree: Any):
        """``(selected, rebuild)``: the tree itself without a
        ``path_filter``, else the list of the leaves it selects (what an
        :class:`OverlapState`'s corrections are shaped as)."""
        if self.config.path_filter is None:
            return tree, lambda t: t
        return self._select(tree)

    def apply_correction(self, tree: Any, state: OverlapState) -> Any:
        """The round's combine: ``state.correction`` added to the gossiped
        leaves (the others pass through as they are). New tensors."""
        sel, rebuild = self._gossiped_sel(tree)
        return rebuild(T.tree_map(torch.add, sel, state.correction))

    def _anticipated(self, tree: Any, pending: tuple) -> Any:
        """The gossiped leaves plus every correction still queued: the
        params as they will stand when this round's correction lands
        (what keeps depth >= 2 on the plain gossip recurrence)."""
        sel = self._gossiped_sel(tree)[0]
        for p in pending:
            sel = T.tree_map(torch.add, sel, p)
        return sel

    def _exact_bufs(self, leaves: list, stacked: bool):
        """``(bufs, unpack, computed)``: the exact mix's buffers (dense
        buckets on the bucketed wire, else the leaves), the map back to
        leaves, and per buffer whether the reference's program mixes the
        value it computed (``z + pending``: a leaf alone) or a
        concatenation of such values (a bucket of several leaves), which
        it contracts as a loaded f32 value (:func:`~consensusml_tpu_torch.
        comm.collectives.combine`)."""
        if not self.bucketed or not leaves:
            return list(leaves), list, [True] * len(leaves)
        plan = self._dense_plan(leaves, stacked=stacked)
        return (plan.pack(leaves, stacked=stacked), lambda bufs: plan.unpack(bufs, stacked=stacked),
                [len(b.leaves) == 1 for b in plan.buckets])

    def _push_correction(self, state: OverlapState | None, corr: Any, choco) -> OverlapState:
        """The queue's rotation: the head (applied this round) drops,
        ``corr`` joins at the back."""
        queue = (() if state is None else tuple(state.pending)) + (corr,)
        return OverlapState(correction=queue[0], choco=choco, pending=queue[1:])

    def _check_overlap(self, state: OverlapState | None, where: str) -> tuple:
        if not self.config.overlap:
            raise ValueError(f"{where} is overlap gossip's; the config has overlap=False")
        if self.compressed and (state is None or state.choco is None):
            raise ValueError("compressed overlap needs the OverlapState carrying CHOCO tracking (from init_state)")
        if state is None and self.config.pipeline_depth > 1:
            raise ValueError(f"pipeline_depth > 1 needs the current OverlapState (the queue) passed to {where}")
        return () if state is None else tuple(state.pending)

    def correction_simulated(self, tree: Any, w: torch.Tensor, state: OverlapState | None = None) -> OverlapState:
        """The next correction from this round's pre-inner stacked params
        through ``w`` (the caller picks a time-varying topology's phase):
        ``(W - I) z_hat``, or compressed ``gamma (s - xhat)`` from one
        CHOCO exchange over the bucket buffers (BN statistics ``(W - I)
        z_hat``). Bucket by bucket, each input released once used.
        Returns the rotated :class:`OverlapState`."""
        pending = self._check_overlap(state, "correction_simulated")
        sel = self._anticipated(tree, pending)
        if not self.compressed:
            leaves, spec = T.flatten(sel)
            del sel
            bufs, unpack, _ = self._exact_bufs(leaves, stacked=True)
            del leaves
            corr = []
            for i in range(len(bufs)):
                corr.append(simulated.mix_stacked(bufs[i], w) - bufs[i])
                bufs[i] = None
            return self._push_correction(state, T.unflatten(spec, unpack(corr)), None)
        compressed, exact, rebuild = self._partition(sel)
        del sel
        dtypes = [t.dtype for t in compressed]
        plan = self._codec_plan(compressed, stacked=True)
        fused = build_fused_plan(plan, self.config.compressor) if self.fused_wire_active else None
        x = plan.pack([t.to(torch.float32) for t in compressed], stacked=True)
        del compressed
        _check_state(x, state.choco.xhat, True)
        gamma = torch.tensor(self.config.gamma, dtype=torch.float32, device=w.device)
        xhat, s, corr = [], [], []
        for i, (hb, sb) in enumerate(zip(state.choco.xhat, state.choco.s)):
            h, sn = self._exchange_bucket_simulated(x[i], hb, sb, w, fused)
            x[i] = None
            xhat.append(h)
            s.append(sn)
            corr.append(gamma * (sn - h))
        corr_c = [c.to(d) for c, d in zip(plan.unpack(corr, stacked=True), dtypes)]
        e_bufs, e_unpack, _ = self._exact_bufs(exact, stacked=True)
        corr_e = e_unpack([simulated.mix_stacked(b, w) - b for b in e_bufs])
        return self._push_correction(state, rebuild(corr_c, corr_e), ChocoState(xhat=xhat, s=s))

    def correction_collective(self, tree: Any, state: OverlapState | None, mesh, step: int | None = None
                              ) -> OverlapState:
        """:meth:`correction_collective_start` finished at once."""
        return self.correction_collective_start(tree, state, mesh, step).wait()

    def correction_collective_start(self, tree: Any, state: OverlapState | None, mesh, step: int | None = None
                                    ) -> InFlight:
        """THIS rank's next correction from its pre-inner params (per
        worker), its exchange posted on the mesh's in-flight transport
        and left there: the encode, the staging and the requests happen
        here; the returned :class:`~consensusml_tpu_torch.comm.transport.
        InFlight`'s ``wait()`` waits, folds the receive in and returns the
        rotated :class:`OverlapState`. What the correction
        needs at the finish is held apart from ``tree``, so the local
        steps may write the parameters in place in between. ``step``: a
        time-varying topology's phase ``step % period``."""
        pending = self._check_overlap(state, "correction_collective")
        topo = self.topology
        if mesh.topology != topo:
            raise ValueError("the mesh is bound to another topology than this engine's")
        if topo.is_time_varying:
            if step is None:
                raise ValueError(f"{type(topo).__name__} is time-varying: correction_collective needs step=...")
            topo = topo.phases[step % topo.period]
        theirs = T.leaves(tree)  # what the local steps will write in place
        sel = self._anticipated(tree, pending)
        if not self.compressed:
            leaves, spec = T.flatten(sel)
            bufs, unpack, computed = self._exact_bufs(leaves, stacked=False)
            bufs = _owned(bufs, theirs)
            del leaves, sel, theirs
            if topo.uses_psum:
                posted = collectives.all_reduce_mean_start(bufs, mesh)
                mixed = posted.wait
            else:
                posted = collectives.ppermute_shifts_start(bufs, topo, topo.shifts, mesh)
                mixed = lambda: [collectives.combine(b, topo, [r[i] for r in posted.wait()],  # noqa: E731
                                                     computed=computed[i]) for i, b in enumerate(bufs)]

            def finish() -> OverlapState:
                corr = [m - b for m, b in zip(mixed(), bufs)]
                return self._push_correction(state, T.unflatten(spec, unpack(corr)), None)

            return InFlight(finish)
        compressed, exact, rebuild = self._partition(sel)
        del sel
        dtypes = [t.dtype for t in compressed]
        plan = self._codec_plan(compressed)
        fused = build_fused_plan(plan, self.config.compressor) if self.fused_wire_active else None
        x = plan.pack([t.to(torch.float32) for t in compressed])
        _check_state(x, state.choco.xhat, True)
        e_bufs, e_unpack, e_computed = self._exact_bufs(exact, stacked=False)
        e_bufs = _owned(e_bufs, theirs)
        del compressed, exact, theirs
        xhat, fold = self._exchange_start(topo, x, list(state.choco.xhat), fused, mesh, e_bufs, e_computed)
        del x
        gamma = torch.tensor(self.config.gamma, dtype=torch.float32, device=mesh.device)

        def finish() -> OverlapState:
            s, e_mixed = fold(list(state.choco.s))
            corr_c = [c.to(d) for c, d in zip(plan.unpack([gamma * (sb - h) for sb, h in zip(s, xhat)]), dtypes)]
            corr_e = e_unpack([m - e for m, e in zip(e_mixed, e_bufs)])
            return self._push_correction(state, rebuild(corr_c, corr_e), ChocoState(xhat=xhat, s=s))

        return InFlight(finish)

    # ---- accounting -----------------------------------------------------
    def wire_bytes_per_round(self, params: Any) -> int:
        """Bytes ONE worker sends per steady-state round (``params`` are
        per-worker leaves; only their shapes are read), the reference's
        sum: the codec payload of every bucket, or of every compressed
        leaf on the per-leaf wire, plus 4 bytes an element of the
        exact-mixed leaves (all of them for exact mixing), times the sends
        of a round (:meth:`_sends_per_round`) and ``gossip_steps``; push-sum
        adds its f32 mass a send. A leaf the ``path_filter`` leaves out
        ships nothing. Warm-up and refresh rounds ship the dense params
        besides and are not folded in, as in the reference."""
        comp = self.config.compressor
        dense = lambda x: 4 * int(torch.Size(x.shape).numel())  # noqa: E731
        if comp is None:
            payload = sum(dense(x) for x in self._select(params)[0])
        else:
            compressed, exact, _ = self._partition(params)
            if self.config.fused_codec:
                # one payload over the tree laid end to end
                payload = comp.wire_bytes((sum(int(x.numel()) for x in compressed),), torch.float32)
            elif self.bucketed:
                plan = self._codec_plan(compressed)
                payload = sum(comp.wire_bytes((b.total,), torch.float32) for b in plan.buckets)
            else:
                payload = sum(comp.wire_bytes(tuple(x.shape), torch.float32) for x in compressed)
            payload += sum(dense(x) for x in exact)
        sends = self._sends_per_round()
        mass = 4 * sends if self.config.push_sum_enabled else 0
        return int(payload * sends * self.config.gossip_steps + mass)

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
