"""Rank targets that drive the parallel modules on given inputs and
return what came out, as numpy: the cross-checks of the tests
(``tests/test_torch_ring.py``, ``test_torch_ulysses.py``,
``test_torch_pipeline.py``) and ``chip_smoke.py``'s ``sequence_parallel``
phase. Run them through :func:`consensusml_tpu_torch.comm.launch.launch`.

A case's axis is the first ``n`` ranks of the world (``n`` its size; the
other ranks run the case too, on their own axes of ``n``, so every
collective of the world has all its ranks); the parent reads ranks 0 ..
n-1's results.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from consensusml_tpu_torch.comm.check import to_numpy
from consensusml_tpu_torch.comm.mesh import rank_device
from consensusml_tpu_torch.parallel.axis import Axis, make_axes
from consensusml_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_last_stage_mean
from consensusml_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
from consensusml_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["run_cases", "sequence_parallel"]

ATTENTION = {"ring": ring_attention, "ring_flash": ring_flash_attention, "ulysses": ulysses_attention}


def _axes(rank: int, world: int, sizes, device, dist_backend: str = "gloo") -> dict[int, Axis]:
    """One axis a size: the world cut into consecutive groups of ``n``
    (every rank makes every group, in the same order)."""
    out = {}
    for n in sorted(set(sizes)):
        members = [list(range(i, i + n)) for i in range(0, world, n)]
        out[n] = make_axes("sp", members, rank, device, dist_backend)
    return out


def _block(x: np.ndarray, axis: Axis, dim: int, device, dtype) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    blk = np.split(x, axis.size, axis=dim)[axis.index]
    return torch.from_numpy(np.ascontiguousarray(blk)).to(device=device, dtype=dtype)


def _attention_case(case: dict, axis: Axis, device) -> dict:
    dtype = getattr(torch, case.get("dtype", "float32"))
    q, k, v = (_block(case[n], axis, 1, device, dtype).requires_grad_(case.get("grad", False)) for n in "qkv")
    fn = ATTENTION[case["kind"]]
    out = fn(q, k, v, axis, causal=case["causal"])
    res = {"out": to_numpy(out)}
    if case.get("grad"):
        # the local loss sum(o^2): the global loss is the sum of the ranks'
        (o2 := (out.float() ** 2).sum()).backward()
        res.update(dq=to_numpy(q.grad), dk=to_numpy(k.grad), dv=to_numpy(v.grad), loss=float(o2.detach()))
    return res


def _stage_fn(stage_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """This stage's slice of a tanh layer stack, in order."""
    for w in stage_params:
        x = torch.tanh(x @ w)
    return x


def _pipeline_case(case: dict, axis: Axis, device) -> dict:
    w = _block(case["w"], axis, 0, device, torch.float32)
    mb = torch.from_numpy(case["mb"]).to(device)
    stage_fn = _stage_fn
    if case["kind"] == "pipeline_bad":
        stage_fn = lambda w, x: torch.cat([x, x], dim=-1)  # noqa: E731
    if case["kind"] in ("pipeline_fwd", "pipeline_bad"):
        try:
            outs = pipeline_apply(stage_fn, w, mb, axis)
        except ValueError as e:
            return {"error": str(e)}
        return {"out": to_numpy(pipeline_last_stage_mean(outs, axis))}
    tgt = torch.from_numpy(case["tgt"]).to(device)
    if case["kind"] == "pipeline_grad":
        w.requires_grad_(True)
        outs = pipeline_apply(stage_fn, w, mb, axis)
        loss = pipeline_last_stage_mean(((outs - tgt) ** 2).mean(), axis)
        loss.backward()
        return {"grad": to_numpy(w.grad), "loss": float(loss.detach())}
    losses = []  # pipeline_train: plain gradient steps on each stage's layers
    for _ in range(case["steps"]):
        w.requires_grad_(True)
        loss = pipeline_last_stage_mean(((pipeline_apply(stage_fn, w, mb, axis) - tgt) ** 2).mean(), axis)
        (g,) = torch.autograd.grad(loss, [w])
        w = (w - case["lr"] * g).detach()
        losses.append(float(loss.detach()))
    return {"losses": losses}


def run_cases(rank: int, world: int, cases: list, device: str = "cpu") -> list:
    """Each case on this rank's axis of the case's size ``n``: attention
    (``kind`` ring, ring_flash or ulysses; ``q``, ``k``, ``v`` the whole
    ``(B, S, H, D)`` inputs, split on S; ``causal``; ``grad``: also the
    gradients of the local ``sum(o^2)``) or a pipeline (``kind``
    pipeline_fwd, pipeline_grad, pipeline_train or pipeline_bad; ``w`` the
    ``(L, d, d)`` layer stack, split on L, ``mb`` the microbatches, ``tgt``
    the targets). A refused case returns its error's message."""
    dev = rank_device(rank, device)
    axes = _axes(rank, world, [c["n"] for c in cases], dev)
    out = []
    for case in cases:
        axis = axes[case["n"]]
        if case["kind"].startswith("pipeline"):
            out.append(_pipeline_case(case, axis, dev))
            continue
        try:
            out.append(_attention_case(case, axis, dev))
        except ValueError as e:
            out.append({"error": str(e)})
    return out


def _dense_block(q, k_all, v_all, my: int, causal: bool) -> torch.Tensor:
    """The plain dense attention of this rank's queries over the gathered
    sequence, f32 math (the check's reference)."""
    s_blk, s = q.shape[1], k_all.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k_all.float()) / float(q.shape[-1]) ** 0.5
    if causal:
        pos_q = my * s_blk + torch.arange(s_blk, device=q.device)
        logits = logits.masked_fill(~(pos_q[:, None] >= torch.arange(s, device=q.device)[None, :]), -torch.inf)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v_all.float())


def _timed(fn, iters: int, dev) -> float:
    """Host milliseconds a call, the calls ending in a card synchronisation
    (the ring's hops are host-staged, so the host clock is the one)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / iters


def sequence_parallel(rank: int, world: int, shapes: list, seed: int = 0, iters: int = 3,
                      device: str = "cuda") -> list:
    """``chip_smoke.py``'s ``sequence_parallel`` phase on this rank: for
    each ``(b, s_blk, h, d)`` shape, bf16 and causal, over a ring of
    ``world`` ranks on the card: :func:`ring_flash_attention`'s output and
    gradients of ``sum(o * do)`` against the plain dense attention of the
    gathered sequence (its K/V gradients summed over the ranks), then the
    host milliseconds a call of the ring flash forward, forward +
    backward, :func:`ring_attention` and :func:`ulysses_attention` (each
    held to the dense output too), the transport's staging milliseconds
    and bytes, and the offset-form launches of one forward + backward
    (``device="cpu"`` rehearses it on the plain versions)."""
    from consensusml_tpu_torch import kernels

    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    axis = make_axes("sp", [list(range(world))], rank, dev)
    stats = axis.transport.stats
    out = []
    for b, s_blk, h, d in shapes:
        gen = torch.Generator(device=dev).manual_seed(seed)  # the same whole sequence on every rank
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        full = [torch.randn(b, world * s_blk, h, d, generator=gen, device=dev, dtype=dtype) for _ in range(4)]
        q, k, v, do = (x[:, rank * s_blk:(rank + 1) * s_blk].contiguous() for x in full)
        kernels.reset_launch_counts()
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = ring_flash_attention(*leaves, axis, causal=True)
        o.backward(do)
        counts = {n: c for n, c in kernels.launch_counts().items() if c}
        forms = kernels.form_counts()
        offset_launches = {n: forms[n]["offset"] for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                                         "flash_attention_bwd_dkv")}
        # the reference: dense attention of this rank's queries over the
        # whole sequence, its K/V gradients summed over the ranks
        qd, kd, vd = (x.float().requires_grad_(True) for x in (q, full[1], full[2]))
        want = _dense_block(qd, kd, vd, rank, True)
        want.backward(do.float())
        dk_all, dv_all = axis.transport.all_reduce_sum([kd.grad, vd.grad])
        sl = slice(rank * s_blk, (rank + 1) * s_blk)
        errs = {"out": (o.float() - want).abs().max().item(),
                "dq": (leaves[0].grad.float() - qd.grad).abs().max().item(),
                "dk": (leaves[1].grad.float() - dk_all[:, sl]).abs().max().item(),
                "dv": (leaves[2].grad.float() - dv_all[:, sl]).abs().max().item()}
        scale = {"out": want.abs().max().item(), "dq": qd.grad.abs().max().item(),
                 "dk": dk_all[:, sl].abs().max().item(), "dv": dv_all[:, sl].abs().max().item()}
        dense_out = want.detach()
        del qd, kd, vd, want, dk_all, dv_all
        with torch.no_grad():
            other = {name: (fn(q, k, v, axis, causal=True).float() - dense_out).abs().max().item()
                     for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention))}
        before = stats.snapshot()

        def fwd_bwd():
            x = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ring_flash_attention(*x, axis, causal=True).backward(do)

        with torch.no_grad():
            ms_fwd = _timed(lambda: ring_flash_attention(q, k, v, axis, causal=True), iters, dev)
            ms_ring = _timed(lambda: ring_attention(q, k, v, axis, causal=True), iters, dev)
            ms_ulysses = _timed(lambda: ulysses_attention(q, k, v, axis, causal=True), iters, dev)
        ms_fwd_bwd = _timed(fwd_bwd, iters, dev)
        moved = stats.since(before)
        out.append({
            "shape": f"B={b} S={world}x{s_blk} H={h} D={d} causal bf16", "max_abs_err": errs,
            "max_abs_ref": scale, "other_forward_max_abs_err": other, "launches": counts,
            "offset_launches": offset_launches, "ring_flash_fwd_ms": ms_fwd, "ring_flash_fwd_bwd_ms": ms_fwd_bwd,
            "ring_attention_ms": ms_ring, "ulysses_ms": ms_ulysses, "timed_calls": 4 * (iters + 1),
            "staging_ms": moved["staging_ms"], "wire_ms": moved["wire_ms"], "bytes_sent": moved["bytes_sent"],
        })
        del full, q, k, v, do, leaves, o
        torch.cuda.empty_cache()
    return out


def _plain_attention_loss(model):
    """``model``'s loss function on the plain attention (``attn_impl="torch"``)."""
    from consensusml_tpu_torch.models.gpt2 import GPT2LM, gpt2_loss_fn
    from consensusml_tpu_torch.models.llama import LlamaLM, llama_loss_fn

    if isinstance(model, GPT2LM):
        return gpt2_loss_fn(model, attn_impl="torch")
    if isinstance(model, LlamaLM):
        return llama_loss_fn(model, attn_impl="torch")
    raise TypeError(f"no tensor-parallel loss for {type(model).__name__}")


def tp_reference_check(spec: dict, state, tp, mesh, loss_fn, init_params: dict, batch0: dict, round0_loss: float,
                       device) -> dict:
    """``chip_smoke.py``'s ``train_collective_tp`` gates, run by every rank
    of a tensor-parallel collective run after its rounds (``spec
    ["tp_check"]``), against the same program without model axes (a fresh
    bundle, its model not split, its attention the plain version:
    ``attn_impl="torch"``) on the worker's model-index-0 rank, the workers
    in turn on a shared card. The gates so hold the split model and the
    flash kernels at the rank's ``H/tp`` heads against the plain program:

    - a worker step's gradients at the final parameters on round 0's first
      batch (dropout from one seed on both sides): the split leaves'
      gradients gathered from the worker's ranks against the logical
      model's, held to the relative tolerances of ``spec["tp_check"]``
      (the whole tree's error norm and the worst leaf's);
    - round 0's loss: the logical model's ``h`` local steps from the
      worker's initial parameters (``init_params``, host) on round 0's
      batches (``batch0``), with a fresh optimizer state and the worker's
      dropout stream, averaged over the workers, against ``round0_loss``
      (the run's), held to ``spec["tp_check"]["loss_rtol"]``.

    Returns the gates' figures (the same on every rank); raises on a miss."""
    from consensusml_tpu_torch.train.collective import spec_bundle
    from consensusml_tpu_torch.train.local_sgd import init_state, local_steps, on_device

    gates = spec["tp_check"]
    first = {k: v[0, 0].to(device) for k, v in batch0.items()}
    trains = state.params.keys()
    leaves = {n: p[0].detach().requires_grad_(True) for n, p in state.params.items()}
    gen = torch.Generator(device=device).manual_seed(11)
    loss, _ = loss_fn({**state.frozen, **leaves}, {}, first, gen)
    grads = dict(zip(trains, torch.autograd.grad(loss, list(leaves.values()))))
    del leaves, loss
    grads = tp.gather_named(grads)  # the logical gradient, on every rank
    params = tp.gather_named({n: p[0].detach() for n, p in state.params.items()})
    frozen = tp.gather_named(state.frozen)
    out = {}
    plain = None
    if tp.axis.index == 0:
        plain = spec_bundle(spec, device)
        plain.loss_fn = _plain_attention_loss(plain.model)
    if tp.axis.index != 0:  # only model index 0 computes the program without model axes
        del grads, params, frozen
        grads = params = None
    if device.type == "cuda":  # the ranks share the card: free every rank's cached blocks first
        torch.cuda.empty_cache()
    mesh.world_barrier()
    for turn in range(mesh.world_size):
        if tp.axis.index == 0 and turn == mesh.rank:
            leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
            gen = torch.Generator(device=device).manual_seed(11)
            loss, _ = plain.loss_fn({**frozen, **leaves}, {}, first, gen)
            want = torch.autograd.grad(loss, list(leaves.values()))
            del leaves, loss
            diff2 = sum(float(((grads[n].float() - w.float()) ** 2).sum()) for n, w in zip(params, want))
            ref2 = sum(float((w.float() ** 2).sum()) for w in want)
            leaf = max((float((grads[n].float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)), n)
                       for n, w in zip(params, want))
            out = {"grad_rel_err": (diff2 / ref2) ** 0.5, "worst_leaf": leaf[1], "worst_leaf_rel_err": leaf[0]}
            del want, grads
            if device.type == "cuda":
                torch.cuda.empty_cache()
            # round 0 without model axes: the worker's h local steps from its initial parameters
            p0 = {n: t.to(device).unsqueeze(0) for n, t in init_params.items()}
            st = init_state(plain.cfg, {n: t[0] for n, t in p0.items()}, mesh.rank, seed=spec["seed"], frozen=frozen)
            del p0
            batch = on_device(batch0, device)
            steps = [{k: v[0, i] for k, v in batch.items()} for i in range(plain.cfg.h)]
            loss0, _ok = local_steps(plain.cfg, plain.loss_fn, st, 0, steps)
            out["round0_loss_worker"] = float(loss0)
            del st, batch, steps
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        if tp.axis.index == 0:
            mesh.barrier()
    del params
    if tp.axis.index == 0:
        # the workers' mean round-0 loss over the index-0 ranks
        total = mesh.transport.all_reduce_sum([torch.tensor([out["round0_loss_worker"]], dtype=torch.float64,
                                                            device=device)])[0]
        out["round0_loss_plain"] = float(total[0]) / mesh.world_size
    # every rank gets index 0's figures
    keys = ("grad_rel_err", "worst_leaf_rel_err", "round0_loss_plain")
    vals = torch.tensor([out.get(k, 0.0) for k in keys] if tp.axis.index == 0 else [0.0] * len(keys),
                        dtype=torch.float64, device=device)
    vals = tp.axis.transport.all_reduce_sum([vals])[0].tolist()
    res = dict(zip(keys, vals))
    res.update(round0_loss_tp=round0_loss, loss_rel_err=abs(round0_loss - res["round0_loss_plain"])
               / abs(res["round0_loss_plain"]), **{k: v for k, v in gates.items()})
    if not (res["grad_rel_err"] <= gates["grad_rel_tol"] and res["worst_leaf_rel_err"] <= gates["leaf_rel_tol"]
            and res["loss_rel_err"] <= gates["loss_rtol"]):
        raise AssertionError(f"the tensor-parallel run disagrees with the same program without model axes: {res}")
    return res


def tp_train_case(rank: int, world: int, case: dict) -> dict:
    """A tensor-parallel collective run of ``llama_tiny`` (the reference's
    hybrid-parallel test, ``tests/test_hybrid_parallel.py``): ``case`` holds
    the model's config overrides (``model``, with ``dtype`` a torch dtype
    name), the topology (``topology``: ``(family, workers)``), ``tp``
    (ranks a worker), the SGD
    ``lr`` and ``momentum``, ``h``, the stacked ``(W, ...)`` numpy initial
    parameters by port name (``params``, every leaf trained) and the
    stacked ``(W, H, B, S)`` numpy round batches (``batches``). Returns per
    round the loss and consensus error, the logical worker's final
    parameters (the worker's model-index-0 rank), and the wire bytes.
    ``family="gpt2"``: a GPT-2 of ``model``'s config, stepped with
    ``case["cfg"]`` (a ``LocalSGDConfig``: ``gpt2_topk``'s, its codec and
    Adam) on ``topology``; ``tp`` 1 is the same run without model axes."""
    from consensusml_tpu_torch.comm.mesh import WorkerMesh
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.models.llama import LlamaConfig, LlamaLM, llama_loss_fn
    from consensusml_tpu_torch.parallel.sharding import llama_tp_rules
    from consensusml_tpu_torch.parallel.tensor import TensorParallel
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.local_sgd import (LocalSGDConfig, init_state, make_collective_train_step,
                                                       rank_batch)
    from consensusml_tpu_torch.train.optim import sgd

    overrides = {**case["model"], "dtype": getattr(torch, case["model"].get("dtype", "float32"))}
    topology = topology_from_name(*case["topology"])
    if case.get("family") == "gpt2":  # gpt2_topk's own gossip (its codec) and optimizer
        import dataclasses

        from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM, gpt2_loss_fn
        from consensusml_tpu_torch.parallel.sharding import gpt2_tp_rules

        model = GPT2LM(GPT2Config(**overrides), device="cpu")
        cfg = case["cfg"]
        cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, topology=topology))
        loss_fn, rules = gpt2_loss_fn(model), gpt2_tp_rules("tp")
    else:
        model = LlamaLM(LlamaConfig(**overrides), device="cpu")
        cfg = LocalSGDConfig(gossip=GossipConfig(topology=topology), optimizer=sgd(case["lr"], case["momentum"]),
                             h=case["h"])
        loss_fn, rules = llama_loss_fn(model), llama_tp_rules("tp")
    mesh = WorkerMesh.create(topology, "gloo", "cpu", model_axes=(("tp", case["tp"]),))
    tp = TensorParallel(mesh.model, rules) if mesh.model is not None else None
    if tp is not None:
        model.tensor_parallel(mesh.model)
    worker = mesh.rank
    params = {n: torch.from_numpy(np.ascontiguousarray(a[worker])) for n, a in case["params"].items()}
    state = init_state(cfg, params if tp is None else tp.shard_named(params), worker, seed=0)
    if tp is not None and cfg.gossip.compressor is not None:  # the codec's state: the logical tree's
        state.gossip = cfg.engine().init_state({"params": params, "model_state": {}})
    step = make_collective_train_step(cfg, loss_fn, mesh, tp=tp)
    rounds = []
    for batch in case["batches"]:
        state, m = step(state, rank_batch({k: torch.from_numpy(v) for k, v in batch.items()}, worker))
        rounds.append({"loss": float(m["loss"]), "consensus_error": float(m["consensus_error"]),
                       "wire_bytes": m["wire_bytes"]})
    own = {n: p[0] for n, p in state.params.items()}
    index = 0 if tp is None else tp.axis.index
    logical = own if tp is None else tp.gather_named(own)
    return {"rounds": rounds, "worker": worker, "index": index, "params": to_numpy(logical) if index == 0 else None}
