"""Spawn the ranks of the collective backend on this host.

:func:`launch` starts ``world`` processes (``torch.multiprocessing``'s
``spawn`` context), makes the ``torch.distributed`` process group in each,
calls ``target(rank, world, *args)`` there, and returns every rank's
result to the parent in rank order. It never hangs and never swallows a
failure:

- a rank whose target raises sends its traceback; the parent then kills
  every rank and raises :class:`RankFailed` with that rank's traceback
  (when several fail, the one that failed first: a rank that dies breaks
  its peers' connections, and their errors come after its own);
- a rank that dies without a result (a signal, ``os._exit``: its
  watchdog's code 3, say) fails the run the same way, with its exit code
  (``RankFailed.exit_codes`` holds every such rank's);
- given a ``timeout``, past it the parent kills every rank and raises
  ``TimeoutError`` (a stalled peer is otherwise ended by the process
  group's own timeout, which fails its rank).

The group's rendezvous is a file in a fresh temporary directory
(``init_method="file://..."``), so concurrent launches (parallel test
workers) never race for a TCP port. Targets must be importable by module
path (spawned children import them afresh) and return picklable values;
plain numbers, numpy arrays and dicts of them travel best.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

__all__ = ["launch", "RankFailed"]

_POLL_S = 0.05
# after a first failure, how long the parent gathers the others' before it
# names the earliest
_GRACE_S = 2.0


class RankFailed(RuntimeError):
    """A rank of a :func:`launch` raised or died; the message carries its
    traceback (or exit code), ``exit_codes`` the exit code of every rank
    that died without a result, by rank."""

    def __init__(self, rank: int, detail: str, exit_codes: dict[int, int] | None = None):
        super().__init__(f"rank {rank} failed:\n{detail}")
        self.rank = rank
        self.exit_codes = exit_codes or {}


def _rank_main(target: Callable, rank: int, world: int, init_method: str, dist_backend: str, threads: int,
               results, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    if threads > 0:
        torch.set_num_threads(threads)
    status, payload, failed_at = "ok", None, None
    try:
        # NCCL picks the rank's card from the current device
        if dist_backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(dist_backend, init_method=init_method, rank=rank, world_size=world)
        try:
            payload = target(rank, world, *args)
        except BaseException:
            # stamped before the group goes down, which breaks the peers'
            # connections and so makes their errors later than this one
            failed_at = time.time()
            raise
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises it
        status, payload, failed_at = "error", traceback.format_exc(), failed_at or time.time()
    results.put((rank, status, payload, failed_at))
    results.close()
    results.join_thread()
    if status != "ok":
        os._exit(1)


def launch(target: Callable, world: int, *args: Any, dist_backend: str = "gloo", timeout: float | None = None,
           threads: int | None = None, per_worker: int = 1) -> list:
    """``[target(r, n, *args) for r in range(n)]`` with ``n = world *
    per_worker`` (``per_worker``: the ranks of a worker under model axes,
    :class:`~.mesh.WorkerMesh`), each in its own spawned process of one
    ``dist_backend`` process group. ``timeout`` is
    the wall-clock limit in seconds (``None``: none). ``threads`` caps each
    rank's intra-op CPU threads (default: an even split of the host's
    cores, since the ranks share them; 0 leaves PyTorch's default).
    Raises :class:`RankFailed` or ``TimeoutError`` as the module docstring
    says; every rank is dead when it returns or raises."""
    import torch.multiprocessing as mp

    if world < 1 or per_worker < 1:
        raise ValueError(f"world and per_worker must be >= 1, got {world} and {per_worker}")
    world *= per_worker
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="cml-launch-")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [
        ctx.Process(target=_rank_main, name=f"cml-rank-{r}", daemon=True,
                    args=(target, r, world, init_method, dist_backend, threads, results, args))
        for r in range(world)
    ]
    out: dict[int, Any] = {}
    errors: dict[int, tuple[float, str]] = {}
    codes: dict[int, int] = {}  # exit codes of ranks that died without a result
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        grace = None
        while len(out) + len(errors) < world:
            now = time.monotonic()
            if grace is not None and now > grace:
                break
            if deadline is not None and now > deadline:
                missing = [r for r in range(world) if r not in out and r not in errors]
                raise TimeoutError(f"ranks {missing} of {world} did not finish within {timeout} s")
            try:
                rank, status, payload, failed_at = results.get(timeout=_POLL_S)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and r not in errors and p.exitcode is not None and not p.is_alive():
                        # its result may still sit in the pipe: give it a moment
                        try:
                            rank, status, payload, failed_at = results.get(timeout=1.0)
                        except queue.Empty:
                            rank, status = r, "error"
                            payload, failed_at = f"died with exit code {p.exitcode} and no result", time.time()
                            codes[r] = p.exitcode
                        break
                else:
                    continue
            if status == "ok":
                out[rank] = payload
                continue
            errors[rank] = (failed_at, payload)
            if grace is None:
                grace = time.monotonic() + _GRACE_S
        if errors:
            first = min(errors, key=lambda r: errors[r][0])
            others = sorted(set(errors) - {first})
            note = f"\n(ranks {others} failed after it)" if others else ""
            raise RankFailed(first, errors[first][1] + note, codes)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
