"""Count the work of an executable without running it: the port's answer
to XLA's ``cost_analysis()`` and ``memory_analysis()``.

:func:`analyze` runs a callable once under
:class:`torch._subclasses.fake_tensor.FakeTensorMode` with fake copies of
its tensors (arguments, module parameters and buffers, constants it
captures): every op computes shapes and dtypes only, on the device the
real tensors name, so nothing launches, nothing is allocated on a device
and no tensor is written. A :class:`WorkCounter` (a
``TorchDispatchMode`` inside the fake mode) counts each aten op:

- **flops**: ``torch.utils.flop_counter``'s formulas for matmuls,
  convolutions and attention (2 a multiply-add, as XLA counts), one per
  output element for every other op that computes, none for ops that only
  move or make data (copies, casts, gathers, concatenations, factories);
- **bytes**: every input read once and every output written once, by the
  elements its strides reach (a broadcast input counts its storage once);
  views move nothing and count zero;
- **live storage**: each op's new storages are tracked until their last
  tensor dies, so the pass knows its high-water mark of live bytes.

A hand-written kernel counts its work from its arguments' shapes, never
from what runs (:func:`counted`): each kernel wrapper reports its
function's flops and bytes (the figures its bound prices: each operand
read once, each result written once; the operations its function does)
to the active counter, then runs with counting suspended, so the kernel
path (a launch on the card), the plain path (the plain version on CPU
tensors) and the fake pass (the plain version on fake tensors, which
computes nothing) all report the same count. A kernel whose work depends
on its data (paged attention's lengths, a masked row of flash attention)
is priced at the static extent its call is given, as XLA prices a
compiled program.

Fake tensors and the kernels: a kernel wrapper takes the card's route only
for a real CUDA tensor (:func:`on_card`); a fake tensor has no memory to
launch on and runs the plain version, which under the fake mode computes
shapes only.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import time
import weakref
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

__all__ = ["WorkCounter", "Analysis", "analyze", "fakes", "counted", "report", "active", "on_card", "via_meta", "is_fake", "tensor_bytes"]


def on_card(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper launches its kernel on ``t``: a real CUDA
    tensor. A CPU or ``meta`` tensor runs the plain version, and so does a
    fake one (the counting pass's: it has no memory to launch on)."""
    return t.is_cuda and not isinstance(t, FakeTensor)


def _reached(t: torch.Tensor) -> int:
    """Elements ``t``'s strides reach (a stride-0 axis counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


def tensor_bytes(t: torch.Tensor) -> int:
    return _reached(t) * t.element_size()


# ops that move or make data and compute nothing: XLA's cost analysis
# gives them no flops (their bytes still count)
_MOVES = {
    "copy_", "_to_copy", "clone", "contiguous", "cat", "stack", "gather", "index_select", "index", "index_put_",
    "index_put", "scatter", "scatter_", "slice_scatter", "select_scatter", "constant_pad_nd", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill_", "zero_", "fill", "arange", "embedding",
    "repeat", "expand_copy", "_unsafe_view", "lift_fresh", "lift_fresh_copy", "detach", "alias", "scalar_tensor",
    "_local_scalar_dense", "masked_select", "nonzero", "flip", "roll", "tril", "triu", "randperm", "as_strided",
    "split_with_sizes_copy", "unbind_copy", "view_copy", "_reshape_copy", "t_copy", "permute_copy",
}
_RANDOM = {"rand", "randn", "rand_like", "randn_like", "randint", "bernoulli", "bernoulli_", "normal_", "uniform_",
           "native_dropout", "exponential_"}


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry

    return flop_registry.get(func.overloadpacket)


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class WorkCounter(TorchDispatchMode):
    """Counts flops, bytes and live storage of every aten op dispatched
    while it is active (see the module docstring), and the work kernel
    wrappers report (:func:`report`). ``suspended`` > 0 stops the op
    counting (a kernel wrapper's own route runs under it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernels: dict[str, list[float]] = {}  # name -> [calls, flops, bytes]
        self.ops = 0
        self.suspended = 0
        self.live = 0
        self.high_water = 0
        self._seen: set[int] = set()
        self._real: dict[int, weakref.ref] = {}  # id -> the host bookkeeping's real tensors

    def keep_real(self, t: torch.Tensor) -> None:
        """Run the ops that read only ``t`` (and other such tensors) for
        real: a host counter's clone (:class:`_FakeCopier`)."""
        self._real[id(t)] = weakref.ref(t)

    def _host_only(self, ts: list, kwargs) -> bool:
        """Whether an op reads only the pass's real host tensors (a step
        counter's clone and what was made from it; ``ts`` the op's tensors)
        and makes nothing on a device. Any other real tensor (a constant a
        closure captures) joins the fake mode as a fake, so the pass never
        writes it."""
        if not ts or any(self._real.get(id(t), lambda: None)() is not t for t in ts):
            return False
        dev = kwargs.get("device")
        return dev is None or torch.device(dev).type == "cpu"

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        row = self.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = int(st.nbytes())
        self.live += n
        self.high_water = max(self.high_water, self.live)
        weakref.finalize(t, self._release, key, n)

    def _release(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if self._real and self._host_only(ins, kwargs):
            # host bookkeeping (a step counter's read and increment) runs for
            # real on the real clones the pass holds, and what it makes stays
            # host bookkeeping
            with unset_fake_temporarily():
                out = func(*args, **kwargs)
            for t in _tensors(out):
                self.keep_real(t)
        else:
            out = func(*args, **kwargs)
        kind = _op_kind(func)
        if kind is None:  # not aten, or a view: moves nothing
            return out
        makes, computes, formula = kind
        outs = _tensors(out)
        if makes:
            for t in outs:  # new storages, a suspended kernel route's too
                self._track(t)
        if self.suspended:
            return out
        self.ops += 1
        self.bytes += sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        elif computes and ins:
            self.flops += float(sum(t.numel() for t in outs))
        return out


_KINDS: dict = {}


def _op_kind(func):
    """``(makes new storages, computes, flop formula)`` of an aten op, None
    for a view or another namespace's op; cached per overload."""
    try:
        return _KINDS[func]
    except KeyError:
        pass
    if func.namespace != "aten" or func.is_view:
        kind = None
    else:
        name = func.overloadpacket.__name__
        makes = not (name.endswith("_") or any(r.alias_info is not None for r in func._schema.returns))
        kind = (makes, name not in _MOVES and name not in _RANDOM, _flop_formula(func))
    _KINDS[func] = kind
    return kind


def active() -> WorkCounter | None:
    """The counting :class:`WorkCounter` of this thread (autograd's worker
    threads inherit the dispatch modes), or None. Cheap when none is."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, WorkCounter) and not mode.suspended:
            return mode
    return None


@contextlib.contextmanager
def report(name: str, flops: float, nbytes: float):
    """Report a kernel's work to the active counter (if any) and suspend
    the op counting for the body, the route that computes it."""
    c = active()
    if c is None:
        yield
        return
    c.add_kernel(name, flops, nbytes)
    c.suspended += 1
    try:
        yield
    finally:
        c.suspended -= 1


def counted(work: Callable[..., tuple[float, float]], name: str | None = None, meta_route: bool = True):
    """Decorate a kernel wrapper: under an active counter, report
    ``work(*args, **kwargs) -> (flops, bytes)`` (its function's work, from
    its arguments' shapes) under ``name`` (default: the wrapper's) and run
    the wrapper with counting suspended (fake operands through
    :func:`via_meta` unless ``meta_route`` is false: a wrapper whose
    autograd graph must reach its operands routes its fakes itself);
    otherwise call it as it is."""

    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = active()
            if c is None:
                return fn(*args, **kwargs)
            flops, nbytes = work(*args, **kwargs)
            c.add_kernel(label, flops, nbytes)
            c.suspended += 1
            try:
                return via_meta(fn, *args, **kwargs) if meta_route else fn(*args, **kwargs)
            finally:
                c.suspended -= 1

        return wrapper

    return deco


def is_fake(tree) -> bool:
    """Whether a tensor of ``tree`` is a fake (a counting pass runs)."""
    return _fake_device(tree) is not None


def _fake_device(tree):
    for t in _tensors(tree):
        if isinstance(t, FakeTensor):
            return t.device
    return None


def _signature(x):
    """A hashable description of an argument: a tensor by shape, strides and
    dtype, a container by its items, anything else by its repr."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype)
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return (type(x).__name__, tuple(_signature(v) for v in x))
    return ("V", repr(x))


_META_RESULTS: dict = {}  # (fn, argument signature) -> fn's result on meta tensors
_META_RESULTS_MAX = 4096


def via_meta(fn: Callable, *args, **kwargs):
    """``fn`` on fake operands, computed on ``meta`` copies of them and
    returned as fakes on the operands' device: the shapes of a kernel's
    results without its route's device-side setup (a fake CUDA tensor's
    indexing needs the CUDA runtime; a scalar built on the card would be a
    real allocation). The meta computation runs outside the fake mode and
    once a signature (a layer's shapes recur across workers and steps).
    Real operands go to ``fn`` as they are."""
    dev = _fake_device((args, kwargs))
    if dev is None:
        return fn(*args, **kwargs)

    def to(x, device):
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=device)
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(to(v, device) for v in x)
        return x

    key = (fn, _signature(args), _signature(tuple(sorted(kwargs.items()))))
    out = _META_RESULTS.get(key)
    if out is None:
        # real meta tensors, computed outside the fake mode: meta kernels
        # alone, without the fake mode's bookkeeping
        with unset_fake_temporarily():
            out = fn(*[to(a, "meta") for a in args], **{k: to(v, "meta") for k, v in kwargs.items()})
        if len(_META_RESULTS) >= _META_RESULTS_MAX:
            _META_RESULTS.clear()
        _META_RESULTS[key] = out
    return to(out, dev)


class Analysis:
    """What :func:`analyze` counted: ``flops``, ``bytes_accessed``,
    ``argument_bytes``, ``output_bytes``, ``alias_bytes`` (outputs in an
    argument's storage: updated in place), ``temp_bytes`` (the pass's
    high-water mark of live storage it made, less its outputs),
    ``seconds`` (the pass's wall time), ``kernels`` (per kernel wrapper:
    calls, flops, bytes) and ``ops`` (aten ops dispatched)."""

    def __init__(self, counter: WorkCounter, args_bytes: int, out_bytes: int, alias_bytes: int, seconds: float,
                 result: Any):
        self.flops = counter.flops
        self.bytes_accessed = counter.bytes
        self.kernel_flops = counter.kernel_flops
        self.kernel_bytes = counter.kernel_bytes
        self.kernels = {k: {"calls": int(v[0]), "flops": v[1], "bytes": v[2]} for k, v in counter.kernels.items()}
        self.ops = counter.ops
        self.argument_bytes = args_bytes
        self.output_bytes = out_bytes
        self.alias_bytes = alias_bytes
        self.temp_bytes = max(0, counter.high_water - (out_bytes - alias_bytes))
        self.seconds = seconds
        self.result = result


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _unique_bytes(ts) -> tuple[int, set]:
    seen: dict[int, int] = {}
    for t in ts:
        try:
            seen.setdefault(_storage_key(t), int(t.untyped_storage().nbytes()))
        except (RuntimeError, NotImplementedError):
            continue
    return sum(seen.values()), set(seen)


def _host_counter(t: torch.Tensor) -> bool:
    """An integer tensor on the host: a step counter or a schedule's
    count, whose value the step reads (``int(count[w])``)."""
    return (not isinstance(t, FakeTensor) and t.device.type == "cpu" and not t.is_floating_point()
            and not t.is_complex() and t.dtype != torch.bool and t.dim() <= 1)


class _FakeCopier:
    """Fake copies of real tensors (one fake storage a real one) and of
    the objects that hold them (dicts, lists, tuples, named tuples,
    dataclasses, modules), leaving everything else as it is. An integer
    host tensor of at most one axis (a step counter) is cloned for real:
    the pass reads and advances the clone. A ``torch.Generator`` is
    cloned, so a draw in the pass leaves the run's own generator where it
    was."""

    def __init__(self, mode: FakeTensorMode, counter: WorkCounter | None = None):
        self.mode = mode
        self.counter = counter
        self.memo: dict[int, Any] = {}

    def __call__(self, x):
        if id(x) in self.memo:
            return self.memo[id(x)][1]
        if isinstance(x, torch.Tensor) and self.counter is not None and _host_counter(x):
            out = x.clone()
            self.counter.keep_real(out)
        elif isinstance(x, torch.Tensor):
            out = x if isinstance(x, FakeTensor) else self.mode.from_tensor(x)
            if isinstance(x, torch.nn.Parameter) and not isinstance(out, torch.nn.Parameter):
                out = torch.nn.Parameter(out, requires_grad=x.requires_grad)
        elif isinstance(x, torch.Generator):
            out = torch.Generator(device=x.device)
            out.set_state(x.get_state())
        elif isinstance(x, torch.nn.Module):
            out = self._module(x)
        elif isinstance(x, dict):
            out = {k: self(v) for k, v in x.items()} if type(x) is dict else type(x)((k, self(v)) for k, v in x.items())
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            out = type(x)(*[self(v) for v in x])
        elif isinstance(x, (list, tuple)):
            out = type(x)(self(v) for v in x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out = dataclasses.replace(x, **{f.name: self(getattr(x, f.name)) for f in dataclasses.fields(x)
                                            if f.init})
        else:
            return x
        self.memo[id(x)] = (x, out)  # x held: its id is not reused while the memo lives
        return out

    def _module(self, m: torch.nn.Module) -> torch.nn.Module:
        """A copy of ``m`` whose every tensor attribute is fake (the
        original, and any thread using it, untouched); ``m`` itself when
        its tensors are fakes already."""
        memo, keep = {}, []
        for sub in m.modules():
            for v in list(vars(sub).values()) + list(sub._parameters.values()) + list(sub._buffers.values()):
                if isinstance(v, torch.Tensor):
                    memo[id(v)] = self(v)
                    keep.append(v)
        if all(isinstance(v, FakeTensor) for v in keep):
            return m
        return copy.deepcopy(m, memo)


def fakes(*objs: Any) -> list:
    """Fake copies of ``objs`` (as :func:`analyze` makes them) in one new
    fake mode: what several passes over the same state can share, each
    :func:`analyze` of them then taking them as they are."""
    return _FakeCopier(FakeTensorMode(allow_non_fake_inputs=True))(list(objs))


def analyze(fn: Callable, *args: Any, setup: Callable | None = None, **kwargs: Any) -> Analysis:
    """Run ``fn(*args, **kwargs)`` once on fake copies of its arguments
    (tensors, generators, modules and the containers holding them; fakes
    given are taken as they are, in their own fake mode) and count its
    work; ``fn`` may be a closure over modules and constants:
    real tensors it captures join the pass as fakes when an op first
    reads them. ``setup(*fake_args)``, when given, builds further
    arguments (appended to ``args``) from the fakes, in the fake mode but
    not counted: state an executable takes that the caller does not hold.
    Nothing runs on a device, nothing is allocated there, no real tensor
    is written and no generator is advanced. Returns the
    :class:`Analysis` (``result`` holds ``fn``'s fake outputs)."""
    t0 = time.perf_counter()
    # fakes given as arguments (a state built in a fake mode of the caller's)
    # keep their own mode: one pass never mixes two
    given = [t for t in _tensors(_plain_tree([args, kwargs])) if isinstance(t, FakeTensor)]
    mode = given[0].fake_mode if given else FakeTensorMode(allow_non_fake_inputs=True)
    counter = WorkCounter()
    faker = _FakeCopier(mode, counter)
    fargs, fkwargs = faker(list(args)), faker(dict(kwargs))
    if setup is not None:
        with mode:
            fargs = fargs + list(setup(*fargs))
    args_bytes, arg_keys = _unique_bytes(_tensors(_plain_tree([fargs, fkwargs])))
    with mode, counter:
        out = fn(*fargs, **fkwargs)
    outs = _tensors(_plain_tree(out))
    out_bytes, out_keys = _unique_bytes(outs)
    alias = sum(int(t.untyped_storage().nbytes()) for t in
                {_storage_key(t): t for t in outs if _storage_key(t) in arg_keys}.values())
    return Analysis(counter, args_bytes, out_bytes, alias, time.perf_counter() - t0, out)


def _plain_tree(x, depth: int = 0):
    """Containers of a result as plain lists (dataclasses and named tuples
    included), for :func:`_tensors`."""
    if depth > 8:
        return []
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, torch.nn.Module):
        return [*x.parameters(), *x.buffers()]
    if isinstance(x, dict):
        return [_plain_tree(v, depth + 1) for v in x.values()]
    if isinstance(x, (list, tuple)):
        return [_plain_tree(v, depth + 1) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [_plain_tree(getattr(x, f.name), depth + 1) for f in dataclasses.fields(x)]
    return []


def nbytes_of(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    return _unique_bytes(_tensors(_plain_tree(tree)))[0]
