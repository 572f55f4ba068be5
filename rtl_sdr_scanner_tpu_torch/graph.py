"""Block steps captured once as CUDA graphs and replayed: the port's
counterpart of ``jax.jit(fn, donate_argnums=...)``.

``donated_step(fn, donate=(0, 1, 2))`` wraps an eager step (the JAX
package's jitted steps, eager in the port) and keeps its call signature.
Arguments are trees of tensors (named tuples, tuples, lists) and Python
numbers:

- **Donated arguments** (the carried state) are copied into buffers the
  step owns at the first call of a signature; every call updates those
  buffers in place and returns the buffers themselves as the new state. A
  caller that passes the returned state back costs nothing; one that passes
  other tensors (a state reset at a retune, a slot reset) has them copied
  in. The state a caller held before a call is not kept, as with JAX.
- **Other tensors** are copied device to device into static buffers at
  every call, on the current stream; the caller's tensors are never aliased.
- **Python numbers** (``spectro_keep``'s 1.0 or 0.0) are written into 0-d
  static tensors (``fill_``, no host-to-device copy): a changed value is
  never a new graph, as JAX traces such arguments.
- **Outputs** (what ``fn`` returns after the new state) are fresh tensors
  at every call: the graph's static outputs are cloned on the same stream
  after the replay, so a caller may hold block b's while block b+1 runs.

``fn`` returns its new state first, one tree for each donated argument in
their order, then its outputs (``(state, outs)``, ``(scan_state,
spectro_acc, ddc_state, outs)``).

Graphs are cached on the signature: the tree structure, and the shape,
dtype and device of every tensor (the type of every number). A new
signature is a new capture, counted in ``.captures`` and logged; a dtype or
shape that differs from the captured buffers' is never cast into them.

On the card the first call of a signature runs ``fn`` once eagerly on
clones of the donated state (a warm-up: cuBLAS handles, cuFFT plans, the
kernel wrappers' once-per-device attributes and weight uploads, the span
markers' load, none of which may happen inside a capture; the real state
does not advance), then
captures ``fn`` into a ``torch.cuda.CUDAGraph`` with a private memory pool
and ``capture_error_mode="thread_local"`` (other scanner threads launch
and read meanwhile; captures, which open with device-wide calls, take
turns), then replays it: the state advances once a call. On the CPU the
same buffers and copies run ``fn`` eagerly in place of the replay, so the
CPU tests reach everything but the capture.

Launch counts: the kernel wrappers' ``.launches`` grow by what a capture
records of them at every replay (the warm-up's are taken back out), so a
count still says how often a path went through a kernel. A capture that
another thread's work ended is taken again (``CAPTURE_TRIES``); a capture
that fails every time, or a replay that fails, raises; nothing falls back
to the eager step.

Spans a step opens (``utils/trace.span``: ``fused_step.STAGES``, the
sharded steps' ``channelize``) are host ranges, recorded once, at the
capture; each also writes its two marker kernels into the capture
(``trace_enter_<stage>``, ``trace_exit_<stage>``), so a device trace of
graphed blocks shows every stage of every replay between its markers. The
warm-up loads the markers. What lies outside every span is this layer's own
device work: the input loads before a replay, the state copies at the end
of the body and the output clones after it.

Steps over several shards (``parallel/sharded_scan.py``: the counterpart of
``jax.jit`` over ``shard_map``) are written as a ``Program``: a function
``run(segment, *args)`` that calls ``segment(key, fn, donate, device)(...)``
for each shard's work between two exchanges (a **segment**: ``fn`` on
that shard's ``device``, ``key`` naming the (shard, segment)) and runs the
exchanges (``parallel/collectives.py``, ``parallel/halo.py``) itself,
eagerly. Calling a ``Program`` runs every segment eagerly, its tensors
moved to the segment's device. ``sharded_step(program)`` is its graphed
form: one ``GraphedStep`` a key, built at the key's first call, so that
two shards of equal shapes on one card never share buffers and no graph
holds more than one card's work. Each segment's graph replays with its
card current, once a call: a loop over a block's chunks runs inside a
segment's function (the JAX package's ``lax.scan`` inside ``shard_map``),
not around its calls. A segment donates the state it writes (``donate``):
the state a program returns may be buffers of several segments' graphs.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from rtl_sdr_scanner_tpu_torch.parallel.collectives import on, to
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.trace import load_marks

LABEL = "graph"
NUMBER_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float32}
# one capture at a time in the process: a capture begins with device-wide
# calls (synchronize, empty_cache), which CUDA refuses while another
# thread's capture is open on the card, and which would end that capture
_CAPTURE_LOCK = threading.Lock()
# captures a step takes before it raises: work of another thread can end a
# capture open on the card (the first launch of a kernel loads its module
# there), and the step then captures again; a step that cannot be
# captured fails every time
CAPTURE_TRIES = 3

_LEAF = "leaf"


def _flatten(tree, leaves: list):
    """The tree's structure (hashable); its leaves (tensors, numbers) appended."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor) or type(tree) in NUMBER_DTYPES:
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"donated_step: cannot take a {type(tree).__name__} argument")


def _unflatten(structure, leaves):
    """The tree of ``structure`` over the leaves (an iterator)."""
    if structure is None:
        return None
    if structure == _LEAF:
        return next(leaves)
    typ, children = structure
    items = [_unflatten(c, leaves) for c in children]
    return typ(*items) if hasattr(typ, "_fields") else typ(items)


def _spec(leaf, device: Optional[torch.device] = None) -> tuple:
    """A leaf's part of a signature; ``device``: a segment's, where every
    tensor is copied in from wherever it lies (so the card a tensor comes
    from is no new signature)."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, device or leaf.device)
    return (type(leaf),)


def _describe(specs) -> str:
    return ", ".join(
        f"{s[1]}{list(s[0])}" if len(s) == 3 else s[0].__name__ for s in specs
    )


def _kernel_counts() -> List[Tuple[Callable, int]]:
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

    return [(fn, fn.launches) for fn in kernel_wrappers().values()]


def _restore(counts) -> None:
    for fn, n in counts:
        fn.launches = n


class _Graph:
    """One signature's buffers and, on the card, its captured graph."""

    def __init__(self, step: "GraphedStep", structures: list, leaves: list, specs: Tuple[tuple, ...]):
        """``structures`` and ``leaves``: each argument's (``_flatten``)."""
        # not a reference: a step and its graphs would make a cycle, and a
        # graph's private pool stays reserved until the cycle is collected
        self.step = weakref.proxy(step)
        devices = {s[2] for s in specs if len(s) == 3}
        if step.device is not None:  # a segment: its tensors copied in from any device
            self.device = step.device
        elif len(devices) != 1:
            raise ValueError(f"{step.name}: a graphed step runs on one device, got tensors on {sorted(map(str, devices))}")
        else:
            self.device = devices.pop()
        self.cuda = self.device.type == "cuda"
        self.structures = structures
        self.kinds, self.buffers = [], []  # per argument
        for i, arg_leaves in enumerate(leaves):
            donated = i in step.donate
            if donated and not all(isinstance(x, torch.Tensor) for x in arg_leaves):
                raise TypeError(f"{step.name}: donated argument {i} holds a number")
            self.kinds.append("state" if donated else "input")
            self.buffers.append([self._buffer(x) for x in arg_leaves])
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_outs: list = []
        self.out_structure = None
        self.launches: List[Tuple[Callable, int]] = []
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def _buffer(self, leaf) -> torch.Tensor:
        if isinstance(leaf, torch.Tensor):
            return torch.empty(leaf.shape, dtype=leaf.dtype, device=self.device)
        return torch.zeros((), dtype=NUMBER_DTYPES[type(leaf)], device=self.device)

    def load(self, leaves: list) -> None:
        """This call's arguments (each one's leaves) into the buffers: every
        input, and each donated leaf that is not already the buffer itself."""
        for arg_leaves, kind, bufs in zip(leaves, self.kinds, self.buffers):
            for buf, leaf in zip(bufs, arg_leaves):
                if not isinstance(leaf, torch.Tensor):
                    buf.fill_(leaf)
                elif kind == "input" or not _same(buf, leaf):
                    buf.copy_(leaf)

    def _args(self, state_clones: bool = False) -> list:
        return [
            _unflatten(structure, iter([b.clone() for b in bufs] if state_clones and kind == "state" else bufs))
            for structure, kind, bufs in zip(self.structures, self.kinds, self.buffers)
        ]

    def body(self) -> list:
        """``fn`` on the buffers, its new state copied into the state
        buffers; returns the outputs' leaves (the graph's static outputs)."""
        step = self.step
        result = step.fn(*self._args())
        n = len(step.donate)
        if not isinstance(result, tuple) or len(result) <= n:
            raise TypeError(f"{step.name}: want (new state x {n}, outputs...), got {type(result).__name__}")
        state_bufs = [b for kind, bufs in zip(self.kinds, self.buffers) if kind == "state" for b in bufs]
        storages = {b.untyped_storage().data_ptr() for b in state_bufs}
        new_leaves: list = []
        for k, i in enumerate(step.donate):
            leaves: list = []
            structure = _flatten(result[k], leaves)
            want = [_spec(b) for b in self.buffers[i]]
            if structure != self.structures[i] or [_spec(x) for x in leaves] != want:
                raise TypeError(
                    f"{step.name}: new state {k} ({_describe(map(_spec, leaves))}) is not donated argument {i}'s "
                    f"({_describe(want)})"
                )
            new_leaves += leaves
        out_leaves: list = []
        self.out_structure = _flatten(result[n:], out_leaves)
        if not all(isinstance(x, torch.Tensor) for x in out_leaves):
            raise TypeError(f"{step.name}: outputs must be tensors")
        # a leaf that reads a state buffer the copies below overwrite (and is
        # not that buffer's own new value in place) is taken first
        aliased = lambda x: x.untyped_storage().data_ptr() in storages
        out_leaves = [x.clone() if aliased(x) else x for x in out_leaves]
        new_leaves = [
            x.clone() if aliased(x) and not _same(buf, x) else x for buf, x in zip(state_bufs, new_leaves)
        ]
        for buf, x in zip(state_bufs, new_leaves):
            if x is not buf:
                buf.copy_(x)
        return out_leaves

    def capture(self) -> None:
        """Warm up on clones of the donated state, then capture ``body``."""
        step, dev = self.step, self.device
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            counts = _kernel_counts()
            load_marks()
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                step.fn(*self._args(state_clones=True))
            current.wait_stream(side)
            _restore(counts)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            for attempt in range(1, CAPTURE_TRIES + 1):
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=torch.cuda.Stream(dev),
                                          capture_error_mode="thread_local"):
                        static_outs = self.body()
                    break
                except Exception as exc:  # the capture was refused or ended; the state is untouched
                    _restore(counts)
                    graph.reset()  # what the failed capture took, freed before another capture opens
                    if attempt == CAPTURE_TRIES:
                        raise RuntimeError(f"{step.name}: CUDA graph capture failed {attempt} times: {exc}") from exc
                    logger.warn(LABEL, "{}: capture {} of {} failed, capturing again: {}", step.name, attempt,
                                CAPTURE_TRIES, exc)
            self.launches = [(fn, fn.launches - n) for fn, n in counts]
            _restore(counts)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.static_outs = graph, static_outs
        self.capture_s = time.perf_counter() - t0

    def run(self, leaves: list) -> tuple:
        # the graph's card current for the loads (which may read another
        # card's tensors), the replay and the clones
        with on(self.device):
            self.load(leaves)
            if not self.cuda:
                outs = self.body()
            else:
                if self.graph is None:
                    self.capture()
                self.graph.replay()
                for fn, n in self.launches:
                    fn.launches += n
                outs = self.static_outs
            self.replays += 1
            states = [
                _unflatten(self.structures[i], iter(self.buffers[i])) for i in self.step.donate
            ]
            return (*states, *_unflatten(self.out_structure, iter([x.clone() for x in outs])))


def _same(buf: torch.Tensor, x: torch.Tensor) -> bool:
    """``x`` is ``buf`` (the state the step returned, passed back)."""
    return x is buf or (
        x.data_ptr() == buf.data_ptr() and x.shape == buf.shape and x.stride() == buf.stride()
        and x.dtype == buf.dtype and x.device == buf.device
    )


class GraphedStep:
    """``fn`` with donated state, one captured graph a signature (module
    docstring). ``.fn`` is the eager step; ``.captures`` counts signatures
    captured; ``.capture_log`` holds each capture's signature, seconds and
    the bytes its graph's private pool took (0 on the CPU). ``device``: a
    segment's, where its buffers live and its graphs run; its arguments may
    lie on any device (default: the one device of every argument)."""

    def __init__(self, fn: Callable, donate: Sequence[int] = (), name: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.fn = fn
        self.device = device
        self.donate = tuple(donate)
        if list(self.donate) != sorted(set(self.donate)):
            raise ValueError(f"donated_step: donate {self.donate} must be increasing argument indices")
        self.name = name or getattr(fn, "__qualname__", "step")
        self.captures = 0
        self.capture_log: List[dict] = []
        self._graphs: Dict[tuple, _Graph] = {}

    def __call__(self, *args):
        structures, leaves = [], []
        for arg in args:
            leaves.append([])
            structures.append(_flatten(arg, leaves[-1]))
        specs = tuple(_spec(x, self.device) for arg_leaves in leaves for x in arg_leaves)
        key = (tuple(structures), specs)
        graph = self._graphs.get(key)
        if graph is None:
            graph = _Graph(self, structures, leaves, specs)
            result = graph.run(leaves)
            self._graphs[key] = graph
            self.captures += 1
            self.capture_log.append(
                {"signature": _describe(specs), "seconds": graph.capture_s, "pool_bytes": graph.pool_bytes}
            )
            logger.info(
                LABEL, "{}: capture {} on {} ({:.2f} s, pool {} bytes): {}", self.name, self.captures,
                graph.device, graph.capture_s, graph.pool_bytes, _describe(specs),
            )
            return result
        return graph.run(leaves)

    def graphs(self) -> List[_Graph]:
        """The captured signatures' graphs, in capture order."""
        return list(self._graphs.values())


def donated_step(fn: Callable, donate: Sequence[int] = (), name: Optional[str] = None) -> GraphedStep:
    """``fn`` as a graphed step whose arguments ``donate`` are its state
    (``jax.jit(fn, donate_argnums=donate)``)."""
    return GraphedStep(fn, donate, name)


def _moved(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return to(tree, device)
    if isinstance(tree, (tuple, list)):
        items = [_moved(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def eager_segment(key: Hashable, fn: Callable, donate: Sequence[int] = (), device: Optional[torch.device] = None):
    """A program's segment run eagerly: ``fn`` on its arguments moved to ``device``."""
    if device is None:
        return fn
    return lambda *args: fn(*(_moved(a, device) for a in args))


class Program:
    """A step over several shards as segments and exchanges (module
    docstring): ``run(segment, *args)``. Calling it runs it eagerly."""

    def __init__(self, run: Callable):
        self.run = run

    def __call__(self, *args):
        return self.run(eager_segment, *args)


class ShardedStep:
    """A ``Program`` as CUDA graphs, one ``GraphedStep`` a (shard, segment)
    key (``.segments``, in first-call order). ``.fn`` is the eager program;
    ``.captures``, ``.capture_log`` and ``.graphs()`` gather the segments'."""

    def __init__(self, program: Program, name: str):
        self.fn = program
        self.name = name
        self.segments: Dict[Hashable, GraphedStep] = {}

    def _segment(self, key: Hashable, fn: Callable, donate: Sequence[int] = (),
                 device: Optional[torch.device] = None) -> GraphedStep:
        step = self.segments.get(key)
        if step is None:
            step = self.segments[key] = GraphedStep(fn, donate, f"{self.name} {key}", device)
        return step

    def __call__(self, *args):
        return self.fn.run(self._segment, *args)

    @property
    def captures(self) -> int:
        return sum(s.captures for s in self.segments.values())

    @property
    def capture_log(self) -> List[dict]:
        return [dict(c, segment=key) for key, s in self.segments.items() for c in s.capture_log]

    def graphs(self) -> List[_Graph]:
        return [g for s in self.segments.values() for g in s.graphs()]


def sharded_step(program: Program, name: str) -> ShardedStep:
    """``program`` graphed, a graph a (shard, segment) (``jax.jit`` over
    ``shard_map``, each segment donating what it declares)."""
    return ShardedStep(program, name)


__all__ = ["GraphedStep", "Program", "ShardedStep", "donated_step", "eager_segment", "sharded_step"]
