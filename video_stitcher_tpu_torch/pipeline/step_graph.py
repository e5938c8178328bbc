"""Programs: units of device work as CUDA graphs.

The port's counterpart of the JAX package's compiled programs: its
per-frame step (``Stitcher._build_step``, which jit-compiles
``stitch_pano`` for the installed geometry), the jit caches of
``Stitcher.stitch*``, ``stitch_batch``, ``stitch_int16`` and ``output``,
the sharded step (``parallel/shard.py``) and the mesh re-solve's device
stages (``mesh/pipeline.py``). XLA builds one executable per function,
input shapes and dtypes and static arguments, and dispatches it once per
call. Here each such key gets a ``Program``: fixed buffers for its inputs,
the function over them, and on the card the CUDA graph of that function,
replayed once per call. A program may also read a named set of
``Buffers`` that an installer fills (a stitcher's state, its tile plan
and its seam weights): a new value of the same shape and dtype is copied
into them, never captured again. K1 reads its active tile count from the
plan's tensor, so a graph walks whichever plan was copied last.

On the card a program runs its function once on its buffers (the warm-up:
it fills the tables' caches and loads the kernels), captures it with
``torch.cuda.graph`` and then replays it. It keeps every cached table and
constant it read (``ops/resize.keeping_taps``), so that no cache frees
memory the graph reads. On the CPU a launch runs the same function
eagerly on the same buffers, so everything but the warm-up and the
capture runs under the CPU tests. On the card a failed capture or replay
raises: there is no eager fallback.

Traced (``utils/trace``): a capture is a span ``capture`` with the
program's name (its time is ``Program.capture_s``). A program set made
with a `mark` brackets each replay with markers on its stream, outside
the graph (``<mark>.<step>`` before, ``<mark>.end`` after), while the
tracer records.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from video_stitcher_tpu_torch.blend import levels
from video_stitcher_tpu_torch.calib.state import CalibState
from video_stitcher_tpu_torch.ops.remap_strips import remap_strips
from video_stitcher_tpu_torch.ops.resize import keeping_taps
from video_stitcher_tpu_torch.ops.warp_tiles import TilePlan
from video_stitcher_tpu_torch.utils import trace

#: (step name and its static arguments, first input's shape, its dtype)
Key = Tuple[tuple, Tuple[int, ...], torch.dtype]


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tuples, lists, NamedTuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in leaves(x)]
    return []


def clone_tree(tree, device: Optional[torch.device] = None):
    """The tree with each tensor copied into a new contiguous one (on
    `device` when given); everything else as it is."""
    if isinstance(tree, torch.Tensor):
        if device is not None and tree.device != device:
            return tree.to(device, copy=True).contiguous()
        return tree.clone(memory_format=torch.contiguous_format)
    if isinstance(tree, dict):
        return {k: clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(x, device) for x in tree)
    return tree


def check_fits(dst, src, what: str = "value") -> None:
    """Raise unless each tensor of `src` has the shape and dtype of the
    tensor of `dst` in its place."""
    d, s = leaves(dst), leaves(src)
    if len(d) != len(s) or any(a.shape != b.shape or a.dtype != b.dtype
                               for a, b in zip(d, s)):
        raise ValueError(f"the {what} does not fit the installed "
                         f"geometry's buffers")


def copy_into(dst, src, what: str = "value") -> None:
    """Copy each tensor of `src` into the tensor of `dst` in its place (on
    the current stream), skipping a tensor that is its own destination.
    Raises unless each has its buffer's shape and dtype."""
    check_fits(dst, src, what)
    for a, b in zip(leaves(dst), leaves(src)):
        if a is not b:
            a.copy_(b, non_blocking=True)


def on_stream(stream, fn: Callable, reads: Sequence = ()) -> Any:
    """fn() queued on `stream` after the caller's current stream (which
    produced `reads`); the allocator keeps each CUDA tensor of `reads`
    until the stream's work on it has run. On the CPU (no stream), fn()."""
    if stream is None:
        return fn()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        out = fn()
    for t in leaves(list(reads)):
        if t.is_cuda:
            t.record_stream(stream)
    return out


class Buffers:
    """A named set of fixed tensors that programs read and an installer
    fills (``copy_from``): a value is cloned when first installed, later
    values of the same name are copied into the clone. Each name is
    an attribute (``buffers.state``)."""

    def __init__(self, **values):
        self._values = {k: clone_tree(v) for k, v in values.items()}

    def __getattr__(self, name):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def copy_from(self, **values) -> None:
        """Copy each value into the buffers of its name (a name not held
        yet is cloned). Raises, copying nothing, unless each fits."""
        for k, v in values.items():
            if k in self._values:
                check_fits(self._values[k], v, k)
        for k, v in values.items():
            if k in self._values:
                copy_into(self._values[k], v, k)
            else:
                self._values[k] = clone_tree(v)


#: captures under way (``no_collection``), and whether the collector
#: ran before the first of them
_capturing = 0
_collector_was_on = False
_capturing_lock = threading.Lock()


@contextlib.contextmanager
def no_collection():
    """Python's cyclic garbage collector held off while a graph is
    captured. A collection there can free the CUDA graph of a program no
    longer reachable, and destroying a graph while this thread captures
    invalidates the capture (cudaErrorStreamCaptureInvalidated, seen on
    an H100 in the sharded reduction's capture); torch.cuda.graph no
    longer collects before it captures. The garbage waits for the next
    collection after the capture."""
    global _capturing, _collector_was_on
    with _capturing_lock:
        if _capturing == 0:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _capturing += 1
    try:
        yield
    finally:
        with _capturing_lock:
            _capturing -= 1
            if _capturing == 0 and _collector_was_on:
                gc.enable()


#: the kernel wrappers whose launches a replay counts: K1 and the
#: blend's kernels (each counts a launch recorded into a capture in
#: ``.captured``, a replay adds its captured launches to ``.launches``)
COUNTED = (remap_strips, *levels.KERNELS)


class Program:
    """One unit of device work: its input buffers (a list of trees),
    `fn(*inputs)` over them and, on the card, the CUDA graph of `fn`
    captured on `stream` with its outputs at fixed addresses."""

    def __init__(self, name: str, fn: Callable, inputs: list,
                 device: torch.device, stream, key=None,
                 marks: Optional[Tuple[str, str]] = None):
        self.name = name
        self.key = key
        #: the markers around each replay (utils/trace.mark), or None
        self.marks = marks
        self.fn = fn
        self.inputs = inputs
        self.device = device
        self.stream = stream             # None on the CPU
        self.output = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: the cached tables and constants the graph reads, held so that
        #: none is freed
        self.kept: list = []
        #: the launches one replay makes (captured into the graph), by
        #: counted wrapper (COUNTED)
        self.launch_counts: Dict[Callable, int] = {}
        #: seconds of the warm-up and capture; bytes the capture reserved
        #: for the graph's private pool (its intermediates and outputs)
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def _run(self):
        return self.fn(*self.inputs)

    def capture(self) -> None:
        """On the card, run `fn` once on the buffers (the warm-up) and
        capture it. The caller's current stream has the buffers ready;
        the program's stream waits for it."""
        if self.stream is None:
            return
        with trace.span("capture", arg=self.name, timed=True) as span:
            self._capture()
        self.capture_s = span.s

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream), \
                keeping_taps(self.kept):
            self._run()
            before = [k.captured for k in COUNTED]
            with no_collection(), torch.cuda.graph(
                    graph, stream=self.stream,
                    capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                self.output = self._run()
            self.pool_bytes = torch.cuda.memory_reserved(
                self.device) - reserved
        self.launch_counts = {k: k.captured - b
                              for k, b in zip(COUNTED, before)}
        self.graph = graph
        caller.wait_stream(self.stream)

    def _copy_in(self, inputs) -> None:
        for buf, x in zip(self.inputs, inputs):
            copy_into(buf, x, f"input of {self.name}")

    def launch(self, *inputs, after: Sequence = ()):
        """Copy `inputs` into the program's buffers and run `fn` on them:
        on the card one graph replay, on the program's stream after the
        caller's current stream and each stream of `after`, and the
        caller's stream waits for it. Returns the outputs, which the
        next launch writes over on the card."""
        self.replays += 1
        if self.stream is None:
            self._copy_in(inputs)
            self.output = self._run()
            return self.output
        caller = torch.cuda.current_stream(self.device)
        own = caller == self.stream
        if not own:
            self.stream.wait_stream(caller)
        for s in after:
            self.stream.wait_stream(s)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if self.marks is not None:
                trace.mark(self.marks[0], self.device)
            self._copy_in(inputs)
            self.graph.replay()
            if self.marks is not None:
                trace.mark(self.marks[1], self.device)
        if not own:
            for t in leaves(list(inputs)):
                if t.is_cuda:
                    t.record_stream(self.stream)
            caller.wait_stream(self.stream)
        for kernel, n in self.launch_counts.items():
            kernel.launches += n
        return self.output

    @property
    def k1_launches(self) -> int:
        """K1's launches one replay makes."""
        return self.launch_counts.get(remap_strips, 0)

    @property
    def blend_launches(self) -> int:
        """The blend kernels' launches one replay makes."""
        return sum(self.launch_counts.get(k, 0) for k in levels.KERNELS)


def key_name(key: Key) -> str:
    """A program key as text: its step and static arguments, then the
    first input's dtype and shape."""
    step, shape, dtype = key
    return (" ".join(str(a) for a in step) + " "
            + str(dtype).replace("torch.", "")
            + "[" + "x".join(str(d) for d in shape) + "]")


class ProgramSet:
    """Programs keyed by (step, first input's shape and dtype) on one
    device and one stream of their own, each built and captured at its
    key's first use (``launch``) or ahead of it (``prepare``). With
    `mark`, each replay is bracketed by markers (``<mark>.<step>``,
    ``<mark>.end``) while the tracer records."""

    def __init__(self, device: torch.device, mark: Optional[str] = None):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.programs: Dict[Key, Program] = {}
        #: captures per key name over this object's life
        self.captures: Dict[str, int] = {}
        self.mark = mark

    def prepare(self, step_key: tuple, fn: Callable, *inputs,
                share: bool = False) -> Program:
        """The program of (step_key, inputs[0]'s shape and dtype): built,
        with `inputs` cloned as its buffers, and captured (on the card,
        after `fn` ran once on them) unless it exists. With `share`, an
        input whose tensors all lie on this device is its own buffer
        (another program's outputs, read where they are)."""
        first = leaves(inputs[0])[0]
        key = (step_key, tuple(first.shape), first.dtype)
        prog = self.programs.get(key)
        if prog is None:
            def buffer(x):
                if share and all(t.device == self.device
                                 for t in leaves(x)):
                    return x
                return clone_tree(x, self.device)
            bufs = on_stream(self.stream,
                             lambda: [buffer(x) for x in inputs], inputs)
            marks = None if self.mark is None else (
                f"{self.mark}.{step_key[0]}".replace(" ", "_"),
                f"{self.mark}.end")
            prog = Program(key_name(key), fn, bufs, self.device,
                           self.stream, key, marks)
            prog.capture()
            self.programs[key] = prog
            self.captures[prog.name] = self.captures.get(prog.name, 0) + 1
        return prog

    def launch(self, step_key: tuple, fn: Callable, *inputs):
        """fn(*inputs) through its key's program: its outputs, which the
        key's next launch writes over."""
        return self.prepare(step_key, fn, *inputs).launch(*inputs)

    def clear(self) -> None:
        """Drop the programs once their last replays have run."""
        if self.stream is not None and self.programs:
            self.stream.synchronize()
        self.programs.clear()


class StepPrograms(ProgramSet):
    """A Stitcher's programs for its installed geometry: one per key of
    its unsharded entries, all reading one set of Buffers (`buffers`:
    the state, its tile plan and the calibration's seam weights) that
    every install fills. Every method is called under the stitcher's
    swap lock, so an install's copies never fall between a replay's input
    copy and its graph, and a capture sees no install."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.geom = None
        #: the values last installed, by name
        self._values: Dict[str, Any] = {}
        self.buffers: Optional[Buffers] = None

    def install(self, geom, state: CalibState, plan: TilePlan,
                **extra) -> None:
        """Install a state, its plan and any other named values (None
        leaves a name as it is): for the geometry the programs were built
        for, copy them into the buffers, ordered after the caller's
        current stream (which produced them) and before any later replay;
        for another geometry, drop the programs once their last replays
        have run."""
        if geom != self.geom:
            self.clear()
            self.buffers = None
            self._values = {}
            self.geom = geom
        values = dict(state=state, plan=plan,
                      **{k: v for k, v in extra.items() if v is not None})
        if self.buffers is not None:
            buffers = self.buffers
            on_stream(self.stream, lambda: buffers.copy_from(**values),
                      values.values())
        self._values.update(values)

    def run(self, step_key: tuple, step: Callable, *inputs) -> Any:
        """step(buffers, *inputs) on the installed values through the
        program of (step_key, inputs[0]'s shape and dtype), built and
        captured at its first use. Returns a copy of its outputs, which
        no later call writes."""
        if "state" not in self._values:
            raise RuntimeError("no state installed: calibrate first")
        if self.buffers is None:
            values = self._values
            self.buffers = on_stream(self.stream,
                                     lambda: Buffers(**values),
                                     values.values())
        buffers = self.buffers
        prog = self.prepare(step_key, lambda *x: step(buffers, *x), *inputs)
        prog.buffers = buffers
        out = prog.launch(*inputs)
        if self.stream is None:
            return clone_tree(out)
        with torch.cuda.stream(self.stream):
            out = clone_tree(out)
        caller = torch.cuda.current_stream(self.device)
        for t in leaves(out):
            t.record_stream(caller)
        caller.wait_stream(self.stream)
        return out
