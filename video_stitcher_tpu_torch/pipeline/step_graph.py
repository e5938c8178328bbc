"""One program per frame: the per-frame step as a CUDA graph.

The port's counterpart of the JAX package's per-frame programs
(``Stitcher._build_step``, which jit-compiles ``stitch_pano`` for the
installed geometry, and the jit caches of ``Stitcher.stitch*``): XLA builds
one executable per step, frames' shape and dtype, and geometry, and
dispatches it once per frame with the state as an argument. Here each such
key gets a ``StepProgram`` with fixed buffers for its frames and its
output; the programs of one geometry share one set of buffers for the
state and its tile plan (``StateBuffers``). On the card a program runs the
step once on its buffers (the warm-up: it fills the tap caches and loads
the kernels), captures it with ``torch.cuda.graph`` and then replays it,
one graph launch per frame. A new state or tile plan for the same geometry
is copied into the buffers (``StepPrograms.install``), never captured
again: K1 reads its active tile count from the plan's tensor, so a graph
walks whichever plan was copied last. A new geometry drops the programs.

On the CPU a program's replay runs the same step eagerly on the same
buffers, so everything but the capture itself runs under the CPU tests.
On the card a failed capture or replay raises: there is no eager
fallback.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from video_stitcher_tpu_torch.calib.state import CalibState
from video_stitcher_tpu_torch.ops.remap_strips import remap_strips
from video_stitcher_tpu_torch.ops.resize import keeping_taps
from video_stitcher_tpu_torch.ops.warp_tiles import TilePlan

#: (step name and its static arguments, frames' shape, frames' dtype)
Key = Tuple[tuple, Tuple[int, ...], torch.dtype]
#: step(frames, state, plan) -> output tensor
Step = Callable[[torch.Tensor, CalibState, TilePlan], torch.Tensor]


def _tensors(state: CalibState, plan: TilePlan) -> List[torch.Tensor]:
    """Every tensor of a state and its plan that the step reads."""
    return [state.fused_maps, state.gains, *state.weight_pyr,
            state.valid_mask, plan.order, plan.count]


class StateBuffers:
    """The state and tile plan the programs of one geometry read: copies
    of the installed ones, written over by each later install."""

    def __init__(self, state: CalibState, plan: TilePlan):
        self.state = CalibState(
            fused_maps=state.fused_maps.clone(), gains=state.gains.clone(),
            weight_pyr=tuple(w.clone() for w in state.weight_pyr),
            valid_mask=state.valid_mask.clone())
        self.plan = plan._replace(order=plan.order.clone(),
                                  count=plan.count.clone())

    def copy_from(self, state: CalibState, plan: TilePlan) -> None:
        """Copy a state and its plan into the buffers (on the current
        stream). Raises unless each tensor has its buffer's shape and
        dtype: a state of another geometry."""
        dst, src = _tensors(self.state, self.plan), _tensors(state, plan)
        if len(dst) != len(src) or any(
                d.shape != s.shape or d.dtype != s.dtype
                for d, s in zip(dst, src)):
            raise ValueError("the state or tile plan does not fit the "
                             "installed geometry's buffers")
        for d, s in zip(dst, src):
            d.copy_(s, non_blocking=True)


class StepProgram:
    """One key's program: its frames and output buffers and, on the
    card, the CUDA graph of the step over them and the state buffers."""

    def __init__(self, key: Key, step: Step, buffers: StateBuffers,
                 device: torch.device, stream):
        self.key = key
        self.step = step
        self.buffers = buffers
        self.device = device
        self.stream = stream             # None on the CPU
        with torch.cuda.stream(stream):  # the buffer's work runs there
            self.frames = torch.empty(key[1], dtype=key[2], device=device)
        self.output: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: the tap tables the graph reads, held so none is freed
        self.kept: list = []
        #: K1 launches one replay makes (captured into the graph)
        self.k1_launches = 0
        #: seconds of the warm-up and capture; bytes the capture reserved
        #: for the graph's private pool (its intermediates)
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    @property
    def name(self) -> str:
        step, shape, dtype = self.key
        return (" ".join(str(a) for a in step) + " "
                + str(dtype).replace("torch.", "")
                + "[" + "x".join(str(d) for d in shape) + "]")

    def _run_step(self) -> torch.Tensor:
        return self.step(self.frames, self.buffers.state, self.buffers.plan)

    def capture(self, frames: torch.Tensor) -> None:
        """On the card: copy `frames` in, run the step once, capture it.
        The caller's current stream has the frames and the state ready;
        the program's stream waits for it."""
        if self.stream is None:
            return
        t0 = time.perf_counter()
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream), keeping_taps(self.kept):
            self.frames.copy_(frames)
            self._run_step()
            before = remap_strips.captured
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                self.output = self._run_step()
            self.pool_bytes = torch.cuda.memory_reserved(
                self.device) - reserved
        self.k1_launches = remap_strips.captured - before
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def replay(self, frames: torch.Tensor) -> torch.Tensor:
        """Copy `frames` into the program's buffer, run the step on it
        (the graph on the card) and return a copy of its output, which no
        later replay writes. On the card the work goes on the program's
        stream, after the caller's current stream, and the caller's
        stream waits for it."""
        self.replays += 1
        if self.stream is None:
            self.frames.copy_(frames)
            out = self._run_step()
            if self.output is None:
                self.output = torch.empty_like(out)
            self.output.copy_(out)
            return self.output.clone()
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            self.frames.copy_(frames)
            self.graph.replay()
            out = self.output.clone()
        if frames.is_cuda:
            frames.record_stream(self.stream)
        out.record_stream(caller)
        caller.wait_stream(self.stream)
        remap_strips.launches += self.k1_launches
        return out


class StepPrograms:
    """A Stitcher's programs, one per key, for its installed geometry.
    Every method is called under the stitcher's swap lock, so an install's
    copies never fall between a replay's input copy and its graph, and a
    capture sees no install."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.geom = None
        self._state: Optional[CalibState] = None
        self._plan: Optional[TilePlan] = None
        self.buffers: Optional[StateBuffers] = None
        self.programs: Dict[Key, StepProgram] = {}
        #: captures per key name over this object's life (a geometry
        #: change captures each key again)
        self.captures: Dict[str, int] = {}

    def install(self, geom, state: CalibState, plan: TilePlan) -> None:
        """Install a state and its plan: for the geometry the programs
        were built for, copy them into the state buffers, ordered after
        the caller's current stream (which produced them) and before any
        later replay; for another geometry, drop the programs once their
        last replays have run."""
        if geom != self.geom:
            if self.stream is not None and self.programs:
                self.stream.synchronize()
            self.programs.clear()
            self.buffers = None
            self.geom = geom
        self._state, self._plan = state, plan
        if self.buffers is None:
            return
        if self.stream is None:
            self.buffers.copy_from(state, plan)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.buffers.copy_from(state, plan)
        for t in _tensors(state, plan):
            t.record_stream(self.stream)

    def run(self, step_key: tuple, step: Step, frames: torch.Tensor
            ) -> torch.Tensor:
        """The output of `step` on `frames` and the installed state,
        through the program of (step_key, frames' shape and dtype),
        built and captured at its first use."""
        key = (step_key, tuple(frames.shape), frames.dtype)
        prog = self.programs.get(key)
        if prog is None:
            if self._state is None:
                raise RuntimeError("no state installed: calibrate first")
            if self.buffers is None:
                self._make_buffers()
            prog = StepProgram(key, step, self.buffers, self.device,
                               self.stream)
            prog.capture(frames)
            self.programs[key] = prog
            self.captures[prog.name] = self.captures.get(prog.name, 0) + 1
        return prog.replay(frames)

    def _make_buffers(self) -> None:
        if self.stream is None:
            self.buffers = StateBuffers(self._state, self._plan)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.buffers = StateBuffers(self._state, self._plan)
        for t in _tensors(self._state, self._plan):
            t.record_stream(self.stream)
