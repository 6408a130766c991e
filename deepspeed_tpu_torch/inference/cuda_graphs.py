"""Program cache of the ragged engine: the port's counterpart of the JAX
engine's jit caches (``_dev_step_jits``, ``_dev_chunk_jits``,
``_dev_fused_jits``, ``_dev_sched_jits``).

A program is a function of no arguments that reads the engine's persistent
tensors (parameters, paged cache, slot rows, block table, token history,
staging buffers) in place and returns one output tensor. The engine keys it
by the JAX program's statics: ``("step", t, nd, nt, w)``, ``("chunk", k, t,
w)``, ``("fused", t, k, nd, nt, w)`` or ``("sched", k, t, w, d)``.

``ProgramCache.run(key, fn, capture)``:

- on the CPU, or with ``capture=False``, calls ``fn`` eagerly;
- on a CUDA device with ``capture=True``, the first call of a key runs
  ``fn`` eagerly on the cache's side stream, which returns the call's
  output and is the warm-up a capture needs (the kernels' libraries, cuBLAS
  workspaces and the like are set up outside the capture, on the stream
  that captures), and then captures ``fn`` as a ``torch.cuda.CUDAGraph``
  from a memory pool every graph of the cache shares (capturing runs
  nothing); every later call replays the graph, as a jitted program runs
  its compiled form from its second call on. A replay's output is the
  graph's static output tensor: the next replay of that graph overwrites
  it, so the caller copies it out, in stream order, before it replays
  again. A failed capture raises.

A ``LoopProgram`` (the scheduler's ``lax.while_loop`` with early exit) is a
prologue, a body and an epilogue around a bool ``pred`` on the device,
which the prologue sets and each body updates. Eagerly it runs the
prologue, the body while ``pred`` reads true, at most ``k`` times, and the
epilogue: a Python loop that reads ``pred`` before each body. The first
run of a key on the card (its warm-up before the capture) runs the first
body whatever ``pred`` says, so the body's kernels and libraries are set up
outside the capture even when ``warmup()`` runs it on an all-retired batch
(a body with no live row changes no state). On the card the three parts
are captured as three graphs (``keep_graph=True``) from the
shared pool, and ``csrc/graph_loop.cu`` composes them into one graph: the
prologue, ``k`` copies of the body each under a CUDA graph conditional (IF)
node that reads ``pred`` just before it, and the epilogue. A replay is one
graph launch; the bodies after the one that clears ``pred`` are skipped on
the device, with no host read in between. (The card's torch 2.11 does not
expose ``begin_capture_to_if_node``, so the port builds the conditional
nodes itself from the graphs torch captured.)

``ProgramCache.warm(key, fn)`` makes that first call ahead of serving (the
engine's ``warmup()``, the counterpart of the JAX engine's ahead-of-time
compiles), so a key's first dispatch already replays.

The kernel wrappers count their launches in Python, which in a graph runs
once, at capture, and launches nothing. The cache takes each graph's counts
(the counters' change while it captured), puts the counters back, and adds
the counts at every replay, so a counter reads the launches that ran. A
loop replay adds its prologue's and epilogue's counts at once; its body
ran as many times as the program says (the engine reads that count from the
program's own output when it reads the tokens), so ``run_loop`` returns the
counts of one body and the caller adds them per iteration with
``add_iterations``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch

from deepspeed_tpu_torch.ops.cuda import paged_attention as _paged

# (object, attribute) of every counter a ragged forward can move
COUNTERS = ((_paged.paged_decode_attention, "launches"),
            (_paged.ragged_prefill_attention, "launches"),
            (_paged.paged_decode_attention_ref, "calls"),
            (_paged.ragged_prefill_attention_ref, "calls"))


def _counts() -> list[int]:
    return [getattr(obj, attr) for obj, attr in COUNTERS]


def _set_counts(values) -> None:
    for (obj, attr), v in zip(COUNTERS, values):
        setattr(obj, attr, v)


@dataclass
class LoopProgram:
    """Up to ``k`` runs of ``body`` while ``pred`` holds; see the module
    docstring. Calling it runs it eagerly."""

    prologue: Callable[[], None]
    body: Callable[[], None]
    epilogue: Callable[[], torch.Tensor]
    pred: torch.Tensor  # bool, shape (), on the program's device
    k: int

    def __call__(self, warm: bool = False) -> torch.Tensor:
        """Run eagerly; ``warm``: the first body runs whatever ``pred`` says."""
        self.prologue()
        for i in range(self.k):
            if not (warm and i == 0) and not bool(self.pred):
                break
            self.body()
        return self.epilogue()


def _loop_lib():
    from deepspeed_tpu_torch.ops.cuda import _build

    lib = _build.load("graph_loop")
    if lib.dstpu_loop_graph_create.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dstpu_loop_graph_create.argtypes = [p, p, p, p, i, i, ctypes.POINTER(p)]
        lib.dstpu_loop_graph_launch.argtypes = [p, p]
        lib.dstpu_loop_graph_destroy.argtypes = [p]
    return lib


class _LoopGraph:
    """The composed, instantiated loop graph and the three captured graphs
    whose pool holds its tensors."""

    def __init__(self, parts: list, pred: torch.Tensor, k: int):
        self.parts = parts
        self.lib = _loop_lib()
        handle = ctypes.c_void_p()
        raw = [g.raw_cuda_graph() for g in parts]
        rc = self.lib.dstpu_loop_graph_create(*raw, pred.data_ptr(), k, pred.device.index or 0,
                                              ctypes.byref(handle))
        if rc:
            raise RuntimeError(f"composing the loop graph failed: cudaError_t {rc}")
        self.exec = handle.value

    def replay(self) -> None:
        rc = self.lib.dstpu_loop_graph_launch(self.exec, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launching the loop graph failed: cudaError_t {rc}")

    def __del__(self):
        if getattr(self, "exec", None):
            self.lib.dstpu_loop_graph_destroy(self.exec)


class ProgramCache:
    """Programs of one engine on one device; see the module docstring."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self._seen: set = set()
        # key -> (graph, static output, counts a replay adds, counts an iteration adds)
        self._graphs: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self._stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.eager_runs = 0
        self.captures = 0
        self.replays = 0
        self.replayed = [0] * len(COUNTERS)  # what replays added to each counter

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    def run(self, key, fn, capture: bool = True) -> torch.Tensor:
        """``fn()``'s output: eagerly, or through the key's graph (above)."""
        return self._run(key, fn, capture)[0]

    def run_loop(self, key, prog: LoopProgram):
        """A ``LoopProgram``'s output, and the launch counts one body adds
        when this call replayed (None when it ran eagerly and its launches
        are counted already): add them with ``add_iterations`` once the
        program's iteration count is known."""
        return self._run(key, prog, True)

    def add_iterations(self, counts, iterations: int) -> None:
        """Count ``iterations`` replayed bodies of a loop program."""
        self._add([n * iterations for n in counts])

    def warm(self, key, fn) -> None:
        """``run``'s first call of ``key`` (eager, then on the card the
        capture), made ahead of the key's first dispatch; nothing if the key
        ran before."""
        if key not in self._seen:
            self._run(key, fn, True)

    def _run(self, key, fn, capture: bool):
        if not (self.on_card and capture):
            self._seen.add(key)
            self.eager_runs += 1
            return fn(), None
        entry = self._graphs.get(key)
        if entry is None:
            self._seen.add(key)
            self.eager_runs += 1
            if isinstance(fn, LoopProgram):
                out = self._on_side_stream(lambda: fn(warm=True))
                self._capture_loop(key, fn)
            else:
                out = self._on_side_stream(fn)
                self._capture(key, fn)
            return out, None
        graph, out, counts, per_iteration = entry
        graph.replay()
        self._add(counts)
        self.replays += 1
        return out, per_iteration

    def _add(self, counts) -> None:
        _set_counts([v + n for v, n in zip(_counts(), counts)])
        self.replayed = [r + n for r, n in zip(self.replayed, counts)]

    def _on_side_stream(self, fn) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        out.record_stream(cur)  # read on the engine's stream after this
        return out

    def _capture_part(self, fn, keep_graph: bool = False):
        """(graph, output, launch counts) of one capture; the counters are
        put back."""
        before = _counts()
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = fn()
        counts = [v - b for v, b in zip(_counts(), before)]
        _set_counts(before)
        return graph, out, counts

    def _capture(self, key, fn):
        graph, out, counts = self._capture_part(fn)
        self._graphs[key] = (graph, out, counts, None)
        self.captures += 1

    def _capture_loop(self, key, prog: LoopProgram):
        pro, _, c_pro = self._capture_part(prog.prologue, keep_graph=True)
        body, _, c_body = self._capture_part(prog.body, keep_graph=True)
        epi, out, c_epi = self._capture_part(prog.epilogue, keep_graph=True)
        graph = _LoopGraph([pro, body, epi], prog.pred, prog.k)
        self._graphs[key] = (graph, out, [a + b for a, b in zip(c_pro, c_epi)], c_body)
        self.captures += 1
