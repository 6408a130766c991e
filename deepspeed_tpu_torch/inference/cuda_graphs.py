"""Program cache of the ragged engine: the port's counterpart of the JAX
engine's jit caches (``_dev_step_jits``, ``_dev_chunk_jits``,
``_dev_fused_jits``).

A program is a function of no arguments that reads the engine's persistent
tensors (parameters, paged cache, slot rows, block table, staging buffers)
in place and returns one output tensor. The engine keys it by the JAX
program's statics: ``("step", t, nd, nt, w)``, ``("chunk", k, t, w)`` or
``("fused", t, k, nd, nt, w)``.

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

``ProgramCache.warm(key, fn)`` makes that first call ahead of serving (the
engine's ``warmup()``, the counterpart of the JAX engine's ahead-of-time
compiles), so a key's first dispatch already replays.

The kernel wrappers count their launches in Python, which in a graph runs
once, at capture, and launches nothing. The cache takes each graph's counts
(the counters' change while it captured), puts the counters back, and adds
the counts at every replay, so a counter reads the launches that ran.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.cuda import paged_attention as _paged

# (object, attribute) of every counter a ragged forward can move
COUNTERS = ((_paged.paged_decode_attention, "launches"),
            (_paged.ragged_prefill_attention, "launches"),
            (_paged.paged_decode_attention_ref, "calls"),
            (_paged.ragged_prefill_attention_ref, "calls"))


class ProgramCache:
    """Programs of one engine on one device; see the module docstring."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self._seen: set = set()
        self._graphs: dict = {}  # key -> (graph, static output, counts a replay adds)
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
        if not (self.on_card and capture):
            self._seen.add(key)
            self.eager_runs += 1
            return fn()
        entry = self._graphs.get(key)
        if entry is None:
            self._seen.add(key)
            self.eager_runs += 1
            out = self._on_side_stream(fn)
            self._capture(key, fn)
            return out
        graph, out, counts = entry
        graph.replay()
        for i, ((obj, attr), n) in enumerate(zip(COUNTERS, counts)):
            setattr(obj, attr, getattr(obj, attr) + n)
            self.replayed[i] += n
        self.replays += 1
        return out

    def warm(self, key, fn) -> None:
        """``run``'s first call of ``key`` (eager, then on the card the
        capture), made ahead of the key's first dispatch; nothing if the key
        ran before."""
        if key not in self._seen:
            self.run(key, fn)

    def _on_side_stream(self, fn) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        out.record_stream(cur)  # read on the engine's stream after this
        return out

    def _capture(self, key, fn):
        before = [getattr(obj, attr) for obj, attr in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = fn()
        counts = []
        for (obj, attr), was in zip(COUNTERS, before):
            counts.append(getattr(obj, attr) - was)
            setattr(obj, attr, was)
        self._graphs[key] = (graph, out, counts)
        self.captures += 1
