"""Per-shape compiled forwards: the port's counterpart of the reference
engine's ``jax.jit`` per shape key (``_fresh_fns``, ``_suffix_fns``,
``_packed_fns``, ``_packed_hit_fns`` in ``repro.core.engine``).

A ``CompiledForward`` wraps one forward at one set of input shapes. It owns
one static buffer per host input and, on CUDA, a CUDA graph and its static
outputs:

  first call   copy the inputs in; one eager warm-up on a side stream
               under ``torch.cuda.set_sync_debug_mode("error")`` (a host
               sync inside the forward raises; the warm-up also builds the
               kernels on a fresh checkout); capture into the caller's
               memory pool (``CUDAGraph.capture_begin``); replay
  later calls  copy the inputs in, staged in pinned host memory and copied
               with ``non_blocking=True``; replay

On the CPU the same object runs the forward eagerly on the same static
buffers: a rule of device. On CUDA a call replays its graph or raises: a
failed capture raises ``CaptureError`` naming the key, chained (``from``)
to the error of the op that broke it, on that call and every later one,
and nothing runs eagerly in its place.

Rules a caller keeps:

- **Inputs.** Host inputs (numpy arrays, one per name given at
  construction) are copied whole on every call, padding included, so a
  short request never reads a longer one's stale slots. Device inputs are
  static tensors the caller owns (they may be views of one buffer that
  several forwards share, as the engine's prefix buffer is); the caller
  writes them before each call.
- **Outputs.** A call returns the graph's static outputs. The next replay
  of any forward that shares the pool may overwrite them (one graph's
  outputs may lie where another's temporaries do), so the caller consumes
  them (copies to the host, or clones what it keeps) before its next call.
  The engine does: ``_score`` copies each logits row to the host, and the
  kept KV blocks are copied out before the step ends.
- **Launch counters.** The kernel wrappers count launches in Python
  integers, which a replay does not move. At first use the warm-up's and
  the capture's counts are taken back out and the capture's change is
  kept; every replay adds it. The counters then read as if every call had
  run eagerly. That a replay launches what its capture recorded is held on
  the card by profiling one replay of each graph (``chip_smoke.py``).
- **Memory.** ``held_bytes`` is what a forward keeps alive between calls:
  its own static inputs and its static outputs. The engine bounds the sum
  over its forwards and drops the least recently used past it.
- **Other threads.** A capture in CUDA's global error mode fails when any
  thread of the process synchronises or allocates meanwhile, and the
  warm-up's sync debug mode is the process's. A first use holds
  ``capture_lock`` over both; a thread that issues device work beside the
  caller's (the offload tier's prefetch) holds it over that work.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_mlp as _mlp
from repro_torch.kernels import rmsnorm as _rms

Spec = Tuple[Tuple[int, ...], torch.dtype]     # (shape, dtype) of one input
_COUNTED = {"rmsnorm": _rms, "fused_mlp": _mlp, "decode_attention": _da}
# held over every warm-up and capture, and by any thread's device work
# beside them (see the module docstring)
capture_lock = threading.Lock()


class CaptureError(RuntimeError):
    """A forward could not be captured as a CUDA graph."""


def read_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count: ``flash_attention[<mode>]`` per
    attention mode, and ``flash_attention`` their sum."""
    out = {name: m.launches for name, m in _COUNTED.items()}
    out["flash_attention"] = _fa.launches
    out.update({f"flash_attention[{m}]": n
                for m, n in _fa.mode_launches.items()})
    return out


def add_launches(delta: Mapping[str, int]) -> None:
    """Add ``delta`` (``read_launches``'s keys) to the wrappers' counts."""
    for name, n in delta.items():
        if name in _COUNTED:
            _COUNTED[name].launches += n
        elif name.startswith("flash_attention["):
            _fa.mode_launches[name[len("flash_attention["):-1]] += n
        # "flash_attention" is the modes' sum


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for m in _COUNTED.values():
        m.launches = 0
    for mode in _fa.mode_launches:
        _fa.mode_launches[mode] = 0


@functools.lru_cache(maxsize=None)
def side_stream(index: int) -> torch.cuda.Stream:
    """The one side stream of device ``index`` for every warm-up and
    capture: cuBLAS keeps a workspace for each stream it has run on, for
    the life of the process, so a stream per engine or per graph would grow
    device memory with every engine made."""
    return torch.cuda.Stream(torch.device("cuda", index))


def _nbytes(tree) -> int:
    """Bytes of the tensors in a forward's outputs (tuples, dicts, None)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


def _diff(after: Mapping[str, int], before: Mapping[str, int]):
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def _sync_debug_error():
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class CompiledForward:
    """``fn(**inputs)`` compiled for one shape key (see the module
    docstring). ``host`` maps input names to (shape, dtype): the forward
    owns a static buffer for each. ``device`` maps input names to static
    tensors the caller owns and writes. ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) is shared by the caller's forwards,
    and ``stream`` (``side_stream``) by every warm-up and capture.
    ``launches`` is the capture's change of the launch counters,
    ``capture_ms`` the first use's warm-up plus capture, ``pool_bytes``
    what the capture added to the pool."""

    def __init__(self, fn: Callable, name: str, host: Mapping[str, Spec],
                 device: Optional[Mapping[str, torch.Tensor]] = None, *,
                 on: torch.device, pool=None, stream=None):
        self.fn, self.name, self.device = fn, name, on
        self.pool, self.stream = pool, stream
        self.host_specs = dict(host)
        self.inputs = {n: torch.zeros(shape, dtype=dt, device=on)
                       for n, (shape, dt) in host.items()}
        self.inputs.update(device or {})
        self.graphed = on.type == "cuda"     # a rule of device
        self._staging = ({n: torch.zeros(host[n][0], dtype=host[n][1],
                                         pin_memory=True)
                          for n in host} if self.graphed else {})
        self._copied: Optional[torch.cuda.Event] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._failure: Optional[CaptureError] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0

    @property
    def held_bytes(self) -> int:
        """Bytes this forward keeps alive between calls: its own static
        inputs and its static outputs (the caller's device inputs are not
        its own)."""
        own = sum(self.inputs[n].nbytes for n in self.host_specs)
        return own + _nbytes(self.outputs)

    def __call__(self, host: Mapping[str, np.ndarray]):
        self._load(host)
        if not self.graphed:
            return self.fn(**self.inputs)
        if self._failure is not None:
            raise self._failure
        if self.graph is None:
            self._first_use()
        self._replay()
        add_launches(self.launches)
        self.replays += 1
        return self.outputs

    def _load(self, host: Mapping[str, np.ndarray]) -> None:
        if set(host) != set(self.host_specs):
            raise ValueError(f"{self.name}: host inputs {sorted(host)}, "
                             f"expected {sorted(self.host_specs)}")
        arrays = {n: torch.as_tensor(a) for n, a in host.items()}
        for n, a in arrays.items():
            if a.shape != self.inputs[n].shape:
                raise ValueError(f"{self.name}: input {n} has shape "
                                 f"{tuple(a.shape)}, expected "
                                 f"{tuple(self.inputs[n].shape)}")
        if not self._staging:
            for n, a in arrays.items():
                self.inputs[n].copy_(a)
            return
        # the previous call's copies read the staging buffers: let them
        # finish before the host writes them again
        if self._copied is not None:
            self._copied.synchronize()
        for n, a in arrays.items():
            self._staging[n].copy_(a)
            self.inputs[n].copy_(self._staging[n], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()

    def _first_use(self) -> None:
        """Warm up, capture, keep the capture's launch counts; the counters
        end where they started. Raises ``CaptureError``."""
        before = read_launches()
        try:
            with capture_lock:
                t0 = time.perf_counter()
                self._warm_up()
                warm = read_launches()
                graph, outputs = self._capture()
            captured = _diff(read_launches(), warm)
        except Exception as e:
            # a failed capture leaves the pool unusable: every later call
            # raises the same error
            self._failure = CaptureError(
                f"capture of {self.name} failed: {e}")
            raise self._failure from e
        finally:
            add_launches(_diff(before, read_launches()))
        self.graph, self.outputs, self.launches = graph, outputs, captured
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _warm_up(self) -> None:
        """One eager run on the side stream; a host sync in it raises."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream), torch.no_grad(), \
                _sync_debug_error():
            self.fn(**self.inputs)
        main.wait_stream(self.stream)

    def _capture(self):
        """Capture ``fn`` into a graph in the shared pool, on the caller's
        capture stream; records what the capture added to the pool. The
        capture leaves the allocator's cached blocks alone (the
        ``torch.cuda.graph`` context manager would empty the cache, and the
        next eager allocations of every caller would go back to
        ``cudaMalloc``)."""
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: collecting an unreachable
        # engine destroys its graphs and frees its pool, calls a capture
        # does not permit
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream), torch.no_grad():
                graph.capture_begin(pool=self.pool)
                try:
                    outputs = self.fn(**self.inputs)
                finally:
                    graph.capture_end()
        finally:
            if was_enabled:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return graph, outputs

    def _replay(self) -> None:
        self.graph.replay()
