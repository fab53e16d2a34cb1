"""The train step's one path: chunks of K steps, each captured as one CUDA
graph where :func:`should_capture` says so.

Counterpart of the JAX trainer's compiled step
(:mod:`deepfluids_tpu.train.trainer`): ``jax.jit`` of one step, and
``--steps_per_call K``'s ``lax.scan`` of K steps over a gather from the
device cache (``[K, B]`` indices) or over stacked batches.  Every run takes
:class:`StepGraph`'s body: K updates (the batch, the x-mirror, the loss,
backward, clipping and Adam at its step's rate) read from static device
tensors, which :meth:`StepGraph.fill` sizes from the first host block of
``[K, ...]`` rows it gets and fills once a chunk, on the card through two
page-locked staging sets in turns (one is written again only after its
last copy's event).  What the rows hold is the trainer's business.

On one CUDA card ("de" / "ae") the first chunk of each ``Trainer.train``
call runs the body eagerly on a side stream (it builds the kernel library,
plans cuDNN and creates Adam's state); the second is captured into one
``torch.cuda.CUDAGraph`` with a memory pool of its own, then replayed once
a chunk, its last step's losses the static outputs (JAX's ``aux[-1]``).
No extra step is taken, so the trajectory is the uncaptured body's.  An FD
launch under capture counts in ``cuda_fd.capture_counts``; each replay
adds those counts to ``cuda_fd.launch_counts``.  A capture or replay that
fails raises: there is no uncaptured fallback.

Spans (:mod:`..spans`): ``train.fill`` (with ``train.stage_wait``),
``train.warmup``, ``train.capture`` (its length is ``capture_s``) and
``train.replay`` (a replay, or an uncaptured body); none inside a capture.
"""

from __future__ import annotations

import gc

import torch

from deepfluids_tpu_torch import spans
from deepfluids_tpu_torch.ops import cuda_fd


def _not_one_card_field(c, device: torch.device, layout) -> str | None:
    """Why a run is not a one-card "de" / "ae" run on a CUDA card, or
    None."""
    if device.type != "cuda":
        return f"the device is {device.type}, not a CUDA card"
    if layout.data.active or layout.model.active:
        return ("a multi-rank layout: its gradients' collectives are not "
                "captured")
    if c.arch not in ("de", "ae"):
        return (f"arch {c.arch}: its code windows and --nn_noise stream are "
                "made on the host each step")
    return None


def device_lr(c, device: torch.device, layout) -> bool:
    """Whether the run's Adam is capturable, with its rate in a device
    tensor: every one-card "de" / "ae" run on a CUDA card, captured or not
    (``--debug_nans``), so both do the same arithmetic."""
    return _not_one_card_field(c, device, layout) is None


def should_capture(c, device: torch.device, layout) -> tuple[bool, str]:
    """(whether a run of config ``c`` on ``device`` under ``layout``
    captures its chunk body into a CUDA graph, the reason)."""
    why = _not_one_card_field(c, device, layout)
    if why is None and c.debug_nans:
        why = "--debug_nans reads every step's loss and gradients"
    if why is not None:
        return False, why
    return True, (f"one card, arch {c.arch}: --steps_per_call "
                  f"{max(1, c.steps_per_call)} steps a CUDA graph replay")


class StepGraph:
    """The static inputs of a chunk of ``k`` steps of ``trainer`` and the
    chunk's body: captured into a CUDA graph after one eager warm-up chunk
    (``capture``), or run eagerly every chunk."""

    def __init__(self, trainer, k: int, capture: bool):
        self.trainer, self.k, self.capture = trainer, k, capture
        self.static: dict[str, torch.Tensor] = {}   # sized by the 1st fill
        self._staging: list[dict[str, torch.Tensor]] = []
        self._rates = None                  # the last block's host rates
        self._events: list[torch.cuda.Event | None] = [None, None]
        self._slot = 0
        self._warm = False
        self.graph: torch.cuda.CUDAGraph | None = None
        self.aux: dict[str, torch.Tensor] | None = None
        self.captured: dict[str, int] = {}  # FD launches a replay
        self.capture_s = 0.0
        self.pool_bytes = 0                 # reserved by the capture
        self.replays = 0

    def _allocate(self, block: dict) -> None:
        """The static tensors (and, on the card, two page-locked staging
        sets) of ``block``'s names, shapes and dtypes."""
        like = {n: torch.stack([torch.as_tensor(r) for r in rows])
                if isinstance(rows, (list, tuple)) else torch.as_tensor(rows)
                for n, rows in block.items()}
        dev = self.trainer.device
        self.static = {n: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                       for n, v in like.items()}
        self._staging = [self.static] if dev.type != "cuda" else [
            {n: torch.zeros(v.shape, dtype=v.dtype, pin_memory=True)
             for n, v in like.items()} for _ in range(2)]

    def fill(self, block: dict) -> None:
        """The static inputs of the next chunk from host ``block``: per
        name an array ``[k, ...]`` or a list of ``k`` rows, ``"lr"`` the
        steps' rates."""
        with spans.span("train.fill"):
            if not self.static:
                self._allocate(block)
            self._rates = block["lr"]
            slot = self._slot
            stage = self._staging[slot]
            if self._events[slot] is not None:
                with spans.span("train.stage_wait"):
                    self._events[slot].synchronize()  # its last copy has run
            for name, rows in block.items():
                dst = stage[name]
                if isinstance(rows, (list, tuple)):
                    for i, row in enumerate(rows):
                        dst[i].copy_(torch.as_tensor(row))
                else:
                    dst.copy_(torch.as_tensor(rows))
            if stage is self.static:
                return
            for name, dst in self.static.items():
                dst.copy_(stage[name], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._events[slot] = event
            self._slot = 1 - slot

    def _body(self) -> dict[str, torch.Tensor]:
        """The chunk's ``k`` updates on the static inputs; the last one's
        losses.  Each update gets its global index (updates done before
        it), its row of each static input and its host rate, which only an
        uncaptured run reads (a captured body does not depend on them)."""
        t, s = self.trainer, self.static
        for i in range(self.k):
            aux = t._block_update(t.step + i, {n: v[i] for n, v in s.items()},
                                  float(self._rates[i]))
        return aux

    def run(self) -> dict[str, torch.Tensor]:
        """One chunk of ``k`` steps on the filled inputs; the last step's
        losses as device tensors (under a graph its static outputs, which
        the next replay overwrites: read them before it)."""
        if not self.capture:
            with spans.span("train.replay"):
                return self._body()
        dev = self.trainer.device
        if not self._warm:
            with spans.span("train.warmup"):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    aux = self._body()
                torch.cuda.current_stream(dev).wait_stream(side)
            self._warm = True
            return aux
        if self.graph is None:
            with spans.span("train.capture") as took:
                self._capture()
            self.capture_s = took.ns * 1e-9
        with spans.span("train.replay"):
            self.graph.replay()
            cuda_fd.count_replay(self.captured)
        self.replays += 1
        return self.aux

    def _capture(self) -> None:
        dev = self.trainer.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        cuda_fd.capture_counts.update(dict.fromkeys(cuda_fd.capture_counts,
                                                    0))
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: a dead trainer's graph
        # freed there (CUDAGraph.reset) would invalidate it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a host thread of the input pipeline (grain's
            # pinning thread) may allocate while this one captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                aux = self._body()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.captured = {n: c for n, c in cuda_fd.capture_counts.items()
                         if c}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.aux = graph, aux
