"""The train step as one CUDA graph: K steps a replay.

Counterpart of the JAX trainer's compiled step
(:mod:`deepfluids_tpu.train.trainer`): ``jax.jit(step,
donate_argnums=(0,))``, one device program a step, and ``--steps_per_call
K``'s ``lax.scan`` of K steps, over a gather from the device cache
(``_get_cached_multi``, fed ``[K, B]`` indices) or over stacked batches
(``_get_train_multi``).  On a CUDA card :class:`StepGraph` captures one
chunk of K steps (for each: the batch gathered or taken, the x-mirror, the
loss through the FD kernels, backward, ``clip_by_global_norm_`` and Adam at
its step's rate) into one ``torch.cuda.CUDAGraph`` with a memory pool of
its own, and replays it once a chunk; the last step's losses are its static
outputs, as JAX returns ``aux[-1]``.  K = 1 is the counterpart of the
jitted step, K > 1 of the scan.

A chunk reads only static device tensors, filled from the host once a
chunk (:meth:`StepGraph.fill`): ``lr`` ``[K]`` (the schedule's table),
``mask`` ``[K, B]`` (``--augment_flip_x``) and either ``idx`` ``[K, B]``
(``--device_data_cache``; ``[K, 2B]`` ``[t ; successor]`` pairs under
``--ae_pred_w``) or the batches ``x`` ``[K, B, *field]`` and ``y`` ``[K,
B, P]`` (the native stream and grain).  On the card each block is written
into page-locked staging (two of them, in turns) and copied to the static
tensors ``non_blocking``; a staging buffer is written again only after
the event of its last copy has passed.

The first chunk of each ``Trainer.train`` call runs the same body eagerly
on a side stream (it builds the kernel library, plans cuDNN and creates
Adam's state); the second is captured, then replayed; no extra step is
taken, so the trajectory is the eager body's.  A launch of an FD kernel
under capture counts in ``cuda_fd.capture_counts``; each replay adds
those counts to ``cuda_fd.launch_counts``.  A capture or replay that fails
raises: there is no eager fallback.

The host's part of a chunk is timed by spans (:mod:`..spans`):
``train.fill`` (with ``train.stage_wait``, the wait on a staging buffer's
event), ``train.warmup``, ``train.capture`` (its length is ``capture_s``)
and ``train.replay`` (on the chunked path, the body run eagerly); none is
opened inside the captured body.

:func:`choose_path` decides where the graph applies.
"""

from __future__ import annotations

import gc

import torch

from deepfluids_tpu_torch import spans
from deepfluids_tpu_torch.ops import cuda_fd

GRAPH = "graph"   # K steps captured once, replayed once a chunk
CHUNK = "chunk"   # the graph's body run eagerly (comparisons, the CPU)
EAGER = "eager"   # Trainer._train_step a step


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
    tensor: every one-card "de" / "ae" run on a CUDA card, graph or not
    (``--debug_nans``), so both do the same arithmetic."""
    return _not_one_card_field(c, device, layout) is None


def choose_path(c, device: torch.device, layout) -> tuple[str, str]:
    """(``GRAPH`` or ``EAGER``, the reason) for a run of config ``c`` on
    ``device`` under ``layout``."""
    why = _not_one_card_field(c, device, layout)
    if why is None and c.debug_nans:
        why = "--debug_nans reads every step's loss and gradients"
    if why is not None:
        return EAGER, why
    return GRAPH, (f"one card, arch {c.arch}: --steps_per_call "
                   f"{max(1, c.steps_per_call)} steps a CUDA graph replay")


class StepGraph:
    """The static inputs of a chunk of ``k`` steps of ``trainer`` and the
    chunk's body: captured into a CUDA graph after one eager warm-up chunk
    (``capture``), or run eagerly every chunk."""

    def __init__(self, trainer, k: int, capture: bool):
        t = trainer
        self.trainer, self.k, self.capture = t, k, capture
        dev, m = t.device, t.manifest
        rows = t.c.batch_size * (2 if t.pair_mode else 1)
        f32 = torch.float32
        shapes = {"lr": ((k,), f32)}
        if t._flip is not None:
            shapes["mask"] = ((k, t.c.batch_size), torch.bool)
        if t.c.device_data_cache:
            shapes["idx"] = ((k, rows), torch.int64)
        else:
            shapes["x"] = ((k, rows) + m.field_shape, f32)
            shapes["y"] = ((k, rows, m.num_param), f32)
        self.static = {n: torch.zeros(s, dtype=d, device=dev)
                       for n, (s, d) in shapes.items()}
        if dev.type == "cuda":
            self._staging = [{n: torch.zeros(s, dtype=d, pin_memory=True)
                              for n, (s, d) in shapes.items()}
                             for _ in range(2)]
        else:
            self._staging = [self.static]
        self._events: list[torch.cuda.Event | None] = [None, None]
        self._slot = 0
        self._warm = False
        self.graph: torch.cuda.CUDAGraph | None = None
        self.aux: dict[str, torch.Tensor] | None = None
        self.captured: dict[str, int] = {}  # FD launches a replay
        self.capture_s = 0.0
        self.pool_bytes = 0                 # reserved by the capture
        self.replays = 0

    def fill(self, block: dict) -> None:
        """The static inputs of the next chunk from host ``block``: per
        name an array ``[k, ...]`` or a list of ``k`` rows."""
        with spans.span("train.fill"):
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
        losses."""
        t, s = self.trainer, self.static
        for i in range(self.k):
            if "idx" in s:
                a, b = t._cache_batch(s["idx"][i])
            else:
                a, b = s["x"][i], s["y"][i]
            aux = t._update(a, b, s["mask"][i] if "mask" in s else None,
                            s["lr"][i])
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
