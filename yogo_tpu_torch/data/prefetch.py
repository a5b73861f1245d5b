"""The hand-off of loader batches to the device (the one-device counterpart
of yogo_tpu/parallel/mesh.py:295-396: prefetch_to_device, pad_batch_to_size,
pad_batch_to_multiple).

The loader yields numpy batches. On a CUDA device each batch is copied
into a reused pinned host buffer and from there, with a non-blocking copy
on a copy stream of its own, to the device; an event marks the copy's end
and the compute stream waits on it when the batch is handed out. `prefetch`
batches are in flight, so the copy of batch n+1 overlaps the step of batch
n. On the CPU the batches are handed out as tensors, one ahead.

Reading a batch (a 51 MB gather at full width, or 64 PNG decodes) and
staging it are host work of tens of milliseconds, and so is dispatching a
training step. So a thread reads, stages and starts the copies while the
caller dispatches steps; numpy's copies and the decoders release the
interpreter lock. The batches come out in the loader's order.

A packed-cache batch is a fancy-indexed copy of a read-only memmap; numpy
arrays are copied INTO the pinned buffer (np.copyto on the buffer's numpy
view), so torch never wraps an array it may not write to.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


def pad_batch_to_size(
    imgs: np.ndarray, labels: np.ndarray, mask: np.ndarray, target: int
) -> Batch:
    """Pad the batch axis to exactly `target` rows; padded rows masked out."""
    b = imgs.shape[0]
    if target == b:
        return imgs, labels, mask
    pad = target - b
    imgs = np.concatenate([imgs, np.repeat(imgs[:1], pad, axis=0)])
    labels = np.concatenate([labels, np.repeat(labels[:1], pad, axis=0)])
    mask = np.concatenate([mask, np.zeros(pad, mask.dtype)])
    return imgs, labels, mask


def pad_batch_to_multiple(
    imgs: np.ndarray, labels: np.ndarray, mask: np.ndarray, multiple: int
) -> Batch:
    """Pad the batch axis so `multiple` divides it; padded rows masked out."""
    target = -(-imgs.shape[0] // multiple) * multiple
    return pad_batch_to_size(imgs, labels, mask, target)


def stack_group(group: List[Batch], accumulate: int) -> Batch:
    """`accumulate` loader batches -> one (A, b, ...) stack for gradient
    accumulation. Batches of different sizes are padded to the largest, and
    a short final group is filled with zero-mask copies of its first
    micro-batch, so the step's input shape never changes (the
    count-weighted accumulation in make_train_step gives an all-padding
    micro-batch zero weight)."""
    tgt = max(b[0].shape[0] for b in group)
    padded = [pad_batch_to_size(*b, tgt) for b in group]
    while len(padded) < accumulate:
        i0, l0, m0 = padded[0]
        padded.append((i0, l0, np.zeros_like(m0)))
    return tuple(np.stack([b[i] for b in padded]) for i in range(3))


def _grouped(batch_iter: Iterable[Batch], accumulate: int) -> Iterator[Batch]:
    if accumulate == 1:
        yield from batch_iter
        return
    group: List[Batch] = []
    for batch in batch_iter:
        group.append(batch)
        if len(group) == accumulate:
            yield stack_group(group, accumulate)
            group = []
    if group:
        yield stack_group(group, accumulate)


class _PinnedSlot:
    """One set of pinned host buffers and the event of its last copy."""

    def __init__(self):
        self.buffers: List[torch.Tensor] = []
        self.event = None

    def stage(self, arrays: Batch) -> List[torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()  # the last copy out of these buffers
        if len(self.buffers) != len(arrays) or any(
            tuple(b.shape) != a.shape or b.numpy().dtype != a.dtype
            for b, a in zip(self.buffers, arrays)
        ):
            self.buffers = [
                torch.from_numpy(np.empty(a.shape, a.dtype)).pin_memory() for a in arrays
            ]
        for buf, a in zip(self.buffers, arrays):
            np.copyto(buf.numpy(), a)
        return self.buffers


def _in_background(items: Iterator, depth: int) -> Iterator:
    """Yield `items` in order while a thread runs the iterator up to
    `depth` items ahead. An exception in the thread is raised here; closing
    this generator early (a break in the consumer) stops the thread."""
    done = object()
    handoff: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                handoff.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in items:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    worker = threading.Thread(target=work, name="yogo-prefetch", daemon=True)
    worker.start()
    try:
        while True:
            item = handoff.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        worker.join()


def _staged(batches: Iterator[Batch], device: torch.device, n_slots: int) -> Iterator:
    """Each host batch -> (tensors on `device`, event of their copies): the
    batch is copied into a pinned slot and from there on a copy stream."""
    copy_stream = torch.cuda.Stream(device)
    slots = [_PinnedSlot() for _ in range(n_slots)]
    for n, batch in enumerate(batches):
        slot = slots[n % n_slots]
        pinned = slot.stage(batch)
        with torch.cuda.stream(copy_stream):
            on_device = tuple(p.to(device, non_blocking=True) for p in pinned)
            slot.event = torch.cuda.Event()
            slot.event.record(copy_stream)
        yield on_device, slot.event


def prefetch_to_device(
    batch_iter: Iterable[Batch],
    device,
    prefetch: int = 2,
    accumulate: int = 1,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Wrap a host (imgs, labels, mask) iterator with device prefetch:
    yields the same batches as tensors on `device`, `prefetch` of them in
    flight. accumulate > 1 groups every `accumulate` consecutive batches
    into one stacked (A, b, ...) batch (see stack_group). A thread reads
    and stages the batches (see the module docstring)."""
    device = torch.device(device)
    batches = _grouped(batch_iter, accumulate)

    if device.type != "cuda":
        # np.array copies: a tensor never shares a read-only array
        tensors = (tuple(torch.from_numpy(np.array(a)) for a in b) for b in batches)
        yield from _in_background(tensors, 1)
        return

    # a slot is free again once its batch was handed out: `prefetch` queued
    # batches, one being staged and one in the consumer's hands
    for on_device, event in _in_background(_staged(batches, device, prefetch + 2), prefetch):
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in on_device:
            # allocated on the copy stream, used on the compute stream
            t.record_stream(compute)
        yield on_device
