"""Copies between the host and a device that keep the host from waiting
on the device where it need not: pinned memory and non-blocking copies."""

from __future__ import annotations

import numpy as np
import torch


def upload(data, device, dtype=None) -> torch.Tensor:
    """``data`` (a numpy array or a list) copied into a tensor on
    ``device``. To a CUDA device it goes through pinned memory with a
    non-blocking copy, which is queued behind the stream's work; a plain
    copy from pageable memory makes the host wait for the stream first, so
    a small constant made in the middle of a step would stall the host."""
    t = torch.tensor(data, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# bytes the pinned route (stage_in, fetch) moved each way
_moved = {"to_device": 0, "to_host": 0}


def moved_bytes() -> dict:
    """Bytes :func:`stage_in` and :func:`fetch` copied through pinned
    memory, each way, since the last :func:`reset_moved_bytes`."""
    return dict(_moved)


def reset_moved_bytes():
    for k in _moved:
        _moved[k] = 0


def stage_in(arrays, device) -> torch.Tensor:
    """numpy arrays of one shape and dtype stacked into one tensor
    [len, *shape] on ``device``. To a CUDA device they are stacked straight
    into one pinned block of PyTorch's caching host allocator and uploaded
    by one non-blocking copy; the block returns to the cache when that copy
    is done. Elsewhere: ``np.stack`` and ``.to``."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.stack(arrays)).to(device)
    dtype = torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype
    host = torch.empty((len(arrays), *arrays[0].shape), dtype=dtype,
                       pin_memory=True)
    np.stack(arrays, out=host.numpy())
    _moved["to_device"] += host.nbytes
    return host.to(device, non_blocking=True)


def fetch(tensors: dict) -> dict:
    """``{name: tensor}`` of one device as ``{name: numpy array}`` on the
    host. From a CUDA device: non-blocking copies into pinned tensors of
    PyTorch's caching host allocator, one a tensor (the allocator rounds a
    block up to a power of two, so one joint block could pin twice the
    bytes), then one wait on an event. The arrays are views of that pinned
    memory: once they are dropped the blocks return to the cache, where the
    next fetch of the same sizes finds them. A CPU tensor's array is a view
    of the tensor."""
    if not any(t.is_cuda for t in tensors.values()):
        return {k: t.numpy() for k, t in tensors.items()}
    host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            .copy_(t, non_blocking=True) for k, t in tensors.items()}
    _moved["to_host"] += sum(t.nbytes for t in host.values())
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(
        next(iter(tensors.values())).device))
    event.synchronize()
    return {k: t.numpy() for k, t in host.items()}
