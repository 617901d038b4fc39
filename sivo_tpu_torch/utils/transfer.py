"""Host <-> device copies that do not stall the stream.

``torch.from_numpy(a).to(cuda)`` and ``t.cpu()`` copy through pageable
host memory and synchronise the host with the device. The tracker's
per-frame summary and the mapper's stage outputs instead start their
copy when the work is enqueued and are waited for later, so the device
keeps working meanwhile (the JAX package does this with a fetch thread,
``sivo_tpu/utils/fetch.py``, which is not ported):

* ``HostCopy`` copies a dict of device tensors into pinned host memory
  with ``non_blocking=True`` and records a CUDA event after them;
  ``done()`` polls the event, ``result()`` waits for it.
* ``to_device`` uploads a numpy array through pinned memory with
  ``non_blocking=True``.

On CPU tensors both copy at once and ``done()`` is always true.
"""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A device -> host copy of named tensors, started at construction."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        self._host: dict[str, torch.Tensor] = {}
        self._event = None
        for name, t in tensors.items():
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                if self._event is None:
                    self._event = torch.cuda.Event()
            else:
                h = t.detach().clone()
            self._host[name] = h
        if self._event is not None:
            self._event.record()

    def done(self) -> bool:
        """True once the copy has landed (never blocks)."""
        return self._event is None or self._event.query()

    def result(self) -> dict[str, np.ndarray]:
        """Wait for the copy; the tensors as numpy arrays."""
        if self._event is not None:
            self._event.synchronize()
        return {name: h.numpy() for name, h in self._host.items()}


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (the host array may change after)."""
    t = torch.from_numpy(np.array(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
