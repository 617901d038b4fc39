"""The regimes the JAX package's CPU reference runs are made in, for the
tools that write ``chip_smoke.py``'s reference tables.

* ``use_k1()``: K1's descriptor semantics. On the CPU
  ``sivo_tpu.ops.pallas_orb.use_pallas()`` is False and the JAX package
  describes keypoints by its XLA path (float canvases), which gives
  other bits than its Pallas kernel K1 (u8 canvases), the semantics the
  port's kernel has. This patches ``use_pallas`` to return True (K1 runs
  interpreted, ~0.4 s a call at 2048 keypoints) and clears the jitted
  frontends' caches, since the choice is made while tracing. K2 stays on
  its XLA path, which is integer-exact.
* ``land_fetches()``: the card's timing. Every host fetch has landed
  when it returns (``fetch_packed_async`` and ``device_get_async``
  wrapped; the paced PCG solve polls the latter), as on the card, where
  the device outruns the host; on the CPU the device work is slow and a
  fetch lands frames late.

The package itself is not changed: both patch module attributes in the
calling process, before its first frame.
"""

from __future__ import annotations

from concurrent.futures import Future

import numpy as np


def use_k1() -> None:
    """Describe keypoints by K1 (interpreted) from here on."""
    from sivo_tpu.ops import pallas_orb
    from sivo_tpu.runtime import frame

    pallas_orb.use_pallas = lambda: True
    for f in (frame.build_frame_nosegnet, frame.build_frame_pre,
              frame.build_frame_post):
        f.clear_cache()


def landed_packed(tree):
    """``fetch_packed_async`` whose copy has landed when it returns."""
    from sivo_tpu.utils import fetch

    keys, arrs, flat_dev = fetch._pack_dispatch(tree)
    fut = Future()
    fut.set_result(np.asarray(flat_dev))
    return fetch.PackedFuture(keys, arrs, fut)


def landed_get(x):
    """``device_get_async`` whose copy has landed when it returns."""
    import jax

    fut = Future()
    fut.set_result(np.asarray(jax.device_get(x)))
    return fut


def land_fetches() -> None:
    """Every host fetch lands before it returns, from here on."""
    from sivo_tpu.utils import fetch

    fetch.fetch_packed_async = landed_packed
    fetch.device_get_async = landed_get


def take_flags(args: list[str], *flags: str) -> tuple[list[str], dict]:
    """``args`` without ``flags``, and which of them were given."""
    given = {f.lstrip("-"): f in args for f in flags}
    return [a for a in args if a not in flags], given
