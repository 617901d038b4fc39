"""The JAX package's descriptors with its kernel K1's semantics, for the
tests that hold the port's session to the JAX package's.

On the CPU ``sivo_tpu/ops/pallas_orb.use_pallas()`` is False, and the
JAX package describes keypoints by its XLA path (``ops/orb.py``: float
canvases, angle 0 on a flat patch), which gives other bits than the
Pallas kernel K1 (u8 canvases, all bits 0 on a flat patch): on the
dumbbell lap 89-96% of keypoints differ in at least one bit. The port's
K1 has the kernel's semantics. Inside ``k1_kernel_semantics()`` the JAX
package takes K1, interpreted on the CPU; its jitted frontends are
retraced on the way in and out, since the choice is made while tracing.
The package itself is not changed.
"""

import contextlib

from sivo_tpu.ops import pallas_orb
from sivo_tpu.runtime import frame as j_frame

# the jitted frontends, whose traces hold the descriptor path
_JITTED = (j_frame.build_frame_nosegnet, j_frame.build_frame_pre,
           j_frame.build_frame_post)


@contextlib.contextmanager
def k1_kernel_semantics():
    use = pallas_orb.use_pallas
    for f in _JITTED:
        f.clear_cache()
    pallas_orb.use_pallas = lambda: True
    try:
        yield
    finally:
        pallas_orb.use_pallas = use
        for f in _JITTED:
            f.clear_cache()
