"""sivo_tpu_torch — the per-frame stereo VO path of sivo_tpu in PyTorch.

A port of the JAX package ``sivo_tpu`` (which stays in the repository as
the reference) to PyTorch and CUDA on an NVIDIA H100. The layout mirrors
``sivo_tpu``: the counterpart of ``sivo_tpu/ops/orb.py`` is
``sivo_tpu_torch/ops/orb.py``, and so on.

This slice covers one stereo pair in, one camera pose out:
``runtime.frame.build_frame`` (SegNet MC-dropout posterior, ORB pyramid,
FAST, keypoint selection, IC angle + rBRIEF, semantic gating, stereo
matching) followed by ``runtime.tracking.Tracker.track`` without a local
mapper. The two Pallas TPU kernels of that path are hand-written CUDA
kernels for Hopper (``csrc/``), each with a plain PyTorch version beside
it that serves CPU tensors and the tests.

The package imports no JAX and nothing of ``sivo_tpu``: what it needs
of the JAX package's numpy-only modules it keeps as copies
(``config.py``, ``io/synthetic.py``, ``runtime/map_state.py``,
``ops/data/brief_pattern.npy``).
"""

from sivo_tpu_torch.utils import precision as _precision

_precision.apply_policy()
