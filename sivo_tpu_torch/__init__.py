"""sivo_tpu_torch — stereo semantic visual SLAM in PyTorch and CUDA.

A port of the JAX package ``sivo_tpu`` (which stays in the repository as
the reference) to PyTorch and CUDA on an NVIDIA H100. The layout mirrors
``sivo_tpu``: the counterpart of ``sivo_tpu/ops/orb.py`` is
``sivo_tpu_torch/ops/orb.py``, and so on.

It covers what the JAX package does, from a stereo pair to the KITTI
trajectory file: the command line (``cli.py``) and ``runtime.system.
System`` with the per-frame frontend (SegNet MC-dropout posterior, ORB
pyramid, FAST, keypoint selection, IC angle + rBRIEF, semantic gating,
stereo matching), the tracker, the local mapper with local BA, loop
closing with global BA, and relocalization; the shell (``.caffemodel``
I/O, the KITTI reader, map serialization, replay renders, the native
vocabulary parser); SegNet training and the offline tools (``tools/``);
and the multi-device paths on ``torch.distributed`` (``parallel/``:
multi-sequence sessions and point-sharded BA; SegNet's MC samples split
over ranks; ``entry.py``, the counterpart of ``__graft_entry__.py``).
The two Pallas TPU kernels are hand-written CUDA kernels for Hopper
(``csrc/``), each with a plain PyTorch version beside it that serves CPU
tensors and the tests.

The package imports no JAX and nothing of ``sivo_tpu``: what it needs
of the JAX package's numpy-only modules it keeps as copies (among them
``config.py``, ``io/synthetic.py``, ``runtime/map_state.py``,
``parallel/multi_sequence.py``), held equal to their originals by
``tests/test_torch_copies.py``.
"""

from sivo_tpu_torch.utils import precision as _precision

_precision.apply_policy()
