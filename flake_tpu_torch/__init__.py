"""flake-tpu on PyTorch and CUDA: the batched FLAC encoder on one GPU.

A port of :mod:`flake_tpu` (JAX on a TPU), which stays beside it as the
reference. The port imports ``torch`` and numpy and never JAX or the JAX
package; its device kernels are CUDA C++ written for Hopper
(``csrc/``), each with a plain PyTorch version that a CPU tensor takes.

Lifecycle as in the reference (flake.h): build a
:class:`~flake_tpu_torch.params.StreamConfig` (via
:func:`~flake_tpu_torch.params.set_defaults`), construct an
:class:`~flake_tpu_torch.encoder.Encoder` on a device, then
``encode_stream(pcm)``.
"""

from flake_tpu_torch.version import __version__, get_version  # noqa: F401
from flake_tpu_torch.params import (  # noqa: F401
    EncodeParams,
    OrderMethod,
    Prediction,
    StereoMethod,
    StreamConfig,
    from_reference,
    set_defaults,
    validate_params,
)
from flake_tpu_torch.encoder import Encoder  # noqa: F401
