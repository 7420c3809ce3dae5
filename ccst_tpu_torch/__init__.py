"""ccst_tpu_torch — the PyTorch / CUDA port of ``ccst_tpu`` for NVIDIA Hopper.

The JAX package ``ccst_tpu`` is the reference: every module here mirrors the
one of the same name there and is tested against it. Public functions take
and return NHWC tensors, the JAX layout. Each Pallas kernel on the ported path
has a hand-written Hopper counterpart under ``kernels/`` (CUDA C++ in
``csrc/``, or Triton) beside a plain PyTorch version, which a wrapper runs
only for a tensor on the CPU.

Ported so far: the Overall-mode stylize path with its style banks and int8
calibration (``pipeline.style_bank``, ``pipeline.stylize``, the
``ccst-tpu-torch`` CLI), with the bf16 ``ref`` and the ``int8-static`` /
``int8-fused`` engines.

Subpackages
-----------
- ``ops``       AdaIN statistics and Welford moments
- ``models``    VGG-19 encoder / mirror decoder, weight conversion, the int8
                engines (``vgg_fast``)
- ``kernels``   Hopper kernels and their plain versions
- ``pipeline``  style banks and stylization
"""

__version__ = "0.1.0"
