"""ccst_tpu_torch — the PyTorch / CUDA port of ``ccst_tpu`` for NVIDIA Hopper.

The JAX package ``ccst_tpu`` is the reference: every module here mirrors the
one of the same name there and is tested against it. Public functions take
and return NHWC tensors, the JAX layout. Each Pallas kernel on the ported path
has a hand-written Hopper counterpart under ``kernels/`` (CUDA C++ in
``csrc/``, or Triton) beside a plain PyTorch version, which a wrapper runs
only for a tensor on the CPU.

Ported so far: the stylize stage with its style banks and int8 calibration
(``pipeline.style_bank``, ``pipeline.stylize``, the ``ccst-tpu-torch`` CLI),
Overall and Single mode, with every engine (``ref``, ``packed``, ``int8``,
``int8-static``, ``int8-fused``); the list subcommands (``data.lists``); the
federated training stage (``federated``); decoder training
(``pipeline.train_decoder``) and the privacy analysis (``privacy``).

Subpackages
-----------
- ``ops``       AdaIN statistics, Welford moments, the training stage's image ops
- ``models``    VGG-19 encoder / mirror decoder (kernel and autograd routes), the
                AdaIN training losses, weight conversion, the packed and int8
                engines (``vgg_fast``), the classifier zoo
- ``kernels``   Hopper kernels and their plain versions
- ``pipeline``  style banks, stylization, amplitude banks, decoder training
- ``federated`` the sequential federated runtime
- ``privacy``   the style inverter, its training and evaluation, LPIPS, the GAN
"""

__version__ = "0.1.0"
