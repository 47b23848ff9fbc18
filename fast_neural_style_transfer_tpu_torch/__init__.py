"""Fast neural style transfer in PyTorch for an NVIDIA H100.

The PyTorch/CUDA port of ``fast_neural_style_transfer_tpu``: the same
modules under the same names (``core``, ``ops``, ``models``, ``infer``,
``serve``, ``cli``, ``export``, ``utils``), NHWC at every public function,
and the reference ``StyleTransferNet`` state_dict layout for weights. The
instance-norm forward runs as a hand-written CUDA kernel for ``sm_90a``
(``csrc/instance_norm.cu``, ``ops/cuda_norm.py``); the convolutions go to
cuDNN (int8 ones to ``torch._int_mm``). Entry points run on the card
unless the caller asks for the CPU.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
