"""axial_vs_tpu_torch: the PyTorch + CUDA port of ``axial_vs_tpu``.

It mirrors the JAX package's tree (``ops``, ``layers``, ``models``,
``utils``) and its channels-last layouts (NHWC / NLC) at every public
function. Parameter and buffer names follow the upstream torch
``state_dict`` layout (timm ConvNeXt, ``sem_seg_head.wc_module``,
``.pixel_decoder``, ``.predictor``), so ``axial_vs_tpu/utils/torch_convert.py``
and ``utils/convert.py`` map one set of weights between the two packages.

The kernels that the JAX package wrote in Pallas for the TPU are CUDA C++
for Hopper (``csrc/``), built at first use by ``ops/native.py``. Each has a
plain PyTorch version beside its wrapper, which runs for CPU tensors only.
This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
