"""SevenNet on PyTorch and CUDA (NVIDIA Hopper).

PyTorch port of ``sevennet_exp_tpu``: the 7net-0 network, its checkpoint
loader and single-device NVE/NVT molecular dynamics on the dense
per-atom neighbor grid. The fused convolution (radial MLP + uvu tensor
product + aggregation + self-interaction linear) and its force backward
run as hand-written CUDA kernels (``csrc/fused_conv_geom.cu``; the
``terms`` cross-check ``csrc/fused_conv_terms.cu``) on the card;
every other piece is plain PyTorch, Grimme D3 dispersion (``ops/d3.py``,
``SevenNetD3Calculator``, ``MolecularDynamics(d3=...)``) included.

The package imports ``torch`` and ``numpy`` only -- never ``jax``, optax
or ``sevennet_exp_tpu``. Entry points run on ``device='cuda'`` unless the
caller asks for the CPU; on CPU tensors the kernels' plain PyTorch
versions run instead.
"""

__version__ = '0.1.0'
