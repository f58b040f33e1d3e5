"""seigen_tpu_torch: the PyTorch + CUDA port of seigen_tpu.

Same physics and lane layout as the JAX package (nodal DG velocity-stress
elastodynamics, LF4 on structured tetrahedral meshes), with host setup in
NumPy, plain tensor code in PyTorch and the operator kernels written by
hand in CUDA C++ for Hopper (``csrc/``).  Nothing here imports JAX.
"""

__version__ = "0.1.0"
