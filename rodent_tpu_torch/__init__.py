"""rodent_tpu_torch — the PyTorch/CUDA port of rodent_tpu.

The JAX package `rodent_tpu` stays the reference; this package runs the
renderer's main path (scene -> BVH device tables -> traversal -> shading
-> film) on torch tensors, with the BVH traversal as a hand-written CUDA
kernel for Hopper (csrc/bvh_traverse.cu).

Layout rules of the port:
- per-ray data are flat (B,) component tensors (the (R, 128) tile layout
  of rodent_tpu.core.tiles is a TPU rule and is not ported);
- every function takes its device from an explicit argument or from the
  tensors it is given: there is no global default device;
- the port imports nothing of the JAX package: the host code it needs
  (accel, io, native, utils.testscenes) is a copy kept here, and nothing
  here imports jax.
"""

__version__ = "0.1.0"
