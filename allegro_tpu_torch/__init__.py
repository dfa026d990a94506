"""allegro_tpu_torch: the Allegro force call in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of ``allegro_tpu`` (JAX on TPU), which stays the reference. The
module layout and names mirror the JAX package (``lib``, ``data``, ``nn``,
``ops``, ``model``, ``md``, ``train``, ``parallel``, ``compile``), and the
data contracts at the public functions are the same: edges sorted by center with the sentinel center ``n_atoms`` on padded
edges, the flat dim-major tensor track, the ``data.keys`` names. This
package imports torch, numpy and scipy, never JAX.
"""

__version__ = "0.1.0"
