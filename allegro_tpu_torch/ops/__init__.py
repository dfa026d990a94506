"""Hand-written CUDA kernels of the tensor-product layer, their wrappers and
plain versions, and the autograd Function that composes them."""
