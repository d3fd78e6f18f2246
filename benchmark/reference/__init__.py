"""The plain reference the benchmark judges the port against.

Plain PyTorch, NumPy and SciPy, float32 with TF32 off.  It imports neither
JAX nor either microbeSEG package and takes nothing the port has made: the
benchmark hands it the weights and inputs it made itself, and it works out
normalisation, tiling, the network, post-processing, augmentation and the
optimizer again.
"""

import torch


def strict_float32() -> None:
    """Float32 products stay float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
