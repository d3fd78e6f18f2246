"""PyTorch/CUDA port of microbeSEG instance segmentation.

Mirrors the layout of the JAX package (``microbeseg_tpu``) module by module,
in PyTorch's idiom: ``nn.Module`` models, plain functions on tensors and an
explicit ``device``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.  The marker flood, connected components and rank relabel
run as hand-written CUDA kernels (``csrc/``) on the card, and as their plain
PyTorch versions on CPU tensors.
"""
