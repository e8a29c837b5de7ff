"""PyTorch/CUDA port of the splay-list system (the JAX package
``repro`` is its reference).  Entry points run on the card unless the
caller passes ``device="cpu"`` or hands in CPU tensors."""
