"""PyTorch port of SemiSFL for NVIDIA Hopper GPUs: the training round of the
CNN family and split-inference serving of the dense decoder LMs.

Mirrors the layout of the JAX package ``repro`` (the reference), which it
never imports.  Entry points run on the card (``device="cuda"``) unless the
caller asks for ``device="cpu"``; the CUDA kernels under ``csrc/`` are
built at first use (``kernels/build.py``)."""
