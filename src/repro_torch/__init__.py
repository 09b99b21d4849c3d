"""PyTorch / CUDA port of the HCache reproduction (``repro``), for NVIDIA
Hopper. It imports ``torch`` and ``numpy``, never ``jax``, and nothing of
the ``repro`` package."""
