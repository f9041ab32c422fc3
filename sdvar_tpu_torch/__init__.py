"""PyTorch/CUDA port of ``sdvar_tpu`` (VAR next-scale image generation and
its training on one card, ``train/``).

The JAX package ``sdvar_tpu`` stays the reference; this package imports
nothing from it and nothing of JAX. Plain tensor code is PyTorch; the two
TPU kernels on the generation path are hand-written for Hopper in CUDA C++:
the fused attention (``csrc/attention.cu``) and the fused top-k/top-p
sampler (``csrc/sampler.cu``). Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, where
every kernel is replaced by its plain PyTorch version.
"""
