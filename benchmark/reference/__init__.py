"""The plain reference that decides ``correct``: VAR, its VQVAE and its
sampling rule written out again in plain PyTorch, in float32 with TF32 off,
from the published description (FoundationVision/VAR) and the port's
documented semantics. It imports neither JAX, nor the JAX package, nor
anything of ``sdvar_tpu_torch``, and takes nothing the port made: it is
handed the benchmark's own weights and inputs and the outputs to judge.

``precision.Precision`` selects the exact computation or the control, the
same mathematics one step lower (float8 e4m3 GEMM inputs where the
configuration states bfloat16; TF32 where it states float32).
"""
