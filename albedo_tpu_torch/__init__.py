"""albedo-tpu on PyTorch and CUDA: the port of ``albedo_tpu`` to one NVIDIA
H100.

Plain tensor code is PyTorch; the hot loops of the ALS fit and the top-k
retrieval are CUDA kernels written by hand (``albedo_tpu_torch.kernels``),
each with a plain PyTorch version beside it in ``albedo_tpu_torch.ops``.
Entry points take ``device="cuda"`` and never fall back to the CPU; the CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""

import torch

# The Gramian (YtY) and the score product must be full float32 to hold the
# JAX package's numerics: TF32 keeps about three decimal digits. Matmuls are
# f32 by default, cuDNN convolutions are not; both are pinned off here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
