"""KVServe on PyTorch and CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100.

``repro_torch`` imports torch, numpy and the standard library, never JAX
and nothing of ``repro``: the JAX-free modules it shares with the JAX
package are its own copies.  Its TPU kernels are hand-written Hopper
kernels (``repro_torch.kernels``).  Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Float32 matrix products and convolutions run in full float32 (no TF32),
and bf16 matrix products reduce in float32, as the JAX package's do.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
