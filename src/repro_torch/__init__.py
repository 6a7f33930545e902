"""PyTorch/CUDA port of the service-chain GP solver (``src/repro``).

The package mirrors ``repro`` module for module: the GP solver
(``core``), and the model substrate that the DNN vertical-split chains run
(``configs``, ``models``).  It imports ``torch`` and numpy only; the Pallas
kernels on its paths are CUDA C++ kernels for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use.

Everything computes in float32.  TF32 is switched off here, once, for the
whole process: reference parity is asserted at full float32 precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
