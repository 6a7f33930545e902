"""The model substrate of the DNN vertical-split chains and the serve
engine: configs in; a cache-less forward, a cached prefill and a
single-token decode out (GQA attention with Gemma-2's soft-capping and
local/global windows, or Mamba-2 SSD mixers; dense SwiGLU/GeGLU or no
FFN), with the attention and SSD kernels of ``kernels``."""
