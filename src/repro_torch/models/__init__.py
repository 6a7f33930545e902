"""The model substrate of the DNN vertical-split chains: configs in, a
cache-less forward out (GQA attention or Mamba-2 SSD mixers, dense SwiGLU
or no FFN), with the attention and SSD kernels of ``kernels``."""
