"""C-Pack decode: CUDA kernel and its plain form."""
