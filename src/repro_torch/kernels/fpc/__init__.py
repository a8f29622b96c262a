"""FPC decode: CUDA kernel and its plain form."""
