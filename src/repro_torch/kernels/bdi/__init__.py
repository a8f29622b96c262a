"""Variable-rate BDI decode: CUDA kernel and its plain form."""
