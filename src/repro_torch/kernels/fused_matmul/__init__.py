"""Fused compressed-weight matmul: plain forms and the CUDA kernel."""
