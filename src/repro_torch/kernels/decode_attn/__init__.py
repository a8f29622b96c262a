"""Paged decode attention: plain forms, CUDA kernels, backend registry."""
