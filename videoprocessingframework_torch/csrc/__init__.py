"""CUDA kernel sources and their build."""
