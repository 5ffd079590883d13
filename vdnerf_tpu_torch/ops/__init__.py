"""Sampling, the NeuS renderer, and the hand-written CUDA kernels."""
