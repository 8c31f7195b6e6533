"""Stencil ops: plain PyTorch step functions and the hand-written kernels."""
