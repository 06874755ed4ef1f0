"""Compute: Lie algebra, projection, triangulation, Hamming matching, ORB,
RANSAC pose, bundle adjustment, and the wrappers of the CUDA kernels."""
