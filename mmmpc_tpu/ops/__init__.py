"""Hand-fused Pallas kernels (Triton route) and the associative-scan
Riccati."""
