"""Pallas kernels (Triton route, GPU) for the geodesic hot loop."""
