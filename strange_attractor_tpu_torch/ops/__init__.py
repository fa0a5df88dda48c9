"""Device operations: projection, emission, binning, tone map, and the CUDA kernel build."""
