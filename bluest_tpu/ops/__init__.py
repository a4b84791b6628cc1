"""Hand-written GPU kernels of the model families (Pallas through Triton)."""
