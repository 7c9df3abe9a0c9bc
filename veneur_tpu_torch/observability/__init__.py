"""Device sync timing for asynchronous CUDA dispatch."""
