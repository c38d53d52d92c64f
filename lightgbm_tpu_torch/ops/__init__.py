"""Device operations: kernels, their dispatch, split search, growth."""
