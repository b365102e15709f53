"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers. Nothing
is built at import: ``build.load()`` compiles csrc/*.cu at first use."""
