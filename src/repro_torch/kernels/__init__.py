"""Hand-written Hopper kernels of the PyTorch port, each beside its plain
PyTorch version (see ``kernels/paged_attention``)."""
