"""Hand-written Hopper kernels of the port and their plain PyTorch versions;
``ops`` dispatches between them by the tensor's device."""
