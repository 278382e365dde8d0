"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the device-dispatching ops (``ops``)."""
