"""Plain float32 PyTorch references of models the port runs, importing no
kernel and no op of the port: the CPU tests hold the port to them."""
