"""Quantization primitives of the port (``optim/compress.py``); the
optimizer and gradient compression come with the training slice."""
