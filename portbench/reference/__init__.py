"""Plain float32 PyTorch references of the benchmark's configurations.

Each family module (``resnet_mrlal``, ``deit_mrlal``) gives ``spec`` (the
state dict and the benchmark's init rules), ``calibrate``, ``forward``,
``train_loss`` and ``decayed``.  Nothing here imports the program or JAX.
"""
