"""launches_per_forward.serve: device kernels a forward of the serving
engine (``serving/resnet_mrlal.py:resnet_mrlal_forward``,
``serving/deit.py:deit_forward``): the kernels of the traced window, the
benchmark's own input draws left out, over the forwards it completed."""


def read(window):
    kernels = window.kernels()
    if not kernels or not window.units:
        return None
    return len(kernels) / window.units
