"""norm_ms.train: device milliseconds a training step in normalisation
kernels, forward and backward (BatchNorm in ResNet, LayerNorm in DeiT;
``work/names.py``), over the steps."""

from portbench.work import names


def read(window):
    if not window.kernels() or not window.units:
        return None
    return window.kernel_seconds(
        lambda n: names.matches(n, names.NORMS)) / window.units * 1e3
