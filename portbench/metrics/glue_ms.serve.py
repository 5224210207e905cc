"""glue_ms.serve: device milliseconds a forward in the block glue
(``serving/resnet_mrlal.py:_block``, ``serving/deit.py:_block``): the
kernels that are none of the port's own and no convolution, matrix
product or attention kernel (``work/names.py``), over the forwards."""

from portbench.work import names


def read(window):
    if not window.kernels() or not window.units:
        return None
    return window.kernel_seconds(names.is_glue) / window.units * 1e3
