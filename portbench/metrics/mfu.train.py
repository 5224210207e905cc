"""mfu.train: the whole training step's share of the card's bf16 peak:
three forwards' FLOPs an image (``work/flops.py``) times the images of
the steps completed, over the window, over 989 TFLOP/s."""

from portbench.work import peaks


def read(window):
    if not window.images:
        return None
    return (100.0 * 3.0 * window.flops_per_image * window.images
            / window.seconds / peaks.BF16_TENSOR_FLOPS)
