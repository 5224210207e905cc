"""mfu.serve: the whole forward's share of the card's bf16 peak: the
model's FLOPs an image (``work/flops.py``, the benchmark's own count)
times the images completed, over the window, over 989 TFLOP/s."""

from portbench.work import peaks


def read(window):
    if not window.images:
        return None
    return (100.0 * window.flops_per_image * window.images / window.seconds
            / peaks.BF16_TENSOR_FLOPS)
