"""launches_per_step.train: device kernels a training step
(``train/steps.py:train_step``: the model's train forward, the loss, the
backward, the optimizer; the Mixup / CutMix of the feed): the kernels of
the traced window, the benchmark's own input draws left out, over the
steps it completed."""


def read(window):
    kernels = window.kernels()
    if not kernels or not window.units:
        return None
    return len(kernels) / window.units
