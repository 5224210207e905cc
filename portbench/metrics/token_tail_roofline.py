"""token_tail_roofline: the DeiT token tail's share of its roofline
(``kernels/deit_token_tail.py``, ``csrc/deit_token_tail.cu``): the least
time of the window's calls, by the shapes the port's launch counter
records (both passes are one call of the function), over the device time
of the two passes' launches in the trace, their overlap counted once."""

from portbench.reference.common import eca_kernel_size
from portbench.work import names, peaks, tails

COUNTER = "mrla_tpu_torch.kernels.deit_token_tail.deit_token_tail"
KERNEL = ("deit_tail_pass",)


def read(window):
    launches = window.counter(COUNTER)
    busy = window.union_seconds(lambda n: names.matches(n, KERNEL))
    if not launches or busy <= 0:
        return None
    ktap = eca_kernel_size(window.cell.config["embed_dim"])
    least = sum(k * peaks.bound_s(*tails.token_tail(*shape, ktap))
                for shape, k in launches.items())
    return 100.0 * least / busy
