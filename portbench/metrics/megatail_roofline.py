"""megatail_roofline: the mega-tail kernel's share of its roofline
(``kernels/mrla_megatail.py``, ``csrc/mrla_megatail.cu``): the least time
of the window's launches, by the shapes the port's launch counter
records, over the device time of the kernel's launches in the trace."""

from portbench.work import names, peaks, tails

COUNTER = "mrla_tpu_torch.kernels.mrla_megatail.mrla_block_tail_fused_next"
KERNEL = ("tail_x1_kernel",)


def read(window):
    launches = window.counter(COUNTER)
    busy = window.union_seconds(lambda n: names.matches(n, KERNEL))
    if not launches or busy <= 0:
        return None
    least = sum(k * peaks.bound_s(*tails.megatail(*shape))
                for shape, k in launches.items())
    return 100.0 * least / busy
