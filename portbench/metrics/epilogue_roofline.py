"""epilogue_roofline: the epilogue kernel's share of its roofline
(``kernels/mrla_epilogue.py``, ``csrc/mrla_epilogue.cu``: the
``tail_window_kernel`` from ``out``): the least time of the window's
launches, by the shapes the port's launch counter records, over the
device time of the kernel's launches in the trace."""

from portbench.work import peaks, tails

COUNTER = "mrla_tpu_torch.kernels.mrla_epilogue.fused_epilogue"


def is_epilogue(name: str) -> bool:
    low = name.lower()
    return "tail_window_kernel" in low and "fromout" in low


def read(window):
    launches = window.counter(COUNTER)
    busy = window.union_seconds(is_epilogue)
    if not launches or busy <= 0:
        return None
    least = sum(k * peaks.bound_s(*tails.epilogue(*shape))
                for shape, k in launches.items())
    return 100.0 * least / busy
