"""The table of device kernel names: which kernels are the port's own,
which are convolutions, matrix products or attention, which normalise.
Matched as lower-case substrings of the kernel's name as the profiler
records it; the first table that matches wins."""

# the port's hand-written kernels (csrc/)
PORT = ("tail_x1_kernel", "tail_window_kernel", "deit_tail_pass",
        "stage4_product_kernel", "rowtail", "hwbc_copy", "roi_align")
# convolutions, matrix products and attention, by the libraries' names
PRODUCTS = ("conv", "xmma", "gemm", "cutlass", "cudnn", "implicit", "sm90_",
            "winograd", "fprop", "dgrad", "wgrad", "nvjet", "cublas",
            "splitk", "gemv", "flash", "fmha", "attention", "sm80_")
# normalisation, forward and backward: BatchNorm and LayerNorm
NORMS = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford",
         "layer_norm", "layernorm", "gammabeta")
# device activity that is no kernel
COPIES = ("memcpy", "memset")


def matches(name: str, table) -> bool:
    low = name.lower()
    return any(k in low for k in table)


def is_kernel(name: str) -> bool:
    return not matches(name, COPIES)


def is_glue(name: str) -> bool:
    """A kernel that is none of the port's and no product: element-wise
    work, reductions, pooling, normalisation, casts and copies."""
    return is_kernel(name) and not (matches(name, PORT)
                                    or matches(name, PRODUCTS))
