"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Importing this package builds nothing: the kernels are compiled by nvcc at
their first launch (``kernels/_build.py``)."""

from mrla_tpu_torch.kernels.deit_token_tail import (
    TailParams,
    deit_token_tail,
    deit_token_tail_reference,
    pack_tail_params,
)
from mrla_tpu_torch.kernels.mrla_epilogue import (
    fused_block_tail,
    fused_block_tail_reference,
    fused_epilogue,
    fused_epilogue_reference,
    mrla_block_tail,
    mrla_light_epilogue,
    mrla_light_epilogue_reference,
    mrla_light_gate,
)
from mrla_tpu_torch.kernels.mrla_epilogue_hwbc import (
    hwbc_copy,
    hwbc_copy_reference,
    mrla_block_tail_hwbc,
)
from mrla_tpu_torch.kernels.mrla_megatail import (
    megatail_covers,
    mrla_block_tail_fused_next,
    mrla_block_tail_fused_next_reference,
)
from mrla_tpu_torch.kernels.mrla_rowtail import (
    mrla_rowtail,
    mrla_rowtail_reference,
    rowtail_covers,
)
from mrla_tpu_torch.kernels.roialign_patch import (
    roi_align_grad_kernel,
    roi_align_kernel,
    roi_align_patch,
)
from mrla_tpu_torch.kernels.mrla_stage4 import (
    pack_stage4_params,
    stage4_resident,
    stage4_resident_reference,
)

__all__ = [
    "TailParams",
    "deit_token_tail",
    "deit_token_tail_reference",
    "fused_block_tail",
    "fused_block_tail_reference",
    "fused_epilogue",
    "fused_epilogue_reference",
    "hwbc_copy",
    "hwbc_copy_reference",
    "megatail_covers",
    "mrla_block_tail",
    "mrla_block_tail_fused_next",
    "mrla_block_tail_fused_next_reference",
    "mrla_block_tail_hwbc",
    "mrla_light_epilogue",
    "mrla_light_epilogue_reference",
    "mrla_light_gate",
    "mrla_rowtail",
    "mrla_rowtail_reference",
    "pack_stage4_params",
    "pack_tail_params",
    "roi_align_grad_kernel",
    "roi_align_kernel",
    "roi_align_patch",
    "rowtail_covers",
    "stage4_resident",
    "stage4_resident_reference",
]
