from repro_torch.kernels.ops import fused_swiglu, gqa_flash_attention
from repro_torch.kernels.flash_attention import LIBRARY as FLASH_LIBRARY, flash_attention
from repro_torch.kernels.swiglu_matmul import LIBRARY as SWIGLU_LIBRARY, swiglu_matmul
from repro_torch.kernels import ref

# every kernel library of the port, in the order chip_smoke.py reports them
LIBRARIES = (FLASH_LIBRARY, SWIGLU_LIBRARY)

__all__ = [
    "gqa_flash_attention",
    "fused_swiglu",
    "flash_attention",
    "swiglu_matmul",
    "ref",
    "FLASH_LIBRARY",
    "SWIGLU_LIBRARY",
    "LIBRARIES",
]
