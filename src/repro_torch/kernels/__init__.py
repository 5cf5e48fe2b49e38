from repro_torch.kernels.ops import (
    fused_swiglu, gqa_bidirectional_attention, gqa_flash_attention, ssd_mixer,
)
from repro_torch.kernels.flash_attention import LIBRARY as FLASH_LIBRARY, flash_attention
from repro_torch.kernels.flash_attention import flash_attention_vjp
from repro_torch.kernels.flash_attention import select_variant as select_flash_variant
from repro_torch.kernels.flash_attention import select_bwd_variant as select_flash_bwd_variant
from repro_torch.kernels.ssd_scan import LIBRARY as SSD_LIBRARY, ssd_scan
from repro_torch.kernels.ssd_scan import select_variant as select_ssd_variant
from repro_torch.kernels.ssd_scan import select_bwd_variant as select_ssd_bwd_variant
from repro_torch.kernels.swiglu_matmul import LIBRARY as SWIGLU_LIBRARY, swiglu_experts
from repro_torch.kernels.swiglu_matmul import swiglu_matmul, swiglu_vjp
from repro_torch.kernels.swiglu_matmul import select_experts_variant
from repro_torch.kernels.swiglu_matmul import select_variant as select_swiglu_variant
from repro_torch.kernels.swiglu_matmul import select_bwd_variant as select_swiglu_bwd_variant
from repro_torch.kernels.causal_conv import LIBRARY as CONV_LIBRARY, causal_conv
from repro_torch.kernels import ref
from repro_torch.kernels.ref import flash_attention_bwd_ref, swiglu_bwd_ref

# every kernel library of the port, in the order chip_smoke.py reports them
LIBRARIES = (FLASH_LIBRARY, SWIGLU_LIBRARY, SSD_LIBRARY, CONV_LIBRARY)

__all__ = [
    "gqa_flash_attention",
    "gqa_bidirectional_attention",
    "ssd_mixer",
    "fused_swiglu",
    "flash_attention",
    "flash_attention_vjp",
    "ssd_scan",
    "causal_conv",
    "swiglu_matmul",
    "swiglu_experts",
    "swiglu_vjp",
    "select_experts_variant",
    "select_flash_variant",
    "select_flash_bwd_variant",
    "select_swiglu_variant",
    "select_swiglu_bwd_variant",
    "select_ssd_variant",
    "select_ssd_bwd_variant",
    "ref",
    "flash_attention_bwd_ref",
    "swiglu_bwd_ref",
    "FLASH_LIBRARY",
    "SSD_LIBRARY",
    "SWIGLU_LIBRARY",
    "CONV_LIBRARY",
    "LIBRARIES",
]
