"""Mamba2-370M — attention-free SSD (state-space duality) LM [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,             # d_inner / head_dim = 2048/64
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,                 # no MLP in mamba2 blocks (assignment: d_ff=0)
    vocab=50280,
    rope_theta=None,
    ssm=SSMSpec(
        d_state=128,
        head_dim=64,
        expand=2,
        n_groups=1,
        conv_width=4,
        chunk=256,
    ),
    source="arXiv:2405.21060 (unverified tier)",
)
