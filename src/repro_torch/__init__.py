"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package grows beside it,
slice by slice, and imports nothing of it (nor of JAX).  Its TPU kernels
become CUDA kernels written by hand (``repro_torch/csrc``), each with a
plain PyTorch version that the CPU tests and ``chip_smoke.py`` hold it to.
Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: LM serving (``serve.Engine`` over ``models.transformer``)
with the flash-attention, fused-SwiGLU and SSD-scan kernels, and the
paper's pipeline up to the unrolled executor (``core``, ``models.cnn``,
``models.slicing``, ``codegen``: plans run on m CUDA streams).
"""
