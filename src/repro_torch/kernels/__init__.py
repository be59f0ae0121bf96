"""The port's kernels: plain PyTorch oracles (:mod:`.ref`), hand-written
CUDA kernels for Hopper behind thin wrappers (:mod:`.gemm`, :mod:`.rmsnorm`,
:mod:`.flash_decode`, :mod:`.flash_attention`), and their registration as
op backends (:mod:`.ops`, :mod:`.serving_ops`)."""
