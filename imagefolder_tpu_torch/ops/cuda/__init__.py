"""Hand-written Hopper kernels with their plain PyTorch versions
(counterpart of ``imagefolder_tpu/ops/pallas``)."""
