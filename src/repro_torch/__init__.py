"""ZeRO-Infinity reproduction, PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: module names mirror
``src/repro/``, and nothing here imports JAX or the JAX package. This slice
holds the serving path (``repro_torch.launch.serve``) with hand-written CUDA
kernels for prefill attention and the MLP projections.
"""
