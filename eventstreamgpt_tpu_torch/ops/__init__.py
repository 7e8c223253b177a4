"""Tensor ops and the hand-written kernels (counterpart: ``eventstreamgpt_tpu/ops``).

`fused_sampling` (kernel A), `decode_step` (kernel B), `vocab_gather`
(kernel C), `dep_graph` (kernel D) and `flash_attention` (kernels E and F,
one source), all CUDA C++ in ``csrc/``, each keep their
plain PyTorch version beside the wrapper. `band_attention` is the plain
PyTorch band product the JAX model runs for narrow local windows.
"""
