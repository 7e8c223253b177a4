"""Tensor ops and the hand-written kernels (counterpart: ``eventstreamgpt_tpu/ops``).

`fused_sampling` (kernel A, Triton) and `decode_step` (kernel B, CUDA C++
in ``csrc/``) each keep their plain PyTorch version beside the wrapper.
"""
