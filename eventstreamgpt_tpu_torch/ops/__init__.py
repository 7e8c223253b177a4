"""Tensor ops and the hand-written kernels (counterpart: ``eventstreamgpt_tpu/ops``).

`fused_sampling` (kernel A, Triton), `decode_step` (kernel B) and
`vocab_gather` (kernel C, both CUDA C++ in ``csrc/``) each keep their plain
PyTorch version beside the wrapper.
"""
