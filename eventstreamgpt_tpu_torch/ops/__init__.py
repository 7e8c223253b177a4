"""Tensor ops and the hand-written kernels (counterpart: ``eventstreamgpt_tpu/ops``).

`fused_sampling` (kernel A, Triton), `decode_step` (kernel B),
`vocab_gather` (kernel C) and `dep_graph` (kernel D; B-D CUDA C++ in
``csrc/``) each keep their plain PyTorch version beside the wrapper.
"""
