"""EventStreamGPT serving and training on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of ``eventstreamgpt_tpu``: each module sits at the same
relative path as its JAX counterpart. The JAX package stays the reference
the port is tested against; this package imports ``torch``, numpy and the
standard library only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; nothing falls back to the CPU on its own. The
hand-written kernels live in `ops.fused_sampling`, `ops.decode_step`,
`ops.vocab_gather`, `ops.dep_graph` and `ops.flash_attention` (CUDA C++
under ``csrc/``).
"""
