"""Static checks on the port's programs (counterpart: ``eventstreamgpt_tpu/analysis``):
the capture guard so far."""

from .compile_guard import CompileGuard, RecompileError

__all__ = ["CompileGuard", "RecompileError"]
