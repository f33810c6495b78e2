"""Utilities: checkpoints, phase timers, the program's spans and a profiler
trace; `convert` hands the JAX package's parameters and state to the port."""

from mpopis_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from mpopis_tpu_torch.utils.profiling import PhaseTimer, span, timed, trace

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "PhaseTimer",
    "span",
    "timed",
    "trace",
]
