"""mfu.enhance: the enhancement calls' counted FLOPs over the window, as a
% of the H100's bf16 peak (perfbench.readings.mfu)."""

from perfbench.readings import mfu as read  # noqa: F401
