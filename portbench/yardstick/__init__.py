"""Frozen arithmetic the benchmark measures against: peaks of the chip,
work and bytes of a train step and of an attention call, and the
reduction of a profiler trace.  Copies, not imports, of the program's own
arithmetic, so that a change to the program cannot move the yardstick."""
