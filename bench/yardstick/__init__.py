"""The yardstick: input generation, peaks, work counts, statistics and
the reduction of profiler traces. It imports nothing of the program."""
