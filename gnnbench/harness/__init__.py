"""The benchmark's yardstick: finding files by name, the training run and its
window, the profiler reader, the work counts and the correctness check."""
