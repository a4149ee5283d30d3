"""The general parts of the benchmark: the run's context and result line
(`context`), seeded inputs (`layouts`), weights (`weights`), the profiler
window (`trace`), FLOP and byte counts (`flops`), statistics (`stats`)
and the model on both sides, port and reference (`models`)."""
