"""The yardstick: cells by name, seeds, weights, counts of operations and
bytes, the reduction of a profiler trace, and the comparisons."""
