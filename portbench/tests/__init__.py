"""CPU tests of the benchmark: its files by name, the reference against the
port, the counters against the port's walker, the trace reduction, the
comparison against its control and faults, and what a run imports."""
