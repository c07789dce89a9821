"""The synthetic token stream and its prefetching feeder."""
