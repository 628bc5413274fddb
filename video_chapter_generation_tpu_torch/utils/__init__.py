"""Host utilities: memory tracking, caching, profiling, FLOP counts."""
