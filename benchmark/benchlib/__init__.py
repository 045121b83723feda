"""The benchmark's own library: traffic generation, spans and launch
records, trace reading, statistics and the lookup of cells, configurations,
drivers, metrics and kernel costs by name."""
