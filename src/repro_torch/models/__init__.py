"""Model graphs for the partitioner."""
