"""The data pipeline: image I/O, the synthetic dataset, the CSV-indexed
dataset, the task-uniform sampler and the prefetching engine."""
