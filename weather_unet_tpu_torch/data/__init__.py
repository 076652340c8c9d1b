"""Host-side data pipeline: datasets, the imbalance sampler, loader-thread
augmentation with keyed RNG streams, the threaded batch loader and the
prefetch onto the GPU."""
