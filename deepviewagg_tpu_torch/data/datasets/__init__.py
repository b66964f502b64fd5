"""Dataset machinery: preprocessing caches, the sphere sampler, the bucket
loader and the synthetic dataset."""
