"""Host input pipeline of the port: audio IO, manifest datasets, corruption, batching."""
