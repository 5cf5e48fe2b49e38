"""Plain PyTorch references of the benchmark's models, independent of the port."""
