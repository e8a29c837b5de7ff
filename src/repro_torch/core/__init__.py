"""State engine, index plane and workloads of the PyTorch port."""
