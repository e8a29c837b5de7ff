"""Training stack of the PyTorch port: checkpoints, the optimizer, the
train step, the data pipeline, the straggler monitor and the elastic
re-mesh and re-lay (the twin of ``repro.train``)."""
