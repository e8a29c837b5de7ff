"""Training stack of the PyTorch port: checkpoints, the optimizer, the
train step, the data pipeline and the straggler monitor (the twin of
``repro.train``, meshless)."""
