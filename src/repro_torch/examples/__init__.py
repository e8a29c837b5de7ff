"""The port's example entry points, twins of the reference's
``examples/`` with the same sizes, seeds and printed lines, run on the
card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.splay_workloads --n 20000
    PYTHONPATH=src python -m repro_torch.examples.train_adaptive_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_adaptive
"""
