"""The paper's evaluation on the port: the benchmark modules of Tables 1-4 and
Figs. 3-5, 11-13 and App. C.3, and the drift battery of the routing
controller (``python -m repro_torch.benchmarks.run``)."""
