"""Plain PyTorch references of the benchmark's apps.

They read only the graph the benchmark made (CSR arrays and weights) and
import nothing of the program under test. Each also returns, per
iteration, the active vertices and the edges out of them: the work the
app's semantics need, which ``metrics/sweep_roofline.py`` counts.
"""
