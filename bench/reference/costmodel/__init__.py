"""A frozen NumPy copy of the partition cost model (§IV-A/B, Defs. 1-4).

``layers``, ``graph``, ``link``, ``memory`` and the accelerator model
(``arch``, ``energy``, ``mapper``) are copies of the port's
``core/{layers,graph,link,memory}.py`` and ``core/hwmodel/*.py`` with
their imports made relative, kept here so that no later change to the
program moves the yardstick the search cell is judged by.
``cnn_graph`` rebuilds EfficientNet-B0's layer graph from its stage table
without torch, and ``evaluate`` scores a cut vector the plain way, one
segment and one link at a time.
"""
