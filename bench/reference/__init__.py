"""Plain references that decide each cell's ``correct``.

Nothing here imports JAX, the JAX package or the port: each reference is
written from the model's or the paper's description in plain NumPy or
PyTorch, and works out again whatever the program derives from the inputs
(schedules, cut plans, quantized weight copies).
"""
