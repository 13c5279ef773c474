"""Entry drivers: one module per entry point that a cell's window drives."""
