"""Small shared utilities with no heavy dependencies."""

from repro_torch.utils.atomicio import atomic_write_json, atomic_write_text

__all__ = ["atomic_write_json", "atomic_write_text"]
