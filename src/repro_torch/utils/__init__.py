"""Small shared utilities: the struct helper and device resolution."""
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

__all__ = ["Struct", "resolve_device"]
