"""Small shared utilities: the struct helper, device resolution, registries."""
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.registry import Registry
from repro_torch.utils.structures import Struct

__all__ = ["Registry", "Struct", "resolve_device"]
