"""Deterministic synthetic data pipeline (counterpart of ``repro.data``;
the dry-run's ``make_batch_specs`` comes with ``launch/dryrun.py``)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset"]
