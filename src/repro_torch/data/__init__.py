"""Synthetic temporal-graph generators (bit-equal to ``repro.data``)."""

from repro_torch.data.synthetic import DATASET_SPECS, SyntheticSpec, generate

__all__ = ["SyntheticSpec", "generate", "DATASET_SPECS"]
