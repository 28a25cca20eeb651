"""Synthetic data: temporal-graph generators and the LM token stream
(bit-equal to ``repro.data``)."""

from repro_torch.data.synthetic import DATASET_SPECS, SyntheticSpec, generate
from repro_torch.data.tokens import synthetic_token_batches

__all__ = ["SyntheticSpec", "generate", "DATASET_SPECS", "synthetic_token_batches"]
