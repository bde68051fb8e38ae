"""End-to-end pipelines and the circuit generator."""

from eig_kl_tpu_torch.models.generator import CircuitGenerator, generate_circuit
from eig_kl_tpu_torch.models.pipelines import (
    fused_partition,
    kl_partition,
    spectral_partition,
)
from eig_kl_tpu_torch.models.run import PartitionRunData as PartitionRun

__all__ = [
    "spectral_partition",
    "kl_partition",
    "fused_partition",
    "PartitionRun",
    "CircuitGenerator",
    "generate_circuit",
]
